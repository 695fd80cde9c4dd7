"""Port of ``tpugraph/utils/tb_writer.py``: a dependency-free TensorBoard
event writer.

TFRecord framing (length + masked crc32c) around hand-encoded
``Event``/``Summary`` protobufs, byte for byte as ``tpugraph`` writes
them: for the same scalars, PNG images and wall time the two packages
write the same file.  ``add_figure`` takes the port's figure record
(:mod:`tpugraph_torch.viz.graphs`), drawn to PNG by
:mod:`tpugraph_torch.viz.writers`, where ``tpugraph`` takes a matplotlib
figure.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Dict, Optional


def _crc_table():
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    """TFRecord's masked CRC-32C of ``data``."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ----------------------------------------------------- protobuf encoding


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_bytes(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _pb_string(field: int, s: str) -> bytes:
    return _pb_bytes(field, s.encode("utf-8"))


def _pb_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _pb_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _scalar_summary(tag: str, value: float) -> bytes:
    # Summary { value = 1 { tag = 1; simple_value = 2 } }
    return _pb_bytes(1, _pb_string(1, tag) + _pb_float(2, float(value)))


def _image_summary(tag: str, png: bytes, height: int, width: int) -> bytes:
    # Summary.Image { height = 1; width = 2; colorspace = 3; encoded = 4 }
    img = (_pb_int64(1, height) + _pb_int64(2, width) + _pb_int64(3, 4)
           + _pb_bytes(4, png))
    # Summary { value = 1 { tag = 1; image = 4 } }
    return _pb_bytes(1, _pb_string(1, tag) + _pb_bytes(4, img))


def _event(summary: Optional[bytes] = None, step: int = 0,
           file_version: Optional[str] = None) -> bytes:
    # Event { wall_time = 1 (double); step = 2; file_version = 3; summary = 5 }
    out = _pb_double(1, time.time()) + _pb_int64(2, step)
    if file_version is not None:
        out += _pb_string(3, file_version)
    if summary is not None:
        out += _pb_bytes(5, summary)
    return out


class SummaryWriter:
    """``tpugraph``'s writer: ``events.out.tfevents.<unix s>.tpugraph``
    under ``logdir``, opened with a ``brain.Event:2`` version record."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.tpugraph"
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "wb")
        self._write_record(_event(file_version="brain.Event:2"))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", masked_crc(data)))

    def add_scalar(self, tag: str, value, step: int = 0) -> None:
        self._write_record(_event(_scalar_summary(tag, float(value)), step))

    def add_scalars(self, main_tag: str, scalars: Dict, step: int = 0) -> None:
        for k, v in scalars.items():
            self.add_scalar(f"{main_tag}/{k}", v, step)

    def add_image_png(self, tag: str, png: bytes, height: int, width: int,
                      step: int = 0) -> None:
        self._write_record(_event(_image_summary(tag, png, height, width), step))

    def add_figure(self, tag: str, record: Dict, step: int = 0) -> None:
        """A figure record drawn to PNG, as an image summary."""
        from tpugraph_torch.viz.writers import render_png

        png, (width, height) = render_png(record)
        self.add_image_png(tag, png, height, width, step)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def read_records(path: str):
    """The records of an event file, each checked against its two masked
    CRCs (``ValueError`` on a mismatch or a truncated record)."""
    with open(path, "rb") as f:
        data = f.read()
    out, i = [], 0
    while i < len(data):
        if i + 12 > len(data):
            raise ValueError(f"{path}: truncated record header at byte {i}")
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[i + 8:i + 12])
        if hcrc != masked_crc(header):
            raise ValueError(f"{path}: bad header CRC at byte {i}")
        body = data[i + 12:i + 12 + n]
        if len(body) != n or i + 16 + n > len(data):
            raise ValueError(f"{path}: truncated record at byte {i}")
        (bcrc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if bcrc != masked_crc(body):
            raise ValueError(f"{path}: bad data CRC at byte {i}")
        out.append(body)
        i += 16 + n
    return out


def _fields(buf: bytes):
    """(field, wire type, value) of one protobuf message, top level only."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, v


def _read_varint(buf: bytes, i: int):
    shift = out = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return out, i


def read_scalars(path: str) -> Dict[str, list]:
    """``{tag: [(step, value), ...]}`` of the scalar summaries of an event
    file (its CRCs checked), in file order."""
    out: Dict[str, list] = {}
    for rec in read_records(path):
        step, summary = 0, None
        for field, _, v in _fields(rec):
            if field == 2:
                step = v
            elif field == 5:
                summary = v
        if summary is None:
            continue
        for _, _, value in _fields(summary):
            tag, simple = None, None
            for f, _, v in _fields(value):
                if f == 1:
                    tag = v.decode("utf-8")
                elif f == 2:
                    (simple,) = struct.unpack("<f", v)
            if tag is not None and simple is not None:
                out.setdefault(tag, []).append((step, simple))
    return out
