"""The port's TensorBoard event writer against ``tpugraph``'s: the same
bytes for the same scalars, images and pinned wall time, every record's
masked CRC-32C checked by a reader written here, and ``add_figure`` on a
figure record."""

import os
import struct
import time

import numpy as np
import pytest
import torch

from tpugraph.utils import tb_writer as jax_tb
from tpugraph_torch.utils import tb_writer as tb
from tpugraph_torch.viz.graphs import pr_curve_record

torch.set_num_threads(1)


def _crc32c_bitwise(data: bytes) -> int:
    """CRC-32C one bit at a time (no table), to check the port's."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
    return crc ^ 0xFFFFFFFF


def _masked(data: bytes) -> int:
    c = _crc32c_bitwise(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def read_event_file(path):
    """Every record of a TFRecord file, each length and payload held to its
    masked CRC-32C."""
    with open(path, "rb") as f:
        data = f.read()
    out, i = [], 0
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[i + 8:i + 12])[0] == _masked(header)
        body = data[i + 12:i + 12 + n]
        assert len(body) == n
        assert struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0] == _masked(body)
        out.append(body)
        i += 16 + n
    assert i == len(data)
    return out


def _write(module, logdir, png):
    w = module.SummaryWriter(logdir)
    for step in (0, 1, 25, 1000, 2 ** 40):
        w.add_scalar("loss/avg_loss", 1.0 / (step + 3), step=step)
        w.add_scalar("acc/train_acc", np.float32(0.25 * (step % 4)), step=step)
    w.add_scalars("acc", {"train": 0.9, "test": -0.8, "weird tag/é": 1e30}, step=7)
    w.add_image_png("mask/adj", png, 3, 5, step=2)
    w.close()
    (name,) = os.listdir(logdir)
    return name


def test_crc32c_known_value():
    assert tb.crc32c(b"123456789") == 0xE3069283 == _crc32c_bitwise(b"123456789")
    assert tb.masked_crc(b"") == _masked(b"")


def test_event_files_byte_identical(tmp_path, monkeypatch):
    """Pinned wall time: the same file name and the same bytes."""
    monkeypatch.setattr(time, "time", lambda: 1760000000.25)
    png = bytes(range(256)) * 3
    a = _write(jax_tb, str(tmp_path / "jax"), png)
    b = _write(tb, str(tmp_path / "port"), png)
    assert a == b == "events.out.tfevents.1760000000.tpugraph"
    ja = (tmp_path / "jax" / a).read_bytes()
    pb = (tmp_path / "port" / b).read_bytes()
    assert ja == pb
    recs = read_event_file(str(tmp_path / "port" / b))
    assert len(recs) == 1 + 10 + 3 + 1
    assert tb.read_records(str(tmp_path / "port" / b)) == recs


def test_scalars_read_back(tmp_path):
    w = tb.SummaryWriter(str(tmp_path))
    for i in range(4):
        w.add_scalar("loss", 1.0 / (i + 1), step=i)
    w.add_scalars("acc", {"train": 0.9, "test": 0.8}, step=0)
    w.close()
    got = tb.read_scalars(w.path)
    assert sorted(got) == ["acc/test", "acc/train", "loss"]
    assert [s for s, _ in got["loss"]] == [0, 1, 2, 3]
    np.testing.assert_allclose([v for _, v in got["loss"]], [1, 0.5, 1 / 3, 0.25],
                               rtol=1e-6)


def test_reader_rejects_a_flipped_byte(tmp_path):
    w = tb.SummaryWriter(str(tmp_path))
    w.add_scalar("loss", 0.5, step=1)
    w.close()
    data = bytearray(open(w.path, "rb").read())
    data[-6] ^= 1
    open(w.path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        tb.read_records(w.path)


def test_add_figure_writes_a_png_record(tmp_path):
    """A figure record becomes an image summary whose PNG decodes to the
    record's pixel size."""
    import matplotlib.image

    rng = np.random.default_rng(0)
    rec = pr_curve_record((rng.random(50) < 0.4).astype(int), rng.random(50))
    w = tb.SummaryWriter(str(tmp_path))
    w.add_figure("pr", rec, step=3)
    w.close()
    recs = read_event_file(w.path)
    assert len(recs) == 2
    body = recs[1]
    start = body.index(b"\x89PNG")
    png = body[start:]
    path = tmp_path / "fig.png"
    path.write_bytes(png)
    img = matplotlib.image.imread(str(path))
    assert img.shape[:2] == (960, 1280)
