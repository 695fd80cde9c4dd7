"""PNG and PDF writers for the port's figure records
(:mod:`tpugraph_torch.viz.graphs`), with the standard library and numpy
only.

The PNG writer rasterises a record on a numpy canvas (figure size times
dpi pixels): images by nearest sampling into their axes box, segments and
polylines as round-capped strokes, markers and nodes as filled discs, all
alpha-blended in drawing order, and text in a fixed 5x7 bitmap font for
printable ASCII carried here; then ``zlib`` and ``struct`` frame it as an
8-bit RGB PNG.  The PDF writer emits one page (figure size in points)
with lines, filled circles as four Bezier curves, stroke and fill
colours, alpha through ``ExtGState`` objects, text in the base-14
Helvetica (no font file), and images as ``FlateDecode`` XObjects.
Neither draws as matplotlib does; both draw what the record holds.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

# 5x7 glyphs of ASCII 0x20-0x7e, five column bytes each, bit 0 the top row
_FONT = bytes.fromhex(
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12"
    "2313086462" "3649552250" "0005030000" "001c224100" "0041221c00"
    "082a1c2a08" "08083e0808" "0050300000" "0808080808" "0060600000"
    "2010080402" "3e5149453e" "00427f4000" "4261514946" "2141454b31"
    "1814127f10" "2745454539" "3c4a494930" "0171090503" "3649494936"
    "064949291e" "0036360000" "0056360000" "0814224100" "1414141414"
    "0041221408" "0201510906" "324979413e" "7e1111117e" "7f49494936"
    "3e41414122" "7f4141221c" "7f49494941" "7f09090101" "3e41415132"
    "7f0808087f" "00417f4100" "2040413f01" "7f08142241" "7f40404040"
    "7f0204027f" "7f0408107f" "3e4141413e" "7f09090906" "3e4151215e"
    "7f09192946" "4649494931" "01017f0101" "3f4040403f" "1f2040201f"
    "7f2018207f" "6314081463" "0304780403" "6151494543" "00007f4141"
    "0204081020" "41417f0000" "0402010204" "4040404040" "0001020400"
    "2054545478" "7f48444438" "3844444420" "384444487f" "3854545418"
    "087e090102" "081454543c" "7f08040478" "00447d4000" "2040443d00"
    "007f102844" "00417f4000" "7c04180478" "7c08040478" "3844444438"
    "7c14141408" "081414187c" "7c08040408" "4854545420" "043f444020"
    "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "0c5050503c"
    "4464544c44" "0008364100" "00007f0000" "0041360800" "08082a1c08")


def glyph(ch: str) -> np.ndarray:
    """The ``[7, 5]`` boolean bitmap of a printable ASCII character (a
    space for any other)."""
    code = ord(ch)
    k = code - 0x20 if 0x20 <= code <= 0x7E else 0
    cols = _FONT[5 * k:5 * k + 5]
    return np.array([[(c >> r) & 1 for c in cols] for r in range(7)], dtype=bool)


# ------------------------------------------------------------------ PNG


class Canvas:
    """An RGB float canvas, white, with alpha-blended stamps; y grows
    downward from the top row."""

    def __init__(self, width: int, height: int):
        self.w, self.h = width, height
        self.rgb = np.ones((height, width, 3), dtype=np.float32)

    def blend(self, mask: np.ndarray, x0: int, y0: int, rgba) -> None:
        """Blend ``rgba`` over the pixels ``mask`` covers, its top-left
        corner at pixel (x0, y0)."""
        h, w = mask.shape
        xa, ya = max(x0, 0), max(y0, 0)
        xb, yb = min(x0 + w, self.w), min(y0 + h, self.h)
        if xa >= xb or ya >= yb:
            return
        m = mask[ya - y0:yb - y0, xa - x0:xb - x0]
        a = float(rgba[3])
        region = self.rgb[ya:yb, xa:xb]
        region[m] = region[m] * (1 - a) + np.asarray(rgba[:3]) * a

    def disc(self, cx: float, cy: float, r: float, rgba) -> None:
        r = max(r, 0.5)
        x0, y0 = int(np.floor(cx - r)), int(np.floor(cy - r))
        n = int(np.ceil(2 * r)) + 2
        yy, xx = np.mgrid[0:n, 0:n]
        mask = (xx + x0 + 0.5 - cx) ** 2 + (yy + y0 + 0.5 - cy) ** 2 <= r * r
        self.blend(mask, x0, y0, rgba)

    def stroke(self, pts: np.ndarray, width: float, rgba) -> None:
        """A polyline through ``pts`` ([K, 2] pixels), round-capped, one
        blend for the whole stroke."""
        pts = np.asarray(pts, dtype=np.float64)
        pts = pts[np.all(np.isfinite(pts), axis=1)]
        if len(pts) == 0:
            return
        r = max(width / 2, 0.5)
        samples = [pts[:1]]
        for a, b in zip(pts[:-1], pts[1:]):
            k = max(int(np.ceil(np.hypot(*(b - a)) * 2)), 1)
            t = np.linspace(0, 1, k + 1)[1:, None]
            samples.append(a + (b - a) * t)
        s = np.concatenate(samples)
        x0 = int(np.floor(s[:, 0].min() - r)) - 1
        y0 = int(np.floor(s[:, 1].min() - r)) - 1
        x1 = int(np.ceil(s[:, 0].max() + r)) + 2
        y1 = int(np.ceil(s[:, 1].max() + r)) + 2
        x0, y0 = max(x0, -1), max(y0, -1)
        x1, y1 = min(x1, self.w + 1), min(y1, self.h + 1)
        if x1 <= x0 or y1 <= y0:
            return
        mask = np.zeros((y1 - y0, x1 - x0), dtype=bool)
        n = int(np.ceil(r))
        offs = [(dx, dy) for dx in range(-n, n + 1) for dy in range(-n, n + 1)
                if dx * dx + dy * dy <= r * r + 0.25]
        ix = np.floor(s[:, 0]).astype(int) - x0
        iy = np.floor(s[:, 1]).astype(int) - y0
        for dx, dy in offs:
            xs, ys = ix + dx, iy + dy
            ok = (xs >= 0) & (xs < mask.shape[1]) & (ys >= 0) & (ys < mask.shape[0])
            mask[ys[ok], xs[ok]] = True
        self.blend(mask, x0, y0, rgba)

    def rect(self, x0, y0, x1, y1, rgba) -> None:
        xa, xb = int(round(min(x0, x1))), int(round(max(x0, x1)))
        ya, yb = int(round(min(y0, y1))), int(round(max(y0, y1)))
        self.blend(np.ones((max(yb - ya, 1), max(xb - xa, 1)), dtype=bool),
                   xa, ya, rgba)

    def image(self, rgba: np.ndarray, x0, y0, x1, y1) -> None:
        """An ``[H, W, 4]`` image stretched over the box by nearest
        sampling."""
        xa, xb = int(round(x0)), int(round(x1))
        ya, yb = int(round(y0)), int(round(y1))
        if xb <= xa or yb <= ya:
            return
        h, w = rgba.shape[:2]
        rows = np.minimum(((np.arange(ya, yb) - ya + 0.5) * h / (yb - ya)).astype(int),
                          h - 1)
        cols = np.minimum(((np.arange(xa, xb) - xa + 0.5) * w / (xb - xa)).astype(int),
                          w - 1)
        px = rgba[rows][:, cols]
        cy = slice(max(ya, 0), min(yb, self.h))
        cx = slice(max(xa, 0), min(xb, self.w))
        px = px[cy.start - ya:cy.stop - ya, cx.start - xa:cx.stop - xa]
        a = px[..., 3:4]
        if np.all(a == 1):
            self.rgb[cy, cx] = px[..., :3]
        else:
            self.rgb[cy, cx] = self.rgb[cy, cx] * (1 - a) + px[..., :3] * a

    def text(self, s: str, x: float, y: float, size_px: float,
             anchor: str = "left", vertical: bool = False) -> None:
        """``s`` in black in the bitmap font, ``size_px`` tall, its
        baseline's left end, centre or right end (``anchor``) at (x, y);
        rotated a quarter turn with ``vertical``."""
        rgba = (0.0, 0.0, 0.0, 1.0)
        scale = max(int(round(size_px / 8)), 1)
        width = 6 * scale * len(s)
        bitmap = np.zeros((7 * scale, max(width, 1)), dtype=bool)
        for i, ch in enumerate(s):
            g = np.kron(glyph(ch), np.ones((scale, scale), dtype=bool))
            bitmap[:, 6 * scale * i:6 * scale * i + 5 * scale] = g
        shift = {"left": 0, "center": width / 2, "right": width}[anchor]
        if vertical:
            bitmap = np.rot90(bitmap)
            self.blend(bitmap, int(round(x - 7 * scale)), int(round(y - width + shift)),
                       rgba)
        else:
            self.blend(bitmap, int(round(x - shift)), int(round(y - 7 * scale)), rgba)

    def png(self) -> bytes:
        return encode_png((np.clip(self.rgb, 0, 1) * 255 + 0.5).astype(np.uint8))


def encode_png(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB ``[H, W, 3]`` array as PNG bytes (one IDAT, filter 0)."""
    h, w, _ = rgb.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def figure_pixels(record: Dict) -> Tuple[int, int]:
    """The record's size in pixels: figure inches times dpi, rounded."""
    w, h = record["figsize"]
    return int(round(w * record["dpi"])), int(round(h * record["dpi"]))


class _Frame:
    """An axes' box on the page and its data-to-box mapping; ``flip``
    puts y = 0 at the top (pixels) rather than the bottom (points)."""

    def __init__(self, ax: Dict, width: float, height: float, flip: bool):
        l, b, w, h = ax["rect"]
        self.x0, self.x1 = l * width, (l + w) * width
        self.ya, self.yb = b * height, (b + h) * height  # from the bottom
        self.height, self.flip = height, flip
        self.xlim = ax["xlim"] or (0.0, 1.0)
        self.ylim = ax["ylim"] or (0.0, 1.0)
        if ax.get("aspect") == "equal":  # square data units, centred
            sx = (self.x1 - self.x0) / abs(self.xlim[1] - self.xlim[0])
            sy = (self.yb - self.ya) / abs(self.ylim[1] - self.ylim[0])
            s = min(sx, sy)
            cx, cy = (self.x0 + self.x1) / 2, (self.ya + self.yb) / 2
            hw = s * abs(self.xlim[1] - self.xlim[0]) / 2
            hh = s * abs(self.ylim[1] - self.ylim[0]) / 2
            self.x0, self.x1, self.ya, self.yb = cx - hw, cx + hw, cy - hh, cy + hh

    def y(self, v):
        return self.height - v if self.flip else v

    def map(self, xy) -> np.ndarray:
        xy = np.asarray(xy, dtype=np.float64).reshape(-1, 2)
        (a, b), (c, d) = self.xlim, self.ylim
        x = self.x0 + (xy[:, 0] - a) / ((b - a) or 1.0) * (self.x1 - self.x0)
        y = self.ya + (xy[:, 1] - c) / ((d - c) or 1.0) * (self.yb - self.ya)
        return np.stack([x, self.y(y)], axis=1)

    def box(self):
        """(left, top, right, bottom) in output coordinates."""
        return self.x0, self.y(self.yb), self.x1, self.y(self.ya)


def _colorbar_rgba(cb: Dict, n: int = 256) -> np.ndarray:
    from tpugraph_torch.viz.graphs import apply_colormap

    v = np.linspace(cb["vmax"], cb["vmin"], n)[:, None]
    return apply_colormap(cb["cmap"], v, cb["vmin"], cb["vmax"])


def render_png(record: Dict) -> Tuple[bytes, Tuple[int, int]]:
    """A figure record drawn to PNG; returns the bytes and (width,
    height)."""
    width, height = figure_pixels(record)
    cv = Canvas(width, height)
    pt = record["dpi"] / 72.0  # pixels a point
    font = 10 * pt
    for ax in record["axes"]:
        fr = _Frame(ax, width, height, flip=True)
        left, top, right, bottom = fr.box()
        for img in ax["images"]:
            cv.image(img["rgba"], left, top, right, bottom)
        if ax["segments"] is not None:
            sg = ax["segments"]
            for seg, col in zip(sg["xy"], sg["colors"]):
                cv.stroke(fr.map(seg), sg["width"] * pt, col)
        for ln in ax["lines"]:
            pts = fr.map(np.stack([ln["x"], ln["y"]], axis=1))
            if ln["style"]:
                cv.stroke(pts, ln["width"] * pt, ln["color"])
            if ln["marker"]:
                for x, y in pts:
                    cv.disc(x, y, ln["markersize"] * pt / 2, ln["color"])
        if ax["points"] is not None:
            p = ax["points"]
            r = np.sqrt(p["size"]) * pt / 2
            for (x, y), col in zip(fr.map(p["xy"]), p["colors"]):
                cv.disc(x, y, r, col)
        for t in ax["texts"]:
            (x, y), = fr.map([[t["x"], t["y"]]])
            cv.text(t["s"], x, y + t["size"] * pt / 2, t["size"] * pt, anchor="center")
        if not ax["axis_off"]:
            for x0, y0, x1, y1 in ((left, top, right, top), (left, bottom, right, bottom),
                                   (left, top, left, bottom), (right, top, right, bottom)):
                cv.stroke(np.array([[x0, y0], [x1, y1]]), 0.8 * pt, (0, 0, 0, 1))
            for v, (x, y) in ((ax["xlim"][0], (left, bottom + 1.4 * font)),
                              (ax["xlim"][1], (right, bottom + 1.4 * font))):
                cv.text(f"{v:.3g}", x, y, font, anchor="center")
            cv.text(f"{ax['ylim'][0]:.3g}", left - 0.4 * font, bottom, font, anchor="right")
            cv.text(f"{ax['ylim'][1]:.3g}", left - 0.4 * font, top + font, font,
                    anchor="right")
        if ax["title"]:
            cv.text(ax["title"], (left + right) / 2, top - 0.6 * font, 1.2 * font,
                    anchor="center")
        if ax["xlabel"]:
            cv.text(ax["xlabel"], (left + right) / 2, bottom + 3.0 * font, font,
                    anchor="center")
        if ax["ylabel"]:
            cv.text(ax["ylabel"], left - 3.5 * font, (top + bottom) / 2, font,
                    anchor="center", vertical=True)
        if ax["legend"]:
            y = top + 1.6 * font
            for ln in ax["lines"]:
                x = right - 8 * font
                if ln["style"]:
                    cv.stroke(np.array([[x, y - 0.4 * font], [x + 2 * font, y - 0.4 * font]]),
                              ln["width"] * pt, ln["color"])
                else:
                    cv.disc(x + font, y - 0.4 * font, ln["markersize"] * pt / 2, ln["color"])
                cv.text(ln["label"] or "", x + 2.6 * font, y, font)
                y += 1.5 * font
        if ax["colorbar"] is not None:
            cb = ax["colorbar"]
            x0 = right + 0.03 * width
            cv.image(_colorbar_rgba(cb), x0, top, x0 + 0.03 * width, bottom)
            cv.text(f"{cb['vmax']:.3g}", x0 + 0.035 * width, top + font, font)
            cv.text(f"{cb['vmin']:.3g}", x0 + 0.035 * width, bottom, font)
    return cv.png(), (width, height)


# ------------------------------------------------------------------ PDF

_K = 0.5522847498  # the Bezier handle length of a quarter circle


def _num(v: float) -> str:
    s = f"{v:.4f}".rstrip("0").rstrip(".")
    return "0" if s in ("", "-0") else s


def _pdf_text(s: str) -> str:
    return "(" + s.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)") + ")"


class _PdfPage:
    """One page's content stream, with its alpha states and images."""

    def __init__(self):
        self.ops: List[str] = []
        self.alphas: Dict[Tuple[str, float], str] = {}
        self.images: List[Tuple[str, np.ndarray]] = []

    def alpha(self, kind: str, a: float) -> None:
        key = (kind, round(float(a), 4))
        if key not in self.alphas:
            self.alphas[key] = f"GS{len(self.alphas)}"
        self.ops.append(f"/{self.alphas[key]} gs")

    def line(self, pts: np.ndarray, width: float, rgba) -> None:
        self.alpha("CA", rgba[3])
        r, g, b = (_num(c) for c in rgba[:3])
        path = " ".join(f"{_num(x)} {_num(y)} {'m' if i == 0 else 'l'}"
                        for i, (x, y) in enumerate(pts))
        self.ops.append(f"{r} {g} {b} RG {_num(width)} w 1 J 1 j {path} S")

    def circle(self, cx: float, cy: float, rad: float, rgba) -> None:
        self.alpha("ca", rgba[3])
        r, g, b = (_num(c) for c in rgba[:3])
        k = _K * rad
        p = [f"{_num(cx + rad)} {_num(cy)} m"]
        for (x1, y1, x2, y2, x3, y3) in (
                (cx + rad, cy + k, cx + k, cy + rad, cx, cy + rad),
                (cx - k, cy + rad, cx - rad, cy + k, cx - rad, cy),
                (cx - rad, cy - k, cx - k, cy - rad, cx, cy - rad),
                (cx + k, cy - rad, cx + rad, cy - k, cx + rad, cy)):
            p.append(" ".join(_num(v) for v in (x1, y1, x2, y2, x3, y3)) + " c")
        self.ops.append(f"{r} {g} {b} rg {' '.join(p)} f")

    def text(self, s: str, x: float, y: float, size: float) -> None:
        self.alpha("ca", 1.0)
        self.ops.append(f"0 0 0 rg BT /F1 {_num(size)} Tf {_num(x)} {_num(y)} Td "
                        f"{_pdf_text(s)} Tj ET")

    def image(self, rgba: np.ndarray, x0, y0, x1, y1) -> None:
        name = f"Im{len(self.images)}"
        rgb = (np.clip(rgba[..., :3], 0, 1) * 255 + 0.5).astype(np.uint8)
        self.images.append((name, rgb))
        self.alpha("ca", 1.0)
        self.ops.append(f"q {_num(x1 - x0)} 0 0 {_num(y1 - y0)} {_num(x0)} {_num(y0)} "
                        f"cm /{name} Do Q")


def render_pdf(record: Dict) -> bytes:
    """A figure record drawn to a one-page PDF."""
    width, height = (72.0 * v for v in record["figsize"])
    page = _PdfPage()
    for ax in record["axes"]:
        fr = _Frame(ax, width, height, flip=False)
        left, top, right, bottom = fr.box()
        for img in ax["images"]:
            page.image(img["rgba"], left, bottom, right, top)
        if ax["segments"] is not None:
            sg = ax["segments"]
            for seg, col in zip(sg["xy"], sg["colors"]):
                page.line(fr.map(seg), sg["width"], col)
        for ln in ax["lines"]:
            pts = fr.map(np.stack([ln["x"], ln["y"]], axis=1))
            if ln["style"]:
                page.line(pts, ln["width"], ln["color"])
            if ln["marker"]:
                for x, y in pts:
                    page.circle(x, y, ln["markersize"] / 2, ln["color"])
        if ax["points"] is not None:
            p = ax["points"]
            for (x, y), col in zip(fr.map(p["xy"]), p["colors"]):
                page.circle(x, y, np.sqrt(p["size"]) / 2, col)
        for t in ax["texts"]:
            (x, y), = fr.map([[t["x"], t["y"]]])
            page.text(t["s"], x, y, t["size"])
        if not ax["axis_off"]:
            page.line(np.array([[left, bottom], [right, bottom], [right, top],
                                [left, top], [left, bottom]]), 0.8, (0, 0, 0, 1))
        for key, dy in (("title", 6.0), ("xlabel", -28.0)):
            if ax[key]:
                page.text(ax[key], (left + right) / 2, (top if key == "title" else bottom)
                          + dy, 12 if key == "title" else 10)
        if ax["ylabel"]:
            page.text(ax["ylabel"], left - 40, (top + bottom) / 2, 10)
        if ax["colorbar"] is not None:
            x0 = right + 0.03 * width
            page.image(_colorbar_rgba(ax["colorbar"]), x0, bottom, x0 + 0.03 * width, top)
    return _pdf_file(page, width, height)


def _pdf_file(page: _PdfPage, width: float, height: float) -> bytes:
    content = "\n".join(page.ops).encode("latin-1", "replace")
    gs = " ".join(f"/{name} << /Type /ExtGState /{kind} {_num(a)} >>"
                  for (kind, a), name in page.alphas.items())
    n_fixed = 5
    xobj = " ".join(f"/{name} {n_fixed + 1 + i} 0 R"
                    for i, (name, _) in enumerate(page.images))
    objs = [
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        (f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {_num(width)} {_num(height)}] "
         f"/Contents 4 0 R /Resources << /Font << /F1 5 0 R >> /ExtGState << {gs} >> "
         f"/XObject << {xobj} >> >> >>").encode(),
        b"<< /Length %d >>\nstream\n" % len(content) + content + b"\nendstream",
        b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>",
    ]
    for _, rgb in page.images:
        data = zlib.compress(rgb.tobytes())
        objs.append(b"<< /Type /XObject /Subtype /Image /Width %d /Height %d "
                    b"/ColorSpace /DeviceRGB /BitsPerComponent 8 /Filter /FlateDecode "
                    b"/Length %d >>\nstream\n" % (rgb.shape[1], rgb.shape[0], len(data))
                    + data + b"\nendstream")
    out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
    offsets = []
    for i, body in enumerate(objs, start=1):
        offsets.append(len(out))
        out += b"%d 0 obj\n" % i + body + b"\nendobj\n"
    xref = len(out)
    out += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objs) + 1)
    for off in offsets:
        out += b"%010d 00000 n \n" % off
    out += (b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n"
            % (len(objs) + 1, xref))
    return bytes(out)


def write_figure(record: Dict, path: str) -> None:
    """Draw a record to ``path`` in its format (``png`` or ``pdf``)."""
    data = render_pdf(record) if record["format"] == "pdf" else render_png(record)[0]
    with open(path, "wb") as f:
        f.write(data)


def check_png(path: str) -> Tuple[int, int]:
    """(width, height) of a PNG file whose signature and IHDR chunk (with
    its CRC) are sound; ``ValueError`` otherwise."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG")
    (crc,) = struct.unpack(">I", head[29:33])
    if zlib.crc32(head[12:29]) & 0xFFFFFFFF != crc:
        raise ValueError(f"{path}: bad IHDR CRC")
    return struct.unpack(">II", head[16:24])


def check_pdf(path: str) -> int:
    """The object count of a PDF file with a header, an xref table and
    ``%%EOF``; ``ValueError`` otherwise."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"%PDF-") or b"xref" not in data or \
            not data.rstrip().endswith(b"%%EOF"):
        raise ValueError(f"{path}: not a whole PDF")
    return data.count(b" 0 obj")
