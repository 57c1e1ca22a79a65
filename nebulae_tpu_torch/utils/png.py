"""PNG codec on the standard library (zlib, struct) and numpy.

`read_png` decodes 8-bit, non-interlaced PNG of colour types 0 (gray),
2 (RGB), 3 (palette), 4 (gray + alpha) and 6 (RGBA), with `tRNS`, through
all five row filters, into what `PIL.Image.open(f).convert("RGBA")` gives:
[H, W, 4] uint8.  `covers` says whether a PNG's header is one of these.
`write_png` encodes [H, W, 3] (RGB) or [H, W, 4] (RGBA) uint8 images;
`encode_png` returns the bytes.

Rows filtered by Sub, Up or None decode one row at a time in numpy.  Average
and Paeth predict each byte from its left neighbour, so an image that uses
them is reconstructed along anti-diagonals of pixels: pixel (y, x) needs
(y, x-1), (y-1, x) and (y-1, x-1), all on earlier diagonals, and the rows
are sheared so that each diagonal is one column of contiguous slices.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Samples per pixel by colour type.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    """(type, payload) of each chunk after the signature, CRCs checked."""
    off = len(SIGNATURE)
    while off + 8 <= len(data):
        length, ctype = struct.unpack_from(">I4s", data, off)
        payload = data[off + 8: off + 8 + length]
        (crc,) = struct.unpack_from(">I", data, off + 8 + length)
        if zlib.crc32(ctype + payload) != crc:
            raise ValueError(f"PNG chunk {ctype!r}: CRC mismatch")
        yield ctype, payload
        off += 12 + length
        if ctype == b"IEND":
            return
    raise ValueError("PNG ends before its IEND chunk")


def header(data: bytes) -> dict | None:
    """The IHDR fields of a PNG stream, or None if `data` is not a PNG."""
    if data[:8] != SIGNATURE or data[12:16] != b"IHDR":
        return None
    w, h, depth, ctype, comp, filt, interlace = struct.unpack_from(">IIBBBBB", data, 16)
    return {"width": w, "height": h, "bit_depth": depth, "color_type": ctype,
            "compression": comp, "filter": filt, "interlace": interlace}


def covers(data: bytes) -> bool:
    """True for an 8-bit, non-interlaced PNG of colour type 0, 2, 3, 4 or 6."""
    hd = header(data)
    return (hd is not None and hd["bit_depth"] == 8 and hd["interlace"] == 0
            and hd["color_type"] in _CHANNELS)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(filt: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Rows filtered only by None, Sub or Up: one row at a time."""
    h, n = rows.shape
    out = np.empty((h, n), np.uint8)
    prev = np.zeros(n, np.uint8)
    for y in range(h):
        r, f = rows[y], filt[y]
        if f == 1:
            r = np.cumsum(r.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif f == 2:
            r = r + prev
        out[y] = r
        prev = out[y]
    return out


def _unfilter_diagonal(filt: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Any mix of the five filters, one anti-diagonal of pixels at a time.

    Row y is stored from column y of a sheared [h + 1, w + h + 1, bpp]
    buffer (row 0 and column 0 stay zero: the bytes left of and above the
    image), so pixel (y, x) sits at [y + 1, x + y + 1] and its left, upper
    and upper-left neighbours at [y + 1, d], [y, d] and [y, d - 1] of the
    previous columns, d = x + y."""
    h, n = rows.shape
    w = n // bpp
    f_px = rows.reshape(h, w, bpp).astype(np.int16)
    sheared = np.zeros((h + 1, w + h + 1, bpp), np.int16)
    f_sh = np.zeros((h, w + h, bpp), np.int16)
    ys = np.arange(h)[:, None]
    f_sh[ys, ys + np.arange(w)[None, :]] = f_px
    ft = filt.astype(np.int16)[:, None]
    for d in range(w + h - 1):
        y0, y1 = max(0, d - w + 1), min(h - 1, d)
        a = sheared[y0 + 1: y1 + 2, d]
        b = sheared[y0: y1 + 1, d]
        c = sheared[y0: y1 + 1, d - 1] if d else np.zeros_like(b)
        t = ft[y0: y1 + 1]
        pred = np.where(t == 1, a, np.where(t == 2, b, np.where(t == 3, (a + b) >> 1,
                                                                 np.where(t == 4, _paeth(a, b, c), 0))))
        sheared[y0 + 1: y1 + 2, d + 1] = (f_sh[y0: y1 + 1, d] + pred) & 255
    out = sheared[1 + ys, 1 + ys + np.arange(w)[None, :]]
    return out.astype(np.uint8).reshape(h, n)


def _to_rgba(px: np.ndarray, ctype: int, palette: np.ndarray | None, trns: bytes | None) -> np.ndarray:
    """Decoded samples [H, W, C] -> RGBA as PIL's convert("RGBA")."""
    h, w = px.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        table[: palette.shape[0], :3] = palette
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            table[: alpha.shape[0], 3] = alpha
        return table[px[..., 0]]
    if ctype in (0, 4):
        out[..., :3] = px[..., :1]
    else:
        out[..., :3] = px[..., :3]
    if ctype in (4, 6):
        out[..., 3] = px[..., -1]
        return out
    out[..., 3] = 255
    if trns is not None:
        if ctype == 0:
            (key,) = struct.unpack(">H", trns[:2])
            out[..., 3][px[..., 0] == key] = 0
        else:
            key = np.asarray(struct.unpack(">HHH", trns[:6]))
            out[..., 3][(px[..., :3] == key).all(-1)] = 0
    return out


def read_png(src) -> np.ndarray:
    """Decode a PNG (a path or bytes) that `covers` accepts -> [H, W, 4]
    uint8 RGBA, equal to PIL's convert("RGBA")."""
    data = src if isinstance(src, (bytes, bytearray, memoryview)) else Path(src).read_bytes()
    data = bytes(data)
    hd = header(data)
    if hd is None:
        raise ValueError("not a PNG stream")
    if not covers(data):
        raise ValueError(f"PNG not covered by this reader (bit depth {hd['bit_depth']}, colour type "
                         f"{hd['color_type']}, interlace {hd['interlace']})")
    w, h, ctype = hd["width"], hd["height"], hd["color_type"]
    palette = trns = None
    idat = []
    for ctype_, payload in _chunks(data):
        if ctype_ == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype_ == b"tRNS":
            trns = payload
        elif ctype_ == b"IDAT":
            idat.append(payload)
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.shape[0] < h * (stride + 1):
        raise ValueError(f"PNG image data holds {raw.shape[0]} bytes, expected {h * (stride + 1)}")
    raw = raw[: h * (stride + 1)].reshape(h, stride + 1)
    filt, rows = raw[:, 0], raw[:, 1:]
    if int(filt.max(initial=0)) > 4:
        raise ValueError(f"PNG row filter {int(filt.max())} is not one of 0-4")
    if bool((filt >= 3).any()):
        px = _unfilter_diagonal(filt, rows, bpp)
    else:
        px = _unfilter_rows(filt, rows, bpp)
    return _to_rgba(px.reshape(h, w, bpp), ctype, palette, trns)


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + ctype + payload + struct.pack(">I", zlib.crc32(ctype + payload))


def _deflate(data: bytes) -> bytes:
    # The run-length strategy: on 1080p frames about twice as fast as the
    # default strategy at level 1, and smaller.
    z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_RLE)
    return z.compress(data) + z.flush()


def encode_png(img: np.ndarray) -> bytes:
    """[H, W, 3] or [H, W, 4] uint8 -> PNG bytes (8-bit RGB or RGBA, every
    row filtered by Up)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"encode_png takes [H, W, 3|4] uint8, got {img.dtype} {img.shape}")
    h, w, c = img.shape
    rows = img.reshape(h, w * c)
    filtered = np.empty((h, w * c + 1), np.uint8)
    filtered[:, 0] = 2
    filtered[:, 1:] = rows
    filtered[1:, 1:] -= rows[:-1]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", _deflate(filtered.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path, img: np.ndarray) -> None:
    """Write `img` ([H, W, 3|4] uint8) as a PNG file."""
    Path(path).write_bytes(encode_png(img))
