"""Minimal 8-bit RGB PNG writer and reader on the standard library's zlib.

The GPU image has no PIL, so the offline renderer writes its PNGs here and
the smoke test decodes the reference renders in ``examples/`` here.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + kind + data
        + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    )


def write_png(path: str, img: np.ndarray) -> None:
    """Write u8 ``img[H, W, 3]`` (row 0 at the top) as a PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] u8, got {img.shape}")
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))  # filter 0
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(
            _SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b"")
        )


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced RGB or RGBA PNG -> u8 ``[H, W, 3]``."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG")
    off, idat, hdr = 8, [], None
    while off < len(data):
        (n,) = struct.unpack(">I", data[off : off + 4])
        kind = data[off + 4 : off + 8]
        body = data[off + 8 : off + 8 + n]
        off += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if depth != 8 or ctype not in (2, 6) or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced RGB/RGBA is supported")
    bpp = 3 if ctype == 2 else 4
    raw = zlib.decompress(b"".join(idat))
    stride = w * bpp
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        base = y * (stride + 1)
        ftype = raw[base]
        line = np.frombuffer(raw, np.uint8, stride, base + 1).astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):
            # Left-dependent filters run pixel by pixel.
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:
                    pred = _paeth(a, b, c)
                cur[i] = (line[i] + pred) & 0xFF
        else:
            raise ValueError(f"{path}: bad filter type {ftype} on row {y}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, bpp)[:, :, :3]
