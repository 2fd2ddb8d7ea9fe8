"""Binary wire protocol, byte for byte the reference's.

The port's own copy of ``raytracer_tpu/server/wire.py``. ``pack_row`` and
``pack_rows_batched`` pack with the native library (``utils/native.py``),
as the JAX package's do; ``pack_row_plain`` and ``pack_rows_batched_plain``
are their plain Python versions.
Outgoing pixel message layout (src/server.rs:173-190, as the web client
reads it at test-client/app.tsx:54-60):

    [0]      message type, u8          (0 = RenderedPixels)
    [1]      number of pixels N, u8    (<= 60 per message)
    [2..4]   x, u16 little-endian      (start column)
    [4..6]   y, u16 little-endian      (row label: 0 = top of image)
    [6..]    N * 3 bytes RGB u8        (gamma-corrected)

Incoming control messages are JSON text (src/server.rs:121-126):
``{"type": "render", "scene": "...", "spp": N}`` and
``{"type": "stop_rendering"}``.
"""

from __future__ import annotations

import struct

import numpy as np

MSG_RENDERED_PIXELS = 0
PIXELS_PER_MSG = 60  # reference: src/server.rs:145

_HEADER = struct.Struct("<BBHH")


def pack_chunk(x: int, y: int, rgb: np.ndarray) -> bytes:
    """One RenderedPixels message for pixels [x, x+n) of row label y."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    n = rgb.shape[0]
    if n > 255 or rgb.shape[1] != 3:
        raise ValueError(f"a chunk holds at most 255 RGB pixels, not {rgb.shape}")
    return _HEADER.pack(MSG_RENDERED_PIXELS, n, x, y) + rgb.tobytes()


def pack_row_plain(y: int, rgb_row: np.ndarray, pixels_per_msg: int = PIXELS_PER_MSG) -> list[bytes]:
    """Split one image row (label y) into 60-pixel messages, like the
    reference's windows() iterator (src/server.rs:169,:254-280)."""
    w = rgb_row.shape[0]
    return [
        pack_chunk(x, y, rgb_row[x : min(x + pixels_per_msg, w)])
        for x in range(0, w, pixels_per_msg)
    ]


def pack_rows_batched_plain(
    y_top_label: int, rgb: np.ndarray, pixels_per_msg: int = PIXELS_PER_MSG
) -> bytes:
    """The standard chunks of several rows concatenated into one buffer (the
    opt-in batched transport). ``rgb`` is [rows, W, 3] in render-space row
    order; row i carries wire label ``y_top_label - i``."""
    return b"".join(
        b"".join(pack_row_plain(y_top_label - i, rgb[i], pixels_per_msg)) for i in range(rgb.shape[0])
    )


def pack_row(y: int, rgb_row: np.ndarray, pixels_per_msg: int = PIXELS_PER_MSG) -> list[bytes]:
    """``pack_row_plain`` by the native packer."""
    from raytracer_tpu_torch.utils import native

    return native.pack_row(y, rgb_row, pixels_per_msg)


def pack_rows_batched(
    y_top_label: int, rgb: np.ndarray, pixels_per_msg: int = PIXELS_PER_MSG
) -> bytes:
    """``pack_rows_batched_plain`` by the native packer, in one call."""
    from raytracer_tpu_torch.utils import native

    return native.pack_rows_blob(rgb, y_top_label - np.arange(rgb.shape[0]), pixels_per_msg)


def parse_chunk(msg: bytes) -> tuple[int, int, int, np.ndarray]:
    """Decode one RenderedPixels message -> (msg_type, x, y, rgb[n,3])."""
    msg_type, n, x, y = _HEADER.unpack_from(msg, 0)
    rgb = np.frombuffer(msg, np.uint8, count=3 * n, offset=_HEADER.size).reshape(n, 3)
    return msg_type, x, y, rgb


def parse_chunks(buf: bytes):
    """Yield (msg_type, x, y, rgb[n,3]) for every chunk of a buffer of
    concatenated chunks (a batched message, or one plain chunk)."""
    off = 0
    end = len(buf)
    while off + _HEADER.size <= end:
        msg_type, n, x, y = _HEADER.unpack_from(buf, off)
        off += _HEADER.size
        rgb = np.frombuffer(buf, np.uint8, count=3 * n, offset=off).reshape(n, 3)
        off += 3 * n
        yield msg_type, x, y, rgb
