"""Component-tuple 3-vector helpers on torch tensors.

Port of the ``*3`` helpers of ``raytracer_tpu/models/vecmath.py``: a vector
is a tuple ``(x, y, z)`` of same-shaped tensors (or of scalars, which
broadcast). The camera, the megakernel's plain twin and the regen engine's
shading core use them; ``as3``/``stack3`` convert [..., 3] tensors at the
boundaries.

Each helper is written as the same sequence of single float32 operations as
its JAX counterpart and as the CUDA kernel's inline functions, so the twin
and the kernel agree bit for bit on the card (the kernel is built with FMA
contraction off). ``normalize3`` therefore multiplies by ``1 / sqrt`` where
the JAX helper uses ``rsqrt``: CUDA's ``rsqrtf`` is not correctly rounded.
"""

from __future__ import annotations

import torch

V3 = tuple  # (x, y, z) of tensors or scalars


def as3(v) -> V3:
    """[..., 3] tensor (or already a tuple) -> component tuple."""
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v[..., 0], v[..., 1], v[..., 2])


def stack3(v: V3) -> torch.Tensor:
    """Component tuple -> [..., 3] tensor."""
    return torch.stack(tuple(v), dim=-1)


def dot3(a: V3, b: V3):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def add3(a: V3, b: V3) -> V3:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub3(a: V3, b: V3) -> V3:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul3(a: V3, b: V3) -> V3:
    """Hadamard product."""
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale3(a: V3, s) -> V3:
    return (a[0] * s, a[1] * s, a[2] * s)


def cross3(a: V3, b: V3) -> V3:
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def normalize3(v: V3, eps: float = 0.0) -> V3:
    """Unit vector; ``eps`` floors |v|^2 when nonzero."""
    n2 = dot3(v, v)
    if eps:
        n2 = torch.clamp_min(n2, eps)
    return scale3(v, torch.sqrt(n2).reciprocal())


def norm2_3(a: V3):
    return dot3(a, a)


def neg3(a: V3) -> V3:
    return (-a[0], -a[1], -a[2])


def reflect3(v: V3, n: V3) -> V3:
    """Mirror v across axis n: 2(v.n)n - v (the reference's flip_across)."""
    d2 = 2.0 * dot3(v, n)
    return (d2 * n[0] - v[0], d2 * n[1] - v[1], d2 * n[2] - v[2])


def local_frame3(n: V3) -> tuple[V3, V3, V3]:
    """Tangent frame (u, v, n): helper axis Y if |n.x| > 0.1 else X,
    u = helper x n normalized, v = n x u (the reference's
    create_local_coord)."""
    use_y = torch.abs(n[0]) > 0.1
    hx = torch.where(use_y, 0.0, 1.0)
    hy = torch.where(use_y, 1.0, 0.0)
    cx = hy * n[2]
    cy = -hx * n[2]
    cz = hx * n[1] - hy * n[0]
    inv = torch.sqrt(cx * cx + cy * cy + cz * cz).reciprocal()
    u = (cx * inv, cy * inv, cz * inv)
    return u, cross3(n, u), n


def from_local3(u: V3, v: V3, w: V3, dx, dy, dz) -> V3:
    """Rotate a local-frame direction (dx, dy, dz) into world space."""
    return tuple(u[k] * dx + v[k] * dy + w[k] * dz for k in range(3))


def where3(m: torch.Tensor, a, b) -> V3:
    """Per-lane select between component tuples (scalars broadcast)."""
    ax = a if isinstance(a, (tuple, list)) else (a, a, a)
    bx = b if isinstance(b, (tuple, list)) else (b, b, b)
    return tuple(torch.where(m, ax[k], bx[k]) for k in range(3))
