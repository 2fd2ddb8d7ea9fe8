"""Component-tuple 3-vector helpers on torch tensors.

Port of the ``*3`` helpers of ``raytracer_tpu/models/vecmath.py``: a vector
is a tuple ``(x, y, z)`` of same-shaped tensors (or of scalars, which
broadcast). The camera and the megakernel's plain twin use them.

Each helper is written as the same sequence of single float32 operations as
its JAX counterpart and as the CUDA kernel's inline functions, so the twin
and the kernel agree bit for bit on the card (the kernel is built with FMA
contraction off). ``normalize3`` therefore multiplies by ``1 / sqrt`` where
the JAX helper uses ``rsqrt``: CUDA's ``rsqrtf`` is not correctly rounded.
"""

from __future__ import annotations

import torch

V3 = tuple  # (x, y, z) of tensors or scalars


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


def where3(m: torch.Tensor, a, b) -> V3:
    """Per-lane select between component tuples (scalars broadcast)."""
    ax = a if isinstance(a, (tuple, list)) else (a, a, a)
    bx = b if isinstance(b, (tuple, list)) else (b, b, b)
    return tuple(torch.where(m, ax[k], bx[k]) for k in range(3))
