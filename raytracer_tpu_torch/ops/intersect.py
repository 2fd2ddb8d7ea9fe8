"""Triangle precompute (port of ``raytracer_tpu/ops/intersect.py:61-76``).

The barycentric-gradient form of Moller-Trumbore: per triangle a unit
normal, its plane offset and two gradient rows, so a hit test is six dot
products. Only the megakernel's triangle arm (cubes) uses it in this slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TriPre(NamedTuple):
    n_unit: torch.Tensor  # [T,3] unit geometric normal
    n_d: torch.Tensor  # [T] a.n_unit
    q1: torch.Tensor  # [T,3] barycentric gradient for u
    q2: torch.Tensor  # [T,3] barycentric gradient for v
    q1_a: torch.Tensor  # [T] a.q1
    q2_a: torch.Tensor  # [T] a.q2


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def tri_precompute(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> TriPre:
    e1 = b - a
    e2 = c - a
    ng = _cross(e1, e2)  # [T,3] unnormalized geometric normal
    nn = torch.clamp_min(_dot(ng, ng), 1e-30)
    n_unit = ng / torch.sqrt(nn)[..., None]
    q1 = _cross(e2, ng) / nn[..., None]
    q2 = _cross(ng, e1) / nn[..., None]
    return TriPre(
        n_unit=n_unit,
        n_d=_dot(a, n_unit),
        q1=q1,
        q2=q2,
        q1_a=_dot(a, q1),
        q2_a=_dot(a, q2),
    )
