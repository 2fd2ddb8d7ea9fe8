"""Light sampling (port of ``raytracer_tpu/render/integrator.py:85``
``sample_light3``): a sphere light or a mesh light.
"""

from __future__ import annotations

import math

import torch

from raytracer_tpu_torch.models.scene import LIGHT_SPHERE, SceneArrays

TWO_PI = float(2.0 * math.pi)


def sample_light3(scene: SceneArrays, u1: torch.Tensor, u2: torch.Tensor, u3: torch.Tensor):
    """A point on THE light -> (y=(x,y,z), ny=(x,y,z), pdf_area[N]).

    Sphere: uniform on the sphere from (u1, u2), pdf 1/(4 pi r^2) (the
    reference's src/geometry.rs:575-587). Mesh: u1 picks a triangle by the
    area CDF, (u2, u3) a uniform point in it, pdf 1/area of the whole light
    (src/geometry.rs:588-592); the normal is normalize((c-a) x (b-a)), the
    reference's Triangle::normal.
    """
    if scene.light_type == LIGHT_SPHERE:
        z = 2.0 * u1 - 1.0
        r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        phi = TWO_PI * u2
        n = (r * torch.cos(phi), r * torch.sin(phi), z)
        y = tuple(scene.light_sph_pos[k] + n[k] * scene.light_sph_r for k in range(3))
    else:
        cdf = scene.light_tri_cdf
        pick = torch.searchsorted(cdf, u1, side="left").clamp_(0, cdf.shape[0] - 1)
        ti = scene.light_tri_idx[pick].long()
        a, b, c = scene.tri_a[ti], scene.tri_b[ti], scene.tri_c[ti]  # [N,3]
        b0 = 1.0 - torch.sqrt(u2)
        b1 = (1.0 - b0) * u3
        ab, ac = b - a, c - a
        y = tuple(a[:, k] + ab[:, k] * b0 + ac[:, k] * b1 for k in range(3))
        ng = (
            ac[:, 1] * ab[:, 2] - ac[:, 2] * ab[:, 1],
            ac[:, 2] * ab[:, 0] - ac[:, 0] * ab[:, 2],
            ac[:, 0] * ab[:, 1] - ac[:, 1] * ab[:, 0],
        )
        length = torch.sqrt(torch.clamp_min(ng[0] * ng[0] + ng[1] * ng[1] + ng[2] * ng[2], 1e-20))
        n = tuple(g / length for g in ng)
    pdf = torch.full_like(u1, 1.0) / scene.light_area
    return y, n, pdf
