"""Light sampling (port of ``raytracer_tpu/render/integrator.py:85``
``sample_light3``), sphere-light arm.

Mesh lights (the area-weighted triangle CDF) are ROADMAP.md queue 1 item 6
and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import math

import torch

from raytracer_tpu_torch.models.scene import LIGHT_SPHERE, SceneArrays

TWO_PI = float(2.0 * math.pi)


def sample_light3(scene: SceneArrays, u1: torch.Tensor, u2: torch.Tensor, u3: torch.Tensor):
    """A point on THE light -> (y=(x,y,z), ny=(x,y,z), pdf_area[N]): uniform
    on the sphere, pdf 1/(4 pi r^2) (the reference's src/geometry.rs:575-587).
    ``u3`` is the mesh-light draw, unused here."""
    if scene.light_type != LIGHT_SPHERE:
        raise NotImplementedError(
            "mesh lights are not ported yet (ROADMAP.md queue 1 item 6, slice three)"
        )
    z = 2.0 * u1 - 1.0
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = TWO_PI * u2
    n = (r * torch.cos(phi), r * torch.sin(phi), z)
    y = tuple(scene.light_sph_pos[k] + n[k] * scene.light_sph_r for k in range(3))
    pdf = torch.full_like(u1, 1.0) / scene.light_area
    return y, n, pdf
