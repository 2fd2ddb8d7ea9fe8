"""BRDF evaluation and importance sampling over wavefront lanes.

Port of the component-tuple functions of ``raytracer_tpu/ops/brdf.py``:
``Mat`` :41, ``gather_mat`` :70, ``eval_nonspecular3`` :197 and
``sample3`` :218, for the diffuse and mirror arms. Every lane gathers its
object's material record by plain indexing (JAX's ``take_obj_rows`` :53 is
a TPU select-sum standing in for that gather) and both arms are computed
with masks. Conventions: ``n`` is the shading normal (facing
the incoming ray), ``o`` the unit direction toward the previous vertex,
``i`` the direction of the next or light vertex.

Phong (``has_phong`` scenes) and the MIS density ``pdf3`` are ROADMAP.md
queue 1 item 6 and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from raytracer_tpu_torch.models import vecmath as vm
from raytracer_tpu_torch.models.scene import BRDF_SPECULAR

INV_PI = float(1.0 / math.pi)
TWO_PI = float(2.0 * math.pi)


def _no_phong() -> NotImplementedError:
    return NotImplementedError(
        "Phong materials are not ported yet (ROADMAP.md queue 1 item 6: Phong, "
        "MIS and mesh lights on the regen engine, slice three)"
    )


class Mat(NamedTuple):
    """Per-lane gathered material record."""

    brdf_type: torch.Tensor  # [N] i32
    c_d: torch.Tensor  # [N,3]
    c_s: torch.Tensor  # [N,3]
    k_d: torch.Tensor  # [N]
    k_s: torch.Tensor  # [N]
    power: torch.Tensor  # [N]
    emitted: torch.Tensor  # [N,3]


def gather_mat(scene, obj: torch.Tensor) -> Mat:
    return Mat(
        brdf_type=scene.brdf_type[obj],
        c_d=scene.c_d[obj],
        c_s=scene.c_s[obj],
        k_d=scene.k_d[obj],
        k_s=scene.k_s[obj],
        power=scene.phong_power[obj],
        emitted=scene.obj_emitted[obj],
    )


def eval_nonspecular3(mat: Mat, n, o, i, has_phong: bool = False) -> torch.Tensor:
    """BRDF value for diffuse lanes -> [N,3] (kd/pi); mirror lanes give 0
    (a delta BRDF, never evaluated by NEE)."""
    if has_phong:
        raise _no_phong()
    f = mat.c_d * (mat.k_d * INV_PI)[:, None]
    return torch.where((mat.brdf_type == BRDF_SPECULAR)[:, None], 0.0, f)


def sample3(mat: Mat, n, o, u1, u2, u3, fix_phong_frame: bool = True, has_phong: bool = False):
    """BRDF sample -> (i=(x,y,z) of [N], pdf[N]): cosine-weighted hemisphere
    from (u1, u2) for diffuse lanes (the reference's src/scene.rs:58-66), the
    mirror direction with pdf 1 for specular lanes."""
    if has_phong:
        raise _no_phong()
    un, vn, wn = vm.local_frame3(n)
    z = torch.sqrt(u1)
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = TWO_PI * u2
    i_diff = vm.from_local3(un, vn, wn, r * torch.cos(phi), r * torch.sin(phi), z)
    pdf_diff = torch.clamp_min(vm.dot3(n, i_diff), 0.0) * INV_PI
    i_spec = vm.reflect3(o, n)
    is_spec = mat.brdf_type == BRDF_SPECULAR
    return vm.where3(is_spec, i_spec, i_diff), torch.where(is_spec, 1.0, pdf_diff)
