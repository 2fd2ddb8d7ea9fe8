"""BRDF evaluation, importance sampling and density over wavefront lanes.

Port of the component-tuple functions of ``raytracer_tpu/ops/brdf.py``:
``Mat`` :41, ``gather_mat`` :70, ``eval_nonspecular3`` :197, ``sample3``
:218 and ``pdf3`` :281, for the diffuse, mirror and Phong arms. Every lane
gathers its object's material record by plain indexing (JAX's
``take_obj_rows`` :53 is a TPU select-sum standing in for that gather) and
every arm is computed with masks. Conventions: ``n`` is the shading normal
(facing the incoming ray), ``o`` the unit direction toward the previous
vertex, ``i`` the direction of the next or light vertex.

``fix_phong_frame=True`` rotates the Phong lobes into world space (the
cosine lobe around n, the power-cosine lobe around the mirror direction);
``False`` keeps the reference's raw local-frame directions
(src/scene.rs:74-95). ``pdf3`` is the density of ``sample3`` at a given
direction, which the MIS balance heuristic needs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from raytracer_tpu_torch.models import vecmath as vm
from raytracer_tpu_torch.models.scene import BRDF_DIFFUSE, BRDF_PHONG, BRDF_SPECULAR

INV_PI = float(1.0 / math.pi)
TWO_PI = float(2.0 * math.pi)


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


def _power_cos(cos_r: torch.Tensor, power: torch.Tensor) -> torch.Tensor:
    """cos_r ** power, 0 where power == 0 (pure diffuse lanes must not
    contribute through cos_r ** 0 == 1)."""
    return torch.where(power > 0.0, cos_r**power, 0.0)


def eval_nonspecular3(mat: Mat, n, o, i, has_phong: bool = False) -> torch.Tensor:
    """BRDF value for diffuse and Phong lanes -> [N,3]: kd/pi, plus for
    Phong ks*color_s*(p+2)/(2pi)*max(o.reflect(i,n),0)^p (the reference's
    src/scene.rs:33, :41-52); mirror lanes give 0 (a delta BRDF, never
    evaluated by NEE). ``has_phong=False`` skips the Phong lobe."""
    f = mat.c_d * (mat.k_d * INV_PI)[:, None]
    if has_phong:
        cos_r = torch.clamp_min(vm.dot3(o, vm.reflect3(i, n)), 0.0)
        lobe = _power_cos(cos_r, mat.power)
        spec = mat.c_s * (mat.k_s * (mat.power + 2.0) / TWO_PI * lobe)[:, None]
        f = f + torch.where((mat.brdf_type == BRDF_PHONG)[:, None], spec, 0.0)
    return torch.where((mat.brdf_type == BRDF_SPECULAR)[:, None], 0.0, f)


def phong_picks(mat: Mat, u1: torch.Tensor):
    """The Phong lanes and the lobe ``u1`` picks on them -> (is_phong,
    pick_d: the cosine lobe, u1 < kd; pick_s: the power-cosine lobe,
    kd <= u1 < kd + ks); where neither holds the sample picks nothing."""
    pick_d = u1 < mat.k_d
    return mat.brdf_type == BRDF_PHONG, pick_d, ~pick_d & (u1 < mat.k_d + mat.k_s)


def sample3(mat: Mat, n, o, u1, u2, u3, fix_phong_frame: bool = True, has_phong: bool = False, picks=None):
    """BRDF sample -> (i=(x,y,z) of [N], pdf[N]).

    Diffuse lanes: the cosine-weighted hemisphere from (u1, u2) (the
    reference's src/scene.rs:58-66). Mirror lanes: the mirror direction,
    pdf 1. Phong lanes: u1 picks the cosine lobe (u1 < kd), the
    power-cosine lobe (u1 < kd + ks) or nothing; (u2, u3) sample the lobe.
    A dead Phong sample returns i = 0 and pdf 1, so the integrator's
    weight f*cos/pdf is 0 and the path ends. ``picks``: ``phong_picks(mat,
    u1)`` where the caller has it.
    """
    un, vn, wn = vm.local_frame3(n)
    z = torch.sqrt(u1)
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = TWO_PI * u2
    i_diff = vm.from_local3(un, vn, wn, r * torch.cos(phi), r * torch.sin(phi), z)
    pdf_diff = torch.clamp_min(vm.dot3(n, i_diff), 0.0) * INV_PI
    i_spec = vm.reflect3(o, n)
    is_spec = mat.brdf_type == BRDF_SPECULAR
    if not has_phong:
        return vm.where3(is_spec, i_spec, i_diff), torch.where(is_spec, 1.0, pdf_diff)

    is_phong, pick_d, pick_s = picks if picks is not None else phong_picks(mat, u1)
    rp = torch.sqrt(torch.clamp_min(1.0 - u2, 0.0))
    phip = TWO_PI * u3
    cos_p, sin_p = torch.cos(phip), torch.sin(phip)
    phd = (rp * cos_p, rp * sin_p, torch.sqrt(u2))
    p = mat.power
    zs = u2 ** (1.0 / (p + 1.0))
    rs = torch.sqrt(torch.clamp_min(1.0 - u2 ** (2.0 / (p + 1.0)), 0.0))
    phs = (rs * cos_p, rs * sin_p, zs)
    ph_s_pdf = (p + 1.0) / TWO_PI * zs**p
    if fix_phong_frame:
        ph_d = vm.from_local3(un, vn, wn, *phd)
        ur, vr, wr = vm.local_frame3(vm.normalize3(i_spec, eps=1e-20))
        ph_s = vm.from_local3(ur, vr, wr, *phs)
    else:
        ph_d, ph_s = phd, phs
    i_phong = vm.where3(pick_d, ph_d, vm.where3(pick_s, ph_s, 0.0))
    pdf_phong = torch.where(
        pick_d,
        torch.clamp_min(vm.dot3(n, ph_d), 0.0) * INV_PI,
        torch.where(pick_s, ph_s_pdf, 1.0),
    )
    i = vm.where3(is_spec, i_spec, vm.where3(is_phong, i_phong, i_diff))
    pdf = torch.where(is_spec, 1.0, torch.where(is_phong, pdf_phong, pdf_diff))
    return i, pdf


def pdf3(mat: Mat, n, o, i) -> torch.Tensor:
    """Density of ``sample3`` at direction ``i`` (solid angle) -> [N]: the
    cosine density for diffuse lanes, kd*cosine + ks*lobe for Phong lanes
    (the power-cosine lobe around the mirror direction, as ``sample3``
    draws it under ``fix_phong_frame``), 0 for mirror lanes (a delta)."""
    p_diff = torch.clamp_min(vm.dot3(n, i), 0.0) * INV_PI
    axis = vm.normalize3(vm.reflect3(o, n), eps=1e-20)
    cos_r = torch.clamp_min(vm.dot3(axis, i), 0.0)
    p_lobe = (mat.power + 1.0) / TWO_PI * _power_cos(cos_r, mat.power)
    p_phong = mat.k_d * p_diff + mat.k_s * p_lobe
    return torch.where(
        mat.brdf_type == BRDF_PHONG,
        p_phong,
        torch.where(mat.brdf_type == BRDF_DIFFUSE, p_diff, 0.0),
    )
