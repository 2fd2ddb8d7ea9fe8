"""Batched ray-primitive intersection (port of ``raytracer_tpu/ops/intersect.py``).

A wavefront of N rays is tested against every primitive of a group at
once: per-(primitive, ray) values are [K, N] tensors, dot products are
expanded into components, and the nearest hit is an argmin. Triangles use
the barycentric-gradient form of Moller-Trumbore (``tri_precompute``):
per triangle a unit normal, its plane offset and two gradient rows, so a
hit test is six dot products.

Mesh triangles behind the BVH go through ``ops.bvh_traverse.bvh_intersect``
(K2 on a CUDA scene, its twin on a CPU scene), seeded with the nearest
sphere/plane/prefix hit; cube and prism triangles are brute-forced.
Semantics as in the reference: two-sided normals, near-then-far sphere
root, the f32 epsilons of ``config.Epsilons``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer_tpu_torch.config import Epsilons
from raytracer_tpu_torch.models import vecmath as vm
from raytracer_tpu_torch.models.scene import SceneArrays
from raytracer_tpu_torch.ops.bvh_traverse import bvh_intersect

INF = 3.0e38


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


def _dot_kn(p: torch.Tensor, v3) -> torch.Tensor:
    """dot(p[K,3], v=(x,y,z) of [N]) -> [K,N]."""
    return p[:, 0:1] * v3[0][None, :] + p[:, 1:2] * v3[1][None, :] + p[:, 2:3] * v3[2][None, :]


def intersect_spheres(ro, rd, pos, r, valid, eps: Epsilons) -> torch.Tensor:
    """t of the nearest valid root per (sphere, ray) -> [S,N]; INF on miss
    (smallpt quadratic, near root then far root)."""
    ro, rd = vm.as3(ro), vm.as3(rd)
    b = _dot_kn(pos, rd) - vm.dot3(ro, rd)[None, :]
    opop = _dot(pos, pos)[:, None] - 2.0 * _dot_kn(pos, ro) + vm.norm2_3(ro)[None, :]
    det = b * b - opop + (r * r)[:, None]
    sq = torch.sqrt(torch.clamp_min(det, 0.0))
    t_near = b - sq
    t_far = b + sq
    t = torch.where(
        t_near > eps.sphere_tmin, t_near, torch.where(t_far > eps.sphere_tmin, t_far, INF)
    )
    return torch.where((det >= 0.0) & valid[:, None], t, INF)


def intersect_planes(ro, rd, pos, n, valid, eps: Epsilons) -> torch.Tensor:
    """t per (plane, ray) -> [P,N]; INF on miss (|d.n| < cutoff or t < 0)."""
    ro, rd = vm.as3(ro), vm.as3(rd)
    d_dot_n = _dot_kn(n, rd)
    po_dot_n = _dot(pos, n)[:, None] - _dot_kn(n, ro)
    t = po_dot_n / d_dot_n
    ok = (torch.abs(d_dot_n) >= eps.plane_parallel) & (t >= 0.0) & valid[:, None]
    return torch.where(ok, t, INF)


def intersect_triangles(ro, rd, pre: TriPre, valid, eps: Epsilons) -> torch.Tensor:
    """t per (triangle, ray) -> [T,N]; INF on miss."""
    ro, rd = vm.as3(ro), vm.as3(rd)
    denom = _dot_kn(pre.n_unit, rd)
    t = (pre.n_d[:, None] - _dot_kn(pre.n_unit, ro)) / denom
    u = _dot_kn(pre.q1, ro) + t * _dot_kn(pre.q1, rd) - pre.q1_a[:, None]
    v = _dot_kn(pre.q2, ro) + t * _dot_kn(pre.q2, rd) - pre.q2_a[:, None]
    ok = (
        (torch.abs(denom) >= eps.tri_parallel)
        & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > eps.tri_tmin)
        & valid[:, None]
    )
    return torch.where(ok, t, INF)


class ScenePre(NamedTuple):
    """Loop-invariant intersection data of a scene."""

    tri: TriPre
    # [S+P+T, 4]: per primitive a 3-vector (sphere centre / plane normal /
    # triangle unit normal) and the object id as f32 (exact below 2^24).
    att: torch.Tensor


def scene_precompute(scene: SceneArrays) -> ScenePre:
    tri = tri_precompute(scene.tri_a, scene.tri_b, scene.tri_c)
    f32 = torch.float32
    att = torch.cat(
        [
            torch.cat([scene.sph_pos, scene.sph_obj[:, None].to(f32)], dim=1),
            torch.cat([scene.pln_n, scene.pln_obj[:, None].to(f32)], dim=1),
            torch.cat([tri.n_unit, scene.tri_obj[:, None].to(f32)], dim=1),
        ],
        dim=0,
    )
    return ScenePre(tri=tri, att=att)


def _group_ts(
    scene: SceneArrays, pre: ScenePre, ro, rd, eps: Epsilons,
    t_cap: torch.Tensor | None = None, any_hit: bool = False, presorted: bool = False,
):
    """Per group (nearest t [N], argmin [N]); ``t_cap`` bounds the BVH
    search (hits at or beyond it may be dropped) and ``any_hit`` lets it stop
    at a first sub-cap hit."""
    ro, rd = vm.as3(ro), vm.as3(rd)
    n = ro[0].shape[0]
    dev = ro[0].device
    inf = torch.full((n,), INF, dtype=torch.float32, device=dev)
    zero = torch.zeros((n,), dtype=torch.int64, device=dev)

    if scene.n_spheres > 0:
        ts_best, ts_arg = torch.min(
            intersect_spheres(ro, rd, scene.sph_pos, scene.sph_r, scene.sph_valid, eps), dim=0
        )
    else:
        ts_best, ts_arg = inf, zero
    if scene.n_planes > 0:
        tp_best, tp_arg = torch.min(
            intersect_planes(ro, rd, scene.pln_pos, scene.pln_n, scene.pln_valid, eps), dim=0
        )
    else:
        tp_best, tp_arg = inf, zero

    if scene.n_triangles == 0:
        tt_best, tt_arg = inf, zero
    elif scene.use_bvh:
        k = scene.bvh_tri_start
        if k > 0:
            pre_prefix = TriPre(*(x[:k] for x in pre.tri))
            tt_best, tt_arg = torch.min(
                intersect_triangles(ro, rd, pre_prefix, scene.tri_valid[:k], eps), dim=0
            )
        else:
            tt_best, tt_arg = inf, zero
        # Seed the traversal with everything known to be closer (ties go to
        # the lower group downstream, so an unimproved seed never wins).
        t_init = torch.minimum(torch.minimum(ts_best, tp_best), tt_best)
        resolved0 = None
        if t_cap is not None:
            if any_hit:
                resolved0 = (t_init < t_cap) | (t_cap <= 0.0)
            t_init = torch.minimum(t_init, t_cap)
        bt, bidx = bvh_intersect(
            scene, ro, rd, eps, t_init=t_init,
            any_hit=any_hit and t_cap is not None, resolved0=resolved0,
            presorted=presorted,
        )
        use_b = bt < tt_best
        tt_best = torch.where(use_b, bt, tt_best)
        tt_arg = torch.where(use_b, bidx.to(torch.int64), tt_arg)
    else:
        tt_best, tt_arg = torch.min(
            intersect_triangles(ro, rd, pre.tri, scene.tri_valid, eps), dim=0
        )
    return (ts_best, ts_arg), (tp_best, tp_arg), (tt_best, tt_arg)


def trace_t(
    scene: SceneArrays, pre: ScenePre, ro, rd, eps: Epsilons,
    t_max: torch.Tensor | None = None, any_hit: bool = False, presorted: bool = False,
):
    """Nearest-hit distance only -> (t [N], valid [N]): the visibility test.
    With ``t_max`` the mesh search is pruned at the target distance (t may
    then equal t_max), which ``t + margin >= dist`` cannot tell from a miss."""
    (ts, _), (tp, _), (tt, _) = _group_ts(
        scene, pre, ro, rd, eps, t_cap=t_max, any_hit=any_hit, presorted=presorted
    )
    t = torch.minimum(torch.minimum(ts, tp), tt)
    return t, t < INF


class HitSoA(NamedTuple):
    """Nearest-hit record, vectors as component tuples of [N]."""

    t: torch.Tensor  # [N]
    pos: tuple  # offset along the normal for planes/triangles
    n: tuple  # two-sided shading normal (faces the incoming ray)
    obj: torch.Tensor  # [N] i64 object index
    valid: torch.Tensor  # [N] bool


class Hit(NamedTuple):
    """``HitSoA`` with [N,3] vectors."""

    t: torch.Tensor
    pos: torch.Tensor
    n: torch.Tensor
    obj: torch.Tensor
    valid: torch.Tensor


def trace_soa(
    scene: SceneArrays, pre: ScenePre, ro, rd, eps: Epsilons,
    t_cap: torch.Tensor | None = None, presorted: bool = False,
) -> HitSoA:
    """Nearest hit of each ray against the whole scene: per-group argmin-t,
    a cross-group argmin, one gather of the winner's attributes."""
    ro, rd = vm.as3(ro), vm.as3(rd)
    (ts_best, ts_arg), (tp_best, tp_arg), (tt_best, tt_arg) = _group_ts(
        scene, pre, ro, rd, eps, t_cap=t_cap, presorted=presorted
    )
    t_best, group = torch.min(torch.stack([ts_best, tp_best, tt_best]), dim=0)
    valid = t_best < INF
    s_off = scene.sph_pos.shape[0]
    p_off = s_off + scene.pln_pos.shape[0]
    idx = torch.where(group == 0, ts_arg, torch.where(group == 1, s_off + tp_arg, p_off + tt_arg))
    row = pre.att[idx]  # [N,4]
    obj = row[:, 3].to(torch.int64)
    v3 = vm.as3(row)

    is_sph = group == 0
    pos_raw = tuple(ro[k] + t_best * rd[k] for k in range(3))
    d = vm.sub3(pos_raw, v3)
    inv_l = 1.0 / torch.sqrt(torch.clamp_min(vm.norm2_3(d), 1e-20))
    n_geo = vm.where3(is_sph, vm.scale3(d, inv_l), v3)
    # Two-sided normal: kept when n.(-rd) >= 0.
    sign = torch.where(vm.dot3(n_geo, rd) <= 0.0, 1.0, -1.0)
    n_ff = vm.scale3(n_geo, sign)
    # Planes and triangles offset the hit along the normal; spheres do not.
    off = torch.where(is_sph, 0.0, eps.hit_offset)
    pos = tuple(pos_raw[k] + off * n_ff[k] for k in range(3))
    return HitSoA(t=t_best, pos=pos, n=n_ff, obj=obj, valid=valid)


def trace(scene, pre, ro, rd, eps, t_cap=None, presorted=False) -> Hit:
    """[N,3]-layout wrapper over ``trace_soa``."""
    h = trace_soa(scene, pre, ro, rd, eps, t_cap=t_cap, presorted=presorted)
    return Hit(t=h.t, pos=vm.stack3(h.pos), n=vm.stack3(h.n), obj=h.obj, valid=h.valid)
