"""The lockstep wavefront integrator (engine ``"simple"``) and light sampling.

Port of ``raytracer_tpu/render/integrator.py``: ``sample_light`` :56,
``sample_light3`` :85 and ``radiance`` :103. The estimator is the
reference's ``Scene::received_radiance`` (src/scene.rs:152-244): next-event
estimation at every non-specular vertex, a BSDF-sampled continuation with
Russian roulette (p = 1 through ``rr_start_depth``, then ``rr_survival``),
and specular vertices that skip NEE and collect emission through the mirror
bounce, divided by p. ``cfg.use_mis`` combines light and BSDF sampling by
the balance heuristic.

N lanes advance in lockstep, one ``bounce`` per depth, until no lane is
alive or ``cfg.max_depth`` is reached (the test of ``alive`` is one host
read a bounce). A bounce draws seven uniforms a lane (3 light, 1 Russian
roulette, 3 BSDF) from the counter hash of ``ops/megakernel.py``:
``uniform(seed, lane, depth, draw)``, so a band is deterministic and does
not depend on the order its lanes are computed in. That is another stream
than ``jax.random``: the engine agrees with the JAX package's
statistically, not lane by lane. Vectors are component tuples inside
(``models/vecmath.py``); ``radiance`` takes and returns [N, 3] tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models import vecmath as vm
from raytracer_tpu_torch.models.scene import BRDF_SPECULAR, LIGHT_SPHERE, SceneArrays
from raytracer_tpu_torch.ops import brdf
from raytracer_tpu_torch.ops.intersect import ScenePre, trace_soa, trace_t
from raytracer_tpu_torch.ops.megakernel import M32, uniform

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


def sample_light(scene: SceneArrays, u1: torch.Tensor, u2: torch.Tensor, u3: torch.Tensor):
    """``sample_light3`` in [N, 3] layout -> (y[N,3], ny[N,3], pdf_area[N])."""
    y, n, pdf = sample_light3(scene, u1, u2, u3)
    return vm.stack3(y), vm.stack3(n), pdf


class PathState(NamedTuple):
    """The lanes' state between two bounces."""

    L: torch.Tensor  # [N,3] radiance collected so far
    beta: torch.Tensor  # [N,3] path throughput
    x: tuple  # the current vertex
    n: tuple  # its shading normal
    obj: torch.Tensor  # [N] i64 its object
    o: tuple  # unit direction toward the previous vertex
    alive: torch.Tensor  # [N] bool
    rays: torch.Tensor  # i64 scalar: rays traced so far


def bounce(
    scene: SceneArrays, pre: ScenePre, cfg: RenderConfig, state: PathState, us, p: float
) -> PathState:
    """One depth of the lockstep loop for every lane: NEE at the current
    vertex, Russian roulette at survival probability ``p``, the BSDF
    continuation and the emission it reaches. ``us`` holds the seven
    uniforms [N] of the bounce: 0-2 the light sample, 3 Russian roulette,
    4-6 the BSDF sample."""
    eps = cfg.eps
    L, beta, x, n, obj, o, alive, rays = state
    light_e = scene.obj_emitted[scene.light_idx]
    mat = brdf.gather_mat(scene, obj)
    is_spec = mat.brdf_type == BRDF_SPECULAR

    # Next-event estimation (non-specular lanes). The shadow query is
    # bounded at dist - margin: a hit below that bound is the reference's
    # invisibility test hit.t + margin < dist (src/scene.rs:258-270).
    y, ny, pdf_l = sample_light3(scene, us[0], us[1], us[2])
    to_y = vm.sub3(y, x)
    dist = torch.sqrt(vm.norm2_3(to_y))
    wi_d = vm.scale3(to_y, 1.0 / torch.clamp_min(dist, 1e-20))
    r2 = torch.clamp_min(dist * dist, 1e-20)
    sh_t, sh_valid = trace_t(scene, pre, x, wi_d, eps, t_max=dist - eps.visibility_margin)
    vis = ~sh_valid | (sh_t + eps.visibility_margin >= dist)
    f_d = brdf.eval_nonspecular3(mat, n, o, wi_d, scene.has_phong)
    cos_x = vm.dot3(n, wi_d)
    cos_y = -vm.dot3(ny, wi_d)
    if cfg.use_mis:
        pdf_l_sa = pdf_l * r2 / torch.clamp_min(cos_y, 1e-8)
        pdf_b_at = brdf.pdf3(mat, n, o, wi_d)
        ok = vis & (cos_y > 0.0) & (cos_x > 0.0)
        direct = torch.where(
            ok[:, None], light_e[None, :] * f_d * (cos_x / (pdf_l_sa + pdf_b_at))[:, None], 0.0
        )
    else:
        # The reference's estimator (src/scene.rs:218-229): no cosine clamp.
        scale = torch.where(vis, 1.0, 0.0) * cos_x * cos_y / (r2 * pdf_l)
        direct = light_e[None, :] * f_d * scale[:, None]
    L = L + torch.where((alive & ~is_spec)[:, None], beta * direct, 0.0)

    # Russian roulette and the BSDF continuation.
    cont = alive & (us[3] < p)
    wi, pdf_b = brdf.sample3(
        mat, n, o, us[4], us[5], us[6], cfg.fix_phong_frame, scene.has_phong
    )
    nxt = trace_soa(scene, pre, x, wi, eps)
    good = cont & nxt.valid
    f_c = brdf.eval_nonspecular3(mat, n, o, wi, scene.has_phong)
    cos_c = vm.dot3(n, wi)
    w_nonspec = torch.where(
        (pdf_b > 1e-12)[:, None], f_c * (cos_c / torch.clamp_min(pdf_b, 1e-12))[:, None], 0.0
    )
    # A mirror's f*cos/pdf collapses to ks (src/scene.rs:34-39, :68).
    weight = torch.where(is_spec[:, None], mat.c_s, w_nonspec) / p

    # Emission picked up at the next vertex.
    nxt_e = scene.obj_emitted[nxt.obj]
    if cfg.use_mis:
        # The balance weight of the BSDF strategy; a mirror bounce is a
        # delta with no competing light strategy and collects in full.
        hit_light = nxt.obj == scene.light_idx
        cos_yb = torch.clamp_min(-vm.dot3(nxt.n, wi), 1e-8)
        pdf_l_sa_b = (nxt.t * nxt.t) / (cos_yb * scene.light_area)
        w_b = torch.where(hit_light, pdf_b / (pdf_b + pdf_l_sa_b), 1.0)
        emis = torch.where(is_spec[:, None], nxt_e / p, weight * w_b[:, None] * nxt_e)
        L = L + torch.where(good[:, None], beta * emis, 0.0)
    else:
        # Only a mirror sees emission through the bounce (src/scene.rs:
        # 170-185); NEE has counted the light for the others (:231-240).
        L = L + torch.where((good & is_spec)[:, None], beta * nxt_e / p, 0.0)

    beta = torch.where(good[:, None], beta * weight, 0.0)
    rays = rays + (alive & ~is_spec).sum() + cont.sum()  # shadow and continuation rays
    alive = good & (beta > 0.0).any(dim=1)
    return PathState(L, beta, nxt.pos, nxt.n, nxt.obj, vm.neg3(wi), alive, rays)


def radiance(
    scene: SceneArrays, pre: ScenePre, cfg: RenderConfig, ro, rd, seed: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Incoming radiance along N camera rays -> ([N,3], rays traced i64
    scalar), on the scene's device. Lane i draws ``uniform(seed, i, depth,
    draw)``. The count is the reference's: the camera rays, a shadow ray per
    live non-specular lane and a continuation ray per lane that passes
    Russian roulette."""
    ro, rd = vm.as3(ro), vm.as3(rd)
    n_lanes = rd[0].shape[0]
    dev = rd[0].device
    hit = trace_soa(scene, pre, ro, rd, cfg.eps)
    valid = hit.valid[:, None]
    state = PathState(
        L=torch.where(valid, scene.obj_emitted[hit.obj], 0.0),
        beta=torch.where(valid, 1.0, 0.0).expand(n_lanes, 3),
        x=hit.pos, n=hit.n, obj=hit.obj, o=vm.neg3(rd), alive=hit.valid,
        rays=torch.tensor(n_lanes, dtype=torch.int64, device=dev),  # camera rays
    )
    lane = torch.arange(n_lanes, dtype=torch.int64, device=dev)
    seed_u = seed & M32
    d = 1
    while d <= cfg.max_depth and bool(state.alive.any()):
        us = [uniform(seed_u, lane, d, draw) for draw in range(7)]
        p = 1.0 if d <= cfg.rr_start_depth else cfg.rr_survival
        state = bounce(scene, pre, cfg, state, us, p)
        d += 1
    return state.L, state.rays
