"""Streaming (regen) wavefront integrator: the engine of BVH scenes, and of
every scene with MIS, Phong materials or a mesh light.

Port of ``raytracer_tpu/render/wavefront.py:139`` ``render_band_regen``,
with NEE and, under ``cfg.use_mis``, the balance heuristic. One lane per
(pixel, subpixel) slot renders its samples back to back; the moment a
lane's path ends (miss, Russian roulette, dead BSDF sample, depth cap) it
starts its next sample in the same iteration, and every contribution banks
straight into the lane's ``acc``. Each iteration:

1. regenerate idle lanes (camera ray from the lane's slot), park lanes with
   no work left at ``PARK_RO``/``PARK_RD`` (their rays miss at the root);
2. BVH scenes: permute the whole lane state by the coherence key (K3), so
   the main trace runs ``presorted`` through the BVH traversal (K2, or K4
   under ``RT_BVH_KERNEL=binary``);
3. main trace, arrival emission, NEE with a shadow ray bounded at
   ``dist - visibility_margin`` that sorts by its own key, with the
   sphere-light back-face cull on BVH scenes;
4. Russian roulette and a cosine or mirror bounce.

BVH scenes also compact the tail: once at most half the loop's lanes hold
work, the working lanes move (stable) to the front of a half-width loop,
up to ``cfg.tail_compact_stages`` times.

Random numbers come from the counter hash of ``ops/megakernel.py``, keyed
on the lane's slot in the frame (``y0*W*4 + pixel*4 + sub``), the
iteration and the draw: ``uniform(seed, slot, it, draw)``, draws 0-1 camera
jitter, 2-3 the light sample, 4 Russian roulette, 5-6 the bounce, 7 the
Phong lobe's third draw and 8 the mesh light's (drawn only where the scene
has Phong materials or a mesh light). So a pixel's result depends neither
on the lane order (the permutation and the compaction change nothing) nor
on the band that holds it.

MIS (``cfg.use_mis``) weighs the two strategies that reach the light by the
balance heuristic: the light sample's direct term is
``light_e*f*cos_x/(pdf_light_sa + pdf_bsdf)``, and emission reached through
a bounce is weighted ``pdf_prev/(pdf_prev + pdf_light_sa)``, where
``pdf_prev`` (a 16th state column, present only under MIS) is the density
of the bounce that led there, ``BIG`` after a camera ray or a mirror bounce.

Left out: the env-gated negative
results of the JAX engine (deferred and reversed shadows, group sorts,
ablations), the bf16 state pair (the state here is f32) and the bitcast
packing of int state into float columns.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models import vecmath as vm
from raytracer_tpu_torch.models.camera import camera_rays3
from raytracer_tpu_torch.models.scene import BRDF_SPECULAR, LIGHT_SPHERE, SceneArrays
from raytracer_tpu_torch.ops import brdf
from raytracer_tpu_torch.ops.intersect import ScenePre, trace_soa, trace_t
from raytracer_tpu_torch.ops.keys import coherence_order
from raytracer_tpu_torch.ops.megakernel import uniform
from raytracer_tpu_torch.render.integrator import sample_light3

# Parking spot for lanes with no ray this iteration: far outside any
# reference-scale scene, pointing away, so every test misses at once and
# the coherence key sorts parked lanes into the miss group.
PARK_RO = 3.0e7
PARK_RD = (1.0, 0.0, 0.0)
# pdf_prev of a vertex reached by a delta (camera ray, mirror bounce): its
# emission takes MIS weight 1.
BIG = 1e30

# Float state columns: ro, rd, beta (path throughput), emis (weight of the
# next hit's emission), acc (the lane's banked radiance), and under MIS
# pdf_prev (the density of the bounce that reached the next hit).
RO, RD, BETA, EMIS, ACC = slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 12), slice(12, 15)
PDF = 15
# Int state columns: active, j (samples started), slot, depth.
ACTIVE, J, SLOT, DEPTH = 0, 1, 2, 3


def tail_widths(n: int, cfg: RenderConfig, use_bvh: bool) -> list[int]:
    """Loop widths of the compaction stages: halves of the band, rounded up
    to 1024 lanes, while they shrink and stay >= 1024."""
    widths: list[int] = []
    if use_bvh and cfg.tail_compact:
        wcur = n
        while len(widths) < cfg.tail_compact_stages:
            cand = -(-(wcur // 2) // 1024) * 1024
            if cand >= wcur or cand < 1024:
                break
            widths.append(cand)
            wcur = cand
    return widths


def bounce(scene: SceneArrays, cfg: RenderConfig, mat, is_spec, nrm, o3, depth, valid, beta, u):
    """Russian roulette and the BSDF (or mirror) bounce of a vertex, with
    draws 4 (roulette), 5-6 and, for Phong, 7 of ``u(draw)`` -> (wi,
    pdf_b, p: the survival probability, beta_next, live: the lanes whose
    path goes on)."""
    p = torch.where(depth <= cfg.rr_start_depth, 1.0, cfg.rr_survival)
    cont = valid & (u(4) < p) & (depth < cfg.max_depth)
    ub = u(5)
    wi, pdf_b = brdf.sample3(
        mat, nrm, o3, ub, u(6), u(7) if scene.has_phong else ub,
        cfg.fix_phong_frame, scene.has_phong,
    )
    f_c = brdf.eval_nonspecular3(mat, nrm, o3, wi, scene.has_phong)
    cos_c = vm.dot3(nrm, wi)
    w_nonspec = torch.where(
        (pdf_b > 1e-12)[:, None],
        f_c * (cos_c / torch.clamp_min(pdf_b, 1e-12))[:, None],
        0.0,
    )
    weight = torch.where(is_spec[:, None], mat.c_s, w_nonspec) / p[:, None]
    beta_next = beta * weight
    live = cont & (beta_next > 0.0).any(dim=1)
    return wi, pdf_b, p, beta_next, live


def render_band_regen(
    scene: SceneArrays,
    pre: ScenePre,
    cfg: RenderConfig,
    y0: int,
    rows: int,
    num_samples: int,
    seed: int,
    permute: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Render a row band -> (sums f32[rows, W, 4, 3], rays traced i64 scalar),
    on the scene's device. ``permute=False`` keeps the lanes in slot order
    (the traces then sort and unsort around the traversal themselves)."""
    eps = cfg.eps
    mis = cfg.use_mis
    w = cfg.width
    n = rows * w * 4
    dev = scene.device
    f32, i32 = torch.float32, torch.int32
    light_e = scene.obj_emitted[scene.light_idx]
    hard_cap = num_samples * (cfg.max_depth + 2) + 64
    bvh = scene.use_bvh
    permute = permute and bvh
    sphere_light = scene.light_type == LIGHT_SPHERE
    cull = bvh and sphere_light
    seed_u = seed & 0xFFFFFFFF
    base = y0 * w * 4

    fs = torch.zeros((n, 16 if mis else 15), dtype=f32, device=dev)
    ints = torch.zeros((n, 4), dtype=i32, device=dev)
    ints[:, SLOT] = torch.arange(base, base + n, dtype=i32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)

    def pack(ro, rd, beta, emis, acc, pdf_prev) -> torch.Tensor:
        cols = [vm.stack3(ro), vm.stack3(rd), beta, emis, acc]
        if mis:
            cols.append(pdf_prev[:, None])
        return torch.cat(cols, dim=1)

    def step(it: int, fs: torch.Tensor, ints: torch.Tensor, rays: torch.Tensor):
        active = ints[:, ACTIVE] != 0
        j = ints[:, J]
        slot = ints[:, SLOT]
        depth = ints[:, DEPTH]
        ro, rd = vm.as3(fs[:, RO]), vm.as3(fs[:, RD])
        beta, emis, acc = fs[:, BETA], fs[:, EMIS], fs[:, ACC]
        pdf_prev = fs[:, PDF] if mis else None
        slot64 = slot.to(torch.int64)

        def u(draw: int) -> torch.Tensor:
            return uniform(seed_u, slot64, it, draw)

        # 1) regenerate: idle lanes start their next sample
        got = ~active & (j < num_samples)
        pix = slot // 4
        sub = slot % 4
        cro, crd = camera_rays3(
            scene, w, cfg.height, cfg.fov_scale,
            (pix % w).to(f32), (pix // w).to(f32), (sub % 2).to(f32), (sub // 2).to(f32),
            u(0), u(1),
        )
        g3 = got[:, None]
        ro = vm.where3(got, cro, ro)
        rd = vm.where3(got, crd, rd)
        depth = torch.where(got, 0, depth)
        beta = torch.where(g3, 1.0, beta)
        emis = torch.where(g3, 1.0, emis)
        if mis:
            pdf_prev = torch.where(got, BIG, pdf_prev)
        j = torch.where(got, j + 1, j)
        active = active | got

        # 1b) park lanes without work; permute the lane state by the key
        ro = vm.where3(active, ro, PARK_RO)
        rd = vm.where3(active, rd, PARK_RD)
        if permute:
            order = coherence_order(scene, ro, rd, eps)
            fs = pack(ro, rd, beta, emis, acc, pdf_prev)[order]
            ints = torch.stack([active.to(i32), j, slot, depth], dim=1)[order]
            active, j, slot, depth = (ints[:, c] for c in range(4))
            active = active != 0
            slot64 = slot.to(torch.int64)
            ro, rd = vm.as3(fs[:, RO]), vm.as3(fs[:, RD])
            beta, emis, acc = fs[:, BETA], fs[:, EMIS], fs[:, ACC]
            pdf_prev = fs[:, PDF] if mis else None

        # 2) main trace: camera and continuation rays together
        rays = rays + active.sum()
        hit = trace_soa(scene, pre, ro, rd, eps, presorted=permute)
        valid = active & hit.valid

        # 3) arrival: emission through the bounce
        em_next = scene.obj_emitted[hit.obj]
        if mis:
            cos_yb = torch.clamp_min(-vm.dot3(hit.n, rd), 1e-8)
            pdf_l_sa = (hit.t * hit.t) / (cos_yb * scene.light_area)
            w_b = torch.where(hit.obj == scene.light_idx, pdf_prev / (pdf_prev + pdf_l_sa), 1.0)
            acc = torch.where(valid[:, None], acc + emis * em_next * w_b[:, None], acc)
        else:
            acc = torch.where(valid[:, None], acc + emis * em_next, acc)
        x, nrm = hit.pos, hit.n
        o3 = vm.neg3(rd)
        depth = torch.where(active, depth + 1, depth)

        # 4) NEE: a light sample and its bounded shadow ray
        mat = brdf.gather_mat(scene, hit.obj)
        is_spec = mat.brdf_type == BRDF_SPECULAR
        ul = u(2)
        y, ny, pdf_l = sample_light3(scene, ul, u(3), ul if sphere_light else u(8))
        to_y = vm.sub3(y, x)
        dist = torch.sqrt(vm.norm2_3(to_y))
        wi_d = vm.scale3(to_y, 1.0 / torch.clamp_min(dist, 1e-20))
        r2 = torch.clamp_min(dist * dist, 1e-20)
        cos_y = -vm.dot3(ny, wi_d)
        nee = valid & ~is_spec
        # Every NEE lane counts as a ray, culled or not: the reference traces
        # every visibility ray (src/scene.rs:218-229).
        rays = rays + nee.sum()
        # A sample on the light's far side is self-occluded by the convex
        # light sphere; BVH scenes skip its trace.
        shadow = nee & (cos_y > 0.0) if cull else nee
        sh_t, sh_valid = trace_t(
            scene, pre,
            vm.where3(shadow, x, PARK_RO), vm.where3(shadow, wi_d, PARK_RD), eps,
            t_max=torch.where(shadow, dist - eps.visibility_margin, 0.0),
        )
        vis = ~sh_valid | (sh_t + eps.visibility_margin >= dist)
        if cull:
            vis = vis & (cos_y > 0.0)
        f_d = brdf.eval_nonspecular3(mat, nrm, o3, wi_d, scene.has_phong)
        cos_x = vm.dot3(nrm, wi_d)
        if mis:
            pdf_l_sa_d = pdf_l * r2 / torch.clamp_min(cos_y, 1e-8)
            pdf_b_at = brdf.pdf3(mat, nrm, o3, wi_d)
            ok = vis & (cos_y > 0.0) & (cos_x > 0.0)
            direct = torch.where(
                ok[:, None],
                light_e[None, :] * f_d * (cos_x / (pdf_l_sa_d + pdf_b_at))[:, None],
                0.0,
            )
        else:
            scale = torch.where(vis, 1.0, 0.0) * cos_x * cos_y / (r2 * pdf_l)
            direct = light_e[None, :] * f_d * scale[:, None]
        acc = acc + torch.where(nee[:, None], beta * direct, 0.0)

        # 5) Russian roulette and the bounce
        wi, pdf_b, p, beta_next, live = bounce(scene, cfg, mat, is_spec, nrm, o3, depth, valid, beta, u)
        # A mirror bounce collects the next hit's emission at beta/p. Without
        # MIS a non-specular one collects none (NEE counted the light); with
        # MIS it collects at beta_next times the balance weight.
        if mis:
            emis = torch.where(is_spec[:, None], beta / p[:, None], beta_next)
            pdf_prev = torch.where(is_spec, BIG, pdf_b)
        else:
            emis = torch.where(is_spec[:, None], beta / p[:, None], 0.0)

        # 6) continue; ended paths regenerate next iteration
        ro = vm.where3(live, x, ro)
        rd = vm.where3(live, wi, rd)
        fs = pack(ro, rd, beta_next, emis, acc, pdf_prev)
        ints = torch.stack([live.to(i32), j, slot, depth], dim=1)
        return fs, ints, rays

    def work(ints: torch.Tensor) -> torch.Tensor:
        return (ints[:, ACTIVE] != 0) | (ints[:, J] < num_samples)

    it = 0

    def run(fs, ints, rays, limit: int):
        """Step until no lane has work, ``hard_cap``, or <= ``limit`` lanes work."""
        nonlocal it
        while it < hard_cap:
            if int(work(ints).sum()) <= limit:
                break
            fs, ints, rays = step(it, fs, ints, rays)
            it += 1
        return fs, ints, rays

    tail_slots, tail_accs = [], []
    for w2 in tail_widths(n, cfg, bvh):
        fs, ints, rays = run(fs, ints, rays, w2)
        # Stable: working lanes first in their current (coherent) order;
        # finished lanes' slots and sums leave with the tail rows.
        order2 = torch.argsort((~work(ints)).to(i32), stable=True)
        fs, ints = fs[order2], ints[order2]
        tail_slots.append(ints[w2:, SLOT])
        tail_accs.append(fs[w2:, ACC])
        fs, ints = fs[:w2], ints[:w2]
    fs, ints, rays = run(fs, ints, rays, 0)

    slot = torch.cat([ints[:, SLOT]] + tail_slots).to(torch.int64) - base
    acc = torch.cat([fs[:, ACC]] + tail_accs)
    out = torch.empty_like(acc)
    out[slot] = acc
    return out.view(rows, w, 4, 3), rays
