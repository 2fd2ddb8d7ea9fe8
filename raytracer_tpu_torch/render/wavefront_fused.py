"""Streaming wavefront with one fused trace a loop iteration (engine "fused").

Port of ``raytracer_tpu/render/wavefront_fused.py::render_band_fused``: the
regen engine's estimator (NEE, Russian roulette, no MIS), software pipelined
so that each iteration issues ONE trace of twice the width instead of a main
trace and a shadow trace:

1. regenerate idle lanes, park lanes without a ray at ``PARK_RO``/``PARK_RD``;
2. trace ``[continuation and camera rays ; the previous vertex's shadow
   rays]`` as one batch of 2N rays with the per-ray caps ``[INF ; dist -
   visibility_margin]``. On a BVH scene ``bvh_intersect`` sorts all 2N rays
   by the coherence key (K3) and walks them with K2 (or K4 under
   ``RT_BVH_KERNEL=binary``): one launch of each an iteration;
3. resolve the previous vertex's NEE from the shadow half;
4. arrival emission;
5. shade: this vertex's NEE becomes pending (its shadow ray is traced in
   the next iteration), Russian roulette and the bounce;
6. a path that ended regenerates in the next iteration.

The loop runs while a lane is active, has samples left or has a pending
NEE, under the regen engine's ``hard_cap``. Rays are counted as JAX counts
them: the active lanes and the pending NEE lanes of each fused trace.

Four choices make a fused frame equal the regen frame path for path (rays
and sums, on every lane):

(a) draws come from the regen engine's counter hash with its layout,
    ``uniform(seed, slot, it, draw)``: 0-1 camera, 2-3 light, 4 Russian
    roulette, 5-6 bounce, 7 Phong lobe, 8 mesh light. Both engines
    regenerate a lane at the start of the iteration after its path ends, so
    each vertex is shaded in the same iteration by both;
(b) every contribution banks straight into ``acc``, as regen does (JAX
    keeps a per-path ``L`` and routes a finished path's last NEE with
    ``nee_to_acc``). The terms arrive in regen's order: emission at
    iteration it, its NEE (resolved at it+1, before), emission at it+1;
(c) the NEE term is regen's ``beta * direct`` with regen's visibility
    ``~sh_valid | (sh_t + margin >= dist)``, and on BVH scenes regen's cull
    of a sphere-light sample on the light's far side (``cos_y <= 0``: not
    traced, no contribution, still counted as a ray);
(d) a lane with no shadow ray is parked at ``PARK_RO``/``PARK_RD`` with cap
    0, not given JAX's zero direction: a zero direction makes inf * 0 = NaN
    in the slab tests and in K3's entry test, where ``torch.minimum``
    propagates NaN and CUDA's ``fminf`` drops it. A cap of 0 resolves the
    lane at the root, so no pixel changes.

As in JAX there is no permutation of the lane state and no tail compaction.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models import vecmath as vm
from raytracer_tpu_torch.models.camera import camera_rays3
from raytracer_tpu_torch.models.scene import BRDF_SPECULAR, LIGHT_SPHERE, SceneArrays
from raytracer_tpu_torch.ops import brdf
from raytracer_tpu_torch.ops.intersect import INF, ScenePre, trace_soa
from raytracer_tpu_torch.ops.megakernel import uniform
from raytracer_tpu_torch.render.integrator import sample_light3
from raytracer_tpu_torch.render.wavefront import PARK_RD, PARK_RO, bounce


def render_band_fused(
    scene: SceneArrays,
    pre: ScenePre,
    cfg: RenderConfig,
    y0: int,
    rows: int,
    num_samples: int,
    seed: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Render a row band -> (sums f32[rows, W, 4, 3], rays traced i64 scalar),
    on the scene's device."""
    if cfg.use_mis:
        raise ValueError("the fused engine renders the NEE path only; MIS renders on the regen engine")
    eps = cfg.eps
    w = cfg.width
    n = rows * w * 4
    dev = scene.device
    f32, i32 = torch.float32, torch.int32
    light_e = scene.obj_emitted[scene.light_idx]
    hard_cap = num_samples * (cfg.max_depth + 2) + 64
    sphere_light = scene.light_type == LIGHT_SPHERE
    cull = scene.use_bvh and sphere_light
    seed_u = seed & 0xFFFFFFFF
    base = y0 * w * 4

    slot = torch.arange(base, base + n, dtype=i32, device=dev)
    slot64 = slot.to(torch.int64)
    pix = slot // 4
    sub = slot % 4
    lane_px, lane_py = (pix % w).to(f32), (pix // w).to(f32)
    lane_sx, lane_sy = (sub % 2).to(f32), (sub // 2).to(f32)
    inf_cap = torch.full((n,), INF, dtype=f32, device=dev)

    def zeros3() -> tuple:
        return tuple(torch.zeros(n, dtype=f32, device=dev) for _ in range(3))

    active = torch.zeros(n, dtype=torch.bool, device=dev)
    j = torch.zeros(n, dtype=i32, device=dev)
    depth = torch.zeros(n, dtype=i32, device=dev)
    ro, rd = zeros3(), zeros3()
    beta = torch.zeros((n, 3), dtype=f32, device=dev)
    emis = torch.zeros_like(beta)
    acc = torch.zeros_like(beta)
    # The pending NEE of the previous vertex: counted lanes, lanes whose
    # shadow ray was traced, their term if visible, the light distance, and
    # the shadow rays with their caps (parked with cap 0 where none).
    has_nee = torch.zeros(n, dtype=torch.bool, device=dev)
    shadow = torch.zeros_like(has_nee)
    nee_val = torch.zeros_like(beta)
    sh_dist = torch.zeros(n, dtype=f32, device=dev)
    sh_ro = tuple(torch.full((n,), PARK_RO, dtype=f32, device=dev) for _ in range(3))
    sh_rd = tuple(torch.full((n,), c, dtype=f32, device=dev) for c in PARK_RD)
    sh_cap = torch.zeros(n, dtype=f32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)

    it = 0
    while it < hard_cap:
        if not bool((active | (j < num_samples) | has_nee).any()):
            break

        def u(draw: int, it=it) -> torch.Tensor:
            return uniform(seed_u, slot64, it, draw)

        # 1) regenerate: idle lanes start their next sample; park the rest
        got = ~active & (j < num_samples)
        cro, crd = camera_rays3(
            scene, w, cfg.height, cfg.fov_scale, lane_px, lane_py, lane_sx, lane_sy, u(0), u(1),
        )
        g3 = got[:, None]
        ro = vm.where3(got, cro, ro)
        rd = vm.where3(got, crd, rd)
        depth = torch.where(got, 0, depth)
        beta = torch.where(g3, 1.0, beta)
        emis = torch.where(g3, 1.0, emis)
        j = torch.where(got, j + 1, j)
        active = active | got
        ro = vm.where3(active, ro, PARK_RO)
        rd = vm.where3(active, rd, PARK_RD)

        # 2) one trace of [main rays ; the previous vertex's shadow rays]
        rays = rays + active.sum() + has_nee.sum()
        hit2 = trace_soa(
            scene, pre,
            tuple(torch.cat([a, b]) for a, b in zip(ro, sh_ro)),
            tuple(torch.cat([a, b]) for a, b in zip(rd, sh_rd)),
            eps, t_cap=torch.cat([inf_cap, sh_cap]),
        )
        sh_t, sh_valid = hit2.t[n:], hit2.valid[n:]
        hit_obj, hit_valid = hit2.obj[:n], hit2.valid[:n]
        x = tuple(c[:n] for c in hit2.pos)
        nrm = tuple(c[:n] for c in hit2.n)

        # 3) the previous vertex's NEE, visible or occluded
        vis = ~sh_valid | (sh_t + eps.visibility_margin >= sh_dist)
        acc = acc + torch.where((shadow & vis)[:, None], nee_val, 0.0)

        # 4) arrival: emission through the bounce
        valid = active & hit_valid
        em_next = scene.obj_emitted[hit_obj]
        acc = torch.where(valid[:, None], acc + emis * em_next, acc)
        o3 = vm.neg3(rd)
        depth = torch.where(active, depth + 1, depth)

        # 5) shade: this vertex's NEE becomes pending
        mat = brdf.gather_mat(scene, hit_obj)
        is_spec = mat.brdf_type == BRDF_SPECULAR
        ul = u(2)
        y, ny, pdf_l = sample_light3(scene, ul, u(3), ul if sphere_light else u(8))
        to_y = vm.sub3(y, x)
        dist = torch.sqrt(vm.norm2_3(to_y))
        wi_d = vm.scale3(to_y, 1.0 / torch.clamp_min(dist, 1e-20))
        r2 = torch.clamp_min(dist * dist, 1e-20)
        cos_y = -vm.dot3(ny, wi_d)
        has_nee = valid & ~is_spec
        shadow = has_nee & (cos_y > 0.0) if cull else has_nee
        f_d = brdf.eval_nonspecular3(mat, nrm, o3, wi_d, scene.has_phong)
        cos_x = vm.dot3(nrm, wi_d)
        # regen's where(vis, 1, 0) * cos_x * cos_y / (r2 * pdf_l) where visible
        scale = cos_x * cos_y / (r2 * pdf_l)
        nee_val = beta * (light_e[None, :] * f_d * scale[:, None])
        sh_dist = dist
        sh_ro = vm.where3(shadow, x, PARK_RO)
        sh_rd = vm.where3(shadow, wi_d, PARK_RD)
        sh_cap = torch.where(shadow, dist - eps.visibility_margin, 0.0)

        # Russian roulette and the bounce, as regen
        wi, _, p, beta_next, live = bounce(scene, cfg, mat, is_spec, nrm, o3, depth, valid, beta, u)
        emis = torch.where(is_spec[:, None], beta / p[:, None], 0.0)

        # 6) continue; ended paths regenerate next iteration
        ro = vm.where3(live, x, ro)
        rd = vm.where3(live, wi, rd)
        beta = beta_next
        active = live
        it += 1
    return acc.view(rows, w, 4, 3), rays
