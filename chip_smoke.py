"""Smoke test of the PyTorch + CUDA port on one GPU: ``python3 chip_smoke.py``.

Builds the port's four kernels from ``raytracer_tpu_torch/ops/csrc`` (one
nvcc each, all at once) and prints what ``-Xptxas -v`` says of each
(registers, stack frame, spills). Holds each kernel against its plain
PyTorch twin on the card: K1 on a cornell_box and a cubes band, and its
all-bands frame launch against the bands launched one by one; K2 and K4 at
every ray class and width of the main path; K3 on every class (and, with a
shorter cut, through its run-time cut count). Counts, with
the twins, the visits of the BVH walks and the rays of K1 that the bounds
below rest on.
Then drives the port's three main paths the way a user would:

- the megakernel path (K1): offline ``Renderer.render_image`` of
  cornell_box and cubes at the reference's 600x450 against the repo's own
  64 spp renders in ``examples/``, and the WebSocket server's ``RenderJob``
  (batch and progressive) with every wire message parsed;
- the BVH path (K2, K3, the regen engine): flying_unicorn at 600x450 16 spp
  against ``examples/flying_unicorn.png``, and served through ``RenderJob``
  with the batched transport, equal to ``render_image(16)``;
- the Phong/MIS path (K2 or K4, K3, the regen engine with Phong and MIS):
  crewmate_phong at 64 spp against ``examples/crewmate_phong.png``, at
  16 spp under the default traversal (K2) and under
  ``RT_BVH_KERNEL=binary`` (the skip-link walk K4), each also served, and
  cornell_box with MIS at 64 spp against ``examples/cornell_box_mis.png``.

Each path runs with every launch count set to 0 just before it and read
just after, and fails if one of its kernels was not launched. Every phase
raises on failure, so the exit code is non-zero. Without CUDA it exits
non-zero at once.

Last come the times: each kernel per launch at the main path's shapes and
per frame, beside its plain twin and its bound (the larger of its
operations over the card's f32 peak and its bytes over the memory rate,
from this run's inputs and counts).

Output: progress lines, then a ``{"kernels": [...]}`` JSON line, the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENES = ("cornell_box", "cubes")
# Bounds on the 600x450 64 spp images against the repo's 64 spp renders
# (examples/cornell_box.png mean 112.16, examples/cubes.png mean 113.79).
IMAGE_MEAN = {"cornell_box": (110.7, 113.7), "cubes": (112.3, 115.3)}
IMAGE_MAD_MAX = 16.0
# flying_unicorn 600x450 16 spp against examples/flying_unicorn.png (a 16 spp
# render, mean 108.99): the mean within these bounds, and the MAD at most the
# MAD between two port renders at seeds 0 and 1 plus this margin.
UNICORN_MEAN = (107.5, 110.5)
UNICORN_MAD_MARGIN = 1.0
# crewmate_phong 600x450 64 spp against examples/crewmate_phong.png (a 64 spp
# render, mean 106.79): the mean within these bounds, the MAD as the
# unicorn's.
CREWMATE_MEAN = (105.29, 108.29)
# crewmate_phong 16 spp under K4 against K2, same seed: equal on this share
# of pixels (a tie or a slab rounding can send one path elsewhere; the
# draws keyed on slot and iteration keep that to the pixel).
VARIANT_PIXEL_SHARE = 0.999
# cornell_box with MIS, 600x450 64 spp, against examples/cornell_box_mis.png
# (a 64 spp render, mean 112.50): the mean within these bounds and the MAD
# below IMAGE_MAD_MAX.
MIS_MEAN = (111.0, 114.0)

# Peak rates of one H100 SXM (NVIDIA's data sheet): f32 outside the tensor
# cores, counting a fused multiply-add as two operations, and HBM3. The
# kernels are built with FMA contraction off, so every add and multiply is
# an instruction of its own; PEAK_F32_INSTR is the rate at which the card
# issues them, which bounds FMA-free code instead.
PEAK_F32_FLOPS = 67e12
PEAK_F32_INSTR = 33.5e12
PEAK_BYTES = 3.35e12

# Operations per unit of work, counted from the CUDA sources (an add, sub,
# mul, division, square root, sine, cosine, min, max or float compare is
# one; the counter hash's integer work and the loads are not counted).
# K1 (megakernel.cu): one sphere/plane/triangle test in trace or occluded;
# a camera ray's regeneration; a bounce besides its trace (hit point and
# normal, emission, Russian roulette, BSDF sample, throughput); a shadow
# ray besides its trace (the light sample, the geometry terms).
K1_OPS = dict(sphere=25, plane=21, tri=47, camera=46, bounce=130, shadow=60)
# K2 (bvh8.cu) and K4 (bvh_binary.cu): per ray (the inverse direction), per
# node visited (K2: 8 slab tests of 26; K4: one of 27), per real leaf
# triangle (K2: denom, t and the tests on t; K4: all of the test) and, for
# K2, per candidate triangle (u, v and their tests, which the search needs
# only for a t that can still win: the least work, not what the kernel,
# which computes them for every real triangle, does).
K2_OPS = dict(ray=9, node=208, tri=16, cand=30)
# K4 per ray: 3 guards and 3 divisions of the inverse direction, 3 compares
# of the octant. Per node whose box is tested: 6 subtractions, 6 products, 12
# minima and maxima, 3 compares. Per real triangle of an entered leaf (the up to three padded
# rows of its last group of four are no work): denom 5, its guard 1, n.ro 5,
# t 2, u 13, v 13, the tests 8.
K4_OPS = dict(ray=9, node=27, tri=47, cand=0)
# K3 (coherence_key.cu): per ray (inverse direction 6, miss 1, octant 3,
# Morton code 3 x 7) and per treetop-cut box (a slab test of 22 and 3
# compares).
K3_OPS = dict(ray=31, cut=25)
# The breakdown's spacer: device cycles (about 0.2 ms) queued in front of a
# timed launch, so that the launch and both its events are queued before
# the device reaches them and the device never waits for the host between
# the two events.
SPACER_CYCLES = 400_000


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def bound_ms(ops: float, nbytes: float) -> tuple[float, str, float]:
    """(least time in ms, "operations" or "bytes", the operations' time at
    the FMA-free instruction rate)."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), ops / PEAK_F32_INSTR * 1e3


def k1_work(static, lanes: int, num_samples: int, rays: int, shadow_share: float):
    """(operations, bytes) of one K1 launch: ``rays`` traced in all, a
    ``shadow_share`` of them shadow rays (counted by the twin on a band of
    the same scene), ``num_samples`` camera rays a lane."""
    ns, npl, nt = static.n_spheres, static.n_planes, static.n_tris
    trace = K1_OPS["sphere"] * ns + K1_OPS["plane"] * npl + K1_OPS["tri"] * nt
    shadow = rays * shadow_share
    bounces = rays - shadow
    ops = (lanes * num_samples * K1_OPS["camera"] + bounces * (trace + K1_OPS["bounce"])
           + shadow * (trace + K1_OPS["shadow"]))
    return ops, lanes * 16 + (20 + 5 * ns + 7 * npl + 13 * nt + 10 * static.n_objects) * 4


def walk_work(table: dict, visits: dict, n: int, table_bytes: int):
    """(operations, bytes) of one K2 or K4 launch over ``n`` rays with the
    twin's counted visits: 37 bytes a ray (origin, direction, t_init,
    resolved0 in; t, index out) and the scene's tables once."""
    ops = (n * table["ray"] + visits["nodes"] * table["node"] + visits["tris"] * table["tri"]
           + visits["cand"] * table["cand"])
    return ops, n * 37 + table_bytes


def lane_diff(kernel: torch.Tensor, twin: torch.Tensor, rtol: float):
    """(max |kernel - twin|, share of lanes beyond rtol*max(1,|twin|))."""
    d = (kernel.double() - twin.double()).abs().reshape(kernel.shape[0], -1)
    tol = rtol * twin.double().abs().clamp_min(1.0).reshape(kernel.shape[0], -1)
    return d.max().item(), (d > tol).any(dim=1).double().mean().item()


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def sorted_runs(scene, classes, widths, eps):
    """Traversal arguments of each class sorted by the coherence key, as the
    wrapper sorts them, then of the sorted bounce rays cut to each width of
    the main path. Returns ([(name, args)], the full bounce args)."""
    from raytracer_tpu_torch.ops import keys

    runs = []
    for cname, (ro, rd, t_init, res0, any_hit) in classes.items():
        order = keys.coherence_order(scene, ro, rd, eps)
        args = (scene, tuple(c[order] for c in ro), tuple(c[order] for c in rd), t_init[order],
                res0[order], any_hit, eps)
        runs.append((cname, args))
        if cname == "bounce":
            bounce = args
    runs += [(f"bounce[:{m}]", (scene, tuple(c[:m] for c in bounce[1]), tuple(c[:m] for c in bounce[2]),
                                bounce[3][:m], bounce[4][:m], False, eps)) for m in widths]
    return runs, bounce


def hold_traversal(label, kernels, twin, runs):
    """Each run through its twin once and through each kernel of
    ``kernels`` ({arm name: function}): t bit-equal on at least
    ``T_EXACT_SHARE`` of all rays, indices that differ only on ties.
    Returns the max |dt| where both hit."""
    from raytracer_tpu_torch.ops import bvh_traverse as bt

    worst, total, equal = 0.0, 0, {arm: 0 for arm in kernels}
    for cname, args in runs:
        scene, ro_s, rd_s, t_init_s, _, any_hit, _ = args
        t_t, i_t = twin(*args)
        for arm, kernel in kernels.items():
            name = f"{label}[{arm}]" if arm else label
            t_k, i_k = kernel(*args)
            torch.cuda.synchronize()
            same = t_k == t_t
            idx_diff = i_k != i_t
            ties_ok = torch.equal(bt.leaf_t(scene, ro_s, rd_s, i_k)[idx_diff],
                                  bt.leaf_t(scene, ro_s, rd_s, i_t)[idx_diff])
            both = (t_k < 1e30) & (t_t < 1e30)
            err = (t_k[both] - t_t[both]).abs().max().item() if both.any() else 0.0
            hits = int((t_k < t_init_s).sum())
            print(f"[kernel-vs-twin] {name} {scene.name} {cname} rays={t_k.numel()} any_hit={any_hit}: t bit-equal "
                  f"on {same.double().mean().item():.6%}, idx differs on {int(idx_diff.sum())} (ties: {ties_ok}), "
                  f"hits below t_init {hits}, max|dt| {err:.3g}", flush=True)
            check(ties_ok, f"{name} {scene.name} {cname}: differing indices are not ties")
            check(hits > t_k.numel() // 50, f"{name} {scene.name} {cname}: only {hits} hits")
            worst = max(worst, err)
            equal[arm] += int(same.sum())
        total += t_t.numel()
    for arm, eq in equal.items():
        check(eq >= bt.T_EXACT_SHARE * total,
              f"{label}[{arm}] t bit-equal on {eq}/{total} rays, below {bt.T_EXACT_SHARE}")
    return worst


# What the redesigned kernels keep of their design steps (the kernels line's
# "redesigned"; each step and its alternatives are timed by
# ``raytracer_tpu_torch/tools/kernel_steps.py``). Stated here, not read from
# a document, so the script needs nothing of the checkout but the program.
REDESIGNED = {
    "K1": "all bands of a frame in one launch; material rows in shared memory; __launch_bounds__(128, 8)",
    "K2": "real leaf triangles only; a triangle's rows loaded together; nodes through the read-only cache",
    "K3": "cut count at compile time for the loader's 32 boxes, eight cuts a loop turn (run-time count "
          "otherwise); one ray a thread",
    "K4": "per-octant node layouts, near child first; a lane walks on to a leaf before it tests rows; 32-byte "
          "nodes; leaf rows four at a time",
}


def with_variant(variant: str, fn):
    """``fn()`` with ``RT_BVH_KERNEL`` set to ``variant``, restored after."""
    saved = os.environ.get("RT_BVH_KERNEL")
    os.environ["RT_BVH_KERNEL"] = variant
    try:
        return fn()
    finally:
        if saved is None:
            os.environ.pop("RT_BVH_KERNEL", None)
        else:
            os.environ["RT_BVH_KERNEL"] = saved


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.loader import load_scene
    from raytracer_tpu_torch.ops import _build
    from raytracer_tpu_torch.ops import bvh_binary as bb
    from raytracer_tpu_torch.ops import bvh_traverse as bt
    from raytracer_tpu_torch.ops import keys
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops.intersect import scene_precompute
    from raytracer_tpu_torch.render.renderer import Renderer
    from raytracer_tpu_torch.server.app import RenderJob, Server
    from raytracer_tpu_torch.server.wire import parse_chunk, parse_chunks
    from raytracer_tpu_torch.tools.kernel_steps import SPACER_CYCLES as RUN_SPACER
    from raytracer_tpu_torch.tools.kernel_steps import card, event_ms, ptxas_lines, scene_rays
    from raytracer_tpu_torch.utils.png import read_png

    def zero_counts() -> None:
        mk.LAUNCHES = keys.LAUNCHES = bt.LAUNCHES = bb.LAUNCHES = 0

    # 1) card
    smi = card()
    name = torch.cuda.get_device_name(0)
    print(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {name}", flush=True)

    # 2) build all four sources at once
    t0 = time.perf_counter()
    sources = ("megakernel", "bvh8", "coherence_key", "bvh_binary")
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = list(pool.map(_build.build, sources))
    print(f"[build] {len(built)} libraries in {time.perf_counter() - t0:.2f} s", flush=True)
    for src, (lib, log) in zip(sources, built):
        print(f"[build] {lib}\n{log.strip()}", flush=True)
        for line in ptxas_lines(log) or ["built before this run: no ptxas output"]:
            print(f"[ptxas] {src}: {line}", flush=True)

    cfg = RenderConfig()
    w = cfg.width
    scenes = {s: load_scene(os.path.join(ROOT, "scenes", f"{s}.toml"), device="cuda") for s in SCENES}

    # 3) K1 against its twin on the card: one 50-row band, 8 samples, same
    # seed; the twin also counts the band's camera, bounce and shadow rays.
    rows, ns, seed, y0 = 50, 8, 20261016, 200
    n = rows * w * 4
    max_err = 0.0
    shadow_share = {}
    for s in SCENES:
        pf, static = mk.pack_params(scenes[s], cfg)
        acc_k, rays_k = mk.mega_cuda(pf, static, y0, ns, n, seed, "cuda")
        counts: dict = {}
        acc_t, rays_t = mk.mega_twin(pf, static, y0, ns, n, seed, "cuda", counts=counts)
        torch.cuda.synchronize()
        err, bad = lane_diff(acc_k, acc_t, mk.LANE_RTOL)
        _, bad_rays = lane_diff(rays_k, rays_t, 0.0)
        mean_k, mean_t = acc_k.mean().item(), acc_t.mean().item()
        print(
            f"[kernel-vs-twin] K1 {s} W={w} rows={rows} samples={ns}: max|d|={err:.3g} "
            f"lanes beyond {mk.LANE_RTOL:g}: {bad:.4%} (ray counts differ on {bad_rays:.4%}) "
            f"band mean kernel={mean_k:.7f} twin={mean_t:.7f} "
            f"rays kernel={int(rays_k.sum())} twin={int(rays_t.sum())}",
            flush=True,
        )
        check(torch.isfinite(acc_k).all().item(), f"{s}: kernel sums not finite")
        check(1.0 - bad >= mk.LANE_SHARE, f"{s}: {bad:.4%} of lanes beyond tolerance")
        check(1.0 - bad_rays >= mk.LANE_SHARE, f"{s}: ray counts differ on {bad_rays:.4%} of lanes")
        check(abs(mean_k - mean_t) <= mk.BAND_RTOL * abs(mean_t), f"{s}: band means differ")
        max_err = max(max_err, err)
        shadow_share[s] = counts["shadow"] / (counts["bounces"] + counts["shadow"])
        print(f"[count] K1 {s} band (twin): {counts['samples']} camera rays, {counts['bounces']} bounces, "
              f"{counts['shadow']} shadow rays (shadow share {shadow_share[s]:.4f})", flush=True)
        # The frame's bands in one launch (the main path's form) against the
        # same bands launched one by one.
        rows_f = Renderer(scenes[s], cfg, device="cuda").plan(4 * ns)[0]
        n_f = rows_f * w * 4
        bands = [(yy, mk.band_seed(cfg.seed, yy, 0)) for yy in range(0, cfg.height, rows_f)]
        acc_f, rays_f = mk.mega_cuda_bands(pf, static, bands, ns, n_f, "cuda")
        one = [mk.mega_cuda(pf, static, yy, ns, n_f, sd, "cuda") for yy, sd in bands]
        same_bands = torch.equal(acc_f, torch.cat([o[0] for o in one])) and torch.equal(
            rays_f, torch.cat([o[1] for o in one]))
        print(f"[kernel-vs-kernel] K1 {s}: one launch of {len(bands)} bands x {n_f} lanes, {ns} samples, "
              f"equal to {len(bands)} one-band launches on every lane: {same_bands}", flush=True)
        check(same_bands, f"{s}: the all-bands launch differs from the one-band launches")

    # 4) K3 and K2 against their twins on flying_unicorn rays
    t0 = time.perf_counter()
    uni = load_scene(os.path.join(ROOT, "scenes", "flying_unicorn.toml"), device="cuda")
    uni_pre = scene_precompute(uni)
    print(f"[load] flying_unicorn: {uni.n_triangles} triangle slots, {uni.bvh8_nodes_flat.shape[0]} "
          f"wide nodes, stack {uni.bvh8_max_stack}, in {time.perf_counter() - t0:.2f} s", flush=True)
    # Every lane of the frame in each class: the sizes the main and shadow
    # traces give K2 and K3 on the first loop iteration.
    n_frame = cfg.width * cfg.height * 4
    cam, classes = scene_rays(uni, uni_pre, cfg, n_frame)
    key_err = 0
    for cname, (ro, rd) in [("camera", cam)] + [(c, v[:2]) for c, v in classes.items()]:
        k_k = keys.coherence_key_cuda(uni, ro, rd, cfg.eps)
        k_t = keys.coherence_key_twin(uni, ro, rd, cfg.eps)
        torch.cuda.synchronize()
        n_diff = int((k_k != k_t).sum())
        key_err = max(key_err, int((k_k.long() - k_t.long()).abs().max()))
        print(f"[kernel-vs-twin] K3 {cname} rays={k_k.numel()}: keys differ on {n_diff} "
              f"(misses {int((k_k >> 30).sum())})", flush=True)
        check(n_diff == 0, f"K3 differs from its twin on {n_diff} {cname} rays")
    # A tree with fewer inner nodes gets a shorter cut, which the kernel takes
    # with its cut count at run time: the unicorn's first 20 boxes.
    short = dataclasses.replace(uni, bvh_cut_lo=uni.bvh_cut_lo[:20].contiguous(),
                                bvh_cut_hi=uni.bvh_cut_hi[:20].contiguous())
    ro, rd = classes["bounce"][:2]
    n_diff = int((keys.coherence_key_cuda(short, ro, rd, cfg.eps)
                  != keys.coherence_key_twin(short, ro, rd, cfg.eps)).sum())
    print(f"[kernel-vs-twin] K3 bounce rays={ro[0].numel()}, 20 cut boxes (run-time count): keys differ on "
          f"{n_diff}", flush=True)
    check(n_diff == 0, f"K3 with 20 cut boxes differs from its twin on {n_diff} rays")
    # K2 on each class at the frame's width, then on the bounce class at the
    # other widths of the main path: the tail-compaction stages of the frame,
    # and a served delivery band with its own stages.
    from raytracer_tpu_torch.render.wavefront import tail_widths

    rows_b = Renderer(uni, cfg, device="cuda").plan_delivery(16)[0]
    n_band = rows_b * cfg.width * 4
    widths = sorted(set(tail_widths(n_frame, cfg, True) + [n_band] + tail_widths(n_band, cfg, True)),
                    reverse=True)
    uni_runs, bounce_args = sorted_runs(uni, classes, widths, cfg.eps)
    k2_err = hold_traversal("K2", {"": bt.bvh_traverse_cuda}, bt.bvh_traverse_twin, uni_runs)

    # 4b) K4 against its twin on crewmate_phong and flying_unicorn rays, the
    # same classes and widths; and against K2 on the nearest-hit classes
    # (both are exact searches with the same t expression).
    t0 = time.perf_counter()
    crew = load_scene(os.path.join(ROOT, "scenes", "crewmate_phong.toml"), device="cuda")
    crew_pre = scene_precompute(crew)
    print(f"[load] crewmate_phong: {crew.n_triangles} triangle slots, {crew.bvh_binary_nodes8.shape[0]} "
          f"binary nodes ({int((crew.bvh_count > 0).sum())} leaves), {crew.bvh8_nodes_flat.shape[0]} wide "
          f"nodes, in {time.perf_counter() - t0:.2f} s", flush=True)
    _, crew_classes = scene_rays(crew, crew_pre, cfg, n_frame)
    crew_runs, crew_bounce = sorted_runs(crew, crew_classes, widths, cfg.eps)
    k2_err = max(k2_err, hold_traversal("K2", {"": bt.bvh_traverse_cuda}, bt.bvh_traverse_twin, crew_runs))
    k4_err = 0.0
    for runs in (crew_runs, uni_runs):
        k4_err = max(k4_err, hold_traversal("K4", {"": bb.bvh_binary_cuda}, bb.bvh_binary_twin, runs))
        for cname, args in runs[:3]:  # camera, bounce, shadow: nearest hits
            t4, _ = bb.bvh_binary_cuda(*args)
            t2, _ = bt.bvh_traverse_cuda(*args)
            same = (t4 == t2).double().mean().item()
            print(f"[K4-vs-K2] {args[0].name} {cname} rays={t4.numel()}: t bit-equal on {same:.6%}", flush=True)
            check(same >= bt.T_EXACT_SHARE, f"K4 and K2 differ on {args[0].name} {cname}")

    # 4c) the visits the walks need on the frame's sorted bounce rays,
    # counted by the twins (the bounds of K2 and K4 below rest on them)
    visits = {}
    for sname, args in (("flying_unicorn", bounce_args), ("crewmate_phong", crew_bounce)):
        n_r = args[1][0].numel()
        for kname, twin in (("K2", bt.bvh_traverse_twin), ("K4", bb.bvh_binary_twin)):
            v: dict = {}
            twin(*args, visits=v)
            visits[kname, sname] = v
            print(f"[visits] {kname} {sname} {n_r} sorted bounce rays (twin): per ray {v['nodes'] / n_r:.4f} "
                  f"nodes, {v['leaves'] / n_r:.4f} leaves, {v['tris'] / n_r:.3f} real leaf triangles, "
                  f"{v['cand'] / n_r:.3f} candidates (t could still win)", flush=True)

    # 5) the megakernel path, offline (counts from here to the end of phase 6)
    zero_counts()
    k1_per_frame = {}
    for s in SCENES:
        before = mk.LAUNCHES
        r = Renderer(scenes[s], RenderConfig(), device="cuda")
        check(r.engine == "mega", f"{s}: select_band_engine gave {r.engine!r}")
        t0 = time.perf_counter()
        img = r.render_image(64)
        wall = time.perf_counter() - t0
        ref = read_png(os.path.join(ROOT, "examples", f"{s}.png")).astype(np.float64)
        mean = float(img.mean())
        mad = float(np.abs(img.astype(np.float64) - ref).mean())
        rays = r.rays_traced()
        print(
            f"[render] {s} 600x450 64spp engine={r.engine} launches={mk.LAUNCHES - before} "
            f"mean={mean:.3f} (ref {ref.mean():.3f}) MAD={mad:.3f} wall={wall:.4f} s "
            f"rays={rays} {rays / wall / 1e6:.1f} Mrays/s | {smi}",
            flush=True,
        )
        lo, hi = IMAGE_MEAN[s]
        check(img.shape == (450, 600, 3) and img.dtype == np.uint8, f"{s}: image {img.shape}")
        k1_per_frame[s] = mk.LAUNCHES - before
        check(k1_per_frame[s] == 1, f"{s}: the frame took {k1_per_frame[s]} K1 launches, not one")
        check(lo <= mean <= hi, f"{s}: image mean {mean:.3f} outside [{lo}, {hi}]")
        check(mad < IMAGE_MAD_MAX, f"{s}: MAD {mad:.3f} >= {IMAGE_MAD_MAX}")

    # 6) the megakernel path, served: RenderJob.run with a capturing send
    server = Server(scenes, device="cuda")
    for s, progressive in (("cornell_box", False), ("cornell_box", True), ("cubes", False)):
        msgs: list = []
        first = []

        async def send(m, msgs=msgs, first=first) -> None:
            if not first:
                first.append(time.perf_counter())
            msgs.append(m)

        job = RenderJob(send=send)
        renderer = server.renderer_for(s, server.width, server.height)
        job.mark_running()
        t0 = time.perf_counter()
        stopped = asyncio.run(job.run(renderer, 16, progressive=progressive))
        wall = time.perf_counter() - t0
        check(not stopped, f"{s}: served render stopped early")
        chunks = [parse_chunk(m) for m in msgs]
        check(len(chunks) > 0 and len(chunks) % 4500 == 0, f"{s}: {len(chunks)} chunks, not whole frames")
        frames = len(chunks) // 4500
        last = np.zeros((450, 600, 3), np.uint8)
        for f in range(frames):
            seen = np.zeros((450, 600), np.int32)
            for mtype, x, y, rgb in chunks[f * 4500 : (f + 1) * 4500]:
                check(mtype == 0 and rgb.shape == (60, 3) and x % 60 == 0, f"{s}: bad chunk at {x},{y}")
                seen[y, x : x + 60] += 1
                last[y, x : x + 60] = rgb
            check((seen == 1).all(), f"{s}: frame {f} does not cover every pixel exactly once")
        if not progressive:
            same = Renderer(scenes[s], RenderConfig(), device="cuda").render_image(16)
            check(np.array_equal(last, same), f"{s}: served frame differs from render_image(16)")
        print(
            f"[serve] {s} 600x450 16spp progressive={progressive}: {frames} frame(s) x 4500 "
            f"chunks, first chunk {first[0] - t0:.4f} s, total {wall:.4f} s, "
            f"{wall / frames:.4f} s/pass, rays={job.stats.rays}, image mean {last.mean():.3f} | {smi}",
            flush=True,
        )
    launches = {"K1": mk.LAUNCHES, "K2": bt.LAUNCHES, "K3": keys.LAUNCHES}
    print(f"[launches] megakernel path: {launches}", flush=True)
    check(launches["K1"] > 0, "the megakernel path did not launch K1")

    # 7) the BVH path, offline: flying_unicorn 600x450 16 spp, seeds 0 and 1
    zero_counts()
    ref = read_png(os.path.join(ROOT, "examples", "flying_unicorn.png")).astype(np.float64)
    imgs = {}
    for sd in (0, 1):
        r = Renderer(uni, RenderConfig(seed=sd), device="cuda")
        check(r.engine == "regen", f"flying_unicorn: select_band_engine gave {r.engine!r}")
        check(r.plan(16) == (450, 1, 4), f"flying_unicorn: plan {r.plan(16)}")
        t0 = time.perf_counter()
        imgs[sd] = img = r.render_image(16)
        wall = time.perf_counter() - t0
        rays = r.rays_traced()
        mean = float(img.mean())
        mad = float(np.abs(img.astype(np.float64) - ref).mean())
        print(
            f"[render] flying_unicorn 600x450 16spp seed={sd} engine={r.engine} "
            f"K2 launches={bt.LAUNCHES} K3 launches={keys.LAUNCHES} mean={mean:.3f} "
            f"(ref {ref.mean():.3f}) MAD={mad:.3f} wall={wall:.4f} s rays={rays} "
            f"{rays / wall / 1e6:.2f} Mrays/s | {smi}",
            flush=True,
        )
        check(img.shape == (450, 600, 3) and np.isfinite(img).all(), "flying_unicorn: bad image")
    unicorn_wall, unicorn_rays_n = wall, rays
    mean0 = float(imgs[0].mean())
    mad0 = float(np.abs(imgs[0].astype(np.float64) - ref).mean())
    mad01 = float(np.abs(imgs[0].astype(np.float64) - imgs[1].astype(np.float64)).mean())
    print(f"[render] flying_unicorn MAD(seed 0, seed 1) = {mad01:.3f}; MAD(seed 0, ref) = {mad0:.3f}", flush=True)
    check(UNICORN_MEAN[0] <= mean0 <= UNICORN_MEAN[1], f"flying_unicorn mean {mean0:.3f} outside {UNICORN_MEAN}")
    check(mad0 <= mad01 + UNICORN_MAD_MARGIN, f"flying_unicorn MAD {mad0:.3f} > {mad01:.3f} + {UNICORN_MAD_MARGIN}")

    # 8) the BVH path, served: batched transport, 16 spp, whole frame once
    msgs, first = [], []

    async def send_u(m) -> None:
        if not first:
            first.append(time.perf_counter())
        msgs.append(m)

    userver = Server({"flying_unicorn": uni}, device="cuda")
    renderer = userver.renderer_for("flying_unicorn", 600, 450)
    rows_b = renderer.plan_delivery(16)[0]
    job = RenderJob(send=send_u)
    job.mark_running()
    t0 = time.perf_counter()
    stopped = asyncio.run(job.run(renderer, 16, batch=True))
    wall = time.perf_counter() - t0
    check(not stopped, "flying_unicorn: served render stopped early")
    served = np.zeros((450, 600, 3), np.uint8)
    seen = np.zeros((450, 600), np.int32)
    n_chunks = 0
    for m in msgs:
        for mtype, x, y, rgb in parse_chunks(m):
            check(mtype == 0 and rgb.shape == (60, 3), f"flying_unicorn: bad chunk at {x},{y}")
            seen[y, x : x + 60] += 1
            served[y, x : x + 60] = rgb
            n_chunks += 1
    check(n_chunks == 4500 and (seen == 1).all(), "flying_unicorn: served frame not whole")
    check(450 // rows_b >= 4 and len(msgs) >= 4, f"flying_unicorn: {len(msgs)} deliveries of {rows_b} rows")
    check(np.array_equal(served, imgs[0]), "flying_unicorn: served frame differs from render_image(16)")
    print(
        f"[serve] flying_unicorn 600x450 16spp batch: {len(msgs)} messages, {450 // rows_b} bands of "
        f"{rows_b} rows, 4500 chunks, first chunk {first[0] - t0:.4f} s, total {wall:.4f} s/pass, "
        f"rays={job.stats.rays}, equal to render_image(16) | {smi}",
        flush=True,
    )
    launches.update(K2=bt.LAUNCHES, K3=keys.LAUNCHES)
    print(f"[launches] BVH path: K2={launches['K2']} K3={launches['K3']}", flush=True)
    check(launches["K2"] > 0 and launches["K3"] > 0, "the BVH path did not launch K2 and K3")

    # 9) the Phong/MIS path: crewmate_phong offline at 64 spp (default
    # traversal), at 16 spp under each traversal variant, offline and
    # served, then cornell_box with MIS (counts from here to the end of 9)
    zero_counts()
    ref = read_png(os.path.join(ROOT, "examples", "crewmate_phong.png")).astype(np.float64)
    imgs = {}
    for sd in (0, 1):
        r = Renderer(crew, RenderConfig(seed=sd), device="cuda")
        check(r.engine == "regen", f"crewmate_phong: select_band_engine gave {r.engine!r}")
        t0 = time.perf_counter()
        imgs[sd] = img = r.render_image(64)
        wall = time.perf_counter() - t0
        rays = r.rays_traced()
        print(f"[render] crewmate_phong 600x450 64spp seed={sd} engine={r.engine} mean={img.mean():.3f} "
              f"(ref {ref.mean():.3f}) MAD={np.abs(img - ref).mean():.3f} wall={wall:.4f} s rays={rays} "
              f"{rays / wall / 1e6:.2f} Mrays/s | {smi}", flush=True)
        check(img.shape == (450, 600, 3), "crewmate_phong: bad image")
    mean0 = float(imgs[0].mean())
    mad0 = float(np.abs(imgs[0] - ref).mean())
    mad01 = float(np.abs(imgs[0].astype(np.float64) - imgs[1]).mean())
    print(f"[render] crewmate_phong MAD(seed 0, seed 1) = {mad01:.3f}; MAD(seed 0, ref) = {mad0:.3f}", flush=True)
    check(CREWMATE_MEAN[0] <= mean0 <= CREWMATE_MEAN[1], f"crewmate_phong mean {mean0:.3f} outside {CREWMATE_MEAN}")
    check(mad0 <= mad01 + UNICORN_MAD_MARGIN, f"crewmate_phong MAD {mad0:.3f} > {mad01:.3f} + {UNICORN_MAD_MARGIN}")

    # Under each variant: render_image(16), then the same frame served with
    # the batched transport, which must equal it.
    cserver = Server({"crewmate_phong": crew}, device="cuda")

    def render_and_serve():
        t0 = time.perf_counter()
        img = Renderer(crew, RenderConfig(), device="cuda").render_image(16)
        wall = time.perf_counter() - t0
        msgs = []

        async def send_c(m) -> None:
            msgs.append(m)

        job = RenderJob(send=send_c)
        job.mark_running()
        t0 = time.perf_counter()
        stopped = asyncio.run(job.run(cserver.renderer_for("crewmate_phong", 600, 450), 16, batch=True))
        check(not stopped, "crewmate_phong: served render stopped early")
        return img, wall, msgs, time.perf_counter() - t0

    variant_imgs, variant_launches = {}, {}
    for variant in ("widesmem", "binary"):
        k2_0, k4_0 = bt.LAUNCHES, bb.LAUNCHES
        img, wall, msgs, served_wall = with_variant(variant, render_and_serve)
        variant_launches[variant] = (bt.LAUNCHES - k2_0, bb.LAUNCHES - k4_0)
        variant_imgs[variant] = img
        served = np.zeros((450, 600, 3), np.uint8)
        seen = np.zeros((450, 600), np.int32)
        for m in msgs:
            for mtype, x, y, rgb in parse_chunks(m):
                check(mtype == 0 and rgb.shape == (60, 3), f"crewmate_phong: bad chunk at {x},{y}")
                seen[y, x : x + 60] += 1
                served[y, x : x + 60] = rgb
        check((seen == 1).all(), f"crewmate_phong {variant}: served frame not whole")
        check(np.array_equal(served, img), f"crewmate_phong {variant}: served frame differs from render_image(16)")
        print(f"[render] crewmate_phong 600x450 16spp RT_BVH_KERNEL={variant}: mean={img.mean():.3f} "
              f"wall={wall:.4f} s; served {len(msgs)} messages, {served_wall:.4f} s/pass, equal to "
              f"render_image(16); launches K2={variant_launches[variant][0]} K4={variant_launches[variant][1]} "
              f"| {smi}", flush=True)
    k2_n, k4_n = variant_launches["binary"]
    check(k4_n > 0 and k2_n == 0, f"RT_BVH_KERNEL=binary launched K2 {k2_n} and K4 {k4_n} times")
    k2_n, k4_n = variant_launches["widesmem"]
    check(k2_n > 0 and k4_n == 0, f"the default variant launched K2 {k2_n} and K4 {k4_n} times")
    same_px = float((variant_imgs["widesmem"] == variant_imgs["binary"]).all(axis=2).mean())
    print(f"[render] crewmate_phong 16spp: the K4 image equals the K2 image on {same_px:.6%} of pixels", flush=True)
    check(same_px >= VARIANT_PIXEL_SHARE, f"K4 and K2 images equal on {same_px:.4%} of pixels only")

    ref = read_png(os.path.join(ROOT, "examples", "cornell_box_mis.png")).astype(np.float64)
    r = Renderer(scenes["cornell_box"], RenderConfig(use_mis=True), device="cuda")
    check(r.engine == "regen", f"cornell_box MIS: select_band_engine gave {r.engine!r}")
    t0 = time.perf_counter()
    img = r.render_image(64)
    wall = time.perf_counter() - t0
    mean, mad = float(img.mean()), float(np.abs(img - ref).mean())
    print(f"[render] cornell_box MIS 600x450 64spp engine={r.engine} mean={mean:.3f} (ref {ref.mean():.3f}) "
          f"MAD={mad:.3f} wall={wall:.4f} s | {smi}", flush=True)
    check(img.shape == (450, 600, 3), "cornell_box MIS: bad image")
    check(MIS_MEAN[0] <= mean <= MIS_MEAN[1], f"cornell_box MIS mean {mean:.3f} outside {MIS_MEAN}")
    check(mad < IMAGE_MAD_MAX, f"cornell_box MIS MAD {mad:.3f} >= {IMAGE_MAD_MAX}")
    path3 = {"K2": bt.LAUNCHES, "K3": keys.LAUNCHES, "K4": bb.LAUNCHES}
    print(f"[launches] Phong/MIS path: {path3}", flush=True)
    check(min(path3.values()) > 0, "the Phong/MIS path did not launch K2, K3 and K4")
    launches["K4"] = path3["K4"]

    # 10) times. K1: the main path's launch (a whole 600x450 frame, 1.08M
    # lanes) at 64 spp beside its twin, and at 256 spp (the headline frame);
    # a 50-row band at 16 samples (the launch of the served path) beside its
    # twin.
    pf, static = mk.pack_params(scenes["cornell_box"], cfg)
    band_ms = event_ms(lambda: mk.mega_cuda(pf, static, y0, 16, n, seed, "cuda"), 20)
    band_twin_ms = wall_ms(lambda: mk.mega_twin(pf, static, y0, 16, n, seed, "cuda"))
    print(f"[time] K1 cornell band 600x50 16 samples: kernel {band_ms:.4f} ms, twin {band_twin_ms:.1f} ms | {smi}")
    r = Renderer(scenes["cornell_box"], cfg, device="cuda")
    rows_f = r.plan(256)[0]
    n_f = rows_f * w * 4
    bands = [(yy, mk.band_seed(cfg.seed, yy, 0)) for yy in range(0, cfg.height, rows_f)]
    lanes_f = len(bands) * n_f

    def k1_frame(samples):
        return mk.mega_cuda_bands(pf, static, bands, samples, n_f, "cuda")

    kernel_ms = event_ms(lambda: k1_frame(16), 5)
    twin_ms = wall_ms(lambda: [mk.mega_twin(pf, static, yy, 16, n_f, sd, "cuda") for yy, sd in bands])
    k1_rays = int(k1_frame(16)[1].sum())
    k1_ops, k1_bytes = k1_work(static, lanes_f, 16, k1_rays, shadow_share["cornell_box"])
    k1_bound, k1_by, k1_instr = bound_ms(k1_ops, k1_bytes)
    print(f"[time] K1 cornell_box 64spp frame (one launch: {len(bands)} bands, {lanes_f} lanes, 16 samples): kernel "
          f"{kernel_ms:.4f} ms, twin {twin_ms:.1f} ms; {k1_rays} rays, {k1_ops:.4g} operations, {k1_bytes} bytes: "
          f"bound {k1_bound:.4f} ms ({k1_by}; {k1_instr:.4f} ms at the FMA-free instruction rate), "
          f"{k1_bound / kernel_ms:.2%} of it reached | {smi}", flush=True)
    t256 = event_ms(lambda: k1_frame(64), 3)
    k1_256_rays = int(k1_frame(64)[1].sum())
    ops256, bytes256 = k1_work(static, lanes_f, 64, k1_256_rays, shadow_share["cornell_box"])
    b256, by256, instr256 = bound_ms(ops256, bytes256)
    print(f"[time] K1 cornell_box 256spp frame (one launch, 64 samples): kernel {t256:.4f} ms; {k1_256_rays} "
          f"rays, bound {b256:.4f} ms ({by256}; {instr256:.4f} ms at the FMA-free instruction rate), "
          f"{b256 / t256:.2%} of it reached | {smi}", flush=True)
    # K3 on the frame's camera rays, K2 on its coherence-sorted bounce rays.
    # A K3 launch is shorter than its wrapper's host time, so its 20 launches
    # are queued behind a spacer: the events time the kernel, not the host.
    k3_ms = event_ms(lambda: keys.coherence_key_cuda(uni, cam[0], cam[1], cfg.eps), 20, RUN_SPACER)
    k3_twin_ms = wall_ms(lambda: keys.coherence_key_twin(uni, cam[0], cam[1], cfg.eps))
    n_cam = cam[0][0].numel()
    n_cut = uni.bvh_cut_lo.shape[0]
    k3_bound, k3_by, _ = bound_ms(n_cam * (K3_OPS["ray"] + n_cut * K3_OPS["cut"]), n_cam * 28 + (n_cut + 1) * 24)
    print(f"[time] K3 {n_cam} camera rays: kernel {k3_ms:.4f} ms (queued behind a spacer), twin {k3_twin_ms:.2f} ms; per 1M rays "
          f"{k3_ms * 1e6 / n_cam:.4f} / {k3_twin_ms * 1e6 / n_cam:.2f} ms; bound {k3_bound:.4f} ms ({k3_by}), "
          f"{k3_bound / k3_ms:.2%} of it reached | {smi}", flush=True)
    k2_ms = event_ms(lambda: bt.bvh_traverse_cuda(*bounce_args), 10)
    k2_twin_ms = wall_ms(lambda: bt.bvh_traverse_twin(*bounce_args))
    table_bytes = lambda sc, nodes: nodes.numel() * 4 + sc.bvh_leaf_tris.numel() * 4  # noqa: E731
    k2_ops, k2_bytes = walk_work(K2_OPS, visits["K2", "flying_unicorn"], n_frame,
                                 table_bytes(uni, uni.bvh8_nodes_flat))
    k2_bound, k2_by, k2_instr = bound_ms(k2_ops, k2_bytes)
    print(f"[time] K2 {n_frame} sorted unicorn bounce rays: kernel {k2_ms:.4f} ms, twin {k2_twin_ms:.2f} ms; per 1M "
          f"rays {k2_ms * 1e6 / n_frame:.4f} / {k2_twin_ms * 1e6 / n_frame:.2f} ms; {k2_ops:.4g} operations, "
          f"{k2_bytes} bytes: bound {k2_bound:.4f} ms ({k2_by}; {k2_instr:.4f} ms at the FMA-free instruction rate), "
          f"{k2_bound / k2_ms:.2%} of it reached | {smi}", flush=True)
    # K4 on the frame's sorted crewmate bounce rays beside K2 on the same
    # rays, and on the unicorn's.
    k4_ms = event_ms(lambda: bb.bvh_binary_cuda(*crew_bounce), 10)
    k4_twin_ms = wall_ms(lambda: bb.bvh_binary_twin(*crew_bounce))
    k2_crew_ms = event_ms(lambda: bt.bvh_traverse_cuda(*crew_bounce), 10)
    k4_uni_ms = event_ms(lambda: bb.bvh_binary_cuda(*bounce_args), 10)
    k4_ops, k4_bytes = walk_work(K4_OPS, visits["K4", "crewmate_phong"], n_frame,
                                 table_bytes(crew, crew.bvh_octant_nodes))
    k4_bound, k4_by, k4_instr = bound_ms(k4_ops, k4_bytes)
    k2c_bound = bound_ms(*walk_work(K2_OPS, visits["K2", "crewmate_phong"], n_frame,
                                    table_bytes(crew, crew.bvh8_nodes_flat)))[0]
    k4u_bound = bound_ms(*walk_work(K4_OPS, visits["K4", "flying_unicorn"], n_frame,
                                    table_bytes(uni, uni.bvh_octant_nodes)))[0]
    print(f"[time] K4 {n_frame} sorted crewmate bounce rays: kernel {k4_ms:.4f} ms, twin {k4_twin_ms:.2f} ms, "
          f"K2 {k2_crew_ms:.4f} ms; per 1M rays {k4_ms * 1e6 / n_frame:.4f} / {k4_twin_ms * 1e6 / n_frame:.2f} / "
          f"{k2_crew_ms * 1e6 / n_frame:.4f} ms; bound K4 {k4_bound:.4f} ms ({k4_by}; {k4_instr:.4f} ms FMA-free), "
          f"K2 {k2c_bound:.4f} ms | {smi}", flush=True)
    print(f"[time] K4 {n_frame} sorted unicorn bounce rays: kernel {k4_uni_ms:.4f} ms, K2 {k2_ms:.4f} ms; per 1M "
          f"rays {k4_uni_ms * 1e6 / n_frame:.4f} / {k2_ms * 1e6 / n_frame:.4f} ms; bound K4 {k4u_bound:.4f} ms "
          f"| {smi}", flush=True)
    for s in SCENES:
        r = Renderer(scenes[s], RenderConfig(), device="cuda")
        for spp in (64, 256):
            r.ray_counts.clear()
            t0 = time.perf_counter()
            r.render_image(spp)
            wall = time.perf_counter() - t0
            rays = r.rays_traced()
            print(f"[time] {s} 600x450 {spp}spp: {wall:.4f} s, {rays / wall / 1e6:.1f} Mrays/s | {smi}",
                  flush=True)
    # Where the time goes: one plain render for the wall, then one with every
    # traversal (K2 or K4) and K3 launch timed by CUDA events recorded
    # directly before and after it, behind a spacer (SPACER_CYCLES): the
    # kernels' own durations. The rest of the wall is glue.
    def breakdown(scene, spp, label):
        spent = {"trav": [], "K3": []}

        def timed(launch, bucket):
            def run(*a):
                torch.cuda._sleep(SPACER_CYCLES)
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                rc = launch(*a)
                e1.record()
                spent[bucket].append((e0, e1))
                return rc
            return run

        def render():
            r = Renderer(scene, RenderConfig(), device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render_image(spp)
            torch.cuda.synchronize()
            return r, (time.perf_counter() - t0) * 1e3

        r, wall = render()
        real = (bt._lib, bb._launch_fn, keys._launch_fn)
        k2_lib = types.SimpleNamespace(rt_bvh8_launch=timed(real[0]().rt_bvh8_launch, "trav"))
        k4_fn, k3_fn = timed(real[1](), "trav"), timed(real[2](), "K3")
        bt._lib, bb._launch_fn, keys._launch_fn = (lambda: k2_lib), (lambda: k4_fn), (lambda: k3_fn)
        try:
            render()
        finally:
            bt._lib, bb._launch_fn, keys._launch_fn = real
        trav = sum(a.elapsed_time(b) for a, b in spent["trav"])
        k3 = sum(a.elapsed_time(b) for a, b in spent["K3"])
        rays = r.rays_traced()
        print(f"[time] {label} 600x450 {spp}spp: {wall / 1e3:.4f} s, {rays / wall / 1e3:.2f} Mrays/s; breakdown "
              f"wall {wall:.1f} ms = traversal kernels {trav:.1f} ms ({len(spent['trav'])} launches) + K3 kernels "
              f"{k3:.1f} ms ({len(spent['K3'])} launches) + glue {wall - trav - k3:.1f} ms (kernel times: events "
              f"directly around each launch of a second render) | {smi}", flush=True)
        return len(spent["trav"]), len(spent["K3"])

    per_frame = {"K1": k1_per_frame["cornell_box"]}
    per_frame["K2"], per_frame["K3"] = breakdown(uni, 16, "flying_unicorn (K2)")
    print(f"[time] flying_unicorn 600x450 16spp: {unicorn_wall:.4f} s, "
          f"{unicorn_rays_n / unicorn_wall / 1e6:.2f} Mrays/s | {smi}", flush=True)
    for variant, label in (("widesmem", "K2"), ("binary", "K4")):
        n_trav, _ = with_variant(variant, lambda: breakdown(crew, 16, f"crewmate_phong ({label})"))
    per_frame["K4"] = n_trav
    r = Renderer(scenes["cornell_box"], RenderConfig(use_mis=True), device="cuda")
    t0 = time.perf_counter()
    r.render_image(256)
    wall = time.perf_counter() - t0
    rays = r.rays_traced()
    print(f"[time] cornell_box MIS 600x450 256spp (regen): {wall:.4f} s, {rays / wall / 1e6:.1f} Mrays/s | {smi}",
          flush=True)

    none = "no single PyTorch call computes this function"
    print(json.dumps({"kernels": [
        {
            "name": "mega_kernel", "route": "cuda",
            "source": "raytracer_tpu_torch/ops/csrc/megakernel.cu",
            "replaces": "raytracer_tpu/ops/pallas/megakernel.py:96",
            "launches": launches["K1"], "max_abs_err": max_err,
            "ms": kernel_ms, "plain_ms": twin_ms, "bound_ms": k1_bound, "bound_by": k1_by,
            "library_ms": None, "library": none, "launches_per_frame": per_frame["K1"],
            "redesigned": REDESIGNED["K1"],
        },
        {
            "name": "bvh8_kernel", "route": "cuda",
            "source": "raytracer_tpu_torch/ops/csrc/bvh8.cu",
            "replaces": "raytracer_tpu/ops/pallas/bvh_kernel.py:159",
            "launches": launches["K2"], "max_abs_err": k2_err,
            "ms": k2_ms, "plain_ms": k2_twin_ms, "bound_ms": k2_bound, "bound_by": k2_by,
            "library_ms": None, "library": none, "launches_per_frame": per_frame["K2"],
            "redesigned": REDESIGNED["K2"],
        },
        {
            "name": "key_kernel", "route": "cuda",
            "source": "raytracer_tpu_torch/ops/csrc/coherence_key.cu",
            "replaces": "raytracer_tpu/ops/pallas/key_kernel.py:41",
            "launches": launches["K3"], "max_abs_err": key_err,
            "ms": k3_ms, "plain_ms": k3_twin_ms, "bound_ms": k3_bound, "bound_by": k3_by,
            "library_ms": None, "library": none, "launches_per_frame": per_frame["K3"],
            "redesigned": REDESIGNED["K3"],
        },
        {
            "name": "bvh_binary_kernel", "route": "cuda",
            "source": "raytracer_tpu_torch/ops/csrc/bvh_binary.cu",
            "replaces": "raytracer_tpu/ops/pallas/bvh_kernel.py:48",
            "launches": launches["K4"], "max_abs_err": k4_err,
            "ms": k4_ms, "plain_ms": k4_twin_ms, "bound_ms": k4_bound, "bound_by": k4_by,
            "library_ms": None, "library": none, "launches_per_frame": per_frame["K4"],
            "redesigned": REDESIGNED["K4"],
        },
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
