"""Smoke test of the PyTorch + CUDA port on one GPU: ``python3 chip_smoke.py``.

Builds the port's four kernels from ``raytracer_tpu_torch/ops/csrc`` (one
nvcc each, all at once), holds each against its plain PyTorch twin on the
card, then drives the port's three main paths the way a user would:

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

Output: progress lines, then a ``{"kernels": [...]}`` JSON line, the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import time
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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def lane_diff(kernel: torch.Tensor, twin: torch.Tensor, rtol: float):
    """(max |kernel - twin|, share of lanes beyond rtol*max(1,|twin|))."""
    d = (kernel.double() - twin.double()).abs().reshape(kernel.shape[0], -1)
    tol = rtol * twin.double().abs().clamp_min(1.0).reshape(kernel.shape[0], -1)
    return d.max().item(), (d > tol).any(dim=1).double().mean().item()


def event_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(reps):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def scene_rays(scene, pre, cfg, n_each: int, seed: int = 20261016):
    """The ray classes of the regen engine on a BVH scene, on the scene's
    device: every camera ray of the frame (one per lane), and, from the
    first hits of ``n_each`` of them, BSDF-bounce rays and shadow rays to
    light samples bounded at ``dist - visibility_margin``. Returns
    (camera (ro, rd), {class: (ro, rd, t_init, resolved0, any_hit)})."""
    from raytracer_tpu_torch.models import vecmath as vm
    from raytracer_tpu_torch.models.camera import camera_rays3
    from raytracer_tpu_torch.ops import brdf
    from raytracer_tpu_torch.ops.intersect import trace_soa
    from raytracer_tpu_torch.ops.megakernel import uniform
    from raytracer_tpu_torch.render.integrator import sample_light3

    dev, eps = scene.device, cfg.eps
    n = cfg.width * cfg.height * 4
    slot = torch.arange(n, device=dev)
    pix, sub = slot // 4, slot % 4
    f32 = torch.float32
    cam = camera_rays3(
        scene, cfg.width, cfg.height, cfg.fov_scale,
        (pix % cfg.width).to(f32), (pix // cfg.width).to(f32), (sub % 2).to(f32), (sub // 2).to(f32),
        uniform(seed, slot, 0, 0), uniform(seed, slot, 0, 1),
    )
    g = torch.Generator(device=dev).manual_seed(seed)
    pick = torch.randperm(n, generator=g, device=dev)[:n_each]
    ro = tuple(c[pick].contiguous() for c in cam[0])
    rd = tuple(c[pick].contiguous() for c in cam[1])
    hit = trace_soa(scene, pre, ro, rd, eps)
    mat = brdf.gather_mat(scene, hit.obj)
    u = [torch.rand(n_each, generator=g, device=dev) for _ in range(4)]
    wi, _ = brdf.sample3(mat, hit.n, vm.neg3(rd), u[0], u[1], u[2], cfg.fix_phong_frame, scene.has_phong)
    y, _, _ = sample_light3(scene, u[2], u[3], u[1])
    to_y = vm.sub3(y, hit.pos)
    dist = torch.sqrt(vm.norm2_3(to_y))
    wi_d = vm.scale3(to_y, 1.0 / torch.clamp_min(dist, 1e-20))
    bound = torch.where(hit.valid, dist - eps.visibility_margin, 0.0)
    inf = torch.full((n_each,), 3.0e38, device=dev)
    none = torch.zeros(n_each, dtype=torch.bool, device=dev)
    res0 = torch.rand(n_each, generator=g, device=dev) < 0.1
    classes = {
        "camera": (ro, rd, inf, none, False),
        "bounce": (hit.pos, wi, inf, none, False),
        "shadow": (hit.pos, wi_d, bound, none, False),
        "shadow-any-hit": (hit.pos, wi_d, bound, res0 | (bound <= 0), True),
    }
    return cam, classes


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


def hold_traversal(label, kernel, twin, runs):
    """Each run through the kernel and its twin: t bit-equal on at least
    ``T_EXACT_SHARE`` of all rays, indices that differ only on ties.
    Returns (max |dt| where both hit, rays, rays bit-equal)."""
    from raytracer_tpu_torch.ops import bvh_traverse as bt

    worst, total, equal = 0.0, 0, 0
    for cname, args in runs:
        scene, ro_s, rd_s, t_init_s, _, any_hit, _ = args
        t_k, i_k = kernel(*args)
        t_t, i_t = twin(*args)
        torch.cuda.synchronize()
        same = t_k == t_t
        idx_diff = i_k != i_t
        ties_ok = torch.equal(bt.leaf_t(scene, ro_s, rd_s, i_k)[idx_diff],
                              bt.leaf_t(scene, ro_s, rd_s, i_t)[idx_diff])
        both = (t_k < 1e30) & (t_t < 1e30)
        err = (t_k[both] - t_t[both]).abs().max().item() if both.any() else 0.0
        hits = int((t_k < t_init_s).sum())
        print(f"[kernel-vs-twin] {label} {scene.name} {cname} rays={t_k.numel()} any_hit={any_hit}: t bit-equal "
              f"on {same.double().mean().item():.6%}, idx differs on {int(idx_diff.sum())} (ties: {ties_ok}), "
              f"hits below t_init {hits}, max|dt| {err:.3g}", flush=True)
        check(ties_ok, f"{label} {scene.name} {cname}: differing indices are not ties")
        check(hits > t_k.numel() // 50, f"{label} {scene.name} {cname}: only {hits} hits")
        worst = max(worst, err)
        total += t_k.numel()
        equal += int(same.sum())
    check(equal >= bt.T_EXACT_SHARE * total,
          f"{label} t bit-equal on {equal}/{total} rays, below {bt.T_EXACT_SHARE}")
    return worst, total, equal


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
    from raytracer_tpu.config import RenderConfig
    from raytracer_tpu.server.wire import parse_chunk, parse_chunks
    from raytracer_tpu_torch.models.loader import load_scene
    from raytracer_tpu_torch.ops import _build
    from raytracer_tpu_torch.ops import bvh_binary as bb
    from raytracer_tpu_torch.ops import bvh_traverse as bt
    from raytracer_tpu_torch.ops import keys
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops.intersect import scene_precompute
    from raytracer_tpu_torch.render.renderer import Renderer
    from raytracer_tpu_torch.server.app import RenderJob, Server
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
    for lib, log in built:
        print(f"[build] {lib}\n{log.strip()}", flush=True)

    cfg = RenderConfig()
    w = cfg.width
    scenes = {s: load_scene(os.path.join(ROOT, "scenes", f"{s}.toml"), device="cuda") for s in SCENES}

    # 3) K1 against its twin on the card: one 50-row band, 8 samples, same seed
    rows, ns, seed, y0 = 50, 8, 20261016, 200
    n = rows * w * 4
    max_err = 0.0
    for s in SCENES:
        pf, static = mk.pack_params(scenes[s], cfg)
        acc_k, rays_k = mk.mega_cuda(pf, static, y0, ns, n, seed, "cuda")
        acc_t, rays_t = mk.mega_twin(pf, static, y0, ns, n, seed, "cuda")
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
    # K2 on each class at the frame's width, then on the bounce class at the
    # other widths of the main path: the tail-compaction stages of the frame,
    # and a served delivery band with its own stages.
    from raytracer_tpu_torch.render.wavefront import tail_widths

    rows_b = Renderer(uni, cfg, device="cuda").plan_delivery(16)[0]
    n_band = rows_b * cfg.width * 4
    widths = sorted(set(tail_widths(n_frame, cfg, True) + [n_band] + tail_widths(n_band, cfg, True)),
                    reverse=True)
    uni_runs, bounce_args = sorted_runs(uni, classes, widths, cfg.eps)
    k2_err, _, _ = hold_traversal("K2", bt.bvh_traverse_cuda, bt.bvh_traverse_twin, uni_runs)

    # 4b) K4 against its twin on crewmate_phong and flying_unicorn rays, the
    # same classes and widths; and against K2 on the nearest-hit classes
    # (both are exact searches with the same t expression).
    t0 = time.perf_counter()
    crew = load_scene(os.path.join(ROOT, "scenes", "crewmate_phong.toml"), device="cuda")
    crew_pre = scene_precompute(crew)
    print(f"[load] crewmate_phong: {crew.n_triangles} triangle slots, {crew.bvh_binary_nodes.shape[0]} "
          f"binary nodes ({int((crew.bvh_count > 0).sum())} leaves), {crew.bvh8_nodes_flat.shape[0]} wide "
          f"nodes, in {time.perf_counter() - t0:.2f} s", flush=True)
    _, crew_classes = scene_rays(crew, crew_pre, cfg, n_frame)
    crew_runs, crew_bounce = sorted_runs(crew, crew_classes, widths, cfg.eps)
    k4_err = 0.0
    for runs in (crew_runs, uni_runs):
        k4_err = max(k4_err, hold_traversal("K4", bb.bvh_binary_cuda, bb.bvh_binary_twin, runs)[0])
        for cname, args in runs[:3]:  # camera, bounce, shadow: nearest hits
            t4, _ = bb.bvh_binary_cuda(*args)
            t2, _ = bt.bvh_traverse_cuda(*args)
            print(f"[K4-vs-K2] {args[0].name} {cname} rays={t4.numel()}: t bit-equal on "
                  f"{(t4 == t2).double().mean().item():.6%}", flush=True)

    # 5) the megakernel path, offline (counts from here to the end of phase 6)
    zero_counts()
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
        check(mk.LAUNCHES > before, f"{s}: the megakernel was not launched")
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

    # 10) times
    pf, static = mk.pack_params(scenes["cornell_box"], cfg)
    kernel_ms = event_ms(lambda: mk.mega_cuda(pf, static, y0, 16, n, seed, "cuda"), 20)
    twin_ms = wall_ms(lambda: mk.mega_twin(pf, static, y0, 16, n, seed, "cuda"))
    print(f"[time] K1 cornell band 600x50 16 samples: kernel {kernel_ms:.4f} ms, twin {twin_ms:.1f} ms | {smi}")
    # K3 on the frame's camera rays, K2 on its coherence-sorted bounce rays.
    k3_ms = event_ms(lambda: keys.coherence_key_cuda(uni, cam[0], cam[1], cfg.eps), 20)
    k3_twin_ms = wall_ms(lambda: keys.coherence_key_twin(uni, cam[0], cam[1], cfg.eps))
    n_cam = cam[0][0].numel()
    print(f"[time] K3 {n_cam} camera rays: kernel {k3_ms:.4f} ms, twin {k3_twin_ms:.2f} ms; per 1M rays "
          f"{k3_ms * 1e6 / n_cam:.4f} / {k3_twin_ms * 1e6 / n_cam:.2f} ms | {smi}", flush=True)
    k2_ms = event_ms(lambda: bt.bvh_traverse_cuda(*bounce_args), 10)
    k2_twin_ms = wall_ms(lambda: bt.bvh_traverse_twin(*bounce_args))
    print(f"[time] K2 {n_frame} sorted bounce rays: kernel {k2_ms:.4f} ms, twin {k2_twin_ms:.2f} ms; per 1M "
          f"rays {k2_ms * 1e6 / n_frame:.4f} / {k2_twin_ms * 1e6 / n_frame:.2f} ms | {smi}", flush=True)
    # K4 on the frame's sorted crewmate bounce rays beside K2 on the same
    # rays, and on the unicorn's.
    k4_ms = event_ms(lambda: bb.bvh_binary_cuda(*crew_bounce), 10)
    k4_twin_ms = wall_ms(lambda: bb.bvh_binary_twin(*crew_bounce))
    k2_crew_ms = event_ms(lambda: bt.bvh_traverse_cuda(*crew_bounce), 10)
    k4_uni_ms = event_ms(lambda: bb.bvh_binary_cuda(*bounce_args), 10)
    print(f"[time] K4 {n_frame} sorted crewmate bounce rays: kernel {k4_ms:.4f} ms, twin {k4_twin_ms:.2f} ms, "
          f"K2 {k2_crew_ms:.4f} ms; per 1M rays {k4_ms * 1e6 / n_frame:.4f} / {k4_twin_ms * 1e6 / n_frame:.2f} / "
          f"{k2_crew_ms * 1e6 / n_frame:.4f} ms | {smi}", flush=True)
    print(f"[time] K4 {n_frame} sorted unicorn bounce rays: kernel {k4_uni_ms:.4f} ms, K2 {k2_ms:.4f} ms; per 1M "
          f"rays {k4_uni_ms * 1e6 / n_frame:.4f} / {k2_ms * 1e6 / n_frame:.4f} ms | {smi}", flush=True)
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
    # Where the time goes: the traversal (K2 or K4) and K3 device time by
    # CUDA events around every launch of one render; the rest is glue.
    def breakdown(scene, spp, label):
        spent = {"trav": [], "K3": []}

        def timed(fn, bucket):
            def run(*a, **kw):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **kw)
                e1.record()
                spent[bucket].append((e0, e1))
                return out
            return run

        real = (bt.bvh_traverse_cuda, bt.bvh_binary_cuda, keys.coherence_key_cuda)
        bt.bvh_traverse_cuda = timed(real[0], "trav")
        bt.bvh_binary_cuda = timed(real[1], "trav")
        keys.coherence_key_cuda = timed(real[2], "K3")
        try:
            r = Renderer(scene, RenderConfig(), device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render_image(spp)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            bt.bvh_traverse_cuda, bt.bvh_binary_cuda, keys.coherence_key_cuda = real
        trav = sum(a.elapsed_time(b) for a, b in spent["trav"])
        k3 = sum(a.elapsed_time(b) for a, b in spent["K3"])
        rays = r.rays_traced()
        print(f"[time] {label} 600x450 {spp}spp: {wall / 1e3:.4f} s, {rays / wall / 1e3:.2f} Mrays/s; breakdown "
              f"wall {wall:.1f} ms = traversal {trav:.1f} ms ({len(spent['trav'])} launches) + K3 {k3:.1f} ms "
              f"({len(spent['K3'])} launches) + glue {wall - trav - k3:.1f} ms | {smi}", flush=True)

    breakdown(uni, 16, "flying_unicorn (K2)")
    print(f"[time] flying_unicorn 600x450 16spp: {unicorn_wall:.4f} s, "
          f"{unicorn_rays_n / unicorn_wall / 1e6:.2f} Mrays/s | {smi}", flush=True)
    for variant, label in (("widesmem", "K2"), ("binary", "K4")):
        with_variant(variant, lambda: breakdown(crew, 16, f"crewmate_phong ({label})"))
    r = Renderer(scenes["cornell_box"], RenderConfig(use_mis=True), device="cuda")
    t0 = time.perf_counter()
    r.render_image(256)
    wall = time.perf_counter() - t0
    rays = r.rays_traced()
    print(f"[time] cornell_box MIS 600x450 256spp (regen): {wall:.4f} s, {rays / wall / 1e6:.1f} Mrays/s | {smi}",
          flush=True)

    print(json.dumps({"kernels": [
        {
            "name": "mega_kernel", "route": "cuda",
            "source": "raytracer_tpu_torch/ops/csrc/megakernel.cu",
            "replaces": "raytracer_tpu/ops/pallas/megakernel.py:96",
            "launches": launches["K1"], "max_abs_err": max_err,
            "ms": kernel_ms, "plain_ms": twin_ms,
        },
        {
            "name": "bvh8_kernel", "route": "cuda",
            "source": "raytracer_tpu_torch/ops/csrc/bvh8.cu",
            "replaces": "raytracer_tpu/ops/pallas/bvh_kernel.py:159",
            "launches": launches["K2"], "max_abs_err": k2_err,
            "ms": k2_ms, "plain_ms": k2_twin_ms,
        },
        {
            "name": "key_kernel", "route": "cuda",
            "source": "raytracer_tpu_torch/ops/csrc/coherence_key.cu",
            "replaces": "raytracer_tpu/ops/pallas/key_kernel.py:41",
            "launches": launches["K3"], "max_abs_err": key_err,
            "ms": k3_ms, "plain_ms": k3_twin_ms,
        },
        {
            "name": "bvh_binary_kernel", "route": "cuda",
            "source": "raytracer_tpu_torch/ops/csrc/bvh_binary.cu",
            "replaces": "raytracer_tpu/ops/pallas/bvh_kernel.py:48",
            "launches": launches["K4"], "max_abs_err": k4_err,
            "ms": k4_ms, "plain_ms": k4_twin_ms,
        },
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
