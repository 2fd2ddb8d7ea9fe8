"""Smoke test of the PyTorch + CUDA port on one GPU: ``python3 chip_smoke.py``.

Builds the port's three kernels from ``raytracer_tpu_torch/ops/csrc`` (one
nvcc each, all at once), holds each against its plain PyTorch twin on the
card, then drives the port's two main paths the way a user would:

- the megakernel path (K1): offline ``Renderer.render_image`` of
  cornell_box and cubes at the reference's 600x450 against the repo's own
  64 spp renders in ``examples/``, and the WebSocket server's ``RenderJob``
  (batch and progressive) with every wire message parsed;
- the BVH path (K2, K3, the regen engine): flying_unicorn at 600x450 16 spp
  against ``examples/flying_unicorn.png``, and served through ``RenderJob``
  with the batched transport, equal to ``render_image(16)``.

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


def unicorn_rays(scene, pre, cfg, n_each: int, seed: int = 20261016):
    """The ray classes of the regen engine on flying_unicorn, on the scene's
    device: every camera ray of the frame (one per lane), and, from the
    first hits of ``n_each`` of them, cosine-bounce rays and shadow rays to
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
    wi, _ = brdf.sample3(mat, hit.n, vm.neg3(rd), u[0], u[1], u[0])
    y, _, _ = sample_light3(scene, u[2], u[3], u[2])
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from raytracer_tpu.config import RenderConfig
    from raytracer_tpu.server.wire import parse_chunk, parse_chunks
    from raytracer_tpu_torch.models.loader import load_scene
    from raytracer_tpu_torch.ops import _build
    from raytracer_tpu_torch.ops import bvh_traverse as bt
    from raytracer_tpu_torch.ops import keys
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops.intersect import scene_precompute
    from raytracer_tpu_torch.render.renderer import Renderer
    from raytracer_tpu_torch.server.app import RenderJob, Server
    from raytracer_tpu_torch.utils.png import read_png

    def zero_counts() -> None:
        mk.LAUNCHES = keys.LAUNCHES = bt.LAUNCHES = 0

    # 1) card
    smi = card()
    name = torch.cuda.get_device_name(0)
    print(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {name}", flush=True)

    # 2) build all three sources at once
    t0 = time.perf_counter()
    sources = ("megakernel", "bvh8", "coherence_key")
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
    cam, classes = unicorn_rays(uni, uni_pre, cfg, n_frame)
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
    runs = []
    for cname, (ro, rd, t_init, res0, any_hit) in classes.items():
        order = keys.coherence_order(uni, ro, rd, cfg.eps)  # as the wrapper runs it
        args = (uni, tuple(c[order] for c in ro), tuple(c[order] for c in rd), t_init[order],
                res0[order], any_hit, cfg.eps)
        runs.append((cname, args))
        if cname == "bounce":
            bounce_args = args
    runs += [(f"bounce[:{m}]", (uni, tuple(c[:m] for c in bounce_args[1]), tuple(c[:m] for c in bounce_args[2]),
                                bounce_args[3][:m], bounce_args[4][:m], False, cfg.eps)) for m in widths]
    k2_err, k2_total, k2_equal = 0.0, 0, 0
    for cname, args in runs:
        _, ro_s, rd_s, t_init_s, _, any_hit, _ = args
        t_k, i_k = bt.bvh_traverse_cuda(*args)
        t_t, i_t = bt.bvh_traverse_twin(*args)
        torch.cuda.synchronize()
        same = t_k == t_t
        idx_diff = i_k != i_t
        ties_ok = torch.equal(bt.leaf_t(uni, ro_s, rd_s, i_k)[idx_diff], bt.leaf_t(uni, ro_s, rd_s, i_t)[idx_diff])
        both = (t_k < 1e30) & (t_t < 1e30)
        err = (t_k[both] - t_t[both]).abs().max().item() if both.any() else 0.0
        hits = int((t_k < t_init_s).sum())
        print(f"[kernel-vs-twin] K2 {cname} rays={t_k.numel()} any_hit={any_hit}: t bit-equal on "
              f"{same.double().mean().item():.6%}, idx differs on {int(idx_diff.sum())} (ties: {ties_ok}), "
              f"hits below t_init {hits}, max|dt| {err:.3g}", flush=True)
        check(ties_ok, f"K2 {cname}: differing indices are not ties")
        check(hits > t_k.numel() // 50, f"K2 {cname}: only {hits} hits")
        k2_err = max(k2_err, err)
        k2_total += t_k.numel()
        k2_equal += int(same.sum())
    check(k2_equal >= bt.T_EXACT_SHARE * k2_total,
          f"K2 t bit-equal on {k2_equal}/{k2_total} rays, below {bt.T_EXACT_SHARE}")

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

    # 9) times
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
    # Where the unicorn's time goes: K2 and K3 device time by CUDA events
    # around every launch of one 16 spp render, the rest is glue.
    spent = {"K2": [], "K3": []}

    def timed(fn, bucket):
        def run(*a, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            spent[bucket].append((e0, e1))
            return out
        return run

    real_k2, real_k3 = bt.bvh_traverse_cuda, keys.coherence_key_cuda
    bt.bvh_traverse_cuda, keys.coherence_key_cuda = timed(real_k2, "K2"), timed(real_k3, "K3")
    try:
        r = Renderer(uni, RenderConfig(), device="cuda")
        t0 = time.perf_counter()
        r.render_image(16)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        bt.bvh_traverse_cuda, keys.coherence_key_cuda = real_k2, real_k3
    k2_tot = sum(a.elapsed_time(b) for a, b in spent["K2"])
    k3_tot = sum(a.elapsed_time(b) for a, b in spent["K3"])
    print(f"[time] flying_unicorn 600x450 16spp breakdown: wall {wall:.1f} ms = K2 {k2_tot:.1f} ms "
          f"({len(spent['K2'])} launches) + K3 {k3_tot:.1f} ms ({len(spent['K3'])} launches) + glue "
          f"{wall - k2_tot - k3_tot:.1f} ms | {smi}", flush=True)
    print(f"[time] flying_unicorn 600x450 16spp: {unicorn_wall:.4f} s, "
          f"{unicorn_rays_n / unicorn_wall / 1e6:.2f} Mrays/s | {smi}", flush=True)

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
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
