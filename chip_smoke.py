"""Smoke test of the PyTorch + CUDA port on one GPU: ``python3 chip_smoke.py``.

Builds the bounce megakernel from ``raytracer_tpu_torch/ops/csrc``, holds
it against its plain PyTorch twin on the card, then drives the port's main
path the way a user would: offline ``Renderer.render_image`` of cornell_box
and cubes at the reference's 600x450 against the repo's own 64 spp renders
in ``examples/``, and the WebSocket server's ``RenderJob`` (batch and
progressive) with every wire message parsed. Every phase raises on failure,
so the exit code is non-zero. Without CUDA it exits non-zero at once.

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

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENES = ("cornell_box", "cubes")
# Bounds on the 600x450 64 spp images against the repo's 64 spp renders
# (examples/cornell_box.png mean 112.16, examples/cubes.png mean 113.79).
IMAGE_MEAN = {"cornell_box": (110.7, 113.7), "cubes": (112.3, 115.3)}
IMAGE_MAD_MAX = 16.0


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from raytracer_tpu.config import RenderConfig
    from raytracer_tpu.server.wire import parse_chunk
    from raytracer_tpu_torch.models.loader import load_scene
    from raytracer_tpu_torch.ops import _build
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.render.renderer import Renderer
    from raytracer_tpu_torch.server.app import RenderJob, Server
    from raytracer_tpu_torch.utils.png import read_png

    # 1) card
    smi = card()
    name = torch.cuda.get_device_name(0)
    print(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {name}", flush=True)

    # 2) build
    t0 = time.perf_counter()
    lib, log = _build.build("megakernel")
    print(f"[build] {lib} in {time.perf_counter() - t0:.2f} s", flush=True)
    print(log.strip(), flush=True)

    cfg = RenderConfig()
    w = cfg.width
    scenes = {s: load_scene(os.path.join(ROOT, "scenes", f"{s}.toml"), device="cuda") for s in SCENES}

    # 3) kernel vs twin on the card: one 50-row band, 8 samples, same seed
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
            f"[kernel-vs-twin] {s} W={w} rows={rows} samples={ns}: max|d|={err:.3g} "
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

    # 4) main path, offline (counts from here to the end of phase 5)
    mk.LAUNCHES = 0
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

    # 5) main path, served: RenderJob.run with a capturing send
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
    launches = mk.LAUNCHES

    # 6) times: one 50-row cornell band at 16 samples, and full renders
    pf, static = mk.pack_params(scenes["cornell_box"], cfg)
    mk.mega_cuda(pf, static, y0, 16, n, seed, "cuda")
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reps = 20
    ev0.record()
    for i in range(reps):
        mk.mega_cuda(pf, static, y0, 16, n, seed + i, "cuda")
    ev1.record()
    torch.cuda.synchronize()
    kernel_ms = ev0.elapsed_time(ev1) / reps
    t0 = time.perf_counter()
    mk.mega_twin(pf, static, y0, 16, n, seed, "cuda")
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - t0) * 1e3
    print(f"[time] cornell band 600x50 16 samples: kernel {kernel_ms:.4f} ms, twin {twin_ms:.1f} ms | {smi}")
    for s in SCENES:
        r = Renderer(scenes[s], RenderConfig(), device="cuda")
        for spp in (64, 256):
            r.ray_counts.clear()
            t0 = time.perf_counter()
            r.render_image(spp)
            wall = time.perf_counter() - t0
            rays = r.rays_traced()
            print(
                f"[time] {s} 600x450 {spp}spp: {wall:.4f} s, {rays / wall / 1e6:.1f} Mrays/s | {smi}",
                flush=True,
            )

    print(json.dumps({"kernels": [{
        "name": "mega_kernel",
        "route": "cuda",
        "source": "raytracer_tpu_torch/ops/csrc/megakernel.cu",
        "replaces": "raytracer_tpu/ops/pallas/megakernel.py:96",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": twin_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
