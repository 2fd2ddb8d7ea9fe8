"""Benchmark of the PyTorch + CUDA port: Mrays/s and wall clock of the
reference's configs, and the two served runs.

The port's counterpart of ``bench.py``, through ``raytracer_tpu_torch``.
Prints ONE JSON line with ``bench.py``'s keys, plus ``card`` (the card's
name and power limit as nvidia-smi gives them), ``transport``, ``cpu_host``
(the host CPU's model and core count) and ``cpu_native`` (the three native
baselines unrounded).

- ``run_config``: the five ``CONFIGS`` through ``Renderer.render_image``.
  One warm-up render (it builds the kernels at first use), then
  ``--repeats`` timed renders (host clock around ``render_image``, which
  ends by pulling the pixels): ``wall_s`` is their median, beside ``min``,
  ``max`` and ``n``. The walls of the mesh scenes vary a lot between runs
  on a shared host, so one reading says little. A config whose warm-up took
  over ``SLOW_WARMUP_S`` seconds is timed once (``n`` = 1).
- ``run_progressive``: cornell_box 1920x1080 toward 1024 spp, progressive
  and batched: first chunk, first image, and the seconds of the third sweep
  (the first steady one), then the render is stopped.
- ``run_mesh_serving``: flying_unicorn 600x450 16 spp as a stock client
  asks for it: first chunk and total.

``--sharding`` prints another line instead: ``run_sharding``, a megakernel
frame and a regen frame through the plain ``Renderer`` on the first device
beside ``parallel.mesh.ShardedRenderer`` over every visible device (one
device is listed twice: the path's overhead), the latter with its one host
thread and with a host thread a device, a dispatch form the port does not
ship and this function alone builds.

Both served runs drive the server's ``RenderJob.run`` in this process with
a ``send`` that keeps the time and parses every message with
``server/wire.py::parse_chunks``; no socket is opened (``"transport":
"in_process"``).

Rays are counted as the reference would trace them: a camera ray per
sample, a shadow ray per live non-specular vertex (culled or not) and a
continuation ray per lane that passes Russian roulette.

CPU baselines, as ``bench.py:89-116, 354-400`` takes them: ``measure_native_cpu``
renders with the native reference-style tracer (``utils/native.py::
cpu_render_band``, one thread per core) on the host that drives the card,
in every run: cornell_box at the full 600x450 frame, the two mesh scenes
on rows 200-229, 4 spp, seed 1. ``vs_baseline`` is the headline Mrays/s
over cornell's, ``vs_native_cpu`` a mesh config's over its scene's. No
number of ``BASELINE_CPU*.json`` is read: those come from another host.
``vs_xla_cpu_same_software`` and ``cpu_xla_mrays_per_s`` stay null: they
are the JAX estimator compiled for the CPU by XLA, which has no
counterpart in the port.

Runs on CUDA; without it the script exits 1 and prints no result. ``--device
cpu --width W --height H --spp-scale S`` runs the same code small on the
CPU (the plain PyTorch twins), for tests. A run function that fails raises.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# (key, scene, spp, use_mis): the configs of bench.py
CONFIGS = [
    ("cornell_256_nee", "cornell_box", 256, False),  # headline
    ("cornell_256_mis", "cornell_box", 256, True),
    ("cubes_64", "cubes", 64, False),
    ("flying_unicorn_16", "flying_unicorn", 16, False),
    ("crewmate_phong_16", "crewmate_phong", 16, False),
]
# A config whose warm-up render took longer than this is timed once.
SLOW_WARMUP_S = 30.0


def _scene(name: str, device: str):
    from raytracer_tpu_torch.models.loader import load_scene

    return load_scene(os.path.join(HERE, "scenes", name + ".toml"), device=device)


def _scaled(spp: int, scale: float) -> int:
    """``spp * scale`` as a multiple of 4, at least 4."""
    return max(4, int(spp * scale) // 4 * 4)


def cpu_host() -> str:
    """The host CPU's model (``/proc/cpuinfo``: its ``model name``, else its
    vendor, family, model and stepping, or on Arm its implementer and part
    numbers), machine type and ``os.cpu_count()``."""
    import platform

    fields: dict = {}
    try:
        with open("/proc/cpuinfo") as fh:
            for ln in fh:
                key, _, val = ln.partition(":")
                fields.setdefault(key.strip().lower(), val.strip())
    except OSError:
        pass
    model = fields.get("model name") or fields.get("cpu model") or ""
    if model in ("", "unknown"):
        # What identifies the part where the model name is not given.
        model = " ".join(f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model", "stepping",
                                                        "cpu implementer", "cpu part") if k in fields)
    return f"{model or 'model unknown'} ({platform.machine()}), {os.cpu_count()} cores"


def measure_native_cpu(scene_name: str) -> dict | None:
    """The native tracer's Mrays/s on ``scene_name`` at ``bench.py``'s
    shapes (``_measure_native_cpu``), or None for a mesh light."""
    from raytracer_tpu_torch.utils import native

    scene = _scene(scene_name, "cpu")
    if scene.use_bvh:
        y0, rows, spp = 200, 30, 4  # a band through the mesh suffices
    else:
        y0, rows, spp = 0, 450, 4
    threads = os.cpu_count() or 1
    native.build()  # outside the timed call
    t0 = time.perf_counter()
    out = native.cpu_render_band(scene, 600, 450, y0, rows, spp, seed=1, n_threads=threads)
    dt = time.perf_counter() - t0
    if out is None:
        return None
    rays = out[1]
    return {"mrays_per_s": rays / dt / 1e6, "rays": rays, "seconds": dt, "threads": threads,
            "rows": [y0, y0 + rows], "spp": spp, "impl": "native-cpp"}


def run_config(
    scene_name: str, spp: int, use_mis: bool, device: str = "cuda",
    width: int = 600, height: int = 450, repeats: int = 5,
) -> dict:
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.render.renderer import Renderer

    cfg = RenderConfig(use_mis=use_mis, width=width, height=height)
    r = Renderer(_scene(scene_name, device), cfg, device=device)
    t0 = time.time()
    r.render_image(spp)  # warm up: builds the kernels, first launches
    n = 1 if time.time() - t0 > SLOW_WARMUP_S else max(1, repeats)
    walls = []
    for _ in range(n):
        r.ray_counts.clear()
        t0 = time.time()
        img = r.render_image(spp)
        walls.append(time.time() - t0)
        if img is None or img.shape != (height, width, 3):
            raise RuntimeError(f"{scene_name}: render_image gave {None if img is None else img.shape}")
    rays = r.rays_traced()  # of the last render; every render traces the same rays
    wall = statistics.median(walls)
    return {
        "mrays_per_s": round(rays / wall / 1e6, 2),
        "wall_s": round(wall, 4),
        "rays": rays,
        "min": round(min(walls), 4),
        "max": round(max(walls), 4),
        "n": n,
    }


def _serve(renderer, spp: int, on_message, **run_kwargs) -> None:
    """Drive one ``RenderJob.run`` in this process; ``on_message(job, raw)``
    sees every message the job sends, in order."""
    from raytracer_tpu_torch.server.app import RenderJob

    async def send(raw) -> None:
        on_message(job, raw)

    job = RenderJob(send=send)
    job.mark_running()
    asyncio.run(job.run(renderer, spp, **run_kwargs))


def run_progressive(
    device: str = "cuda", width: int = 1920, height: int = 1080, spp: int = 1024
) -> dict:
    """Progressive ``width`` x ``height`` cornell_box toward ``spp``, batched
    transport. Three sweeps are timed: the first is the short
    fast-first-image sweep, the second repays its samples, the third is the
    first steady refinement pass; then the render is stopped."""
    from raytracer_tpu_torch.server import wire
    from raytracer_tpu_torch.server.app import Server

    srv = Server({"cornell_box": _scene("cornell_box", device)}, width=width, height=height,
                 device=device, sharded=False)
    r = srv.renderer_for("cornell_box", width, height)
    rows_p, k_p, _ = r.plan_progressive(spp)
    int(r.render_band_sums(0, rows_p, k_p, 1, return_rays=True)[1])  # warm the band's shape
    frame_px = width * height
    seen = {"px": 0, "first": None, "passes": []}
    t0 = time.time()

    def on_message(job, raw) -> None:
        if not isinstance(raw, (bytes, bytearray)) or len(seen["passes"]) >= 3:
            return
        if seen["first"] is None:
            seen["first"] = time.time() - t0
        for _mt, _x, _y, rgb in wire.parse_chunks(raw):
            seen["px"] += rgb.shape[0]
        if seen["px"] >= frame_px:
            seen["px"] -= frame_px
            seen["passes"].append(time.time() - t0)
            if len(seen["passes"]) == 3:
                job.stop()

    _serve(r, spp, on_message, progressive=True, batch=True)
    passes = seen["passes"]
    if len(passes) < 3:
        raise RuntimeError(f"progressive render delivered {len(passes)} sweeps, not 3")
    return {
        "width": width, "height": height, "target_spp": spp,
        "first_chunk_s": round(seen["first"], 4),
        "first_image_s": round(passes[0], 4),
        "s_per_refinement_pass": round(passes[2] - passes[1], 4),
        "spp_per_pass": 4 * k_p,
        "passes_measured": len(passes),
    }


def run_mesh_serving(
    device: str = "cuda", width: int = 600, height: int = 450, spp: int = 16
) -> dict:
    """First-chunk latency and total of a default (not progressive, not
    batched) flying_unicorn render, as a stock client asks for it: the
    frame streams in at least ``DELIVERY_BANDS`` bands."""
    from raytracer_tpu_torch.server import wire
    from raytracer_tpu_torch.server.app import Server

    srv = Server({"flying_unicorn": _scene("flying_unicorn", device)}, width=width, height=height,
                 device=device, sharded=False)
    r = srv.renderer_for("flying_unicorn", width, height)
    rows, k, _ = r.plan_delivery(spp)
    int(r.render_band_sums(0, rows, k, 1, return_rays=True)[1])  # warm the band's shape
    seen = {"px": 0, "first": None}
    t0 = time.time()

    def on_message(job, raw) -> None:
        if not isinstance(raw, (bytes, bytearray)):
            return
        if seen["first"] is None:
            seen["first"] = time.time() - t0
        for _mt, _x, _y, rgb in wire.parse_chunks(raw):
            seen["px"] += rgb.shape[0]

    _serve(r, spp, on_message)
    total = time.time() - t0
    if seen["px"] != width * height:
        raise RuntimeError(f"served {seen['px']} pixels of {width * height}")
    return {
        "width": width, "height": height, "spp": spp,
        "first_chunk_s": round(seen["first"], 4),
        "total_s": round(total, 4),
    }


def _timed_frames(r, spp: int, repeats: int) -> dict:
    r.render_image(spp)  # warm up
    walls = []
    for _ in range(max(1, repeats)):
        t0 = time.time()
        img = r.render_image(spp)
        walls.append(time.time() - t0)
    return {"wall_s": round(statistics.median(walls), 4), "min": round(min(walls), 4),
            "max": round(max(walls), 4), "n": len(walls), "image": img}


def run_sharding(devices: list, width: int = 600, height: int = 450, repeats: int = 5,
                 spp_scale: float = 1.0) -> dict:
    """cornell_box 256 spp (the megakernel) and flying_unicorn 16 spp (the
    regen engine): the plain frame on ``devices[0]`` beside the frame over
    ``devices``, dispatched by one host thread (``ShardedRenderer`` as it
    is) and by a host thread a device. ``equal`` says whether a regen frame
    equals the plain one on every pixel."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.parallel.mesh import ShardedRenderer
    from raytracer_tpu_torch.render.renderer import Renderer

    class ThreadedBands(ShardedRenderer):
        pool = ThreadPoolExecutor(max_workers=len(devices))

        def device_bands(self, *args):
            jobs = [self.pool.submit(self.device_band, d, *args) for d in range(self.n_dev)]
            return [job.result() for job in jobs]

    out = {"devices": [str(d) for d in devices]}
    cfg = RenderConfig(width=width, height=height)
    for key, name, spp in (("cornell_256_nee", "cornell_box", 256), ("flying_unicorn_16", "flying_unicorn", 16)):
        spp = _scaled(spp, spp_scale)
        scene = _scene(name, devices[0])
        forms = {
            "plain": Renderer(scene, cfg, device=devices[0]),
            "one_host_thread": ShardedRenderer(scene, cfg, devices),
            "thread_per_device": ThreadedBands(scene, cfg, devices),
        }
        row = {"engine": forms["plain"].engine, "plan": forms["one_host_thread"].plan(spp)}
        for form, r in forms.items():
            row[form] = _timed_frames(r, spp, repeats)
        plain = row["plain"].pop("image")
        for form in ("one_host_thread", "thread_per_device"):
            img = row[form].pop("image")
            row[form]["equal"] = bool(np.array_equal(img, plain))
            row[form]["mean_diff"] = round(float(img.mean()) - float(plain.mean()), 4)
        out[key] = row
    ThreadedBands.pool.shutdown()
    return out


def result(results: dict, card: str, width: int, height: int, spp: int, cpu: dict, host: str) -> dict:
    """The JSON object of one run from its per-config results and the
    native baselines ``cpu`` ({scene: measure_native_cpu(scene)})."""
    headline = results["cornell_256_nee"]

    def ratio(mrays: float, base: dict | None, digits: int = 1):
        return round(mrays / base["mrays_per_s"], digits) if base else None

    for key, scene in (("flying_unicorn_16", "flying_unicorn"), ("crewmate_phong_16", "crewmate_phong")):
        results[key]["vs_native_cpu"] = ratio(results[key]["mrays_per_s"], cpu[scene])
    nat, mesh = cpu["cornell_box"], cpu["flying_unicorn"]
    return {
        "metric": f"Mrays/s/chip, cornell_box {width}x{height}@{spp}spp (NEE path)",
        "value": headline["mrays_per_s"],
        "unit": "Mrays/s",
        # Against the native reference-style CPU tracer on this run's host.
        "vs_baseline": ratio(headline["mrays_per_s"], nat),
        "baseline_impl": "native-cpp reference-style tracer",
        # JAX on XLA's CPU backend has no counterpart in the port.
        "vs_xla_cpu_same_software": None,
        "wall_clock_to_256spp_s": headline["wall_s"],
        "rays_traced": headline["rays"],
        "cpu_native_mrays_per_s": round(nat["mrays_per_s"], 3) if nat else None,
        "cpu_native_mesh_mrays_per_s": round(mesh["mrays_per_s"], 4) if mesh else None,
        "cpu_xla_mrays_per_s": None,
        "card": card,
        "transport": "in_process",
        "cpu_host": host,
        "cpu_native": cpu,
        "configs": results,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bench_torch")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--width", type=int, default=600)
    p.add_argument("--height", type=int, default=450)
    p.add_argument("--spp-scale", type=float, default=1.0, help="multiplies every config's spp")
    p.add_argument("--repeats", type=int, default=5, help="timed renders per config")
    p.add_argument("--sharding", action="store_true",
                   help="time multi-device row bands beside the plain frame instead (run_sharding)")
    args = p.parse_args(argv)

    sys.path.insert(0, HERE)
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("bench_torch: torch.cuda.is_available() is False (pass --device cpu for a "
              "small CPU run of the plain twins)", file=sys.stderr)
        return 1
    if args.device == "cpu":
        card = "cpu"
    else:
        from raytracer_tpu_torch.tools.kernel_steps import card as card_line

        card = card_line()

    if args.sharding:
        from raytracer_tpu_torch.render.renderer import shard_devices

        devices = shard_devices(args.device)
        if len(devices) == 1:
            devices = devices * 2
        sharding = run_sharding(devices, args.width, args.height, args.repeats, args.spp_scale)
        print(json.dumps({"card": card, "sharding": sharding}))
        return 0

    full = (args.width, args.height) == (600, 450)
    results = {}
    for key, scene, spp, mis in CONFIGS:
        results[key] = run_config(scene, _scaled(spp, args.spp_scale), mis, args.device,
                                  args.width, args.height, args.repeats)
    pw, ph = (1920, 1080) if full else (args.width, args.height)
    results["progressive_1080p"] = run_progressive(args.device, pw, ph, _scaled(1024, args.spp_scale))
    results["unicorn_16_serving"] = run_mesh_serving(
        args.device, args.width, args.height, _scaled(16, args.spp_scale))
    cpu = {s: measure_native_cpu(s) for s in ("cornell_box", "flying_unicorn", "crewmate_phong")}
    print(json.dumps(result(results, card, args.width, args.height, _scaled(256, args.spp_scale),
                            cpu, cpu_host())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
