"""Served requests: the program's render server over a loopback WebSocket,
driven by the stock clients' requests in an open loop.

The port's ``server.app.Server``, holding only the configuration's scene,
serves on 127.0.0.1 at a port the system picks, in this process. The load
generators (``loadgen.py``, ``generators`` of them) run in child
processes, so that decoding the pixels does not share the server's
interpreter or one core: each opens its share of the pool of connections,
the first sends one request of each client kind (the warm-up), and, once
told to go, each sends its share of the requests at their due times (``window.arrivals``:
the traffic's rate over the window, kinds in equal shares in an order
drawn from the seed). Set-up ends when the first timed request is due.
Latencies count from when a request was due: to its first pixel message
(``first_chunk``) and to the message that completed its last pixel
(``image``). A request that fails or is not done a minute after the
window closes counts as beyond any limit.

A traced run profiles the first ``trace_seconds`` of the window and spans
each ``RenderJob.run`` that starts in it and the ``render_band_sums`` calls
inside it, each band's span ending when its kernels are done.
"""

from __future__ import annotations

import asyncio
import base64
import gc
import json
import os
import statistics
import sys
import time

from rtbench import window


def _jobs(ctx, rows: list[int]) -> list[dict]:
    """The load generators' jobs: arrival i goes to generator i mod n, each
    with its share of the connections."""
    tf, p = ctx.traffic, ctx.render_params
    due = window.arrivals(tf["rate"], ctx.seconds, ctx.seed)
    order = window.kinds(sorted(tf["clients"]), len(due), ctx.seed)
    # A client that states the image size states the configuration's.
    kinds = {k: {**v, **({"width": p["width"], "height": p["height"]} if "width" in v else {})}
             for k, v in tf["clients"].items()}
    n = tf["generators"]
    return [{
        "scene": ctx.config["scene_name"], "width": p["width"], "height": p["height"], "rows": rows,
        "kinds": kinds, "connections": tf["connections"] // n, "due": due[g::n], "order": order[g::n],
        "seconds": ctx.seconds, "wait_after_s": tf["wait_after_s"], "warmup": g == 0,
    } for g in range(n)]


class _BandSpy:
    """The renderer as ``RenderJob.run`` sees it, timing each band call to
    the end of its kernels."""

    def __init__(self, renderer, spans: list):
        self._r, self._spans = renderer, spans

    def __getattr__(self, name):
        return getattr(self._r, name)

    def render_band_sums(self, *a, **k):
        import torch

        t0 = time.perf_counter()
        out = self._r.render_band_sums(*a, **k)
        if self._r.device.type == "cuda":
            torch.cuda.current_stream(self._r.device).synchronize()
        self._spans.append(time.perf_counter() - t0)
        return out


def run(ctx) -> dict:
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.loader import load_scene
    from raytracer_tpu_torch.server import app

    cfg = RenderConfig(seed=ctx.seed, **ctx.render)
    scene = load_scene(ctx.scene_path, device=ctx.device)
    server = app.Server({ctx.config["scene_name"]: scene}, cfg, device=ctx.device,
                        width=ctx.render["width"], height=ctx.render["height"])
    rows = window.check_rows(ctx.render_params["height"], ctx.config["check"]["row_stride"], ctx.seed)
    ctx.check_rows = rows
    job_spans: list = []
    tracing = {"on": False}
    if ctx.trace:
        orig = app.RenderJob.run

        async def traced_run(self, renderer, *a, **k):
            if not tracing["on"]:
                return await orig(self, renderer, *a, **k)
            bands: list = []
            t0 = time.perf_counter()
            try:
                return await orig(self, _BandSpy(renderer, bands), *a, **k)
            finally:
                job_spans.append((time.perf_counter() - t0, sum(bands)))

        app.RenderJob.run = traced_run
    out = asyncio.run(_serve(ctx, server, _jobs(ctx, rows), tracing))
    out["job_spans"] = job_spans
    out["memory_peak_bytes"] = ctx.memory_peak()
    del server, scene
    gc.collect()
    ctx.free()
    return out


async def _serve(ctx, server, jobs: list[dict], tracing: dict) -> dict:
    from rtbench import trace as tr

    ws = await server.serve(port=0, host="127.0.0.1")
    port = ws.sockets[0].getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    children = []
    try:
        for job in jobs:
            child = await asyncio.create_subprocess_exec(
                sys.executable, os.path.join(here, "loadgen.py"), str(port),
                stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE, limit=1 << 28)
            children.append(child)
            child.stdin.write((json.dumps(job) + "\n").encode())
            await child.stdin.drain()
        for child in children:
            line = await child.stdout.readline()
            if line.strip() != b"ready":
                raise RuntimeError(f"load generator: {line!r}")
        setup_s = time.time() - ctx.t_start
        events: dict = {}
        prof = None
        if ctx.trace:
            prof = tr.profiled(events)
            prof.__enter__()
            tracing["on"] = True
        for child in children:
            child.stdin.write(b"go\n")
            await child.stdin.drain()
        if prof is not None:
            await asyncio.sleep(ctx.traffic["trace_seconds"])
            tracing["on"] = False
            prof.__exit__(None, None, None)
        reps = [json.loads(await child.stdout.readline()) for child in children]
        for child in children:
            await child.wait()
    finally:
        for child in children:
            if child.returncode is None:
                child.kill()
                await child.wait()
        ws.close()
        await ws.wait_closed()
    rep = {"requests": sorted((r for x in reps for r in x["requests"]), key=lambda r: r["due"]),
           "errors": [e for x in reps for e in x["errors"]], "cpu_s": max(x["cpu_s"] for x in reps)}
    recs = rep["requests"]
    due = [r["due"] for r in recs]
    first = window.latencies(due, [r["first"] if r["done"] is not None else None for r in recs])
    image = window.latencies(due, [r["done"] for r in recs])
    failed = sum(r["done"] is None for r in recs)
    late = [r["late"] for r in recs if r["late"] is not None]
    ok_first = [v for v in first if v != window.NEVER]
    ok_image = [v for v in image if v != window.NEVER]
    print(f"served: {len(recs)} requests, {failed} failed; first chunk median "
          f"{statistics.median(ok_first) if ok_first else None} s, image median "
          f"{statistics.median(ok_image) if ok_image else None} s; generator late p95 "
          f"{window.percentile(late, 95) if late else None} s, max {max(late) if late else None} s; "
          f"busiest generator's CPU {rep['cpu_s']} s; errors {rep['errors']}", file=sys.stderr)
    return {
        "setup_s": setup_s,
        # Images whose last pixel came inside the window, per second of it.
        "images_per_s": sum(r["done"] is not None and r["done"] < ctx.seconds for r in recs) / ctx.seconds,
        "first_chunk_p95_s": window.percentile(first, 95),
        "image_p95_s": window.percentile(image, 95),
        "attempted": len(recs),
        "failed": failed,
        "requests": recs,
        "events": events.get("events"),
        "traced_frames": [],
    }


def check(ctx, out: dict) -> dict:
    """The numbers compared: requests whose image differs from the first
    finished one of their kind (the server renders a kind's frame from the
    same seed every time), and the share of the reference's rows on which
    a request's pixels differ from the reference's."""
    import numpy as np

    from rtbench import compare

    w = ctx.render_params["width"]
    rows = ctx.check_rows
    kinds = ctx.traffic["clients"]
    firsts, unequal, worst = {}, 0, 0.0
    refs = {}
    for r in out["requests"]:
        if r["done"] is None or "digest" not in r:
            continue
        k = r["kind"]
        if k not in firsts:
            firsts[k] = r["digest"]
        unequal += int(r["digest"] != firsts[k])
        spp = kinds[k]["spp"]
        if spp not in refs:
            refs[spp] = compare.reference_rows(ctx, spp, rows)
        got = np.frombuffer(base64.b64decode(r["rows"]), np.uint8).reshape(len(rows), w, 3)
        # The rows arrive in the order of ``rows`` (render rows), as the reference's.
        worst = max(worst, compare.pixels_off_pct(got, refs[spp]))
    return {"pixels_off_pct": (worst, ctx.config["check"]["pixels_off_pct"]), "images_unequal": (unequal, 0)}
