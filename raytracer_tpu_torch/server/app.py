"""Asyncio WebSocket render server.

Port of ``raytracer_tpu/server/app.py``, speaking the same protocol (JSON
``render`` / ``stop_rendering`` in, binary 60-pixel RenderedPixels chunks
out, ``raytracer_tpu_torch.server.wire``) with the same per-connection job
semantics: one render at a time, a job created pre-cancelled, cancellation
observed between band dispatches, the optional ``width``/``height``,
``progressive``, ``stats`` and ``batch`` request fields.

Renders run on ``device`` (CUDA by default), with ``sharded`` choosing
between the one-device renderer and row bands over every visible CUDA
device (``render.renderer.make_renderer``'s policy). Differences from the
JAX server: a render that raises is logged and ends the job, so the
connection takes the next render; a renderer that cannot be built is logged
and closes the connection.
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import string
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from raytracer_tpu_torch.config import DEFAULT_PORT, RenderConfig
from raytracer_tpu_torch.render.renderer import (
    SHARDED_ENGINES,
    Renderer,
    finalize_device_dyn,
    make_renderer,
)
from raytracer_tpu_torch.server import wire
from raytracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from raytracer_tpu_torch.utils.timing import RenderStats

log = logging.getLogger("raytracer_tpu_torch.server")

WIDTH = 600  # reference: src/server.rs:29-30
HEIGHT = 450

# Hostile-request guards (as in the JAX server): requests outside these
# bounds close the connection.
MAX_DIM = 4096
MAX_SPP = 1 << 20
# Each cached renderer pins a device scene copy; bound the cache.
MAX_RENDERERS = 8


def _start_pull(t: torch.Tensor):
    """Start copying ``t`` to the host; returns a function that waits for the
    copy and gives the numpy array. On CUDA the copy is enqueued now, so
    work enqueued later does not delay it."""
    if t.device.type != "cuda":
        return t.numpy
    host = t.to("cpu", non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait() -> np.ndarray:
        done.synchronize()
        return host.numpy()

    return wait


class CancellationToken:
    """AtomicBool-equivalent cancel flag (reference: src/server.rs:226-251)."""

    def __init__(self) -> None:
        self._cancelled = threading.Event()

    def is_cancelled(self) -> bool:
        return self._cancelled.is_set()

    def cancel(self) -> bool:
        """Cancel; returns whether it was ALREADY cancelled (CAS semantics)."""
        already = self._cancelled.is_set()
        self._cancelled.set()
        return already

    def reset(self) -> None:
        self._cancelled.clear()


@dataclass
class RenderJob:
    """Per-connection render job; created pre-cancelled so running()==False."""

    send: "callable"  # async fn(bytes | str) -> None
    cancel_token: CancellationToken = field(default_factory=CancellationToken)

    PASSES_PER_DISPATCH = 8  # cancellation granularity at high spp

    def __post_init__(self) -> None:
        self.cancel_token.cancel()
        self.stats: RenderStats | None = None  # stats of the most recent run()
        # Strong reference to the detached render task (the event loop keeps
        # only a weak one).
        self.task: asyncio.Task | None = None

    def running(self) -> bool:
        return not self.cancel_token.is_cancelled()

    def stop(self) -> None:
        self.cancel_token.cancel()

    def mark_running(self) -> None:
        """Flip to running synchronously, before the render task is
        scheduled, so a render message arriving in between is ignored."""
        self.cancel_token.reset()

    async def run(
        self,
        renderer: Renderer,
        spp: int,
        progressive: bool = False,
        want_stats: bool = False,
        batch: bool = False,
        arrived: float | None = None,
    ) -> bool:
        """Render + stream; returns True if stopped before completion.

        Callers flip the job to running with ``mark_running()`` first. The
        render's RenderStats land in ``self.stats``; ``want_stats`` also
        sends them to the client as a JSON text message after the pixels.
        Their ``wall_s`` counts from ``arrived`` (``time.perf_counter()``
        when the request came in; default: now), and their phases are
        ``executor_wait`` (from a hand-off to the executor to its thread
        starting), ``band`` (``render_band_sums``, which the engines' own
        spans trace), ``pull`` (finalize and the wait for the u8 pixels;
        span ``rt.server.pull``) and ``send`` (time in ``self.send``; span
        ``rt.server.send``).
        """
        cancelled = self.cancel_token.is_cancelled
        cfg = renderer.cfg
        height = cfg.height
        loop = asyncio.get_running_loop()
        stats = RenderStats()
        if arrived is not None:
            stats.started = arrived
        stats.pixels = cfg.width * height
        if progressive:
            _, k_p_, n_chunks_ = renderer.plan_progressive(spp)
            stats.samples = k_p_ * n_chunks_ * 4
        else:
            stats.samples = renderer.samples_rendered(spp) * 4
        # This render's ray counters (device scalars), kept locally: the
        # renderer is shared across connections and the warm-up thread.
        ray_counts: list = []
        bands = 0
        # 60 pixels per message at the reference width; wider frames use 240.
        ppm = wire.PIXELS_PER_MSG if cfg.width <= 600 else 240

        async def in_executor(fn, *args):
            t_sub = time.perf_counter()

            def timed():
                stats.add("executor_wait", time.perf_counter() - t_sub)
                return fn(*args)

            return await loop.run_in_executor(None, timed)

        def band(y0: int, rows: int, k: int, n: int, salt: int):
            with stats.phase("band"):
                return renderer.render_band_sums(y0, rows, k, n, salt=salt, return_rays=True)

        def pull_rgb(sums, num_samples) -> np.ndarray:
            with stats.phase("pull", span="rt.server.pull"):
                return finalize_device_dyn(sums, num_samples).cpu().numpy()

        async def send(msg) -> None:
            with stats.phase("send", span="rt.server.send"):
                await self.send(msg)

        async def stream_rows(y0: int, rows: int, rgb: np.ndarray) -> None:
            # rgb holds render rows [y0, y0+rows); wire labels are flipped:
            # label = height-1-y_render (src/server.rs:181).
            valid = min(rows, height - y0)
            if batch:
                # A band's standard chunks concatenated into few messages,
                # each below ~1 MiB (python-websockets' default max_size).
                bytes_per_row = 3 * rgb.shape[1] + 6 * (-(-rgb.shape[1] // ppm))
                rows_per_msg = max(1, (1 << 19) // bytes_per_row)
                for i0 in range(0, valid, rows_per_msg):
                    i1 = min(i0 + rows_per_msg, valid)
                    await send(wire.pack_rows_batched(height - 1 - (y0 + i0), rgb[i0:i1], ppm))
                return
            for i in range(valid):
                for msg in wire.pack_row(height - 1 - (y0 + i), rgb[i], ppm):
                    await send(msg)

        _, k, n_passes = renderer.plan(spp)
        if n_passes == 0:
            # spp < 4: the reference's integer spp/4 yields zero samples and
            # streams black pixels (src/server.rs:332-360).
            black = np.zeros((1, cfg.width, 3), np.uint8)
            for y in range(height):
                if cancelled():
                    break
                await stream_rows(y, 1, black)
        elif progressive:
            # Re-stream the whole frame after every k-sample chunk. Running
            # band sums stay on the device; finalize runs there too, so only
            # u8 pixels cross to the host. One band behind: band i+1 is
            # enqueued before band i's pixels are waited for and sent.
            rows_p, k_p, n_chunks = renderer.plan_progressive(spp)
            sums = {y0: None for y0, _ in renderer.iter_bands(spp, rows_p)}
            pending = None  # (y0, rows, wait-for-pixels function)
            # First sweep at 4 samples so a whole image lands early; the
            # stolen samples are repaid in sweep 2 and the total is exact.
            if n_chunks > 1 and k_p > 4:
                sched = [4, k_p - 4] + [k_p] * (n_chunks - 1)
            else:
                sched = [k_p] * n_chunks

            def dispatch(y0, chunk, kc, done):
                out, nrays = band(y0, rows_p, kc, 1, chunk)
                with stats.phase("pull", span="rt.server.pull"):
                    s = out if sums[y0] is None else sums[y0] + out
                    return s, nrays, _start_pull(finalize_device_dyn(s, done))

            def wait(ppull):
                with stats.phase("pull", span="rt.server.pull"):
                    return ppull()

            done = 0
            for chunk, kc in enumerate(sched):
                if cancelled():
                    break
                done += kc
                for y0, rows in renderer.iter_bands(spp, rows_p):
                    if cancelled():
                        break
                    s, nrays, pull = await in_executor(dispatch, y0, chunk, kc, done)
                    sums[y0] = s
                    ray_counts.append(nrays)
                    bands += 1
                    if pending is not None:
                        py0, prows, ppull = pending
                        await stream_rows(py0, prows, await in_executor(wait, ppull))
                    pending = (y0, rows, pull)
            if pending is not None and not cancelled():
                py0, prows, ppull = pending
                await stream_rows(py0, prows, await in_executor(wait, ppull))
        else:
            # Each pixel streamed exactly once, band by band, as its band
            # completes all samples.
            # BVH scenes: one dispatch per sample, as render_rows does.
            rows_b, k, n_passes = renderer.plan_delivery(spp)
            g = 1 if renderer.scene.use_bvh else self.PASSES_PER_DISPATCH
            for y0, rows in renderer.iter_bands(spp, rows_b):
                if cancelled():
                    break
                sums = None
                for g0 in range(0, n_passes, g):
                    if cancelled():
                        break
                    out, nrays = await in_executor(band, y0, rows_b, k, min(g, n_passes - g0), g0)
                    ray_counts.append(nrays)
                    bands += 1
                    sums = out if sums is None else sums + out
                if sums is not None and not cancelled():
                    rgb = await in_executor(pull_rgb, sums, k * n_passes)
                    await stream_rows(y0, rows, rgb)

        stats.bands = bands
        stats.rays = int(sum(int(r) for r in ray_counts))
        self.stats = stats
        if want_stats and not cancelled():
            await self.send(json.dumps({"type": "render_stats", **stats.summary()}))
        return self.cancel_token.cancel()


class Server:
    """WebSocket server over a set of loaded scenes, rendering on ``device``."""

    def __init__(
        self,
        scenes: dict,
        cfg: RenderConfig | None = None,
        width: int = WIDTH,
        height: int = HEIGHT,
        device: str | torch.device = DEFAULT_DEVICE,
        sharded: bool | None = None,
    ) -> None:
        self.device = resolve_device(device)
        self.scenes = {name: s.to(self.device) for name, s in scenes.items()}
        self.base_cfg = cfg or RenderConfig()
        # The reference's compute parallelism is row bands over its thread
        # pool (src/server.rs:157-199); here it is row bands over devices.
        # sharded=None uses every visible CUDA device for a scene the
        # megakernel renders and the plain renderer otherwise
        # (make_renderer's policy). Fail fast on an engine that cannot shard:
        # raising per render request would tear down client connections.
        if sharded and self.base_cfg.engine not in SHARDED_ENGINES:
            raise ValueError("sharded serving requires engine='regen' or 'mega'")
        self.sharded = sharded
        self.width = width
        self.height = height
        self.connections: set[str] = set()
        self._renderers: OrderedDict[tuple[str, int, int], Renderer] = OrderedDict()
        self._renderers_lock = threading.Lock()  # warm-up thread vs event loop

    def renderer_for(self, scene_name: str, width: int, height: int) -> Renderer:
        key = (scene_name, width, height)
        with self._renderers_lock:
            if key not in self._renderers:
                cfg = replace(self.base_cfg, width=width, height=height)
                self._renderers[key] = make_renderer(
                    self.scenes[scene_name], cfg, self.device, sharded=self.sharded
                )
                while len(self._renderers) > MAX_RENDERERS:
                    # Evict LRU; an in-flight render keeps its own reference.
                    self._renderers.popitem(last=False)
            self._renderers.move_to_end(key)
            return self._renderers[key]

    def warmup(self, block: bool = False) -> threading.Thread:
        """Render one band of every scene at the default resolution in a
        daemon thread, so the kernel build (nvcc, at first use) and the
        first launch are paid at startup instead of by the first client."""

        def go() -> None:
            import time as _time

            for name in self.scenes:
                t0 = _time.time()
                try:
                    r = self.renderer_for(name, self.width, self.height)
                    rows, _, _ = r.plan_delivery(64)
                    # return_rays=True keeps warm-up off the shared ray_counts;
                    # int() waits for the band.
                    int(r.render_band_sums(0, rows, 1, 1, return_rays=True)[1])
                    log.info(
                        "warm-up: %s %dx%d ready in %.1fs",
                        name, self.width, self.height, _time.time() - t0,
                    )
                except Exception:
                    log.exception("warm-up failed for %s", name)

        t = threading.Thread(target=go, name="rt-warmup", daemon=True)
        t.start()
        if block:
            t.join()
        return t

    def _new_connection_id(self) -> str:
        # 5 distinct lowercase letters (reference: src/server.rs:63-78)
        while True:
            cid = "".join(random.sample(string.ascii_lowercase, 5))
            if cid not in self.connections:
                self.connections.add(cid)
                return cid

    async def handle_connection(self, websocket) -> None:
        cid = self._new_connection_id()
        log.info("[%s] Accepted connection.", cid)
        send_lock = asyncio.Lock()

        async def send(msg) -> None:
            async with send_lock:
                try:
                    await websocket.send(msg)
                except Exception:
                    job.stop()  # send on a closed socket cancels (ref :213-216)

        job = RenderJob(send=send)
        try:
            async for raw in websocket:
                arrived = time.perf_counter()
                if isinstance(raw, (bytes, bytearray)):
                    continue
                log.info("[%s] New message: %r", cid, raw)
                try:
                    msg = json.loads(raw)
                    mtype = msg["type"]
                except (json.JSONDecodeError, KeyError, TypeError):
                    log.error("[%s] failed to parse message", cid)
                    break  # reference panics the connection task (:92)
                if not job.running() and mtype == "render":
                    try:
                        scene = msg["scene"]
                        spp = int(msg["spp"])  # required, like the reference
                        w = int(msg.get("width", self.width))
                        h = int(msg.get("height", self.height))
                    except (KeyError, TypeError, ValueError):
                        log.error("[%s] malformed render request", cid)
                        break
                    if scene not in self.scenes:
                        log.error("[%s] unknown scene %r", cid, scene)
                        break  # reference unwrap-panics (:100)
                    if not (1 <= w <= MAX_DIM and 1 <= h <= MAX_DIM) or not (
                        0 <= spp <= MAX_SPP
                    ):
                        log.error(
                            "[%s] rejected render request w=%s h=%s spp=%s", cid, w, h, spp
                        )
                        break
                    progressive = bool(msg.get("progressive", False))
                    want_stats = bool(msg.get("stats", False))
                    batch = bool(msg.get("batch", False))
                    try:
                        renderer = self.renderer_for(scene, w, h)
                    except Exception as e:
                        log.error("[%s] no renderer for %r at %dx%d: %s", cid, scene, w, h, e)
                        break

                    async def run_render(arrived: float = arrived) -> None:
                        log.info("[%s] Rendering...", cid)
                        try:
                            stopped = await job.run(
                                renderer, spp, progressive, want_stats, batch, arrived=arrived
                            )
                        except Exception:
                            log.exception("[%s] render failed", cid)
                            job.stop()
                            return
                        if not stopped:
                            log.info(
                                "[%s] Done rendering. stats=%s",
                                cid, job.stats.summary() if job.stats else None,
                            )

                    job.mark_running()
                    task = asyncio.get_running_loop().create_task(run_render())
                    job.task = task
                    task.add_done_callback(lambda t, job=job: setattr(job, "task", None))
                elif job.running() and mtype == "stop_rendering":
                    job.stop()
                    log.info("[%s] Render cancelled.", cid)
                # all other (state, message) pairs are ignored (ref :112)
        finally:
            job.stop()
            self.connections.discard(cid)
            log.info("[%s] Disconnected.", cid)

    async def serve(self, port: int = DEFAULT_PORT, host: str = "0.0.0.0"):
        import websockets

        # No keepalive pings: a long band must not tear a healthy connection.
        server = await websockets.serve(
            self.handle_connection, host, port, max_size=1 << 22, ping_interval=None,
        )
        log.info("Listening on port %s.", port)
        return server

    async def serve_forever(self, port: int = DEFAULT_PORT, host: str = "0.0.0.0") -> None:
        server = await self.serve(port, host)
        await server.wait_closed()
