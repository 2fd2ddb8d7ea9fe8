"""Render observability: the port's copy of ``RenderStats`` and
``Throughput`` from ``raytracer_tpu/utils/timing.py`` (the same fields and
summary keys, which the server sends to clients that ask for ``stats``),
and ``device_trace``, its profiler trace over ``torch.profiler``."""

from __future__ import annotations

import contextlib
import gzip
import logging
import os
import shutil
import time
from dataclasses import dataclass, field

log = logging.getLogger("raytracer_tpu_torch.timing")


@dataclass
class RenderStats:
    """Per-phase wall time and ray counts of one render."""

    phases: dict = field(default_factory=dict)  # name -> seconds
    rays: int = 0
    samples: int = 0
    pixels: int = 0
    bands: int = 0  # band dispatches
    started: float = field(default_factory=time.time)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (time.time() - t0)

    @property
    def wall(self) -> float:
        return time.time() - self.started

    @property
    def mrays_per_s(self) -> float:
        return self.rays / max(self.wall, 1e-9) / 1e6

    def summary(self) -> dict:
        return {
            "wall_s": round(self.wall, 3),
            "rays": self.rays,
            "mrays_per_s": round(self.mrays_per_s, 2),
            "samples": self.samples,
            "pixels": self.pixels,
            "bands": self.bands,
            "phases": {k: round(v, 3) for k, v in self.phases.items()},
        }

    def log_summary(self, prefix: str = "") -> None:
        log.info("%srender stats: %s", prefix, self.summary())


@contextlib.contextmanager
def device_trace(trace_dir: str | None, device="cuda"):
    """Trace the block with ``torch.profiler`` when ``trace_dir`` is set; a
    no-op otherwise.

    The device-side complement of ``RenderStats``' phase timers: host ops
    always, and the device's kernels and copies when ``device``, the device
    the block renders on, is a CUDA one. On exit one Chrome trace is written,
    ``trace_dir/<run>.trace.json.gz`` (a frame is hundreds of thousands of
    slices), which ``tools/top_ops.py`` summarizes and Perfetto displays.
    """
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.trace.json")
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()  # the device's last kernels belong to the trace
    prof.export_chrome_trace(path)
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb", compresslevel=3) as dst:
        shutil.copyfileobj(src, dst)
    os.remove(path)
    log.info("device trace written to %s.gz", path)


class Throughput:
    """Simple EMA throughput meter for streaming paths."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.value = 0.0
        self._last: float | None = None

    def tick(self, units: float) -> float:
        now = time.time()
        if self._last is not None:
            dt = max(now - self._last, 1e-9)
            inst = units / dt
            self.value = self.alpha * inst + (1 - self.alpha) * self.value
        self._last = now
        return self.value
