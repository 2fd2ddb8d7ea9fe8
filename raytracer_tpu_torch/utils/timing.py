"""Render observability: the port's one tracing system.

- ``span(name)``: a host span in the ``torch.profiler`` trace. While a
  profiler records, it enters ``torch.profiler.record_function(name)``, so
  the span is a ``user_annotation`` slice in the same Chrome trace, on the
  same clock, as the device's kernels and copies; otherwise it is one shared
  no-op. Names are ``rt.<layer>.<phase>``; on any one thread the program's
  spans tile its host work at one level and never nest, so that a trace's
  idle gaps fall to the phase the host was in.
- ``count(name, n)``: a process-wide counter, added to only while a
  profiler records; ``counters()`` reads them, ``reset_counters()`` clears
  them.
- ``RenderStats``: the port's copy of ``raytracer_tpu/utils/timing.py``'s
  (the same fields and summary keys, which the server sends to clients that
  ask for ``stats``); a phase given a span name is also that span.
- ``device_trace``: a ``torch.profiler`` trace of a block, written to a
  directory.

The switch is the profiler's own state, which the profiler sets for the
whole process from its start to its stop. A profiler records the spans and
operations of the thread that started it, and of every thread only when
started with ``experimental_config=_ExperimentalConfig(profile_all_threads=True)``.
"""

from __future__ import annotations

import contextlib
import gzip
import logging
import os
import shutil
import threading
import time
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _autograd_profiler

log = logging.getLogger("raytracer_tpu_torch.timing")

_NO_SPAN = contextlib.nullcontext()
_counters: dict[str, int] = {}
_counters_lock = threading.Lock()


def recording() -> bool:
    """Whether a ``torch.profiler`` records in this process."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str | None):
    """A context manager: the span ``name`` while a profiler records, else
    (or when ``name`` is None) a shared no-op."""
    if name is None or not recording():
        return _NO_SPAN
    return torch.profiler.record_function(name)


_open_span = span  # RenderStats.phase's argument ``span`` shadows the function


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if recording():
        with _counters_lock:
            _counters[name] = _counters.get(name, 0) + n


def counters() -> dict[str, int]:
    """A copy of the counters."""
    with _counters_lock:
        return dict(_counters)


def reset_counters() -> None:
    with _counters_lock:
        _counters.clear()


@dataclass
class RenderStats:
    """Per-phase wall time and ray counts of one render."""

    phases: dict = field(default_factory=dict)  # name -> seconds
    rays: int = 0
    samples: int = 0
    pixels: int = 0
    bands: int = 0  # band dispatches
    started: float = field(default_factory=time.perf_counter)

    def add(self, name: str, seconds: float) -> None:
        self.phases[name] = self.phases.get(name, 0.0) + seconds

    @contextlib.contextmanager
    def phase(self, name: str, span: str | None = None):
        """Time the block into ``phases[name]``; with ``span``, the block is
        also that span."""
        t0 = time.perf_counter()
        try:
            with _open_span(span):
                yield
        finally:
            self.add(name, time.perf_counter() - t0)

    @property
    def wall(self) -> float:
        return time.perf_counter() - self.started

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

    Host ops and the program's spans always, and the device's kernels and
    copies when ``device``, the device the block renders on, is a CUDA one.
    On exit one Chrome trace is written,
    ``trace_dir/<run>.trace.json.gz`` (a frame is hundreds of thousands of
    slices), which ``tools/top_ops.py`` summarizes and Perfetto displays.
    """
    if not trace_dir:
        yield
        return
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
