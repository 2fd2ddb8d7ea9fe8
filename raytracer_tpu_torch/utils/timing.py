"""Host-side render statistics: the port's copy of ``RenderStats`` from
``raytracer_tpu/utils/timing.py`` (the same fields and summary keys, which
the server sends to clients that ask for ``stats``)."""

from __future__ import annotations

import contextlib
import logging
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
