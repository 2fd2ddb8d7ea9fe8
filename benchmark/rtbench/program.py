"""What the program records itself in a traced run: its spans in the trace
(``user_annotation`` slices named ``rt.<layer>.<phase>``, which it emits
through ``torch.profiler.record_function`` while the profiler records) and
its counters (``raytracer_tpu_torch.utils.timing.counters()``, counted
only while the profiler records, so over the profiled frames alone).

A program that records neither gives ``None`` from each function here, and
the per-layer metrics that read them leave themselves out of the result.
"""

from __future__ import annotations

import collections

PREFIX = "rt."


def span_ms(ctx) -> dict | None:
    """The total duration in ms of each program span in the trace, by name;
    ``None`` when the trace holds none."""
    total: dict = collections.defaultdict(float)
    for e in ctx.out.get("events") or []:
        if str(e.get("cat", "")).lower() == "user_annotation" and e["name"].startswith(PREFIX):
            total[e["name"]] += float(e.get("dur", 0.0)) / 1e3
    return dict(total) or None


def counters(ctx) -> dict | None:
    """The program's counters over the profiled part of the run; ``None``
    when the trace holds no program span or the program keeps no counters."""
    if span_ms(ctx) is None:
        return None
    from raytracer_tpu_torch.utils import timing

    read = getattr(timing, "counters", None)
    return read() if read is not None else None


def frames(ctx) -> int:
    """The profiled frames of an offline run."""
    return len(ctx.out.get("traced_frames") or [])


def per_frame(ctx, value):
    """``value`` over the profiled frames; ``None`` where either is missing."""
    n = frames(ctx)
    return None if value is None or n == 0 else value / n
