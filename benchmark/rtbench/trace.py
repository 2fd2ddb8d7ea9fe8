"""The device trace of a traced run: ``torch.profiler`` over a bounded part
of the window, reduced to what the per-layer metrics read.

The profiler writes one Chrome trace to a temporary directory under
``TMPDIR``; it is read back and deleted. Device slices are the ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` events, host slices ``cpu_op``,
``cuda_runtime`` and ``user_annotation`` (the benchmark's own spans, which
``torch.profiler.record_function`` makes). A card's busy time is the union
of its device slices, so that overlapping streams count once (the
arithmetic of the program's ``tools/top_ops.py::device_busy``, copied);
the window runs from the first to the last slice of any kind.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import json
import os
import shutil
import tempfile

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "cuda_runtime", "user_annotation"})
SPAN_PREFIX = "rtbench."


@dataclasses.dataclass
class Summary:
    window_us: float
    busy_us: dict  # device index -> union of its device slices
    kernels: dict  # kernel name -> [total us, launches], over every device
    launches: int  # kernel slices in the window
    gaps: dict  # name of what the host did -> idle seconds of the first device
    spans: dict  # benchmark span name -> [(start us, duration us)]

    def busy_share(self) -> float:
        """Mean busy share of the devices that ran anything."""
        return sum(self.busy_us.values()) / len(self.busy_us) / self.window_us

    def kernel_us(self, like: str) -> tuple[float, int]:
        """Total device time and launches, over every device, of the kernels
        whose name holds ``like``."""
        us = n = 0
        for name, (t, c) in self.kernels.items():
            if like in name:
                us += t
                n += c
        return us, n

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v[0] / 1e6] for n, v in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def _union(spans):
    out = []
    for t0, t1 in sorted(spans):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def _device(e) -> int:
    args = e.get("args") or {}
    return int(args.get("device", e.get("pid", 0)))


def summarize(events: list[dict]) -> Summary:
    dev_ev = [e for e in events if str(e.get("cat", "")).lower() in DEVICE_CATS]
    host_ev = [e for e in events if str(e.get("cat", "")).lower() in HOST_CATS]
    every = dev_ev + host_ev
    if not dev_ev:
        raise RuntimeError("the trace holds no device slice: torch.profiler saw no CUDA activity")
    start = min(float(e["ts"]) for e in every)
    stop = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in every)
    per_dev = collections.defaultdict(list)
    kernels = collections.defaultdict(lambda: [0.0, 0])
    launches = 0
    for e in dev_ev:
        t0, d = float(e["ts"]), float(e.get("dur", 0.0))
        dv = _device(e)
        per_dev[dv].append((t0, t0 + d))
        if str(e.get("cat", "")).lower() == "kernel":
            launches += 1
            kernels[e["name"]][0] += d
            kernels[e["name"]][1] += 1
    busy = {}
    unions = {}
    for dv, spans in per_dev.items():
        unions[dv] = _union(spans)
        busy[dv] = sum(t1 - t0 for t0, t1 in unions[dv])
    # Idle gaps of the first device, each put to the host slice (not a
    # benchmark span) that overlaps it most.
    gaps = collections.defaultdict(float)
    first = min(unions)
    edges = [start] + [x for iv in unions[first] for x in iv] + [stop]
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                   for e in host_ev if not e["name"].startswith(SPAN_PREFIX)))
    starts = [h[0] for h in host]
    longest = max((h[1] - h[0] for h in host), default=0.0)
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        best, name = 0.0, "no host slice"
        lo = bisect.bisect_left(starts, g0 - longest)
        hi = bisect.bisect_right(starts, g1)
        for h0, h1, nm in host[lo:hi]:
            ov = min(g1, h1) - max(g0, h0)
            if ov > best:
                best, name = ov, nm
        gaps[name] += (g1 - g0) / 1e6
    spans = collections.defaultdict(list)
    for e in host_ev:
        if e["name"].startswith(SPAN_PREFIX):
            spans[e["name"]].append((float(e["ts"]), float(e.get("dur", 0.0))))
    return Summary(window_us=stop - start, busy_us=busy, kernels=dict(kernels),
                   launches=launches,
                   gaps=dict(gaps), spans=dict(spans))


@contextlib.contextmanager
def profiled(out: dict):
    """Profile the block (host and CUDA); on exit ``out["events"]`` holds
    the trace's complete slices."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("a traced run needs a CUDA card: no device slice to read")
    tmp = tempfile.mkdtemp(prefix="rtbench-trace-")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            yield
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            data = json.load(fh)
        out["events"] = [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
