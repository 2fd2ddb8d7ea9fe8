"""Summarize a ``torch.profiler`` trace: top device kernels and host ops by
total time, and the device's busy share.

Port of ``raytracer_tpu/tools/top_ops.py``, the companion of
``tools.render --profile DIR``. Reads the Chrome trace JSON that
``utils.timing.device_trace`` writes (``DIR/*.trace.json`` or ``.json.gz``)
and sums slice durations by event name, so a render's time can be
apportioned (BVH traversal kernel, coherence key, sort, shading ops) without
a trace viewer:

    python -m raytracer_tpu_torch.tools.render scenes/flying_unicorn.toml \\
        --spp 16 --profile chiprun_out/trace
    python -m raytracer_tpu_torch.tools.top_ops chiprun_out/trace --top 15

The profiler tags every slice with a category. Device slices (``kernel``,
``gpu_memcpy``, ``gpu_memset``) and host operator slices (``cpu_op``) are
listed apart, and the union of the device slices over the traced window is
the device's busy time: the rest of the window the device sat idle.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import sys

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op"})


def load_trace_events(profile_dir: str) -> list[dict]:
    """All complete-slice events from every trace.json(.gz) under the dir."""
    pats = [
        os.path.join(profile_dir, "**", "*.trace.json.gz"),
        os.path.join(profile_dir, "**", "*.trace.json"),
    ]
    files = sorted({f for p in pats for f in glob.glob(p, recursive=True)})
    events: list[dict] = []
    for f in files:
        opener = gzip.open if f.endswith(".gz") else open
        with opener(f, "rt") as fh:
            data = json.load(fh)
        events += [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]
    return events


def by_category(events: list[dict], cats) -> list[dict]:
    """The events whose category is one of ``cats``."""
    return [e for e in events if str(e.get("cat", "")).lower() in cats]


def summarize(
    events: list[dict],
    top: int = 20,
    like: str | None = None,
    include_host_frames: bool = False,
):
    """-> (rows, total_us): rows = [(name, total_us, count, mean_us)].

    Python source-line slices (``file.py(123): fn``, category
    ``python_function``, recorded only when the profiler is asked for
    stacks) are excluded unless ``include_host_frames``: they nest, so their
    durations count twice.
    """
    total = collections.Counter()
    count = collections.Counter()
    for e in events:
        name = e.get("name", "?")
        if not include_host_frames and (name.startswith("$") or e.get("cat") == "python_function"):
            continue
        if like and like not in name:
            continue
        dur = float(e.get("dur", 0.0))  # microseconds
        total[name] += dur
        count[name] += 1
    rows = [
        (name, us, count[name], us / max(count[name], 1))
        for name, us in total.most_common(top)
    ]
    return rows, sum(total.values())


def device_busy(events: list[dict]) -> tuple[float, float]:
    """-> (busy_us, window_us): the time at least one device slice ran (the
    union of their intervals: streams may overlap), and the traced window,
    from the first start to the last end of the device and host-op slices."""
    spans = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
        for e in by_category(events, DEVICE_CATS)
    )
    busy, end = 0.0, float("-inf")
    for t0, t1 in spans:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    window = by_category(events, DEVICE_CATS | HOST_CATS)
    if not window:
        return 0.0, 0.0
    start = min(float(e["ts"]) for e in window)
    stop = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in window)
    return busy, stop - start


def format_rows(rows, total_us: float, what: str) -> list[str]:
    lines = [f"{'total_ms':>10} {'count':>7} {'mean_us':>9}  name"]
    lines += [f"{us / 1e3:>10.2f} {n:>7} {mean:>9.1f}  {name[:90]}" for name, us, n, mean in rows]
    lines.append(f"{total_us / 1e3:>10.2f} {'':>7} {'':>9}  TOTAL ({what})")
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="raytracer-tpu-torch-top-ops")
    p.add_argument("profile_dir", help="dir passed to tools.render --profile")
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--like", default=None, help="substring filter on op names")
    p.add_argument(
        "--all", action="store_true",
        help="include Python source-line slices (they nest and count twice)",
    )
    args = p.parse_args(argv)

    events = load_trace_events(args.profile_dir)
    if not events:
        print(f"no trace events under {args.profile_dir}", file=sys.stderr)
        return 1
    device = by_category(events, DEVICE_CATS)
    if device:
        rows, total_us = summarize(device, args.top, args.like)
        print("\n".join(["device kernels and copies:"] + format_rows(rows, total_us, "device slices")))
        busy, window = device_busy(events)
        print(f"device busy {busy / 1e3:.2f} ms of a {window / 1e3:.2f} ms window: "
              f"{busy / max(window, 1e-9):.2%} busy, {1 - busy / max(window, 1e-9):.2%} idle")
        rows, total_us = summarize(by_category(events, HOST_CATS), args.top, args.like)
        print("\n".join(["host ops (they nest: a parent's time holds its children's):"]
                        + format_rows(rows, total_us, "host op slices")))
    else:  # a CPU render: host ops alone
        host = by_category(events, HOST_CATS) or events
        rows, total_us = summarize(host, args.top, args.like, args.all)
        print("\n".join(format_rows(rows, total_us, "all matching slices")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
