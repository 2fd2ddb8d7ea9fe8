"""The knee of a served cell: its traffic at several fixed rates, one short
window each, to find the highest rate at which completions keep pace with
arrivals through the window. Run once when a served cell is defined; the
cell's traffic file then states its rate as a number.

    python3 benchmark/rtbench/sweep.py --workload <cell> --rates 1,2,3 --seconds 20

For each rate it prints the requests, how many finished, the latencies'
medians and 95th percentiles, the generator's lateness, and the median
image latency of the window's last third over its first third: near 1
where the server keeps pace, growing with the backlog where it does not.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(1, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import run as runmod
    from rtbench import served, spec, window

    sp = spec.load(ROOT)
    cell = spec.cell(sp, args.workload)
    config = spec.config(sp, cell["config"], ROOT)
    base = spec.traffic(cell["traffic"])
    for rate in (float(r) for r in args.rates.split(",")):
        a = argparse.Namespace(seed=args.seed, seconds=args.seconds, trace=0, device="cuda", width=0, height=0)
        ctx = runmod.Ctx(a, cell, config, {**base, "rate": rate})
        out = served.run(ctx)
        recs = out["requests"]
        lat = window.latencies([r["due"] for r in recs], [r["done"] for r in recs])
        fin = [v for v in lat if v != window.NEVER]
        third = max(1, len(recs) // 3)
        head = [v for v in lat[:third] if v != window.NEVER]
        tail = [v for v in lat[-third:] if v != window.NEVER]
        late = [r["late"] for r in recs if r["late"] is not None]
        print(json.dumps({
            "rate": rate, "requests": len(recs), "finished": len(fin),
            "image_median_s": statistics.median(fin) if fin else None,
            "image_p95_s": window.percentile(lat, 95),
            "first_chunk_p95_s": out["first_chunk_p95_s"],
            "images_per_s": out["images_per_s"],
            "late_p95_s": window.percentile(late, 95) if late else None,
            "tail_over_head": (statistics.median(tail) / statistics.median(head)) if head and tail else None,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
