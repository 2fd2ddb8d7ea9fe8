#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration and its traffic
mix come from ``BENCHMARK.json`` and the files it names (``rtbench/spec.py``).
With ``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled part of the
window by ``metrics/<name>.py``. Every run compares what the timed path
produced with the plain reference (``rtbench/compare.py``) and prints each
number compared beside its limit: on standard error as its last lines, and
in the result under ``checks``, its last key. The last line of standard
output is the result, one JSON object.

The run needs as many CUDA cards as the cell asks for; without them it
exits 3 and prints no result. It exits 4 if ``jax``, ``jaxlib``, ``flax``
or the JAX package ``raytracer_tpu`` is loaded once the window has closed,
and 2 where ``BENCHMARK.json`` or a file it names is missing.

For the tests only: ``--device cpu --width W --height H`` runs the same
code on the CPU at a tiny size (the program's plain PyTorch twins), with
the platform ``cpu`` in its result. No cell uses it.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(1, ROOT)
# Caches inside the checkout; no library of the run may load JAX.
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

from rtbench import spec as specmod  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer_tpu")


class Ctx:
    """What a driver, the comparison and the metric readers share."""

    def __init__(self, args, cell, config, traffic):
        self.args = args
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.t_start = T_START
        self.cards = cell["chips"]
        self.device = "cuda" if args.device == "cuda" else "cpu"
        self.ref_device = "cuda:0" if args.device == "cuda" else "cpu"
        self.render = dict(config["render"])
        if args.width:
            # The check's rows keep their share of the image at a tiny size.
            chk = dict(config["check"])
            chk["row_stride"] = max(1, chk["row_stride"] * args.height // self.render["height"])
            self.config = config = {**config, "check": chk}
            self.render.update(width=args.width, height=args.height)
        self.render_params = {**config.get("reference", {}), **self.render}
        self.scene_path = os.path.join(ROOT, config["scene"])
        self.kind = traffic["kind"]
        self.ref_counts: dict = {}
        self.ref_rays = None
        self.check_rows: list = []
        self.out: dict = {}
        self.summary = None

    def sync(self):
        import torch

        if self.device == "cuda":
            for d in range(self.cards):
                torch.cuda.synchronize(d)

    def memory_peak(self) -> int:
        import torch

        if self.device != "cuda":
            return 0
        return max(torch.cuda.max_memory_allocated(d) for d in range(self.cards))

    def free(self):
        import torch

        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--width", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--height", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    try:
        spec = specmod.load(ROOT)
        cell = specmod.cell(spec, args.workload)
        config = specmod.config(spec, cell["config"], ROOT)
        traffic = specmod.traffic(cell["traffic"])
    except (specmod.SpecError, OSError) as e:
        print(f"run.py: {e}", file=sys.stderr)
        return 2

    import torch

    if args.device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell["chips"]:
            print(f"run.py: the cell needs {cell['chips']} CUDA card(s), {have} visible", file=sys.stderr)
            return 3
    else:
        torch.set_num_threads(2)

    ctx = Ctx(args, cell, config, traffic)
    import importlib

    driver = importlib.import_module(f"rtbench.{traffic['kind']}")
    out = driver.run(ctx)
    ctx.out = out
    t_ref = time.time()
    found = forbidden_modules()
    if found:
        print(f"run.py: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 4
    checks = driver.check(ctx, out)
    print(f"run.py: set-up {out['setup_s']:.3f} s, window closed {t_ref - T_START:.3f} s after the start, "
          f"reference and check {time.time() - t_ref:.3f} s", file=sys.stderr)
    correct = all(v <= lim for v, lim in checks.values()) and out["failed"] == 0

    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    device = device_record(ctx, out)
    if ctx.trace:
        from rtbench import trace as tr

        ctx.summary = tr.summarize(out["events"])
        metrics = {}
        for m in specmod.per_layer(spec, cell["name"]):
            v = specmod.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = sum(ctx.summary.busy_us.values()) / len(ctx.summary.busy_us) / 1e6
        device["window_s"] = ctx.summary.window_us / 1e6
        result["breakdown"] = ctx.summary.breakdown()
    else:
        metrics = {}
        for m in specmod.end_to_end(spec, cell["name"]):
            v = out[m["name"]] if m["name"] in out else out[specmod.stem(m["name"])]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    found = forbidden_modules()
    if found:
        print(f"run.py: loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def device_record(ctx, out) -> dict:
    import torch

    if ctx.device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": ctx.cards,
            "memory_peak_bytes": out["memory_peak_bytes"]}


if __name__ == "__main__":
    sys.exit(main())
