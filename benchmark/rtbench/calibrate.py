"""Readings that set a cell's limit on ``pixels_off_pct``: the program's on
many seeds, and the control's on three or more.

    python3 benchmark/rtbench/calibrate.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

from the root of a checkout, on the card(s) the cell asks for. For every
seed it renders the frame the cell's timed path renders (offline:
``make_renderer(...).render_image(spp)``; served: the same frame at each
client kind's sample count, which the server's bands equal) and prints its
``pixels_off_pct`` against the reference on that seed's check rows. The
control is the reference's own frame in the nearest lower precision than
the configuration's float32, bfloat16, put in the program's place; where
the program has a lower-precision path of its own (the regen engine's
``RT_STATE_BF16=1``), the program with it switched on. With ``--faults``
it also reads, on the control's seeds, the program with each fault of
``faults.py`` that the cell can have planted under it. Not run by the
benchmark's runs; its readings are in ``PERF.md``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(1, ROOT)


class _Args:
    def __init__(self, seed, device):
        self.seed, self.seconds, self.trace, self.device = seed, 0.0, 0, device
        self.width = self.height = 0


def cell_faults(config: dict) -> tuple[str, ...]:
    """The planted faults a configuration's frames can have."""
    from rtbench import faults

    if config["schedule"] != "k1":
        return ()
    return faults.SHARDED_FAULTS if config["cards"] > 1 else faults.K1_FAULTS


def readings(workload: str, seeds: list[int], control_seeds: list[int], device: str = "cuda",
             width: int = 0, height: int = 0, with_faults: bool = False) -> dict:
    import torch

    from rtbench import compare, faults, spec, window

    sp = spec.load(ROOT)
    cell = spec.cell(sp, workload)
    config = spec.config(sp, cell["config"], ROOT)
    traffic = spec.traffic(cell["traffic"])
    import run as runmod

    def ctx_for(seed):
        a = _Args(seed, device)
        a.width, a.height = width, height
        c = runmod.Ctx(a, cell, config, traffic)
        c.check_rows = window.check_rows(c.render_params["height"], c.config["check"]["row_stride"], seed)
        return c

    spps = ([traffic["spp"]] if traffic["kind"] == "offline"
            else sorted({k["spp"] for k in traffic["clients"].values()}))
    out = {"program": [], "control": [], "faults": {}}
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.loader import load_scene
    from raytracer_tpu_torch.render.renderer import make_renderer

    c0 = ctx_for(seeds[0])
    scene = load_scene(c0.scene_path, device=c0.device)

    def program(c, spp):
        r = make_renderer(scene, RenderConfig(seed=c.seed, **c.render), c.device)
        return compare.image_rows(r.render_image(spp), c.check_rows)

    for seed in seeds:
        c = ctx_for(seed)
        t0 = time.time()
        v = max(compare.pixels_off_pct(program(c, s), compare.reference_rows(c, s, c.check_rows)) for s in spps)
        out["program"].append([seed, v, time.time() - t0])
        print(json.dumps({"seed": seed, "program": v}), flush=True)
    for seed in control_seeds:
        c = ctx_for(seed)
        refs = {s: compare.reference_rows(c, s, c.check_rows) for s in spps}
        vals = []
        for s in spps:
            if config["schedule"] == "regen":
                os.environ["RT_STATE_BF16"] = "1"
                try:
                    got = program(c, s)
                finally:
                    del os.environ["RT_STATE_BF16"]
            else:
                got = compare.reference_rows(c, s, c.check_rows, dtype=torch.bfloat16)
            vals.append(compare.pixels_off_pct(got, refs[s]))
        out["control"].append([seed, max(vals)])
        print(json.dumps({"seed": seed, "control": max(vals)}), flush=True)
        for name in cell_faults(config) if with_faults else ():
            with faults.planted(name):
                v = max(compare.pixels_off_pct(program(c, s), refs[s]) for s in spps)
            out["faults"].setdefault(name, []).append([seed, v])
            print(json.dumps({"seed": seed, "fault": name, "reading": v}), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--faults", action="store_true", help="read the planted faults on the control's seeds")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 3
    r = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                 [int(s) for s in args.control_seeds.split(",")], with_faults=args.faults)
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
