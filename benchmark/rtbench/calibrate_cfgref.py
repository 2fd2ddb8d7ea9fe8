"""Readings that set the limit on ``pixels_off_pct`` of a cell whose
configuration names its own reference module (``offline_cfgref.py``).

    python3 benchmark/rtbench/calibrate_cfgref.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9 [--faults]

from the root of a checkout, on the card the cell asks for. For every seed
it renders the frame the cell's timed path renders
(``make_renderer(...).render_image(spp)``) and prints its
``pixels_off_pct`` against the configuration's reference on that seed's
check rows. On the control's seeds it reads two controls in the nearest
lower precision than the configuration's float32: the program with its
bfloat16 state (``RT_STATE_BF16=1``) and the reference computed in
bfloat16; and with ``--faults`` the program under the planted faults of
``faults.py`` that fit an offline frame of one card (half the samples, an
answer altered). A caller may hand ``readings`` further faults of its own.
Not run by the benchmark's runs; its readings are in ``PERF.md``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(1, ROOT)

FAULTS = ("half_the_samples", "answer_altered")


@contextlib.contextmanager
def _env(name: str, value: str):
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            del os.environ[name]
        else:
            os.environ[name] = saved


def readings(workload: str, seeds: list[int], control_seeds: list[int], faults: dict | None = None,
             device: str = "cuda", width: int = 0, height: int = 0) -> dict:
    """-> {"program": [[seed, value, seconds]], "control_state_bf16": [[seed,
    value]], "control_reference_bf16": [[seed, value]], "faults": {name:
    [[seed, value]]}}; ``faults`` maps a name to a function that returns a
    context manager planting the fault."""
    import torch

    import run as runmod
    from rtbench import calibrate, compare, offline_cfgref, spec, window
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.loader import load_scene
    from raytracer_tpu_torch.render.renderer import make_renderer

    sp = spec.load(ROOT)
    cell = spec.cell(sp, workload)
    config = spec.config(sp, cell["config"], ROOT)
    traffic = spec.traffic(cell["traffic"])
    spp = traffic["spp"]

    def ctx_for(seed):
        a = calibrate._Args(seed, device)
        a.width, a.height = width, height
        c = runmod.Ctx(a, cell, config, traffic)
        c.check_rows = window.check_rows(c.render_params["height"], c.config["check"]["row_stride"], seed)
        return c

    c0 = ctx_for(seeds[0])
    scene = load_scene(c0.scene_path, device=c0.device)

    def program(c):
        r = make_renderer(scene, RenderConfig(seed=c.seed, **c.render), c.device)
        return compare.image_rows(r.render_image(spp), c.check_rows)

    def emit(**kv):
        print(json.dumps(kv), flush=True)

    out = {"program": [], "control_state_bf16": [], "control_reference_bf16": [], "faults": {}}
    for seed in seeds:
        c = ctx_for(seed)
        t0 = time.time()
        v = compare.pixels_off_pct(program(c), offline_cfgref.reference_rows(c, spp, c.check_rows))
        out["program"].append([seed, v, time.time() - t0])
        emit(seed=seed, program=v)
    for seed in control_seeds:
        c = ctx_for(seed)
        ref = offline_cfgref.reference_rows(c, spp, c.check_rows)
        with _env("RT_STATE_BF16", "1"):
            v = compare.pixels_off_pct(program(c), ref)
        out["control_state_bf16"].append([seed, v])
        emit(seed=seed, control_state_bf16=v)
        v = compare.pixels_off_pct(offline_cfgref.reference_rows(c, spp, c.check_rows, dtype=torch.bfloat16), ref)
        out["control_reference_bf16"].append([seed, v])
        emit(seed=seed, control_reference_bf16=v)
        for name, plant in (faults or {}).items():
            with plant():
                v = compare.pixels_off_pct(program(c), ref)
            out["faults"].setdefault(name, []).append([seed, v])
            emit(seed=seed, fault=name, reading=v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--faults", action="store_true", help="read the planted faults on the control's seeds")
    args = ap.parse_args(argv)
    import torch

    from rtbench import faults

    if not torch.cuda.is_available():
        print("calibrate_cfgref.py: no CUDA card", file=sys.stderr)
        return 3
    planted = {name: (lambda name=name: faults.planted(name)) for name in FAULTS} if args.faults else None
    r = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                 [int(s) for s in args.control_seeds.split(",")], planted)
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
