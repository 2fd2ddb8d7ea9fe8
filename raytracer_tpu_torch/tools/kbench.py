"""BVH traversal kernels alone: ms per 1M rays on two wavefronts of a scene.

Port of ``raytracer_tpu/tools/kbench.py``, over the measurement helpers of
``tools/kernel_steps.py`` (``scene_rays``, ``event_ms``). Times only the
kernel launch (CUDA events around ``--reps`` launches queued behind a
device-side spacer, so the host's launch rate is not in the time) of each
variant:

- ``widesmem``: K2, the 8-wide traversal (``ops/bvh_traverse.py``);
- ``binary``: K4, the skip-link walk of the binary tree (``ops/bvh_binary.py``);

on two wavefronts, both sorted by the coherence key as the engine sorts them:

- ``coherent``: camera rays through the frame;
- ``bounce``: BSDF-sampled rays from the camera rays' hit points (the hard
  case: a wavefront in the middle of its paths).

CUDA only: without a card it exits 1. The first line names the card and its
power limit.

Usage:
  python -m raytracer_tpu_torch.tools.kbench [scenes/flying_unicorn.toml] \\
      [--n 1048576] [--variants widesmem,binary] [--reps 5]
"""

from __future__ import annotations

import argparse
import sys

import torch

VARIANTS = ("widesmem", "binary")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="raytracer-tpu-torch-kbench")
    p.add_argument("scene", nargs="?", default="scenes/flying_unicorn.toml")
    p.add_argument("--n", type=int, default=1 << 20)
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    variants = [v for v in args.variants.split(",") if v]
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        p.error(f"unknown variants {unknown}; this tool has {', '.join(VARIANTS)}")
    if not torch.cuda.is_available():
        print("kbench: torch.cuda.is_available() is False; the kernels run on a CUDA device only",
              file=sys.stderr)
        return 1

    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.loader import load_scene
    from raytracer_tpu_torch.ops import bvh_binary as bb
    from raytracer_tpu_torch.ops import bvh_traverse as bt
    from raytracer_tpu_torch.ops import keys
    from raytracer_tpu_torch.ops.intersect import scene_precompute
    from raytracer_tpu_torch.tools.kernel_steps import SPACER_CYCLES, card, event_ms, scene_rays

    cfg = RenderConfig()
    eps = cfg.eps
    scene = load_scene(args.scene, device="cuda")
    if not scene.use_bvh:
        print(f"{scene.name}: no BVH: nothing to measure")
        return 1
    lanes = cfg.width * cfg.height * 4
    if not 0 < args.n <= lanes:
        p.error(f"--n must be in 1..{lanes} (the lanes of a {cfg.width}x{cfg.height} frame)")
    _, classes = scene_rays(scene, scene_precompute(scene), cfg, args.n, seed=20261016 + args.seed)

    print(f"{card()} | {scene.name}: {args.n} rays, reps={args.reps}")
    kernels = {"widesmem": ("K2", bt.bvh_traverse_cuda), "binary": ("K4", bb.bvh_binary_cuda)}
    for variant in variants:
        kname, launch = kernels[variant]
        for wname, cname in (("coherent", "camera"), ("bounce", "bounce")):
            ro, rd, t_init, res0, any_hit = classes[cname]
            order = keys.coherence_order(scene, ro, rd, eps)
            run_args = (scene, tuple(c[order] for c in ro), tuple(c[order] for c in rd),
                        t_init[order], res0[order], any_hit, eps)
            ms = event_ms(lambda: launch(*run_args), args.reps, SPACER_CYCLES)
            hits = float((launch(*run_args)[0] < 1e30).double().mean())
            print(f"  {variant:9s} ({kname}) {wname:9s} {ms * 1e6 / args.n:8.4f} ms/1Mray  "
                  f"(mean of {args.reps} launches behind a spacer; hit {hits:.3f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
