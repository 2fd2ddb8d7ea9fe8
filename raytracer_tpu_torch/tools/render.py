"""Offline render CLI: scene TOML -> PNG.

    python -m raytracer_tpu_torch.tools.render scenes/cornell_box.toml \\
        --spp 64 --out cornell.png [--mis] [--width 600 --height 450] \\
        [--engine mega|regen|fused|simple] [--device cuda] [--no-shard] \\
        [--profile DIR]

Port of ``raytracer_tpu/tools/render.py``. The PNG is written by the
standard library's zlib (``utils/png.py``), so no imaging package is needed.
``--engine`` sets ``RenderConfig.engine`` (default ``mega``: the megakernel
where the scene allows it, else regen; ``fused`` for the fused-trace engine).
``RT_BVH_KERNEL=binary`` in the environment traces mesh scenes with the
binary skip-link walk (K4) instead of the 8-wide traversal (K2). With
several CUDA devices visible the row bands are spread over all of them
unless ``--no-shard`` is given. ``--profile DIR`` writes a ``torch.profiler``
Chrome trace of the render into DIR, the program's ``rt.*`` spans among its
slices (``tools/top_ops.py`` summarizes it), and prints the program's
counters of the render (``utils/timing.py::counters``) after its stats.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="raytracer-tpu-torch-render")
    parser.add_argument("scene", help="path to a scene .toml")
    parser.add_argument("--spp", type=int, default=64)
    parser.add_argument("--out", default=None, help="output PNG (default <scene>.png)")
    parser.add_argument("--width", type=int, default=600)
    parser.add_argument("--height", type=int, default=450)
    parser.add_argument("--mis", action="store_true", help="enable multiple importance sampling")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-depth", type=int, default=None)
    parser.add_argument("--engine", default="mega", help="mega (default), regen, fused or simple")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument(
        "--no-shard", action="store_true",
        help="force the single-device renderer even with multiple devices",
    )
    parser.add_argument(
        "--profile", metavar="DIR", default=None,
        help="write a torch.profiler Chrome trace of the render into DIR "
        "(summarize it with python -m raytracer_tpu_torch.tools.top_ops DIR)",
    )
    args = parser.parse_args(argv)

    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.loader import load_scene
    from raytracer_tpu_torch.render.renderer import make_renderer
    from raytracer_tpu_torch.utils.png import write_png
    from raytracer_tpu_torch.utils.timing import RenderStats, counters, device_trace, reset_counters

    kwargs = dict(width=args.width, height=args.height, use_mis=args.mis, seed=args.seed,
                  engine=args.engine)
    if args.max_depth is not None:
        kwargs["max_depth"] = args.max_depth
    cfg = RenderConfig(**kwargs)

    stats = RenderStats(pixels=args.width * args.height, samples=args.spp)
    with stats.phase("load"):
        scene = load_scene(args.scene, device=args.device)
    renderer = make_renderer(
        scene, cfg, device=args.device, sharded=False if args.no_shard else None
    )
    with stats.phase("render"), device_trace(args.profile, renderer.device):
        reset_counters()
        img = renderer.render_image(args.spp)
    stats.rays = renderer.rays_traced()

    out = args.out or (args.scene.rsplit(".", 1)[0] + ".png")
    write_png(out, img)
    print(f"wrote {out}  {stats.summary()}", file=sys.stderr)
    if args.profile:
        print(f"counters {json.dumps(counters(), sort_keys=True)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
