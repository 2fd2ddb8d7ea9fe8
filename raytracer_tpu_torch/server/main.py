"""CLI entry point: ``python -m raytracer_tpu_torch.server.main <scenes-dir>``.

Mirrors ``raytracer_tpu/server/main.py`` (the reference bootstrap,
src/main.rs:16-55): eagerly load the scenes from the given directory, read
PORT from the environment (default 8080), serve forever. The default scene
list is the reference's, ``raytracer_tpu_torch.config.SCENE_NAMES``: cornell_box,
cubes and flying_unicorn. ``--device`` defaults to ``cuda`` and there is no
silent CPU fallback. With several CUDA devices visible, row bands are
spread over all of them unless ``--no-shard`` is given. A ``--config`` may
ask for any engine of ``ENGINES`` (``engine = "fused"`` too); one whose
``engine`` is none of them is refused at start-up (the JAX server renders
an unknown name as regen).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import sys

from raytracer_tpu_torch.config import SCENE_NAMES, port_from_env
from raytracer_tpu_torch.models.loader import load_all_scenes
from raytracer_tpu_torch.render.renderer import ENGINES
from raytracer_tpu_torch.server.app import HEIGHT, WIDTH, Server
from raytracer_tpu_torch.utils.device import DEFAULT_DEVICE


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="raytracer-tpu-torch-server")
    parser.add_argument("scenes_dir", help="directory containing <scene>.toml")
    parser.add_argument("--port", type=int, default=None, help="overrides PORT env")
    parser.add_argument("--width", type=int, default=WIDTH)
    parser.add_argument("--height", type=int, default=HEIGHT)
    parser.add_argument("--scenes", nargs="*", default=None, help="scene names to load")
    parser.add_argument("--config", default=None, help="render config TOML (see config.toml)")
    parser.add_argument("--device", default=DEFAULT_DEVICE, help="torch device (default cuda)")
    parser.add_argument(
        "--no-shard", action="store_true",
        help="render on one device even when several CUDA devices are visible",
    )
    parser.add_argument(
        "--http-port",
        type=int,
        default=None,
        help="also serve the web viewer (clients/web) over plain HTTP",
    )
    parser.add_argument(
        "--no-warmup",
        action="store_true",
        help="skip the startup build and first band of every scene",
    )
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")

    cfg = None
    if args.config:
        from raytracer_tpu_torch.config import config_from_toml

        cfg = config_from_toml(args.config)
        if cfg.engine not in ENGINES:
            print(
                f"{args.config}: engine {cfg.engine!r} is not one of this server's "
                f"({', '.join(ENGINES)})",
                file=sys.stderr,
            )
            return 1

    names = args.scenes or SCENE_NAMES
    try:
        scenes = load_all_scenes(args.scenes_dir, names=names, device=args.device)
    except Exception as e:  # the reference exits(1) on any scene load failure
        print(f"Failed to load scenes from {args.scenes_dir}: {e}", file=sys.stderr)
        return 1

    server = Server(
        scenes, cfg=cfg, width=args.width, height=args.height, device=args.device,
        sharded=False if args.no_shard else None,
    )
    if not args.no_warmup:
        server.warmup()  # background; the first client skips the kernel build
    port = args.port if args.port is not None else port_from_env()

    async def run_all():
        tasks = [server.serve_forever(port=port)]
        if args.http_port:
            tasks.append(_serve_viewer(args.http_port))
        await asyncio.gather(*tasks)

    asyncio.run(run_all())
    return 0


async def _serve_viewer(port: int) -> None:
    """Serve the static web viewer (clients/web/index.html)."""
    from aiohttp import web

    root = os.path.join(os.path.dirname(__file__), "..", "..", "clients", "web")

    async def index(_req):
        return web.FileResponse(os.path.join(root, "index.html"))

    app = web.Application()
    app.router.add_get("/", index)
    app.router.add_static("/", root)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "0.0.0.0", port)
    await site.start()
    logging.getLogger("raytracer_tpu_torch.server").info("Viewer at http://0.0.0.0:%d/", port)
    await asyncio.Event().wait()


if __name__ == "__main__":
    sys.exit(main())
