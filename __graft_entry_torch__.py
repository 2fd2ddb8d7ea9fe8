"""Harness entry points of the PyTorch + CUDA port: one band step on one
device, and a dry run of the multi-device path.

The port's counterpart of ``__graft_entry__.py``. Both run on CUDA unless
``device="cpu"`` is passed, which runs the kernels' plain PyTorch twins.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _cornell(width: int, height: int, device: str):
    sys.path.insert(0, HERE)
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.loader import load_scene

    scene = load_scene(os.path.join(HERE, "scenes", "cornell_box.toml"), device=device)
    cfg = RenderConfig(width=width, height=height, rays_per_pass=1 << 14)
    return scene, cfg


def entry(device: str = "cuda"):
    """(forward step, example args) on the flagship scene.

    The forward step is one lockstep render pass of a cornell_box band:
    camera rays, the bounce loop (trace, NEE, BSDF sampling, Russian
    roulette) and the per-subpixel radiance sums. ``fn(*args)`` returns
    (sums f32[8, 64, 4, 3], rays traced) on ``device``.
    """
    scene, cfg = _cornell(64, 48, device)
    from raytracer_tpu_torch.ops.intersect import scene_precompute
    from raytracer_tpu_torch.render.renderer import _render_band_impl

    pre = scene_precompute(scene)

    def fn(scene, pre, y0, seed):
        return _render_band_impl(scene, pre, cfg, y0, 8, 2, 1, seed)

    return fn, (scene, pre, 0, 0)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """One full sharded render over ``n_devices`` devices, at tiny shapes:
    the scene copied to every device, the frame's rows split over them, the
    ray counts summed (``raytracer_tpu_torch/parallel/mesh.py``). On
    ``device="cpu"`` the list is the CPU ``n_devices`` times."""
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.loader import load_scene
    from raytracer_tpu_torch.parallel.mesh import ShardedRenderer

    if device == "cpu":
        devices = ["cpu"] * n_devices
    else:
        have = torch.cuda.device_count()
        assert have >= n_devices, f"need {n_devices} devices, have {have}"
        devices = [f"cuda:{i}" for i in range(n_devices)]
    scene, cfg = _cornell(64, n_devices * 6, devices[0])
    r = ShardedRenderer(scene, cfg, devices)
    img = r.render_image(8)
    assert img is not None and img.shape == (cfg.height, 64, 3)
    assert np.isfinite(r.rays_traced()) and r.rays_traced() > 0

    # The mesh (BVH) scene through the same sharded path: the regen engine
    # with the BVH traversal and the coherence key on every device.
    unicorn = load_scene(os.path.join(HERE, "scenes", "flying_unicorn.toml"), device=devices[0])
    mcfg = RenderConfig(
        width=32, height=n_devices * 3, rays_per_pass=1 << 12, mesh_rays_per_pass=1 << 12,
    )
    rm = ShardedRenderer(unicorn, mcfg, devices)
    img = rm.render_image(4)
    assert img is not None and img.shape == (mcfg.height, 32, 3)
    assert np.isfinite(rm.rays_traced()) and rm.rays_traced() > 0
