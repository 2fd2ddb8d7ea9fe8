"""Offline frames: one client renders whole frames back to back (a closed
loop) through the program's ``make_renderer(...).render_image(spp)``.

Set-up loads the configuration's scene, builds the renderer (on several
cards ``make_renderer``'s default spreads the bands over them) and renders
one frame, which builds the kernels. The window renders frames until
``seconds`` have passed and the frame then in flight is done. A traced run
then profiles ``trace_frames`` more frames, each inside a span. Frames the
check keeps: the first, the last, and about one in ``keep_every`` between,
drawn from the seed.
"""

from __future__ import annotations

import gc
import time

from rtbench import trace as tr
from rtbench import window


def run(ctx) -> dict:
    import torch

    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.loader import load_scene
    from raytracer_tpu_torch.render.renderer import make_renderer

    tf, seed = ctx.traffic, ctx.seed
    cfg = RenderConfig(seed=seed, **ctx.render)
    scene = load_scene(ctx.scene_path, device=ctx.device)
    renderer = make_renderer(scene, cfg, ctx.device)
    spp = tf["spp"]
    renderer.render_image(spp)
    ctx.sync()
    setup_s = time.time() - ctx.t_start

    kept, frames, traced = {}, 0, []
    t0 = t_end = time.perf_counter()
    while t_end - t0 < ctx.seconds or frames == 0:
        img = renderer.render_image(spp)
        t_end = time.perf_counter()
        if window.kept(frames, seed, tf["keep_every"]):
            kept[frames] = img
        frames += 1
    kept[frames - 1] = img
    events: dict = {}
    if ctx.trace:
        with tr.profiled(events):
            for _ in range(tf["trace_frames"]):
                f0 = time.perf_counter()
                with torch.profiler.record_function("rtbench.frame"):
                    renderer.render_image(spp)
                traced.append(time.perf_counter() - f0)
    frame_s = window.frame_time(t0, t_end, frames)
    out = {
        "setup_s": setup_s,
        "frame_s": frame_s,
        "attempted": frames,
        "failed": 0,
        "memory_peak_bytes": ctx.memory_peak(),
        "kept": kept,
        "spp": spp,
        "traced_frames": traced,
        "events": events.get("events"),
    }
    del renderer, scene
    gc.collect()
    ctx.free()
    return out


def check(ctx, out: dict) -> dict:
    """The numbers compared: kept frames that differ from the first (a frame
    is deterministic in its seed), and the share of the reference's rows on
    which the first frame's pixels differ from the reference's."""
    import numpy as np

    from rtbench import compare

    first = out["kept"][0]
    unequal = sum(int(not np.array_equal(img, first)) for img in out["kept"].values())
    res = compare.against_reference(ctx, {out["spp"]: first})
    res["frames_unequal"] = (unequal, 0)
    return res
