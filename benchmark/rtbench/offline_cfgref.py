"""Offline frames held to the reference module that the configuration names.

The run is ``offline.run``'s: one client renders whole frames back to back
through ``make_renderer(...).render_image(spp)``. The check is
``offline.check``'s, with the reference taken from the module the
configuration names under ``"reference_module"`` (a module of
``rtbench.reference`` with ``dev_scene(path, params, device, dtype)`` and
``render_rows(scene, schedule, rows, spp, seed, cards, counts, record)``),
so that a configuration whose materials or lights the plain reference
lacks brings its own reference as a new module and needs no edit of the
existing one. A traffic mix picks this module with ``"kind":
"offline_cfgref"``.
"""

from __future__ import annotations

import importlib

import numpy as np

from rtbench import compare, window
from rtbench.offline import run  # noqa: F401  (the offline frames' run)


def reference_scene(ctx, dtype=None):
    """The configuration's reference scene on the reference's device."""
    import torch

    from rtbench.reference import render as R

    ref = importlib.import_module(ctx.config["reference_module"])
    params = R.Params(**{k: v for k, v in ctx.render_params.items() if k in R.Params.__dataclass_fields__})
    return ref, ref.dev_scene(ctx.scene_path, params, ctx.ref_device, dtype or torch.float32)


def reference_rows(ctx, spp: int, rows: list[int], dtype=None, counts=None, record=None) -> np.ndarray:
    """u8 [len(rows), W, 3] of the configuration's reference at render rows ``rows``."""
    ref, ds = reference_scene(ctx, dtype)
    out = ref.render_rows(ds, ctx.config["schedule"], rows, spp, ctx.seed, ctx.cards, counts, record)
    return out.numpy()


def check(ctx, out: dict) -> dict:
    """The numbers compared: the share of the reference's rows on which the
    first kept frame's pixels differ from the reference's, and the kept
    frames that differ from the first. The reference's counts and, in a
    traced run, its rays stay in ``ctx.ref_counts`` and ``ctx.ref_rays``
    for the work counts."""
    chk = ctx.config["check"]
    rows = window.check_rows(ctx.render_params["height"], chk["row_stride"], ctx.seed)
    ctx.check_rows = rows
    first = out["kept"][0]
    counts: dict = {}
    record = [] if ctx.trace else None
    ref = reference_rows(ctx, out["spp"], rows, counts=counts, record=record)
    ctx.ref_counts, ctx.ref_rays = counts, record
    unequal = sum(int(not np.array_equal(img, first)) for img in out["kept"].values())
    return {"pixels_off_pct": (compare.pixels_off_pct(compare.image_rows(first, rows), ref), chk["pixels_off_pct"]),
            "frames_unequal": (unequal, 0)}
