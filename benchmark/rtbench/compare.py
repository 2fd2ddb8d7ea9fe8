"""The comparison that decides ``correct``: the program's pixels against the
plain reference's on rows drawn from the seed.

The reference (``reference/``) renders, from the scene's files alone, the
rows ``window.check_rows(H, stride, seed)`` of the frame the program
rendered, with the same render seed and sample count; both finalize to u8.
The number compared is the share of those pixels (in percent) on which any
channel differs. The program and the reference agree except where float32
rounding takes a path another way; a lower precision, a sample left out or
a wrong draw moves most pixels. The reference runs after the window, once
the program's state is freed.
"""

from __future__ import annotations

import numpy as np

from rtbench import window


def reference_scene(ctx, dtype=None):
    import torch

    from rtbench.reference import render as R
    from rtbench.reference import scene as RS

    params = R.Params(**{k: v for k, v in ctx.render_params.items() if k in R.Params.__dataclass_fields__})
    return R.DevScene(RS.load(ctx.scene_path), params, ctx.ref_device, dtype or torch.float32)


def reference_rows(ctx, spp: int, rows: list[int], dtype=None, counts=None, record=None) -> np.ndarray:
    """u8 [len(rows), W, 3] of the reference at render rows ``rows``."""
    from rtbench.reference import frame

    ds = reference_scene(ctx, dtype)
    out = frame.render_rows(ds, ctx.config["schedule"], rows, spp, ctx.seed, ctx.cards, counts, record)
    return out.numpy()


def pixels_off_pct(got: np.ndarray, ref: np.ndarray) -> float:
    """Percent of pixels of ``got`` on which some channel differs from ``ref``."""
    return float((got != ref).any(axis=-1).mean() * 100.0)


def image_rows(img: np.ndarray, rows: list[int]) -> np.ndarray:
    """An image's pixels (row 0 at the top) at render rows ``rows`` (0 at the bottom)."""
    h = img.shape[0]
    return img[[h - 1 - r for r in rows]]


def against_reference(ctx, images: dict) -> dict:
    """Compare each ``{spp: image}`` with the reference at the check rows
    -> ``{"pixels_off_pct": (worst value, limit)}``. The reference's counts
    at the offline sample count are kept in ``ctx.ref_counts`` (and its
    traced rays in ``ctx.ref_rays`` in a traced run) for the work counts."""
    chk = ctx.config["check"]
    rows = window.check_rows(ctx.render_params["height"], chk["row_stride"], ctx.seed)
    ctx.check_rows = rows
    worst = 0.0
    for spp, img in sorted(images.items()):
        counts: dict = {}
        record = [] if ctx.trace else None
        ref = reference_rows(ctx, spp, rows, counts=counts, record=record)
        worst = max(worst, pixels_off_pct(image_rows(img, rows), ref))
        ctx.ref_counts, ctx.ref_rays = counts, record
    return {"pixels_off_pct": (worst, chk["pixels_off_pct"])}
