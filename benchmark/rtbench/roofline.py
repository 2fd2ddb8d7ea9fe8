"""Kernels' shares of their rooflines: the least time of the work a frame's
inputs need (``work.py``, counted from the reference's rays on the check
rows and scaled to the whole frame) over the kernel's device time a frame
in the trace."""

from __future__ import annotations

from rtbench import work


def _frame_scale(ctx) -> float:
    return ctx.render_params["height"] / len(ctx.check_rows)


def _frames(ctx) -> int:
    return len(ctx.out.get("traced_frames") or [])


def k1_pct(ctx):
    us, n = ctx.summary.kernel_us("mega_kernel")
    if n == 0 or not _frames(ctx) or not ctx.ref_counts:
        return None
    from rtbench.reference import scene as RS

    sc = RS.load(ctx.scene_path)
    s = _frame_scale(ctx)
    counts = {k: v * s for k, v in ctx.ref_counts.items()}
    p = ctx.render_params
    ops, nbytes = work.k1_work(counts, len(sc.sph_r), len(sc.pln_n), p["height"] * p["width"] * 4, len(sc.brdf))
    return work.least_s(ops, nbytes) / (us / 1e6 / _frames(ctx)) * 100.0


def k2_pct(ctx):
    us, n = ctx.summary.kernel_us("bvh8_kernel")
    if n == 0 or not _frames(ctx) or not ctx.ref_rays:
        return None
    import torch

    from rtbench import compare
    from rtbench.reference import bvh

    ds = compare.reference_scene(ctx)
    tree = bvh.Tree(ds.sc.tris)
    total = {"rays": 0, "boxes": 0, "tris": 0, "cand": 0}
    for cap_kind in (False, True):
        batch = [(o, d, c) for o, d, c in ctx.ref_rays if (c is not None) == cap_kind]
        if not batch:
            continue
        ro = torch.cat([b[0] for b in batch])
        rd = torch.cat([b[1] for b in batch])
        cap = torch.cat([b[2] for b in batch]) if cap_kind else None
        for i in range(0, ro.shape[0], 1 << 18):
            c = bvh.walk_counts(tree, ds.tri_rows, ro[i:i + (1 << 18)], rd[i:i + (1 << 18)],
                                None if cap is None else cap[i:i + (1 << 18)],
                                ds.p.tri_tmin, ds.p.tri_parallel)
            for k in total:
                total[k] += c[k]
    s = _frame_scale(ctx)
    ops, nbytes = work.walk_work({k: v * s for k, v in total.items()}, tree.table_bytes())
    return work.least_s(ops, nbytes) / (us / 1e6 / _frames(ctx)) * 100.0
