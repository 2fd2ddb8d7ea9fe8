"""Rows of a frame by the reference: which band seeds a row, and its u8 pixels.

A frame of ``spp`` samples per pixel renders ``spp // 4`` samples per
subpixel of a 2x2 grid, taken in powers of two of at most 16 (so a
sample count that is not a power of two rounds up, and the finalize
divides by the count rendered). Sphere/plane scenes render row bands in
one pass each; a band of ``band_rows`` rows starting at render row ``y0``
draws under ``band_seed(seed, y0, 0)``. On one card the band height is the
largest divisor of the height at most ``max(lanes_per_pass // (4 W),
ceil(H / 9))``; over ``cards`` cards each card renders a part of
``ceil(H / (bands * cards))`` rows of a band, as its own band, where
``bands = min(9, ceil(H / (target * cards)))``. Mesh scenes render one
sample of every lane per dispatch, dispatch ``p`` under ``band_seed(seed,
0, p)``, and sum the dispatches in order.
"""

from __future__ import annotations

import torch

from rtbench.reference import render as R


def samples(spp: int) -> int:
    """Samples per subpixel that a frame of ``spp`` renders."""
    ns = spp // 4
    if ns <= 0:
        return 0
    k = min(16, 1 << (ns.bit_length() - 1))
    return k * -(-ns // k)


def band_rows(p: R.Params, cards: int, lanes_per_pass: int = 1 << 17) -> int:
    """Rows of one seeded band of a sphere/plane frame."""
    target = max(1, lanes_per_pass // (p.width * 4))
    if cards == 1:
        target = max(target, -(-p.height // 9))
        target = max(1, min(target, p.height))
        return next(r for r in range(target, 0, -1) if p.height % r == 0)
    bands = min(max(1, -(-p.height // (target * cards))), 9)
    return -(-p.height // (bands * cards))


def lanes_of_rows(p: R.Params, rows: list[int], device, band: int | None, seed: int) -> R.Lanes:
    """The lanes of render rows ``rows``: with ``band`` rows a band, each
    lane's slot in its band and its band's seed; without, its slot in the
    frame (the seed is the dispatch's, given to the renderer)."""
    dev = torch.device(device)
    y = torch.as_tensor(rows, dtype=torch.int64, device=dev)[:, None, None]
    x = torch.arange(p.width, dtype=torch.int64, device=dev)[None, :, None]
    sub = torch.arange(4, dtype=torch.int64, device=dev)[None, None, :]
    shape = (len(rows), p.width, 4)
    y, x, sub = y.expand(shape).reshape(-1), x.expand(shape).reshape(-1), sub.expand(shape).reshape(-1)
    if band is None:
        slot = (y * p.width + x) * 4 + sub
        seed_u = torch.zeros_like(slot)
    else:
        y0 = (y // band) * band
        slot = ((y - y0) * p.width + x) * 4 + sub
        seeds = {int(v): band_seed_u(seed, int(v)) for v in torch.unique(y0).tolist()}
        seed_u = torch.tensor([seeds[int(v)] for v in y0.tolist()], dtype=torch.int64, device=dev)
    return R.Lanes(slot=slot, seed=seed_u, px=x, py=y, sub=sub)


def band_seed_u(seed: int, y0: int) -> int:
    return R.band_seed(seed, y0, 0) & R.M32


def render_rows(ds: R.DevScene, schedule: str, rows: list[int], spp: int, seed: int, cards: int = 1,
                counts: dict | None = None, record: list | None = None) -> torch.Tensor:
    """u8 pixels [len(rows), W, 3] of render rows ``rows`` (0 = bottom) of
    the frame of ``spp`` under render seed ``seed``."""
    p = ds.p
    ns = samples(spp)
    if schedule == "k1":
        lanes = lanes_of_rows(p, rows, ds.device, band_rows(p, cards), seed)
        sums, _ = R.render_k1(ds, lanes, ns, counts)
    elif schedule == "regen":
        lanes = lanes_of_rows(p, rows, ds.device, None, seed)
        sums = None
        for d in range(ns):
            out, _ = R.render_regen(ds, lanes, R.band_seed(seed, 0, d), counts, record)
            sums = out if sums is None else sums + out
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    if ns == 0:
        return torch.zeros((len(rows), p.width, 3), dtype=torch.uint8)
    return R.finalize(sums.view(len(rows), p.width, 4, 3), ns).cpu()
