"""The measured window's arithmetic and the served traffic's schedule: plain
functions of timestamps and seeds, so that the tests can check them on
synthetic numbers.
"""

from __future__ import annotations

import math
import random

# A request that fails or never finishes counts as this late: beyond any limit.
NEVER = math.inf


def frame_time(t0: float, t_end: float, frames: int) -> float:
    """Seconds per frame of a closed loop that started at ``t0`` and
    finished its last of ``frames`` frames at ``t_end``: the whole window
    over the frames in it. The window closes when the frame in flight at
    the deadline finishes, so every frame counted is whole."""
    if frames <= 0:
        raise ValueError("no frame finished in the window")
    return (t_end - t0) / frames


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least q% of the values at or below it. ``NEVER`` sorts
    last, so failures count as beyond any limit."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def latencies(due: list[float], done: list[float | None]) -> list[float]:
    """Each request's time from when it was due to ``done`` (``None``: it
    failed or never finished)."""
    return [NEVER if d is None else d - t for t, d in zip(due, done)]


def arrivals(rate: float, seconds: float, seed: int) -> list[float]:
    """Due times of an open loop at ``rate`` per second over ``seconds``: the
    gaps are the quantiles of the exponential distribution at ``n = rate *
    seconds`` evenly spaced levels, scaled to fill the window and put in an
    order drawn from ``seed``. Every seed gives the same gaps, in another
    order: the same work, another arrival pattern."""
    n = max(1, round(rate * seconds))
    gaps = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
    scale = seconds / sum(gaps)
    gaps = [g * scale for g in gaps]
    random.Random(seed).shuffle(gaps)
    due, t = [], 0.0
    for g in gaps:
        due.append(t)
        t += g
    return due


def kinds(names: list[str], n: int, seed: int) -> list[str]:
    """``n`` request kinds in equal shares of ``names`` (the remainder to
    the first ones), in an order drawn from ``seed``."""
    out = [names[i % len(names)] for i in range(n)]
    random.Random(seed ^ 0x5EED).shuffle(out)
    return out


def check_rows(height: int, stride: int, seed: int) -> list[int]:
    """Render rows the reference computes: every ``stride``-th row from an
    offset drawn from ``seed``."""
    off = random.Random(seed ^ 0xC4EC).randrange(stride)
    return list(range(off, height, stride))


def kept(index: int, seed: int, every: int) -> bool:
    """Whether frame ``index`` is among those kept for the check: about one
    in ``every``, drawn from ``seed``, and always the first."""
    return index == 0 or random.Random(seed * 1_000_003 + index).randrange(every) == 0
