"""The window's arithmetic and the traffic's schedule, on synthetic numbers."""

import collections
import math

import pytest

from rtbench import window


def test_schedule_repeats_for_a_seed_and_changes_with_it():
    a = window.arrivals(8.0, 30, 12345)
    assert a == window.arrivals(8.0, 30, 12345)
    b = window.arrivals(8.0, 30, 2**31 + 7)
    assert a != b
    assert len(a) == len(b) == 240
    # The same gaps in another order: the same work.
    gaps = lambda d: sorted(round(y - x, 12) for x, y in zip(d, d[1:]))  # noqa: E731
    assert len(set(gaps(a)) ^ set(gaps(b))) <= 4
    assert 0.0 == a[0] and a[-1] < 30.0


def test_client_mix_in_equal_thirds():
    k = window.kinds(["cli", "headless", "web"], 240, 99)
    assert collections.Counter(k) == {"cli": 80, "headless": 80, "web": 80}
    assert k == window.kinds(["cli", "headless", "web"], 240, 99)
    assert k != window.kinds(["cli", "headless", "web"], 240, 100)


def test_whole_frames_only():
    # Frames end at 0.4, 0.8, ... ; the deadline 1.0 falls inside the third,
    # which is counted whole: the window is 1.2 s over 3 frames.
    assert window.frame_time(0.0, 1.2, 3) == pytest.approx(0.4)
    with pytest.raises(ValueError):
        window.frame_time(0.0, 1.0, 0)


def test_a_stall_inside_the_window_moves_the_rate():
    steady = window.frame_time(0.0, 10 * 0.06, 10)
    stalled = window.frame_time(0.0, 10 * 0.06 + 0.3, 10)
    assert stalled > steady * 1.4


def test_failures_count_beyond_any_limit():
    due = [0.0, 0.1, 0.2, 0.3]
    lat = window.latencies(due, [0.05, 0.2, None, 0.35])
    assert lat[2] == window.NEVER
    assert window.percentile(lat, 95) == math.inf
    assert window.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 95) == 10
    assert window.percentile(list(range(1, 201)), 95) == 190


def test_open_loop_counts_from_due():
    # A request sent late because every connection was busy is late by
    # the wait as well.
    assert window.latencies([1.0], [1.75]) == [0.75]


def test_check_rows_and_kept_frames():
    rows = window.check_rows(450, 32, 5)
    assert rows == window.check_rows(450, 32, 5) and len(rows) in (14, 15)
    assert all(b - a == 32 for a, b in zip(rows, rows[1:]))
    kept = [i for i in range(400) if window.kept(i, 77, 16)]
    assert kept[0] == 0 and 10 < len(kept) < 50
