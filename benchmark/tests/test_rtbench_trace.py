"""The trace's reduction on a synthetic trace: busy and idle shares, the
kernels by name, the idle gaps by what the host did, the benchmark's spans."""

import pytest

from rtbench import trace


def ev(cat, name, ts, dur, device=0):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {"device": device}}


def synthetic():
    return [
        ev("user_annotation", "rtbench.frame", 0, 1000),
        ev("cpu_op", "aten::sort", 0, 300),
        ev("kernel", "bvh8_kernel(TravParams)", 100, 200),
        ev("kernel", "elementwise", 250, 100),  # overlaps the first: counted once
        ev("cpu_op", "aten::nonzero", 400, 400),
        ev("kernel", "key_kernel<0>", 700, 100),
        ev("gpu_memcpy", "Memcpy DtoH", 850, 50),
        ev("cuda_runtime", "cudaStreamSynchronize", 900, 100),
    ]


def test_busy_is_the_union_of_device_slices():
    s = trace.summarize(synthetic())
    assert s.window_us == 1000
    assert s.busy_us == {0: 200 + 50 + 100 + 50}
    assert s.busy_share() == pytest.approx(0.4)
    assert s.launches == 3
    assert s.kernel_us("bvh8_kernel") == (200, 1)
    assert s.kernel_us("key_kernel") == (100, 1)


def test_idle_gaps_go_to_the_overlapping_host_slice():
    s = trace.summarize(synthetic())
    # Gaps: [0,100) sort, [350,700) nonzero, [800,850) nonzero (to 800) or sync, [900,1000) sync.
    assert s.gaps["aten::sort"] == pytest.approx(100e-6)
    assert s.gaps["aten::nonzero"] == pytest.approx(350e-6)
    assert s.gaps["cudaStreamSynchronize"] == pytest.approx(100e-6)
    assert sum(s.gaps.values()) == pytest.approx(600e-6)
    b = s.breakdown()
    assert b["device_ops"][0] == ["bvh8_kernel(TravParams)", 200e-6]
    assert b["idle_gaps"][0][0] == "aten::nonzero"


def test_spans_and_devices_apart():
    events = synthetic() + [ev("kernel", "mega_kernel", 100, 500, device=1)]
    s = trace.summarize(events)
    assert s.spans["rtbench.frame"] == [(0.0, 1000.0)]
    assert s.busy_us[1] == 500
    assert s.busy_share() == pytest.approx((400 + 500) / 2 / 1000)
    assert s.kernel_us("mega_kernel") == (500, 1)


def test_no_device_slice_is_an_error():
    with pytest.raises(RuntimeError):
        trace.summarize([ev("cpu_op", "aten::add", 0, 10)])
