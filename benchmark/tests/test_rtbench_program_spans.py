"""The readers of the program's own spans and counters on a synthetic trace:
each gives the number the trace and the counters make, and ``None`` on a
trace without the program's spans or from a program without counters."""

import pytest

from rtbench import spec, trace
from raytracer_tpu_torch.utils import timing


def ev(cat, name, ts, dur, device=0):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {"device": device}}


def events():
    """Two profiled frames' worth of slices, in microseconds."""
    return [
        ev("user_annotation", "rtbench.frame", 0, 1000),
        ev("user_annotation", "rt.regen.sync", 0, 100),
        ev("user_annotation", "rt.regen.camera", 100, 200),
        ev("cpu_op", "aten::mul", 120, 80),
        ev("user_annotation", "rt.regen.trace", 300, 200),
        ev("user_annotation", "rt.regen.sync", 500, 50),
        ev("user_annotation", "rt.regen.shade", 550, 150),
        ev("user_annotation", "rt.render.finalize", 700, 50),
        ev("user_annotation", "rt.render.pull", 750, 250),
        ev("kernel", "bvh8_kernel", 100, 150),
        ev("kernel", "elementwise", 320, 160),
        ev("kernel", "elementwise", 560, 130),
        ev("gpu_memcpy", "Memcpy DtoH", 900, 50),
    ]


COUNTERS = {"regen.steps": 10, "regen.lanes_stepped": 4000, "regen.lanes_working": 3000, "host.syncs": 13}
# Idle gaps of the first device, each to the span that overlaps it most:
# [0,100) sync; [250,320) camera (50 against the trace's 20); [480,560) sync
# (50 against 20 and 10); [690,900) pull (150 against 50 and 10); [950,1000) pull.
EXPECTED = {
    "regen_steps_per_frame.unicorn": 5.0,
    "lane_occupancy_pct.unicorn": 75.0,
    "host_syncs_per_frame.unicorn": 6.5,
    "regen_sync_ms_per_frame.unicorn": (100 + 50) / 1e3 / 2,
    "regen_dispatch_ms_per_frame.unicorn": (200 + 200 + 150) / 1e3 / 2,
    "render_gap_ms_per_frame.offline": (210 + 50) / 1e3 / 2,
    "render_gap_ms_per_frame.x4": (210 + 50) / 1e3 / 2,
}
COUNTED = {"regen_steps_per_frame.unicorn", "lane_occupancy_pct.unicorn", "host_syncs_per_frame.unicorn"}


class Ctx:
    def __init__(self, evs, frames=2):
        self.out = {"events": evs, "traced_frames": [1.0] * frames}
        self.summary = trace.summarize(evs)


def test_every_new_metric_is_declared_with_its_cell():
    sp = spec.load()
    declared = {m["name"]: m for m in sp["per_layer"]}
    for name in EXPECTED:
        m = declared[name]
        assert m["source"] == ("program_counter" if name in COUNTED else "program_span")
        assert m["layer"] == ("renderer" if name.startswith("render_gap") else "regen engine")


def test_the_gaps_fall_to_the_program_spans():
    gaps = Ctx(events()).summary.gaps
    assert gaps == pytest.approx({"rt.regen.sync": 180e-6, "rt.regen.camera": 70e-6,
                                  "rt.render.pull": 260e-6})
    assert "aten::mul" not in gaps  # it lies inside the camera's span and a kernel


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_trace_with_program_spans(name, monkeypatch):
    monkeypatch.setattr(timing, "counters", lambda: dict(COUNTERS))
    assert spec.metric_reader(name)(Ctx(events())) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_trace_without_program_spans(name, monkeypatch):
    monkeypatch.setattr(timing, "counters", lambda: dict(COUNTERS))
    plain = [e for e in events() if not e["name"].startswith("rt.")]
    assert spec.metric_reader(name)(Ctx(plain)) is None


@pytest.mark.parametrize("name", sorted(COUNTED))
def test_counter_readers_on_a_program_without_counters(name, monkeypatch):
    monkeypatch.delattr(timing, "counters")
    assert spec.metric_reader(name)(Ctx(events())) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_without_profiled_frames(name, monkeypatch):
    monkeypatch.setattr(timing, "counters", lambda: dict(COUNTERS))
    value = spec.metric_reader(name)(Ctx(events(), frames=0))
    assert value is None or name == "lane_occupancy_pct.unicorn"
