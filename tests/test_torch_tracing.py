"""The port's tracing system (``utils/timing.py``) on the CPU: spans and
counters are no-ops unless a ``torch.profiler`` records; under one, the
regen engine's, the renderer's, the four-card path's and the server's spans
land in the trace inside the caller's own span and never overlap on one
thread; the counters agree with what the loop did; tracing changes no
pixel; the server's phases reach the client."""

import asyncio
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracer_tpu.utils.timing import RenderStats as JaxRenderStats
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.loader import load_scene
from raytracer_tpu_torch.parallel.mesh import ShardedRenderer
from raytracer_tpu_torch.render import wavefront
from raytracer_tpu_torch.render.renderer import Renderer
from raytracer_tpu_torch.utils import timing
from raytracer_tpu_torch.utils.timing import RenderStats, count, counters, reset_counters, span
from tests.torch_cpu import one_torch_thread  # noqa: F401  (autouse)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
CALLER = "test.frame"
REGEN_SPANS = {"rt.regen." + p for p in ("sync", "camera", "sort", "trace", "shadow", "shade",
                                         "compact", "scatter")}
RENDER_SPANS = {"rt.render.finalize", "rt.render.pull"}
# 32 x 16 pixels: 2048 lanes, so the band compacts its tail once (to 1024).
MESH_CFG = RenderConfig(width=32, height=16, mesh_rays_per_pass=1 << 11)
K1_CFG = RenderConfig(width=24, height=12)


@pytest.fixture(scope="module")
def unicorn():
    return load_scene(os.path.join(SCENES, "flying_unicorn.toml"), device="cpu")


@pytest.fixture(scope="module")
def cornell():
    return load_scene(os.path.join(SCENES, "cornell_box.toml"), device="cpu")


def traced(fn, tmp_path):
    """Run ``fn`` under a CPU profiler inside the caller's span ``CALLER``
    -> (its result, the trace's complete slices, the counters)."""
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(CALLER):
            out = fn()
    got = counters()
    reset_counters()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    return out, events, got


def rt_spans(events):
    return [e for e in events if e["name"].startswith("rt.")]


def assert_tiled_inside_the_caller(events):
    """Every rt. span is a user annotation inside the caller's span, and no
    two of one thread overlap."""
    (caller,) = [e for e in events if e["name"] == CALLER]
    c0, c1 = caller["ts"], caller["ts"] + caller["dur"]
    by_thread = {}
    for e in rt_spans(events):
        assert e["cat"] == "user_annotation", e
        assert c0 <= e["ts"] and e["ts"] + e["dur"] <= c1, e["name"]
        by_thread.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"], e["name"]))
    for spans in by_thread.values():
        spans.sort()
        for (_, end, a), (start, _, b) in zip(spans, spans[1:]):
            assert start >= end, f"{a} overlaps {b}"


def test_span_and_count_are_noops_without_a_profiler():
    reset_counters()
    assert not timing.recording()
    with span("rt.test.a") as a:
        count("test.n", 5)
    assert a is None and span("rt.test.b") is span("rt.test.c") is span(None)
    assert counters() == {}


def test_counters_count_only_while_a_profiler_records(tmp_path):
    def go():
        assert timing.recording()
        count("test.n")
        count("test.n", 4)
        with span(None):  # no name: the no-op, also while recording
            pass
        return counters()

    inside, events, got = traced(go, tmp_path)
    assert inside == got == {"test.n": 5}
    got["test.n"] = 0  # a copy
    count("test.n")  # the profiler has stopped
    assert counters() == {}
    assert rt_spans(events) == []


def test_counters_hold_under_threads(tmp_path):
    """Many threads counting at once lose no update."""
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def go():
            def worker():
                for _ in range(2000):
                    count("test.n")

            threads = [threading.Thread(target=worker) for _ in range(4 * (os.cpu_count() or 1))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
            return len(threads)

        n, _, got = traced(go, tmp_path)
    finally:
        sys.setswitchinterval(saved)
    assert got == {"test.n": 2000 * n}


def test_regen_frame_spans_and_counters(unicorn, tmp_path, monkeypatch):
    """A BVH frame: every regen and renderer span (``rt.regen.sort`` only
    under ``RT_PERMUTE_STATE=1``), tiled inside the caller's; the counters
    against the loop's own steps, counted by wrapping the camera, which
    every step calls once over the loop's width."""
    steps = []
    camera = wavefront.camera_rays3

    def counted(scene, w, h, fov, px, *a):
        steps.append(px.shape[0])
        return camera(scene, w, h, fov, px, *a)

    monkeypatch.setattr(wavefront, "camera_rays3", counted)
    r = Renderer(unicorn, MESH_CFG, device="cpu")
    assert r.engine == "regen"
    _, events, got = traced(lambda: r.render_image(8), tmp_path)
    names = {e["name"] for e in rt_spans(events)}
    assert names == (REGEN_SPANS - {"rt.regen.sort"}) | RENDER_SPANS
    assert_tiled_inside_the_caller(events)
    n_sync = sum(e["name"] == "rt.regen.sync" for e in events)
    n_pull = sum(e["name"] == "rt.render.pull" for e in events)
    assert got["regen.steps"] == len(steps) > 0
    assert got["regen.lanes_stepped"] == sum(steps)
    assert 0 < got["regen.lanes_working"] <= got["regen.lanes_stepped"]
    assert got["host.syncs"] == n_sync + n_pull
    # Two dispatches (8 spp: 2 samples a subpixel), each with one tail stage:
    # a loop test per step, and one more that ends each of the 2 x 2 runs.
    assert n_sync == got["regen.steps"] + 4 and n_pull == 1
    assert sum(e["name"] == "rt.regen.compact" for e in events) == 2
    assert sum(e["name"] == "rt.regen.camera" for e in events) == got["regen.steps"]
    # Only the two compactions gather the state, each over the band's 2048 lanes.
    assert got["regen.rows_gathered"] == 2 * 2048
    # The permuted step: its sort span and its gathers, one a step.
    monkeypatch.setenv("RT_PERMUTE_STATE", "1")
    _, events, permuted = traced(lambda: Renderer(unicorn, MESH_CFG, device="cpu").render_image(8), tmp_path)
    assert {e["name"] for e in rt_spans(events)} == REGEN_SPANS | RENDER_SPANS
    assert_tiled_inside_the_caller(events)
    assert sum(e["name"] == "rt.regen.sort" for e in events) == permuted["regen.steps"]
    assert permuted["regen.rows_gathered"] == 2 * 2048 + permuted["regen.lanes_stepped"]


def test_k1_frame_spans(cornell, tmp_path):
    r = Renderer(cornell, K1_CFG, device="cpu")
    assert r.engine == "mega"
    _, events, got = traced(lambda: r.render_image(16), tmp_path)
    assert [e["name"] for e in sorted(rt_spans(events), key=lambda e: e["ts"])] == [
        "rt.mega.launch", "rt.render.finalize", "rt.render.pull"]
    assert_tiled_inside_the_caller(events)
    assert got == {"host.syncs": 1}


@pytest.mark.parametrize("scene_name", ["unicorn", "cornell"])
def test_a_traced_frame_equals_an_untraced_one(scene_name, request, tmp_path):
    scene = request.getfixturevalue(scene_name)
    r = Renderer(scene, MESH_CFG if scene_name == "unicorn" else K1_CFG, device="cpu")
    plain = r.render_image(8)
    under, events, _ = traced(lambda: r.render_image(8), tmp_path)
    assert rt_spans(events)
    np.testing.assert_array_equal(under, plain)


def test_sharded_renderer_spans(cornell, tmp_path):
    """The four-card path over two CPU devices: each band's launch and
    gather, no span inside another."""
    r = ShardedRenderer(cornell, K1_CFG, ["cpu", "cpu"])
    rows, _, _ = r.plan(16)
    n_bands = -(-K1_CFG.height // rows)
    img, events, got = traced(lambda: r.render_image(16), tmp_path)
    names = [e["name"] for e in rt_spans(events)]
    assert names.count("rt.mesh.launch") == names.count("rt.mesh.gather") == n_bands
    assert set(names) == {"rt.mesh.launch", "rt.mesh.gather"} | RENDER_SPANS
    assert_tiled_inside_the_caller(events)
    assert got == {"host.syncs": n_bands}
    np.testing.assert_array_equal(img, r.render_image(16))


def test_render_stats_phase_times_and_spans(tmp_path):
    st = RenderStats()

    def go():
        with st.phase("pull", span="rt.test.pull"):
            pass
        with st.phase("pull"):  # accumulates, no span
            pass

    _, events, _ = traced(go, tmp_path)
    assert [e["name"] for e in rt_spans(events)] == ["rt.test.pull"]
    assert st.phases["pull"] > 0
    assert st.wall > 0 and st.started <= time.perf_counter()


def test_served_render_reports_its_phases(cornell):
    """A served render with stats: the phases band, pull and send above 0,
    the wait for the executor timed, the wall counted from the request's
    arrival, and the summary's keys those of the JAX server."""
    from raytracer_tpu_torch.server.app import RenderJob, Server

    srv = Server({"cornell_box": cornell}, width=30, height=12, device="cpu")
    renderer = srv.renderer_for("cornell_box", 30, 12)
    texts = []

    async def send(msg):
        if isinstance(msg, str):
            texts.append(json.loads(msg))

    job = RenderJob(send=send)
    job.mark_running()
    arrived = time.perf_counter() - 5.0  # a request that waited 5 s
    assert asyncio.run(job.run(renderer, 8, want_stats=True, arrived=arrived)) is False
    (stats,) = texts
    assert stats["type"] == "render_stats"
    phases = job.stats.phases
    assert {"band", "pull", "send", "executor_wait"} <= set(phases)
    assert phases["band"] > 0 and phases["pull"] > 0 and phases["send"] > 0
    assert stats["wall_s"] >= 5.0
    jax = JaxRenderStats().summary()
    assert sorted(k for k in stats if k != "type") == sorted(jax)
