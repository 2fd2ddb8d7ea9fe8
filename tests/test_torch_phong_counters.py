"""The regen engine's Phong counters (``render/wavefront.py``), on the CPU.

In a scene with Phong materials each step adds, on the device and lane
slot by slot, the valid lanes on a Phong surface (``regen.phong_hits``),
those whose draw 5 picked the power-cosine lobe (``regen.phong_lobe``) and
those whose draw 5 picked nothing (``regen.phong_dead``); the band sums
the slots and hands the sums to the counters once, after its loop, while a
profiler records. Here:

- the counters equal a direct count of ``sample3``'s picks, made by
  wrapping the bounce, on a tiny crewmate frame;
- they exist only in a Phong scene and only while a profiler records, and
  the one read a band adds is counted in ``host.syncs``;
- a traced crewmate frame equals an untraced one;
- the graph path's plumbing (the capture stood in for by a replay in
  Python) counts as the eager band does (``tests/test_torch_step_graphs.py``
  holds the crewmate's step to no host read);
- the tally adds ops to a Phong scene's steps alone, counted in the
  dispatcher, and leaves the sums as they are.
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.loader import load_scene
from raytracer_tpu_torch.models.scene import BRDF_PHONG
from raytracer_tpu_torch.ops.intersect import scene_precompute
from raytracer_tpu_torch.render import wavefront
from raytracer_tpu_torch.render.renderer import Renderer
from raytracer_tpu_torch.render.wavefront import StepGraphs, render_band_regen
from raytracer_tpu_torch.utils.timing import counters, reset_counters
from tests.test_torch_step_graphs import _replays_on_the_cpu
from tests.torch_cpu import one_torch_thread  # noqa: F401  (autouse)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
PHONG = ("regen.phong_hits", "regen.phong_lobe", "regen.phong_dead")
# 32 x 16 pixels: 2048 lanes, so each dispatch compacts its tail once.
CFG = RenderConfig(width=32, height=16, mesh_rays_per_pass=1 << 11)


def _scene(name):
    return load_scene(os.path.join(SCENES, f"{name}.toml"), device="cpu")


@pytest.fixture(scope="module")
def crewmate():
    return _scene("crewmate_phong")


def traced(fn):
    """``fn()`` under a CPU profiler -> (its result, the counters)."""
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    got = counters()
    reset_counters()
    return out, got


def test_counters_equal_the_picks_of_the_bounce(crewmate, monkeypatch):
    """Each bounce's picks counted on the host from ``sample3``'s rule (the
    cosine lobe below k_d, the power-cosine lobe below k_d + k_s, nothing
    above), over the valid lanes on a Phong surface."""
    direct = np.zeros(3, np.int64)
    bounce = wavefront.bounce

    def counted(scene, cfg, mat, is_spec, nrm, o3, depth, valid, beta, u, tally=None):
        ub = u(5)
        on = valid & (mat.brdf_type == BRDF_PHONG)
        pick_d = ub < mat.k_d
        pick_s = ~pick_d & (ub < mat.k_d + mat.k_s)
        direct[:] += [int(on.sum()), int((on & pick_s).sum()), int((on & ~pick_d & ~pick_s).sum())]
        return bounce(scene, cfg, mat, is_spec, nrm, o3, depth, valid, beta, u, tally)

    monkeypatch.setattr(wavefront, "bounce", counted)
    r = Renderer(crewmate, CFG, device="cpu")
    assert r.engine == "regen" and crewmate.has_phong
    _, got = traced(lambda: r.render_image(8))
    assert [got[k] for k in PHONG] == direct.tolist()
    hits, lobe, dead = direct
    assert 0 < lobe and 0 < dead and lobe + dead < hits < got["regen.lanes_working"]


def test_counters_only_in_a_phong_scene_and_while_recording(crewmate):
    r = Renderer(crewmate, CFG, device="cpu")
    reset_counters()
    r.render_image(8)
    assert counters() == {}
    _, got = traced(lambda: r.render_image(8))
    assert all(got[k] > 0 for k in PHONG)
    # A loop test per step, one more that ends each of the 2 dispatches' 2
    # runs (``tests/test_torch_tracing.py`` counts them on the unicorn), the
    # pull, and one read of the Phong sums a dispatch.
    assert got["host.syncs"] == got["regen.steps"] + 4 + 1 + 2
    for name, cfg in (("flying_unicorn", CFG), ("cornell_box", RenderConfig(width=24, height=12))):
        other = Renderer(_scene(name), cfg, device="cpu")
        _, got = traced(lambda: other.render_image(4))
        assert got["host.syncs"] > 0 and not set(PHONG) & set(got), name


def test_a_traced_crewmate_frame_equals_an_untraced_one(crewmate):
    r = Renderer(crewmate, CFG, device="cpu")
    plain = r.render_image(4)
    under, got = traced(lambda: r.render_image(4))
    assert got["regen.phong_hits"] > 0
    np.testing.assert_array_equal(under, plain)


def test_graph_plumbing_counts_as_the_eager_band(crewmate, monkeypatch):
    """The band that captures and one that replays every step count what the
    eager band counts, and give its sums."""
    pre = scene_precompute(crewmate)
    want = [traced(lambda s=seed: render_band_regen(crewmate, pre, CFG, 0, CFG.height, 1, s)) for seed in (5, 6)]
    _replays_on_the_cpu(monkeypatch)
    graphs = StepGraphs()
    for seed, ((s_want, r_want), c_want) in zip((5, 6), want):
        (s_got, r_got), c_got = traced(lambda: render_band_regen(crewmate, pre, CFG, 0, CFG.height, 1, seed,
                                                                    graphs=graphs))
        assert torch.equal(s_got, s_want) and int(r_got) == int(r_want)
        assert [c_got[k] for k in PHONG] == [c_want[k] for k in PHONG]
        assert c_got["regen.graph_steps"] > 0
    assert c_got["regen.graph_steps"] == c_got["regen.steps"]


@pytest.mark.parametrize("name", ["flying_unicorn", "crewmate_phong"])
def test_the_tally_adds_ops_to_a_phong_step_alone(name, crewmate, monkeypatch):
    """The eager band with its tally against the same band with the tally
    dropped, counted in the dispatcher: ops added in a Phong scene's steps
    alone, and the same sums."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            return func(*args, **(kwargs or {}))

    scene = crewmate if name == "crewmate_phong" else _scene(name)
    pre = scene_precompute(scene)

    def band():
        with Count() as c:
            sums, _ = render_band_regen(scene, pre, CFG, 0, CFG.height, 1, 5)
        return sums, c.ops

    band()  # the first band builds what the later ones reuse
    (with_tally, counted) = band()
    bounce = wavefront.bounce
    monkeypatch.setattr(wavefront, "bounce", lambda *a: bounce(*a[:10]))  # the tally is the 11th
    (without, plain) = band()
    assert torch.equal(with_tally, without)
    assert plain > 0 and (counted > plain if scene.has_phong else counted == plain), (counted, plain)
