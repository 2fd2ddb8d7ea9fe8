"""The regen engine's CUDA-graph path (``render/wavefront.py``), on the CPU.

A capture needs a CUDA device (``tests/test_torch_cuda.py`` holds the
graphed bands against the eager ones there). Here:

- the counter hash gives the same bits for the iteration and the seed as
  0-d i64 tensors, which a replay reads, as for Python ints;
- ``camera_rays3`` with a frame built once (``camera_frame``) is bit-equal
  to its own form;
- ``step_graphable`` is false on the CPU and under ``RT_SHADOW_COMPACT``,
  and a CPU renderer keeps no graph;
- the step makes no host read and no host-to-device copy, so it can be
  captured: no op of its phases reads a value on the host or builds a
  tensor from host data (the BVH scenes with K2 and K3 stood in for by
  device-only functions, since their CPU twins walk on the host; the
  crewmate's step with its Phong tally);
- the graph path's plumbing (the width's buffers, the 0-d iteration and
  seed, the write-back, the tail stages, a second band replaying what the
  first captured, the counters, the ray count that leaves the band) gives
  the eager band's sums and rays, with the capture stood in for by a
  replay of the captured step in Python;
- ``StepGraphs`` is bounded and lends a key's graphs to one band at a time.
"""

import contextlib
import dataclasses
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.camera import camera_frame, camera_rays3
from raytracer_tpu_torch.models.loader import load_scene
from raytracer_tpu_torch.ops import bvh_traverse, keys
from raytracer_tpu_torch.ops.intersect import scene_precompute
from raytracer_tpu_torch.ops.megakernel import M32, hash3, uniform
from raytracer_tpu_torch.render import wavefront
from raytracer_tpu_torch.render.renderer import Renderer
from raytracer_tpu_torch.render.wavefront import StepGraphs, render_band_regen, step_graphable, tail_widths
from raytracer_tpu_torch.utils.timing import count, counters, reset_counters
from tests.torch_cpu import one_torch_thread  # noqa: F401  (autouse)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
CPU = torch.device("cpu")
PHASES = {"rt.regen." + p for p in ("camera", "sort", "trace", "shadow", "shade")}


def _scene(name):
    scene = load_scene(os.path.join(SCENES, f"{name}.toml"), device="cpu")
    return scene, scene_precompute(scene)


@pytest.fixture(scope="module")
def unicorn():
    return _scene("flying_unicorn")


@pytest.fixture(scope="module")
def cornell():
    return _scene("cornell_box")


@pytest.fixture(scope="module")
def crewmate():
    return _scene("crewmate_phong")


def _zero_d(value: int) -> torch.Tensor:
    """A 0-d i64 tensor filled in place, as the band fills its own."""
    return torch.zeros((), dtype=torch.int64).fill_(value)


@pytest.mark.parametrize("seed", [0, 1234, 2**31 + 12345, M32])
def test_counter_hash_takes_0d_tensors(seed):
    lane = torch.arange(1 << 12, dtype=torch.int64) * 977 + 3
    seed_t = _zero_d(seed)
    for it in (0, 1, 7, 95, 1000, 2**20 + 3):
        it_t = _zero_d(it)
        assert torch.equal(hash3(lane ^ seed_t, it_t, 5), hash3(lane ^ seed, it, 5))
        for draw in range(9):
            assert torch.equal(uniform(seed_t, lane, it_t, draw), uniform(seed, lane, it, draw))


@pytest.mark.parametrize("name", ["flying_unicorn", "cornell_box", "crewmate_phong"])
def test_camera_rays_from_a_frame_built_once(name):
    scene, _ = _scene(name)
    w, h, fov = 40, 30, RenderConfig().fov_scale
    slot = torch.arange(w * h * 4, dtype=torch.int64)
    pix, sub = slot // 4, slot % 4
    args = (
        (pix % w).float(), (pix // w).float(), (sub % 2).float(), (sub // 2).float(),
        uniform(9, slot, 3, 0), uniform(9, slot, 3, 1),
    )
    want = camera_rays3(scene, w, h, fov, *args)
    got = camera_rays3(scene, w, h, fov, *args, camera_frame(scene, w, h, fov))
    for a, b in zip(want[0] + want[1], got[0] + got[1]):
        assert torch.equal(a, b)


def test_graph_predicate(monkeypatch, cornell):
    cuda = torch.device("cuda")
    monkeypatch.delenv("RT_SHADOW_COMPACT", raising=False)
    assert step_graphable(cuda) and not step_graphable(CPU)
    for value in ("1", "force"):
        monkeypatch.setenv("RT_SHADOW_COMPACT", value)
        assert not step_graphable(cuda) and not step_graphable(CPU)
    monkeypatch.setenv("RT_SHADOW_COMPACT", "0")
    assert step_graphable(cuda)
    # A CPU renderer passes its graphs to every regen band and keeps none.
    scene, _ = cornell
    r = Renderer(scene, RenderConfig(width=16, height=8, engine="regen"), device="cpu")
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        r.render_image(4)
    got = counters()
    reset_counters()
    assert len(r.graphs) == 0 and got["regen.steps"] > 0
    assert "regen.graph_steps" not in got and "regen.graph_captures" not in got


class HostReads(TorchDispatchMode):
    """Records the ops that read a tensor's value on the host or build a
    tensor from host data, while one of the step's phase spans is open."""

    def __init__(self):
        super().__init__()
        self.phase = None
        self.found: list[tuple[str, str]] = []

    @contextlib.contextmanager
    def span(self, name):
        outer, self.phase = self.phase, name if name in PHASES else self.phase
        try:
            yield
        finally:
            self.phase = outer

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__ if hasattr(func, "__name__") else str(func)
        if self.phase is not None:
            reads = func in (
                torch.ops.aten._local_scalar_dense.default, torch.ops.aten.lift_fresh.default,
                torch.ops.aten.nonzero.default, torch.ops.aten.masked_select.default,
            )
            if func is torch.ops.aten.index.Tensor or func is torch.ops.aten.index_put_.default:
                reads = any(i is not None and i.dtype == torch.bool for i in args[1])
            if reads:
                self.found.append((self.phase, name))
        return func(*args, **(kwargs or {}))


def _device_only_kernels(monkeypatch):
    """Stand-ins for K2 and K3 that, like the kernels, read nothing on the
    host: the traversal keeps each ray's ``t_init`` and finds triangle 0, the
    key is made of the ray's octant and origin."""

    def walk(scene, ro, rd, t_init, resolved0, any_hit, eps):
        return t_init.clone(), torch.zeros(t_init.shape, dtype=torch.int32)

    def key(scene, ro, rd, eps):
        o = ((rd[0] < 0).to(torch.int32) + 2 * (rd[1] < 0).to(torch.int32)) << 13
        return o | (torch.abs(ro[0] * 64.0).to(torch.int32) & 0x1FFF)

    monkeypatch.setattr(bvh_traverse, "bvh_traverse", walk)
    monkeypatch.setattr(keys, "coherence_key", key)


@pytest.mark.parametrize("case", ["unicorn", "unicorn_deferred", "cornell_mis", "crewmate", "unicorn_permuted"])
def test_the_step_reads_nothing_on_the_host(case, unicorn, cornell, crewmate, monkeypatch):
    if case != "cornell_mis":
        (scene, pre), cfg = crewmate if case == "crewmate" else unicorn, RenderConfig(width=32, height=24)
        _device_only_kernels(monkeypatch)
    else:
        (scene, pre), cfg = cornell, RenderConfig(width=16, height=8, engine="regen", use_mis=True)
    if case.endswith("deferred"):
        monkeypatch.setenv("RT_DEFER_SHADOW", "1")
    if case.endswith("permuted"):
        monkeypatch.setenv("RT_PERMUTE_STATE", "1")
    mode = HostReads()
    monkeypatch.setattr(wavefront, "span", mode.span)
    with mode:
        sums, _ = render_band_regen(scene, pre, cfg, 0, cfg.height, 2, 77)
    assert mode.found == []
    assert torch.isfinite(sums).all()


class Replayed:
    """A stand-in for a captured step on the CPU: each replay runs the step
    the capture was given, on the width's buffers, with its write-back."""

    def __init__(self, bg, st, step):
        self.bg, self.st, self.step = bg, st, step

    def replay(self):
        self.step(self.bg.it, self.st.fs, self.st.ints, self.bg.rays)


def _replays_on_the_cpu(monkeypatch):
    def capture(bg, st, step):
        st.graph = Replayed(bg, st, step)
        count("regen.graph_captures")

    monkeypatch.setattr(wavefront, "step_graphable", lambda device: True)
    monkeypatch.setattr(wavefront.BandGraphs, "_capture", capture)


@pytest.mark.parametrize("case", ["unicorn", "unicorn_deferred", "cornell_mis", "unicorn_permuted"])
def test_graph_plumbing_gives_the_eager_band(case, unicorn, cornell, monkeypatch):
    if case.startswith("unicorn"):
        (scene, pre), cfg = unicorn, RenderConfig(width=32, height=24)
    else:
        (scene, pre), cfg = cornell, RenderConfig(width=16, height=8, engine="regen", use_mis=True)
    if case.endswith("deferred"):
        monkeypatch.setenv("RT_DEFER_SHADOW", "1")
    if case.endswith("permuted"):
        monkeypatch.setenv("RT_PERMUTE_STATE", "1")
    n = cfg.width * cfg.height * 4
    widths = [n] + tail_widths(n, cfg, scene.use_bvh)
    assert len(widths) == (3 if scene.use_bvh else 1)
    want = [render_band_regen(scene, pre, cfg, 0, cfg.height, 1, seed) for seed in (5, 6)]
    _replays_on_the_cpu(monkeypatch)
    graphs = StepGraphs()
    got = []
    for seed in (5, 6):
        reset_counters()
        with profile(activities=[ProfilerActivity.CPU]):
            sums, rays = render_band_regen(scene, pre, cfg, 0, cfg.height, 1, seed, graphs=graphs)
        got.append((sums, rays, counters()))
    reset_counters()
    (bg,) = graphs._bands.values()
    assert sorted(bg.stages) == sorted(widths)
    for (s_want, r_want), (s_got, r_got, c) in zip(want, got):
        assert torch.equal(s_want, s_got) and int(r_want) == int(r_got)
        assert r_got.data_ptr() != bg.rays.data_ptr()  # the count leaves as a copy
    # The first band steps each width once eagerly, then captures it; the
    # second (another seed, the same key) replays every step.
    first, second = got[0][2], got[1][2]
    assert first["regen.graph_captures"] == len(widths)
    assert first["regen.graph_steps"] == first["regen.steps"] - len(widths)
    assert "regen.graph_captures" not in second
    assert second["regen.graph_steps"] == second["regen.steps"] > 0


def test_step_graphs_are_bounded_and_lent_to_one_band_at_a_time():
    graphs = StepGraphs()
    with graphs.band(("a",), CPU, ()) as a:
        with graphs.band(("a",), CPU, ()) as busy:
            assert a is not None and busy is None
        with graphs.band(("b",), CPU, ()) as b:
            assert b is not None and b is not a
    with graphs.band(("a",), CPU, ()) as again:
        assert again is a
    # Past the bound the least recently used idle key goes; a held one stays.
    with graphs.band(("held",), CPU, ()) as held:
        for i in range(2 * StepGraphs.MAX_BANDS):
            with graphs.band((i,), CPU, ()):
                pass
        assert len(graphs) == StepGraphs.MAX_BANDS
        assert graphs._bands[("held",)] is held
    assert ("a",) not in graphs._bands


def test_a_hook_change_is_another_key(unicorn, monkeypatch):
    """A hook the captured step baked in gives its own graphs."""
    scene, pre = unicorn
    cfg = dataclasses.replace(RenderConfig(width=16, height=8), tail_compact=False)
    _replays_on_the_cpu(monkeypatch)
    graphs = StepGraphs()
    render_band_regen(scene, pre, cfg, 0, 8, 1, 3, graphs=graphs)
    monkeypatch.setenv("RT_SORT_GROUP", "8")
    render_band_regen(scene, pre, cfg, 0, 8, 1, 3, graphs=graphs)
    monkeypatch.setenv("RT_STATE_BF16", "1")
    render_band_regen(scene, pre, cfg, 0, 8, 1, 3, graphs=graphs)
    render_band_regen(scene, pre, cfg, 0, 8, 2, 3, graphs=graphs)
    assert len(graphs) == 4
