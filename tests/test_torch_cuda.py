"""Tests of the port that need an NVIDIA GPU; they skip without one.

This file imports no jax, so it also runs on a machine that has only
PyTorch: ``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``
(``tests/conftest.py`` imports jax).
"""

import os

import pytest
import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.loader import load_scene
from raytracer_tpu_torch.ops import megakernel as mk
from raytracer_tpu_torch.render.renderer import Renderer

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell_box", "cubes"])
def test_kernel_matches_twin_on_gpu(cuda, name):
    cfg = RenderConfig()
    scene = load_scene(os.path.join(SCENES, f"{name}.toml"), device=cuda)
    pf, static = mk.pack_params(scene, cfg)
    n = 2 * cfg.width * 4
    before = mk.LAUNCHES
    acc_k, rays_k = mk.mega_cuda(pf, static, 100, 8, n, 77, cuda)
    assert mk.LAUNCHES == before + 1
    acc_t, rays_t = mk.mega_twin(pf, static, 100, 8, n, 77, cuda)
    torch.cuda.synchronize()
    d = (acc_k - acc_t).abs().amax(dim=1)
    tol = mk.LANE_RTOL * acc_t.abs().amax(dim=1).clamp_min(1.0)
    assert (d <= tol).double().mean().item() >= mk.LANE_SHARE
    assert (rays_k == rays_t).double().mean().item() >= mk.LANE_SHARE
    assert abs(acc_k.mean().item() - acc_t.mean().item()) <= mk.BAND_RTOL * acc_t.mean().item()


@pytest.mark.cuda
def test_renderer_defaults_to_the_kernel(cuda):
    scene = load_scene(os.path.join(SCENES, "cornell_box.toml"))  # default device: cuda
    assert scene.device.type == "cuda"
    r = Renderer(scene, RenderConfig(width=64, height=48))
    before = mk.LAUNCHES
    img = r.render_image(8)
    assert mk.LAUNCHES > before
    assert img.shape == (48, 64, 3) and img.mean() > 20


def _unicorn_rays(scene, n, seed, dev):
    """Camera rays through the unicorn's box, random rays inside it, parked."""
    g = torch.Generator().manual_seed(seed)
    lo, hi = scene.bvh_lo[0].cpu(), scene.bvh_hi[0].cpu()
    inside = lo + (hi - lo) * torch.rand((n, 3), generator=g)
    cam = scene.cam_pos.cpu().expand(n // 2, 3)
    ro = torch.cat([cam, inside[n // 2:]])
    d = torch.cat([inside[: n // 2] - cam, torch.randn((n - n // 2, 3), generator=g)])
    rd = d / d.norm(dim=1, keepdim=True)
    ro[-n // 16:] = 3.0e7
    rd[-n // 16:] = torch.tensor([1.0, 0.0, 0.0])
    return tuple(ro.to(dev).unbind(1)), tuple(rd.to(dev).unbind(1))


@pytest.mark.cuda
@pytest.mark.parametrize("n_cut", [32, 20])
def test_key_kernel_is_bit_equal_to_twin_on_gpu(cuda, n_cut):
    """32 cut boxes: the kernel with its cut count at compile time; 20: the
    same source with the count at run time."""
    import dataclasses

    from raytracer_tpu_torch.ops import keys

    scene = load_scene(os.path.join(SCENES, "flying_unicorn.toml"), device=cuda)
    assert scene.bvh_cut_lo.shape[0] == 32
    scene = dataclasses.replace(scene, bvh_cut_lo=scene.bvh_cut_lo[:n_cut].contiguous(),
                                bvh_cut_hi=scene.bvh_cut_hi[:n_cut].contiguous())
    ro, rd = _unicorn_rays(scene, 1 << 16, 1, cuda)
    before = keys.LAUNCHES
    k = keys.coherence_key_cuda(scene, ro, rd, RenderConfig().eps)
    assert keys.LAUNCHES == before + 1
    assert torch.equal(k, keys.coherence_key_twin(scene, ro, rd, RenderConfig().eps))


@pytest.mark.cuda
def test_key_kernel_reads_a_device_table_past_64_cut_boxes(cuda, monkeypatch):
    """RT_MAX_CUT=256: the kernel's third instance, over a device copy of
    the table."""
    from raytracer_tpu_torch.ops import keys

    monkeypatch.setenv("RT_MAX_CUT", "256")
    scene = load_scene(os.path.join(SCENES, "flying_unicorn.toml"), device=cuda)
    assert scene.bvh_cut_lo.shape[0] == 256
    ro, rd = _unicorn_rays(scene, 1 << 16, 6, cuda)
    k = keys.coherence_key_cuda(scene, ro, rd, RenderConfig().eps)
    assert torch.equal(k, keys.coherence_key_twin(scene, ro, rd, RenderConfig().eps))
    assert ((k >> 17) & 0x1FFF).max().item() >= keys.KEY_MAX_CUT


@pytest.mark.cuda
def test_fused_engine_equals_regen_on_gpu(cuda):
    """The fused engine through K3 and K2, one launch of each a trace: the
    regen frame's pixels and rays."""
    from raytracer_tpu_torch.ops import bvh_traverse, keys

    scene = load_scene(os.path.join(SCENES, "flying_unicorn.toml"), device=cuda)
    regen = Renderer(scene, RenderConfig(width=64, height=48))
    fused = Renderer(scene, RenderConfig(width=64, height=48, engine="fused"))
    want = regen.render_image(8)
    k0, b0 = keys.LAUNCHES, bvh_traverse.LAUNCHES
    got = fused.render_image(8)
    assert fused.engine == "fused" and keys.LAUNCHES - k0 == bvh_traverse.LAUNCHES - b0 > 0
    assert (got == want).all() and fused.rays_traced() == regen.rays_traced()


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_traversal_kernel_matches_twin_on_gpu(cuda, any_hit):
    from raytracer_tpu_torch.ops import bvh_traverse as bt

    eps = RenderConfig().eps
    scene = load_scene(os.path.join(SCENES, "flying_unicorn.toml"), device=cuda)
    n = 1 << 15
    ro, rd = _unicorn_rays(scene, n, 2, cuda)
    g = torch.Generator().manual_seed(3)
    t_init = torch.where(torch.rand(n, generator=g) < 0.5, bt.INF, 10 + 200 * torch.rand(n, generator=g)).to(cuda)
    resolved = (torch.rand(n, generator=g) < 0.1).to(cuda)
    before = bt.LAUNCHES
    t_k, i_k = bt.bvh_traverse_cuda(scene, ro, rd, t_init, resolved, any_hit, eps)
    assert bt.LAUNCHES == before + 1
    t_t, i_t = bt.bvh_traverse_twin(scene, ro, rd, t_init, resolved, any_hit, eps)
    torch.cuda.synchronize()
    assert (t_k == t_t).double().mean().item() >= bt.T_EXACT_SHARE
    diff = i_k != i_t
    assert torch.equal(bt.leaf_t(scene, ro, rd, i_k)[diff], bt.leaf_t(scene, ro, rd, i_t)[diff])
    assert (t_k < t_init).sum() > n // 20


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_tris", [0, 8, None])
def test_traversal_kernel_leaf_tris_matches_twin_on_gpu(cuda, leaf_tris):
    """RT_LEAF_TRIS's argument (None: every row) in K2 and in its twin."""
    from raytracer_tpu_torch.ops import bvh_traverse as bt

    eps = RenderConfig().eps
    scene = load_scene(os.path.join(SCENES, "flying_unicorn.toml"), device=cuda)
    n = 1 << 15
    ro, rd = _unicorn_rays(scene, n, 6, cuda)
    args = (scene, ro, rd, torch.full((n,), bt.INF, device=cuda), torch.zeros(n, dtype=torch.bool, device=cuda),
            False, eps)
    t_k, i_k = bt.bvh_traverse_cuda(*args, leaf_tris=leaf_tris)
    t_t, i_t = bt.bvh_traverse_twin(*args, leaf_tris=leaf_tris)
    torch.cuda.synchronize()
    assert (t_k == t_t).double().mean().item() >= bt.T_EXACT_SHARE
    diff = i_k != i_t
    assert torch.equal(bt.leaf_t(scene, ro, rd, i_k)[diff], bt.leaf_t(scene, ro, rd, i_t)[diff])
    if leaf_tris is None:
        assert torch.equal(t_k, bt.bvh_traverse_cuda(*args, leaf_tris=10 ** 6)[0])
    if leaf_tris == 0:
        assert (t_k == bt.INF).all()


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_binary_walk_kernel_matches_twin_on_gpu(cuda, any_hit):
    from raytracer_tpu_torch.ops import bvh_binary as bb
    from raytracer_tpu_torch.ops import bvh_traverse as bt

    eps = RenderConfig().eps
    scene = load_scene(os.path.join(SCENES, "crewmate_phong.toml"), device=cuda)
    n = 1 << 15
    ro, rd = _unicorn_rays(scene, n, 4, cuda)
    g = torch.Generator().manual_seed(5)
    t_init = torch.where(torch.rand(n, generator=g) < 0.5, bt.INF, 10 + 200 * torch.rand(n, generator=g)).to(cuda)
    resolved = (torch.rand(n, generator=g) < 0.1).to(cuda)
    before = bb.LAUNCHES
    t_k, i_k = bb.bvh_binary_cuda(scene, ro, rd, t_init, resolved, any_hit, eps)
    assert bb.LAUNCHES == before + 1
    t_t, i_t = bb.bvh_binary_twin(scene, ro, rd, t_init, resolved, any_hit, eps)
    torch.cuda.synchronize()
    assert (t_k == t_t).double().mean().item() >= bt.T_EXACT_SHARE
    diff = i_k != i_t
    assert torch.equal(bt.leaf_t(scene, ro, rd, i_k)[diff], bt.leaf_t(scene, ro, rd, i_t)[diff])
    assert (t_k < t_init).sum() > n // 20


@pytest.mark.cuda
def test_unicorn_renders_through_k2_and_k3(cuda):
    from raytracer_tpu_torch.ops import bvh_traverse, keys

    scene = load_scene(os.path.join(SCENES, "flying_unicorn.toml"), device=cuda)
    r = Renderer(scene, RenderConfig(width=64, height=48))
    assert r.engine == "regen"
    k0, b0 = keys.LAUNCHES, bvh_traverse.LAUNCHES
    img = r.render_image(8)
    assert keys.LAUNCHES > k0 and bvh_traverse.LAUNCHES > b0
    assert img.shape == (48, 64, 3) and img.mean() > 20


@pytest.mark.cuda
def test_crewmate_binary_variant_renders_through_k4(cuda, monkeypatch):
    from raytracer_tpu_torch.ops import bvh_binary, bvh_traverse

    monkeypatch.setenv("RT_BVH_KERNEL", "binary")
    scene = load_scene(os.path.join(SCENES, "crewmate_phong.toml"), device=cuda)
    r = Renderer(scene, RenderConfig(width=64, height=48, use_mis=True))
    assert r.engine == "regen"
    k4, k2 = bvh_binary.LAUNCHES, bvh_traverse.LAUNCHES
    img = r.render_image(8)
    assert bvh_binary.LAUNCHES > k4 and bvh_traverse.LAUNCHES == k2
    assert img.shape == (48, 64, 3) and img.mean() > 20


@pytest.mark.cuda
def test_all_bands_launch_equals_one_band_launches_on_gpu(cuda):
    cfg = RenderConfig(width=64, height=48)
    scene = load_scene(os.path.join(SCENES, "cubes.toml"), device=cuda)
    pf, static = mk.pack_params(scene, cfg)
    n = 8 * cfg.width * 4
    bands = [(y0, mk.band_seed(3, y0, 0)) for y0 in range(0, cfg.height, 8)]
    before = mk.LAUNCHES
    acc, rays = mk.mega_cuda_bands(pf, static, bands, 4, n, cuda)
    assert mk.LAUNCHES == before + 1
    one = [mk.mega_cuda(pf, static, y0, 4, n, seed, cuda) for y0, seed in bands]
    assert torch.equal(acc, torch.cat([o[0] for o in one]))
    assert torch.equal(rays, torch.cat([o[1] for o in one]))


@pytest.mark.cuda
def test_simple_engine_renders_on_gpu(cuda):
    """The lockstep engine on the card agrees with K1's frame in the mean
    (two streams of random numbers, one estimator)."""
    scene = load_scene(os.path.join(SCENES, "cornell_box.toml"), device=cuda)
    base = dict(width=64, height=48, rays_per_pass=1 << 14)
    simple = Renderer(scene, RenderConfig(engine="simple", **base))
    assert simple.engine == "simple"
    before = mk.LAUNCHES
    a = simple.render_image(64)
    assert mk.LAUNCHES == before  # plain PyTorch on the card, no kernel of its own
    b = Renderer(scene, RenderConfig(**base)).render_image(64)
    assert a.shape == (48, 64, 3) and abs(float(a.mean()) - float(b.mean())) < 2.0
    assert simple.rays_traced() > 64 * 48 * 64


@pytest.mark.cuda
def test_checkpoint_resume_on_gpu(cuda, tmp_path):
    import numpy as np

    from raytracer_tpu_torch.render.checkpoint import RenderCheckpoint, render_with_checkpoint

    scene = load_scene(os.path.join(SCENES, "cornell_box.toml"), device=cuda)
    cfg = RenderConfig(width=64, height=48, rays_per_pass=1 << 12)
    r = Renderer(scene, cfg)
    whole = render_with_checkpoint(r, "cornell_box", 128)
    calls = {"n": 0}

    def cancelled():
        calls["n"] += 1
        return calls["n"] > 5

    part = render_with_checkpoint(r, "cornell_box", 128, cancelled=cancelled)
    assert 0 < part.num_samples < 32
    path = str(tmp_path / "ck.npz")
    part.save(path)
    done = render_with_checkpoint(r, "cornell_box", 128, checkpoint=RenderCheckpoint.load(path, "cornell_box", cfg))
    assert done.num_samples == 32
    np.testing.assert_array_equal(done.sums, whole.sums)


@pytest.mark.cuda
def test_sharded_band_over_one_card_twice(cuda):
    """``[cuda:0, cuda:0]``: each device band equals the plain band function
    (the megakernel), and a regen frame equals the plain renderer's."""
    from raytracer_tpu_torch.parallel.mesh import ShardedRenderer

    scene = load_scene(os.path.join(SCENES, "cornell_box.toml"), device=cuda)
    cfg = RenderConfig(width=64, height=48, rays_per_pass=1 << 14)
    r = ShardedRenderer(scene, cfg, [cuda, cuda])
    rows, k, n_passes = r.plan(16)
    sums, rays = r.render_band_sums(0, rows, k, n_passes, return_rays=True)
    half = rows // 2
    total = 0
    for d in range(2):
        want, n = mk.render_band_mega(scene, cfg, d * half, half, k * n_passes, mk.band_seed(cfg.seed, d * half, 0))
        assert torch.equal(sums[d * half : (d + 1) * half], want)
        total += int(n)
    assert int(rays) == total
    unicorn = load_scene(os.path.join(SCENES, "flying_unicorn.toml"), device=cuda)
    ucfg = RenderConfig(width=64, height=48)
    a = ShardedRenderer(unicorn, ucfg, [cuda, cuda]).render_image(8)
    assert (a == Renderer(unicorn, ucfg).render_image(8)).all()


@pytest.mark.cuda
def test_sharded_over_every_visible_card(cuda):
    """More than one card: every device's band equals the plain band function
    on the first card (bit for bit across cards), a regen frame equals the
    plain renderer's, and ``make_renderer`` shards a megakernel scene by
    default and a regen one only when asked."""
    from raytracer_tpu_torch.parallel.mesh import ShardedRenderer
    from raytracer_tpu_torch.render.renderer import make_renderer

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs at least two CUDA devices")
    devices = [torch.device("cuda", i) for i in range(n)]
    scene = load_scene(os.path.join(SCENES, "cornell_box.toml"), device=devices[0])
    cfg = RenderConfig(width=64, height=48, rays_per_pass=1 << 14)
    r = make_renderer(scene, cfg, devices[0])
    assert type(r) is ShardedRenderer and r.n_dev == n
    rows, k, n_passes = r.plan(16)
    sums, rays = r.render_band_sums(0, rows, k, n_passes, return_rays=True)
    assert sums.device == devices[0]
    per = rows // n
    total = 0
    for d in range(n):
        want, n_d = mk.render_band_mega(scene, cfg, d * per, per, k * n_passes, mk.band_seed(cfg.seed, d * per, 0))
        assert torch.equal(sums[d * per : (d + 1) * per], want), d
        total += int(n_d)
    assert int(rays) == total
    unicorn = load_scene(os.path.join(SCENES, "flying_unicorn.toml"), device=devices[0])
    ucfg = RenderConfig(width=64, height=48)
    plain = Renderer(unicorn, ucfg, device=devices[0]).render_image(8)
    assert type(make_renderer(unicorn, ucfg, devices[0])) is Renderer
    asked = make_renderer(unicorn, ucfg, devices[0], sharded=True)
    assert type(asked) is ShardedRenderer and asked.n_dev == n
    assert (asked.render_image(8) == plain).all()


def _regen_case(name, cuda, monkeypatch):
    """(scene, precompute, config) of a graphed-band case."""
    from raytracer_tpu_torch.ops.intersect import scene_precompute

    if name == "unicorn_deferred":
        monkeypatch.setenv("RT_DEFER_SHADOW", "1")
    if name == "unicorn_permuted":
        monkeypatch.setenv("RT_PERMUTE_STATE", "1")
    scene_file, cfg = {
        # 12,288 lanes: every tail width (6,144, 3,072, 2,048).
        "unicorn": ("flying_unicorn", RenderConfig(width=64, height=48)),
        "unicorn_deferred": ("flying_unicorn", RenderConfig(width=64, height=48)),
        "unicorn_permuted": ("flying_unicorn", RenderConfig(width=64, height=48)),
        "crewmate_phong": ("crewmate_phong", RenderConfig(width=64, height=48)),
        "cornell_mis": ("cornell_box", RenderConfig(width=32, height=24, engine="regen", use_mis=True)),
    }[name]
    scene = load_scene(os.path.join(SCENES, f"{scene_file}.toml"), device=cuda)
    return scene, scene_precompute(scene), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["unicorn", "crewmate_phong", "cornell_mis", "unicorn_deferred", "unicorn_permuted"])
def test_graphed_regen_band_equals_the_eager_band(cuda, name, monkeypatch):
    """The same kernels in the same order: every element of the sums and the
    ray count, on the band that captures and on one that replays."""
    from raytracer_tpu_torch.render.wavefront import StepGraphs, render_band_regen, tail_widths

    scene, pre, cfg = _regen_case(name, cuda, monkeypatch)
    graphs = StepGraphs()
    for seed in (5, 6, 7):
        want, want_rays = render_band_regen(scene, pre, cfg, 0, cfg.height, 2, seed)
        got, got_rays = render_band_regen(scene, pre, cfg, 0, cfg.height, 2, seed, graphs=graphs)
        assert torch.equal(got, want), seed
        assert int(got_rays) == int(want_rays), seed
    (bg,) = graphs._bands.values()
    n = cfg.width * cfg.height * 4
    assert sorted(bg.stages) == sorted([n] + tail_widths(n, cfg, scene.use_bvh))
    assert all(st.graph is not None for st in bg.stages.values())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["unicorn", "crewmate_phong"])
def test_graphed_default_band_equals_the_eager_permuted_band(cuda, name, monkeypatch):
    """The default step (the lanes in slot order, each trace sorting its own
    rays by K3's key) replayed as graphs against the eager permuted step of
    ``RT_PERMUTE_STATE=1``: every element of the sums, the ray count, and
    K2's and K3's launches (two of each a step on both)."""
    from raytracer_tpu_torch.ops import bvh_traverse, keys
    from raytracer_tpu_torch.render.wavefront import StepGraphs, render_band_regen, tail_widths

    scene, pre, cfg = _regen_case(name, cuda, monkeypatch)
    graphs = StepGraphs()

    def band(**kw):
        k2, k3 = bvh_traverse.LAUNCHES, keys.LAUNCHES
        sums, rays = render_band_regen(scene, pre, cfg, 0, cfg.height, 2, seed, **kw)
        return sums, int(rays), (bvh_traverse.LAUNCHES - k2, keys.LAUNCHES - k3)

    for seed in (5, 6, 7):
        with monkeypatch.context() as m:
            m.setenv("RT_PERMUTE_STATE", "1")
            want, want_rays, want_launches = band()
        got, got_rays, got_launches = band(graphs=graphs)
        assert torch.equal(got, want), seed
        assert got_rays == want_rays and got_launches == want_launches and min(got_launches) > 0, seed
    (bg,) = graphs._bands.values()
    n = cfg.width * cfg.height * 4
    assert sorted(bg.stages) == sorted([n] + tail_widths(n, cfg, scene.use_bvh))
    assert all(st.graph is not None for st in bg.stages.values())


@pytest.mark.cuda
def test_a_second_render_replays_with_no_capture(cuda):
    """A renderer captures its widths in the first frame; later frames replay
    every step, and K2's and K3's launch counters rise with each replayed
    launch, as much as an eager frame's."""
    from torch.profiler import ProfilerActivity, profile

    from raytracer_tpu_torch.ops import bvh_traverse, keys
    from raytracer_tpu_torch.utils.timing import counters, reset_counters

    scene = load_scene(os.path.join(SCENES, "flying_unicorn.toml"), device=cuda)
    cfg = RenderConfig(width=64, height=48)
    r = Renderer(scene, cfg)
    eager = Renderer(scene, cfg)
    eager.graphs = None

    def frame(renderer):
        k3, k2 = keys.LAUNCHES, bvh_traverse.LAUNCHES
        reset_counters()
        with profile(activities=[ProfilerActivity.CPU]):
            img = renderer.render_image(8)
        got = counters()
        reset_counters()
        return img, got, (keys.LAUNCHES - k3, bvh_traverse.LAUNCHES - k2)

    want, _, eager_launches = frame(eager)
    first, c1, l1 = frame(r)
    assert c1["regen.graph_captures"] == len(r.graphs._bands[next(iter(r.graphs._bands))].stages) == 4
    n_bands = len(r.graphs)
    for _ in range(2):
        img, c, launches = frame(r)
        assert (img == want).all() and len(r.graphs) == n_bands
        assert "regen.graph_captures" not in c
        assert c["regen.graph_steps"] == c["regen.steps"] > 0
        assert launches == l1 == eager_launches and min(launches) > 0
    assert (first == want).all() and r.rays_traced() == 3 * eager.rays_traced()


@pytest.mark.cuda
def test_graphed_bands_under_threads(cuda):
    """Threads that share a renderer, as the server's executor threads do:
    each band equals the eager band, whether it held the key's graphs or
    stepped eagerly while another band held them."""
    from concurrent.futures import ThreadPoolExecutor

    scene = load_scene(os.path.join(SCENES, "flying_unicorn.toml"), device=cuda)
    cfg = RenderConfig(width=64, height=48)
    r = Renderer(scene, cfg)
    eager = Renderer(scene, cfg)
    eager.graphs = None
    rows = 16
    want = {y0: eager.render_band_sums(y0, rows, 1, 1, salt=1, return_rays=True) for y0 in (0, 16, 32)}

    def band(y0):
        sums, rays = r.render_band_sums(y0, rows, 1, 1, salt=1, return_rays=True)
        torch.cuda.current_stream().synchronize()
        return y0, sums, int(rays)

    with ThreadPoolExecutor(4) as pool:
        for y0, sums, rays in pool.map(band, [0, 16, 32] * 4):
            assert torch.equal(sums, want[y0][0]) and rays == int(want[y0][1]), y0


def _counted(fn):
    """``fn()`` under a profiler -> (its result, the program's counters)."""
    from torch.profiler import ProfilerActivity, profile

    from raytracer_tpu_torch.utils.timing import counters, reset_counters

    reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    got = counters()
    reset_counters()
    return out, got


@pytest.mark.cuda
def test_graphed_crewmate_band_counts_its_phong_arms_as_the_eager_band(cuda, monkeypatch):
    """The Phong counters, summed on the device inside the step, read the
    same on the band that captures, on those that replay and eagerly."""
    from raytracer_tpu_torch.render.wavefront import StepGraphs, render_band_regen

    phong = ("regen.phong_hits", "regen.phong_lobe", "regen.phong_dead")
    scene, pre, cfg = _regen_case("crewmate_phong", cuda, monkeypatch)
    graphs = StepGraphs()
    for seed in (5, 6, 7):
        (want, _), c_want = _counted(lambda: render_band_regen(scene, pre, cfg, 0, cfg.height, 2, seed))
        (got, _), c_got = _counted(lambda: render_band_regen(scene, pre, cfg, 0, cfg.height, 2, seed,
                                                             graphs=graphs))
        assert torch.equal(got, want), seed
        assert [c_got[k] for k in phong] == [c_want[k] for k in phong], seed
        assert all(c_got[k] > 0 for k in phong) and c_got["regen.graph_steps"] > 0
    assert c_got["regen.graph_steps"] == c_got["regen.steps"]


def _band_ops(scene, pre, cfg):
    """ATen ops an eager band of two samples dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from raytracer_tpu_torch.render.wavefront import render_band_regen

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            return func(*args, **(kwargs or {}))

    with Count() as c:
        render_band_regen(scene, pre, cfg, 0, cfg.height, 2, 5)
    return c.ops


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["unicorn", "crewmate_phong"])
def test_the_phong_counters_add_ops_to_a_phong_step_alone(cuda, monkeypatch, name):
    """The band with its Phong tally against the same band with the tally
    dropped, counted in the dispatcher: the tally adds ops to a Phong
    scene's steps and none to the unicorn's, so the unicorn's captured step
    is the parent's. (What the profiler counts for one graph replay varies
    with the process's history: 745 and 599 kernels for the same unicorn
    step in one process.)"""
    from raytracer_tpu_torch.render import wavefront

    scene, pre, cfg = _regen_case(name, cuda, monkeypatch)
    _band_ops(scene, pre, cfg)  # the first band builds what the later ones reuse (7 ops more)
    counted = _band_ops(scene, pre, cfg)
    bounce = wavefront.bounce
    monkeypatch.setattr(wavefront, "bounce", lambda *a: bounce(*a[:10]))  # the tally is the 11th
    plain = _band_ops(scene, pre, cfg)
    assert plain > 0 and (counted > plain if name == "crewmate_phong" else counted == plain), (counted, plain)
