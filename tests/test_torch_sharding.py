"""Row bands over several devices in the port (``parallel/mesh.py``), on a
list of CPU devices.

Property (a): a device's rows equal, bit for bit, the plain band function
called on one device at the device's first row with the seed the sharded
renderer gives it (the contract of ``tests/test_sharding.py:49``). Property
(b): for the regen engine a multi-device frame equals the plain
``Renderer``'s frame on every pixel. The cases of ``tests/test_sharding.py``
(:26, :38, :86, :95) on the port; band plans equal to the JAX
``ShardedRenderer``'s; ``make_renderer``'s policy; ``Server(sharded=)``;
the multi-device dry run of ``__graft_entry_torch__``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from raytracer_tpu.models.loader import load_scene as jax_load_scene
from raytracer_tpu.parallel.mesh import ShardedRenderer as JaxShardedRenderer
from raytracer_tpu.parallel.mesh import make_mesh
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.loader import load_scene
from raytracer_tpu_torch.ops.intersect import scene_precompute
from raytracer_tpu_torch.ops.megakernel import band_seed, render_band_mega
from raytracer_tpu_torch.parallel.mesh import ShardedRenderer
from raytracer_tpu_torch.render import renderer as rnd
from raytracer_tpu_torch.render.renderer import Renderer, make_renderer
from raytracer_tpu_torch.render.wavefront import render_band_regen
from raytracer_tpu_torch.server.app import Server
from tests.torch_cpu import jax_cfg, one_torch_thread  # noqa: F401  (autouse)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
CPUS = ["cpu"] * 4


@pytest.fixture(scope="module")
def cornell():
    return load_scene(os.path.join(SCENES, "cornell_box.toml"), device="cpu")


@pytest.fixture(scope="module")
def unicorn():
    return load_scene(os.path.join(SCENES, "flying_unicorn.toml"), device="cpu")


def test_sharded_render_runs_and_covers_frame(cornell):
    cfg = RenderConfig(width=64, height=48, rays_per_pass=1 << 14)
    r = ShardedRenderer(cornell, cfg, CPUS)
    assert r.n_dev == 4 and r.engine == "mega"
    img = r.render_image(8)
    assert img.shape == (48, 64, 3)
    assert img[:16].mean() > img[-16:].mean()  # every band rendered: the light is at the top
    assert r.rays_traced() > 48 * 64 * 8


def test_sharded_matches_single_device_statistically(cornell):
    """Megakernel frames of different band heights draw under different band
    seeds: they agree in the mean (tests/test_sharding.py:38, 5%)."""
    cfg = RenderConfig(width=64, height=48, rays_per_pass=1 << 14)
    img1 = Renderer(cornell, cfg, device="cpu").render_image(32)
    img4 = ShardedRenderer(cornell, cfg, CPUS).render_image(32)
    assert not np.array_equal(img1, img4)
    m1, m4 = img1.astype(np.float64).mean(), img4.astype(np.float64).mean()
    assert abs(m1 - m4) / max(m1, 1.0) < 0.05


@pytest.mark.parametrize("engine", ["mega", "regen"])
def test_device_band_equals_the_plain_band_function(cornell, engine):
    """Property (a), on every device."""
    cfg = RenderConfig(width=64, height=48, rays_per_pass=1 << 14, engine=engine)
    r = ShardedRenderer(cornell, cfg, CPUS)
    assert r.engine == engine
    rows, k, n_passes = r.plan(8)
    rows_per_dev = rows // r.n_dev
    y0, salt = 0, 3
    sums, rays = r.render_band_sums(y0, rows, k, n_passes, salt=salt, return_rays=True)
    assert sums.shape == (rows, 64, 4, 3)
    total = 0
    for d in range(r.n_dev):
        y0_d = y0 + d * rows_per_dev
        if engine == "mega":
            want, n = render_band_mega(cornell, cfg, y0_d, rows_per_dev, k * n_passes,
                                       band_seed(cfg.seed, y0_d, salt))
        else:
            want, n = render_band_regen(cornell, scene_precompute(cornell), cfg, y0_d, rows_per_dev,
                                        k * n_passes, band_seed(cfg.seed, 0, salt))
        assert torch.equal(sums[d * rows_per_dev : (d + 1) * rows_per_dev], want), d
        total += int(n)
    assert int(rays) == total


@pytest.mark.parametrize("height", [24, 22])
def test_sharded_regen_frame_equals_the_plain_frame(unicorn, height):
    """Property (b): every pixel, also where the last band overshoots H."""
    cfg = RenderConfig(width=32, height=height, rays_per_pass=1 << 12, mesh_rays_per_pass=1 << 12)
    r = ShardedRenderer(unicorn, cfg, CPUS)
    plain = Renderer(unicorn, cfg, device="cpu")
    rows, _, _ = r.plan(8)
    assert rows % 4 == 0 and (height % rows != 0) == (height == 22)
    np.testing.assert_array_equal(r.render_image(8), plain.render_image(8))
    if height == 24:  # no overshoot: the same rays
        assert r.rays_traced() == plain.rays_traced()


def test_sharded_band_rows_cover_height(cornell):
    cfg = RenderConfig(width=64, height=50, rays_per_pass=1 << 12)
    r = ShardedRenderer(cornell, cfg, CPUS)
    rows, _, _ = r.plan(16)
    assert rows % r.n_dev == 0
    ys = [y for y, _ in r.iter_bands(16)]
    assert ys[0] == 0 and ys[-1] + rows >= cfg.height
    assert r.render_image(16).shape == (50, 64, 3)


def test_sharded_mesh_scene_runs(unicorn):
    cfg = RenderConfig(width=32, height=24, rays_per_pass=1 << 12, mesh_rays_per_pass=1 << 12)
    r = ShardedRenderer(unicorn, cfg, CPUS)
    rows, _, _ = r.plan(8)
    assert rows % r.n_dev == 0 and r.engine == "regen"
    assert r.render_image(8).shape == (24, 32, 3)


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("size", [(600, 450), (64, 50), (1920, 1080)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_band_plans_equal_jax_sharded_renderer(cornell, unicorn, n_dev, size):
    mesh = make_mesh(np.asarray(jax.devices()[:n_dev]))
    w, h = size
    paths = {"cornell_box": cornell, "flying_unicorn": unicorn}
    for name, port in paths.items():
        ref = jax_load_scene(os.path.join(SCENES, f"{name}.toml"))
        for engine in ("mega", "regen"):
            cfg = RenderConfig(width=w, height=h, engine=engine)
            jr = JaxShardedRenderer(ref, jax_cfg(cfg), mesh)
            r = ShardedRenderer(port, cfg, ["cpu"] * n_dev)
            for spp in (0, 4, 16, 64, 256, 1024):
                assert r.plan(spp) == jr.plan(spp), (name, engine, spp)
                assert r.plan_delivery(spp) == jr.plan_delivery(spp), (name, engine, spp)
                assert r.plan_progressive(spp) == jr.plan_progressive(spp), (name, engine, spp)
            for target in (1, 7, 113):
                assert r._delivery_rows(target) == jr._delivery_rows(target)


def test_make_renderer_policy(cornell, unicorn, monkeypatch):
    cfg = RenderConfig(width=32, height=24)
    # One device (the CPU, or one card): the plain renderer.
    assert type(make_renderer(cornell, cfg, "cpu")) is Renderer
    assert type(make_renderer(cornell, cfg, "cpu", sharded=False)) is Renderer
    forced = make_renderer(cornell, cfg, "cpu", sharded=True)
    assert type(forced) is ShardedRenderer and forced.n_dev == 1
    assert forced.plan(16) == Renderer(cornell, cfg, device="cpu").plan(16)
    simple = RenderConfig(width=32, height=24, engine="simple")
    with pytest.raises(ValueError, match="regen.*mega"):
        make_renderer(cornell, simple, "cpu", sharded=True)
    with pytest.raises(ValueError, match="streaming engines"):
        ShardedRenderer(cornell, simple, CPUS)
    # Several devices visible: None shards a scene the megakernel renders
    # (its bands run side by side), never the regen engine (a BVH scene, or
    # MIS: its bands occupy the host one after the other) nor "simple"; True
    # still shards the regen engine, and False forbids it.
    monkeypatch.setattr(rnd, "shard_devices", lambda device="cuda": [torch.device("cpu")] * 2)
    both = make_renderer(cornell, cfg, "cpu")
    assert type(both) is ShardedRenderer and both.n_dev == 2
    assert type(make_renderer(cornell, simple, "cpu")) is Renderer
    assert type(make_renderer(cornell, cfg, "cpu", sharded=False)) is Renderer
    mis = RenderConfig(width=32, height=24, use_mis=True)
    for scene, regen_cfg in ((unicorn, cfg), (cornell, mis), (cornell, RenderConfig(width=32, height=24, engine="regen"))):
        assert type(make_renderer(scene, regen_cfg, "cpu")) is Renderer
        asked = make_renderer(scene, regen_cfg, "cpu", sharded=True)
        assert type(asked) is ShardedRenderer and asked.engine == "regen" and asked.n_dev == 2


def test_server_sharded_argument(cornell, monkeypatch):
    with pytest.raises(ValueError, match="sharded serving"):
        Server({"cornell_box": cornell}, cfg=RenderConfig(engine="simple"), device="cpu", sharded=True)
    srv = Server({"cornell_box": cornell}, device="cpu", sharded=True)
    assert type(srv.renderer_for("cornell_box", 32, 24)) is ShardedRenderer
    srv = Server({"cornell_box": cornell}, device="cpu", sharded=False)
    assert type(srv.renderer_for("cornell_box", 32, 24)) is Renderer
    assert type(Server({"cornell_box": cornell}, device="cpu").renderer_for("cornell_box", 32, 24)) is Renderer


def test_render_cli_no_shard_flag(tmp_path, monkeypatch):
    from raytracer_tpu_torch.tools.render import main

    made = []
    real = rnd.make_renderer
    monkeypatch.setattr(rnd, "make_renderer", lambda *a, **kw: made.append(kw) or real(*a, **kw))
    args = [os.path.join(SCENES, "cornell_box.toml"), "--spp", "4", "--width", "16", "--height", "12",
            "--device", "cpu", "--out", str(tmp_path / "a.png")]
    assert main(args) == 0 and main(args + ["--no-shard"]) == 0
    assert [kw["sharded"] for kw in made] == [None, False]


def test_dryrun_multichip_on_cpu_devices():
    import __graft_entry_torch__ as entry

    entry.dryrun_multichip(4, device="cpu")
