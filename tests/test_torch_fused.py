"""The fused-trace engine (``render/wavefront_fused.py``, engine "fused") on
the CPU, against the port's regen engine and the JAX package's fused one.

- Path for path: a fused band equals the regen band with the same seed, on
  every slot's sums and on the ray count, on cornell_box (spheres and
  planes), crewmate_phong (the BVH with its sphere-light cull and the Phong
  draw 7) and the cube-light box (the mesh-light draw 8), at small sizes;
  and through ``Renderer.render_image``, the server's ``RenderJob``, the
  checkpointed render and ``tools/render.py --engine fused``.
- Against JAX: the light pixel of a 608-wide band at row 340 sums exactly
  50 x 8 in both (``tests/test_wavefront.py:98-112``); the 72x54 64 spp
  image mean within 1.5 of JAX's ``Renderer(engine="fused")`` and its MAD
  under 1.15 x JAX's own seed-0/seed-1 MAD + 0.5
  (``tests/test_wavefront.py:86-96``); the offline, delivery and
  progressive plans equal JAX's.
- fused with MIS resolves to regen, and ``sharded=True`` raises, as in JAX.
"""

import asyncio
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.config import RenderConfig as JaxRenderConfig
from raytracer_tpu.models.loader import load_scene as jax_load_scene
from raytracer_tpu.ops.intersect import scene_precompute as jax_scene_precompute
from raytracer_tpu.render.renderer import Renderer as JaxRenderer
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.loader import load_scene, load_scene_dict
from raytracer_tpu_torch.ops.intersect import scene_precompute
from raytracer_tpu_torch.render.renderer import Renderer, make_renderer
from raytracer_tpu_torch.render.wavefront import render_band_regen
from raytracer_tpu_torch.render.wavefront_fused import render_band_fused
from tests.test_materials_extra import CUBE_LIGHT, _box_scene
from tests.torch_cpu import jax_cfg, one_torch_thread  # noqa: F401  (autouse)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


def _scene(name: str):
    if name == "cube_light":
        return load_scene_dict(_box_scene([], CUBE_LIGHT), name="ml", device="cpu")
    return load_scene(os.path.join(SCENES, f"{name}.toml"), device="cpu")


@pytest.fixture(scope="module")
def cornell():
    return _scene("cornell_box")


@pytest.mark.parametrize("name,width,rows,samples", [
    ("cornell_box", 40, 6, 4), ("crewmate_phong", 32, 6, 2), ("cube_light", 32, 6, 4),
])
def test_fused_band_equals_regen_band(name, width, rows, samples):
    scene = _scene(name)
    cfg = RenderConfig(width=width, height=4 * rows)
    pre = scene_precompute(scene)
    want, want_rays = render_band_regen(scene, pre, cfg, rows, rows, samples, 11)
    got, got_rays = render_band_fused(scene, pre, cfg, rows, rows, samples, 11)
    assert int(got_rays) == int(want_rays) > rows * width * 4 * samples
    assert torch.equal(got, want) and got.abs().sum() > 0


def test_fused_frame_equals_regen_frame_and_mis_resolves_to_regen(cornell):
    base = dict(width=30, height=24, rays_per_pass=1 << 10)
    fused = Renderer(cornell, RenderConfig(engine="fused", **base), device="cpu")
    regen = Renderer(cornell, RenderConfig(engine="regen", **base), device="cpu")
    assert fused.engine == "fused" and len(list(fused.iter_bands(8))) > 1
    np.testing.assert_array_equal(fused.render_image(8), regen.render_image(8))
    assert fused.rays_traced() == regen.rays_traced()
    # MIS is the regen engine's: fused + MIS renders the regen MIS frame.
    mis = Renderer(cornell, RenderConfig(engine="fused", use_mis=True, **base), device="cpu")
    assert mis.engine == "regen"
    img = mis.render_image(8)
    np.testing.assert_array_equal(img, Renderer(cornell, RenderConfig(use_mis=True, **base), device="cpu")
                                  .render_image(8))
    assert img.mean() > 5
    with pytest.raises(ValueError, match="NEE path only"):
        render_band_fused(cornell, mis.pre, mis.cfg, 0, 1, 1, 0)


def test_sharded_fused_raises(cornell):
    with pytest.raises(ValueError, match="'regen' or 'mega'"):
        make_renderer(cornell, RenderConfig(engine="fused"), device="cpu", sharded=True)
    assert type(make_renderer(cornell, RenderConfig(engine="fused"), device="cpu")) is Renderer


def test_light_pixel_sums_exactly_like_jax(cornell):
    """Pixel 300 of row 340 of a 608x456 frame looks straight at the light:
    every path collects 50 at its first vertex, so each subpixel sums 50 x 8."""
    import jax

    from raytracer_tpu.render.wavefront_fused import render_band_fused as jax_band_fused

    cfg = RenderConfig(width=608, height=456, rays_per_pass=1 << 12)
    sums, rays = render_band_fused(cornell, scene_precompute(cornell), cfg, 340, 1, 8, 2)
    np.testing.assert_allclose(sums[0, 300].numpy(), 50.0 * 8, rtol=1e-4)
    ref = jax_load_scene(os.path.join(SCENES, "cornell_box.toml"))
    want, want_rays = jax_band_fused(ref, jax_scene_precompute(ref), jax_cfg(cfg), jnp.int32(340), 1, 8,
                                     jax.random.key(2))
    np.testing.assert_allclose(np.asarray(want)[0, 300], 50.0 * 8, rtol=1e-4)
    # The same estimator on other random streams: the band's ray counts agree.
    assert abs(int(rays) - int(want_rays)) < 0.05 * int(want_rays)


def test_image_matches_jax_fused_engine(cornell):
    base = dict(width=72, height=54, rays_per_pass=1 << 14)
    ref = jax_load_scene(os.path.join(SCENES, "cornell_box.toml"))
    a = JaxRenderer(ref, JaxRenderConfig(engine="fused", seed=0, **base)).render_image(64).astype(np.float64)
    a2 = JaxRenderer(ref, JaxRenderConfig(engine="fused", seed=1, **base)).render_image(64).astype(np.float64)
    b = Renderer(cornell, RenderConfig(engine="fused", seed=0, **base), device="cpu").render_image(64)
    b = b.astype(np.float64)
    floor = np.abs(a - a2).mean()
    assert abs(a.mean() - b.mean()) < 1.5
    assert np.abs(a - b).mean() < 1.15 * floor + 0.5


@pytest.mark.parametrize("cfg", [
    RenderConfig(engine="fused"),
    RenderConfig(engine="fused", width=32, height=24, rays_per_pass=1 << 12, mesh_rays_per_pass=1 << 13),
    RenderConfig(engine="fused", width=1920, height=1080),
], ids=["600x450", "32x24", "1920x1080"])
@pytest.mark.parametrize("name", ["cornell_box", "crewmate_phong"])
def test_plans_equal_jax(name, cfg):
    path = os.path.join(SCENES, f"{name}.toml")
    port = Renderer(load_scene(path, device="cpu"), cfg, device="cpu")
    ref = JaxRenderer(jax_load_scene(path), jax_cfg(cfg))
    assert port.engine == "fused"
    for spp in (4, 16, 64, 256):
        assert port.plan(spp) == ref.plan(spp)
        assert port.plan_delivery(spp) == ref.plan_delivery(spp)
        assert port.plan_progressive(spp) == ref.plan_progressive(spp)


def test_fused_serves_checkpoints_and_renders_from_the_cli(cornell, tmp_path):
    from raytracer_tpu_torch.render.checkpoint import render_with_checkpoint
    from raytracer_tpu_torch.server import wire
    from raytracer_tpu_torch.server.app import RenderJob, Server
    from raytracer_tpu_torch.tools.render import main as render_main
    from raytracer_tpu_torch.utils.png import read_png

    srv = Server({"cornell_box": cornell}, cfg=RenderConfig(engine="fused"), width=60, height=12, device="cpu")
    r = srv.renderer_for("cornell_box", 60, 12)
    assert r.engine == "fused"
    served = np.zeros((12, 60, 3), np.uint8)

    async def send(raw):
        for _t, x, y, rgb in wire.parse_chunks(raw):
            served[y, x : x + rgb.shape[0]] = rgb

    job = RenderJob(send=send)
    job.mark_running()
    assert asyncio.run(job.run(r, 8, batch=True)) is False
    np.testing.assert_array_equal(served, r.render_image(8))

    sums = {}
    for engine in ("fused", "regen"):
        cfg = RenderConfig(engine=engine, width=30, height=12, rays_per_pass=1 << 11)
        sums[engine] = render_with_checkpoint(Renderer(cornell, cfg, device="cpu"), "cornell_box", 32).sums
    np.testing.assert_array_equal(sums["fused"], sums["regen"])

    out = str(tmp_path / "fused.png")
    assert render_main([os.path.join(SCENES, "cornell_box.toml"), "--spp", "4", "--width", "24", "--height",
                        "18", "--engine", "fused", "--device", "cpu", "--out", out]) == 0
    img = read_png(out)
    assert img.shape == (18, 24, 3) and img.mean() > 20
