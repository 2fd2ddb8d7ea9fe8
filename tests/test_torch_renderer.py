"""The port's slice as a whole: ``Renderer.render_image`` on the CPU (the
megakernel's twin) against the JAX ``Renderer`` at the same small size.

The JAX package renders with its streaming engine on the CPU backend (the
megakernel needs a TPU) and draws other random numbers, so the images agree
statistically: same shape and orientation, means within 3 levels at 16 spp.
"""

import os

import jax  # noqa: F401  (tests/conftest.py keeps jax on the CPU)
import numpy as np
import pytest

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu.models.loader import load_scene as jax_load_scene
from raytracer_tpu.render.renderer import Renderer as JaxRenderer
from raytracer_tpu_torch.models.loader import load_scene
from raytracer_tpu_torch.render.renderer import Renderer, select_band_engine
from tests.torch_cpu import jax_cfg, one_torch_thread  # noqa: F401  (autouse)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
W, H, SPP = 32, 24, 16


@pytest.mark.parametrize("name", ["cornell_box", "cubes"])
def test_render_image_matches_jax(name):
    path = os.path.join(SCENES, f"{name}.toml")
    cfg = RenderConfig(width=W, height=H)
    ref = JaxRenderer(jax_load_scene(path), jax_cfg(cfg)).render_image(SPP)
    r = Renderer(load_scene(path, device="cpu"), cfg, device="cpu")
    assert r.engine == "mega"
    img = r.render_image(SPP)
    assert img.shape == ref.shape == (H, W, 3) and img.dtype == np.uint8
    assert abs(img.mean() - ref.mean()) < 3.0
    # Orientation: row 0 is the top (the ceiling light); row profiles agree.
    rows_p, rows_j = img.mean(axis=(1, 2)), ref.mean(axis=(1, 2))
    assert np.corrcoef(rows_p, rows_j)[0, 1] > 0.8
    assert np.corrcoef(rows_p, rows_j[::-1])[0, 1] < np.corrcoef(rows_p, rows_j)[0, 1]
    assert r.rays_traced() > W * H * SPP
    again = Renderer(load_scene(path, device="cpu"), cfg, device="cpu").render_image(SPP)
    np.testing.assert_array_equal(again, img)


def test_one_launch_frame_equals_band_by_band():
    """``render_image`` renders a megakernel frame's bands in one launch; it
    equals the band-by-band composite of ``render_rows``, which the served
    path uses."""
    cfg = RenderConfig(width=16, height=12, rays_per_pass=16 * 4 * 3)
    r = Renderer(load_scene(os.path.join(SCENES, "cornell_box.toml"), device="cpu"), cfg, device="cpu")
    rows, _, _ = r.plan(8)
    assert rows == 3
    img = r.render_image(8)
    rays = r.rays_traced()
    assert len(r.ray_counts) == 1
    want = np.zeros_like(img)
    for y0, _ in r.iter_bands(8):
        rgb, _ = r.render_rows(y0, 8)
        want[cfg.height - y0 - rows : cfg.height - y0] = rgb[::-1]
    np.testing.assert_array_equal(img, want)
    assert r.rays_traced() == 2 * rays
    assert r.render_image(8, cancelled=lambda: True) is None


def test_spp_below_four_renders_black():
    r = Renderer(load_scene(os.path.join(SCENES, "cornell_box.toml"), device="cpu"),
                 RenderConfig(width=W, height=H), device="cpu")
    assert not r.render_image(2).any()


def test_engine_gate_raises_outside_the_slice():
    scene = load_scene(os.path.join(SCENES, "cornell_box.toml"), device="cpu")
    assert select_band_engine(scene, RenderConfig()) == "mega"
    assert select_band_engine(scene, RenderConfig(engine="regen")) == "regen"
    # MIS is the regen engine's, as in raytracer_tpu/render/renderer.py:134.
    assert select_band_engine(scene, RenderConfig(use_mis=True)) == "regen"
    # The lockstep and fused engines render when asked for; fused with MIS
    # resolves to regen (raytracer_tpu/render/renderer.py:143-144).
    assert select_band_engine(scene, RenderConfig(engine="simple")) == "simple"
    assert select_band_engine(scene, RenderConfig(engine="fused")) == "fused"
    assert select_band_engine(scene, RenderConfig(engine="fused", use_mis=True)) == "regen"
    r = Renderer(scene, RenderConfig(engine="fused", width=W, height=H), device="cpu")
    assert r.engine == "fused" and r.pre is not None
    img = r.render_image(4)
    assert img.shape == (H, W, 3) and img.mean() > 5 and r.rays_traced() > W * H * 4
    # A name that neither package defines is refused (JAX renders it as regen).
    with pytest.raises(NotImplementedError, match="not one of"):
        select_band_engine(scene, RenderConfig(engine="warp"))
    with pytest.raises(NotImplementedError, match="'mega', 'regen', 'fused', 'simple'"):
        Renderer(scene, RenderConfig(engine="warp"), device="cpu")


@pytest.fixture(scope="module")
def unicorns():
    path = os.path.join(SCENES, "flying_unicorn.toml")
    return jax_load_scene(path), load_scene(path, device="cpu")


@pytest.mark.parametrize("cfg", [
    RenderConfig(),
    RenderConfig(width=32, height=24, mesh_rays_per_pass=1 << 13),
    RenderConfig(width=1920, height=1080),
    RenderConfig(width=90, height=12),
], ids=["600x450", "32x24", "1080p", "90x12"])
def test_unicorn_plans_equal_jax(unicorns, cfg):
    ref, port = unicorns
    jr = JaxRenderer(ref, jax_cfg(cfg))
    r = Renderer(port, cfg, device="cpu")
    assert r.engine == "regen"
    for spp in (0, 2, 4, 16, 64, 100, 1024):
        assert r.plan(spp) == jr.plan(spp), spp
        assert r.plan_delivery(spp) == jr.plan_delivery(spp), spp
        assert r.plan_progressive(spp) == jr.plan_progressive(spp), spp
    if cfg == RenderConfig():
        # One band is the whole frame: 1,080,000 lanes, one sample a dispatch;
        # served, the frame streams in 5 bands of 90 rows.
        assert r.plan(16) == (450, 1, 4) and r.plan_delivery(16) == (90, 1, 4)


def test_cuda_is_the_default_and_never_falls_back(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        load_scene(os.path.join(SCENES, "cornell_box.toml"))
    scene = load_scene(os.path.join(SCENES, "cornell_box.toml"), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        Renderer(scene, RenderConfig(width=W, height=H))
