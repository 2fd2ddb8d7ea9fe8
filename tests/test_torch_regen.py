"""The port's regen engine on the CPU (K2 and K3 through their twins).

- determinism: the same seed gives the same sums;
- the lane order does not matter: the draws are keyed on the frame slot,
  so the per-iteration state permutation and the tail compaction leave
  every slot's sum unchanged (exactly equal on >= 99.9% of slots: torch's
  vectorised CPU loops may round the last lanes of a tensor differently
  from the others, which can flip a branch on a rare slot), and so does
  cutting the frame into other bands;
- cornell_box through regen agrees statistically with the megakernel's
  twin at equal spp;
- flying_unicorn at 32x24, 64 spp, against the independent C++ tracer
  (native/cpu_tracer.cpp): 8x8 tile means within 4.5 u8, calibrated as in
  tests/test_golden_unicorn.py:64-110, against the mean of four native
  renders (seeds 11-14) so that the native side's own noise is halved.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.loader import load_scene
from raytracer_tpu_torch.ops import bvh_traverse, keys
from raytracer_tpu_torch.ops.intersect import scene_precompute
from raytracer_tpu_torch.render.renderer import Renderer
from raytracer_tpu_torch.render.wavefront import render_band_regen, tail_widths
from tests.torch_cpu import one_torch_thread  # noqa: F401  (autouse)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
EXACT_SHARE = 0.999


@pytest.fixture(scope="module")
def unicorn():
    scene = load_scene(os.path.join(SCENES, "flying_unicorn.toml"), device="cpu")
    return scene, scene_precompute(scene)


def _band(pair, cfg, y0, rows, ns, seed, **kw):
    scene, pre = pair
    return render_band_regen(scene, pre, cfg, y0, rows, ns, seed, **kw)


def _exact_share(a, b):
    return (a == b).reshape(-1, 3).all(dim=1).double().mean().item()


def test_same_seed_same_sums(unicorn):
    cfg = RenderConfig(width=16, height=12)
    s1, r1 = _band(unicorn, cfg, 0, 12, 2, 1234)
    s2, r2 = _band(unicorn, cfg, 0, 12, 2, 1234)
    assert torch.equal(s1, s2) and int(r1) == int(r2)
    s3, _ = _band(unicorn, cfg, 0, 12, 2, 1235)
    assert not torch.equal(s1, s3)
    assert s1.shape == (12, 16, 4, 3) and torch.isfinite(s1).all() and s1.mean() > 0.05


def test_permutation_leaves_slot_sums_unchanged(unicorn):
    cfg = RenderConfig(width=24, height=16, tail_compact=False)
    keys.LAUNCHES = 0
    on, rays_on = _band(unicorn, cfg, 0, 16, 2, 99)
    off, rays_off = _band(unicorn, cfg, 0, 16, 2, 99, permute=False)
    assert _exact_share(on, off) >= EXACT_SHARE
    assert int(rays_on) == int(rays_off)
    assert keys.LAUNCHES == 0 and bvh_traverse.LAUNCHES == 0  # CPU: twins only


def test_tail_compaction_leaves_slot_sums_unchanged(unicorn):
    cfg = RenderConfig(width=32, height=24)
    assert tail_widths(32 * 24 * 4, cfg, True) == [2048, 1024]
    on, rays_on = _band(unicorn, cfg, 0, 24, 1, 7)
    off, rays_off = _band(unicorn, dataclasses.replace(cfg, tail_compact=False), 0, 24, 1, 7)
    assert _exact_share(on, off) >= EXACT_SHARE
    assert int(rays_on) == int(rays_off)


def test_bands_do_not_change_pixels(unicorn):
    """A pixel draws the same numbers whatever band holds it."""
    cfg = RenderConfig(width=16, height=12)
    whole, _ = _band(unicorn, cfg, 0, 12, 1, 5)
    top, _ = _band(unicorn, cfg, 6, 6, 1, 5)
    assert _exact_share(whole[6:], top) >= EXACT_SHARE


def test_tail_widths_follow_jax():
    cfg = RenderConfig()
    assert tail_widths(1_080_000, cfg, True) == [540672, 270336, 135168]
    assert tail_widths(1_080_000, cfg, False) == []
    assert tail_widths(1_080_000, dataclasses.replace(cfg, tail_compact=False), True) == []
    assert tail_widths(1500, cfg, True) == [1024]
    assert tail_widths(1000, cfg, True) == []


def test_cornell_regen_agrees_with_the_mega_twin():
    path = os.path.join(SCENES, "cornell_box.toml")
    scene = load_scene(path, device="cpu")
    w, h, spp = 32, 24, 64
    mega = Renderer(scene, RenderConfig(width=w, height=h), device="cpu")
    regen = Renderer(scene, RenderConfig(width=w, height=h, engine="regen"), device="cpu")
    assert (mega.engine, regen.engine) == ("mega", "regen")
    a, b = mega.render_image(spp).astype(np.float64), regen.render_image(spp).astype(np.float64)
    # Two independent 64 spp renders: image and channel means within MC
    # noise (~0.5 u8 here), and the rows' profile (light at the top) alike.
    assert abs(a.mean() - b.mean()) < 1.5
    np.testing.assert_allclose(a.mean(axis=(0, 1)), b.mean(axis=(0, 1)), atol=2.0)
    assert np.corrcoef(a.mean(axis=(1, 2)), b.mean(axis=(1, 2)))[0, 1] > 0.95
    # Rays per sample agree within 2%: same estimator, same ray accounting.
    ra, rb = mega.rays_traced(), regen.rays_traced()
    assert abs(ra / rb - 1.0) < 0.02


def test_unicorn_matches_native_tracer(unicorn):
    from raytracer_tpu.utils import native

    lib = native._lib()
    if lib is None or not hasattr(lib, "rt_cpu_render_band"):
        pytest.skip("native cpu tracer not built")

    w, h, spp, tile = 32, 24, 64, 8

    def tiles(img):
        return img.astype(np.float64).reshape(h // tile, tile, w // tile, tile, 3).mean(axis=(1, 3, 4))

    scene, _ = unicorn
    cpp, cpp_rays = [], 0
    for seed in (11, 12, 13, 14):
        rgb01, rays = native.cpu_render_band(scene, w, h, 0, h, spp, seed=seed)
        v = np.clip(rgb01, 0.0, 1.0) ** (1.0 / 2.2) * 255.0 + 0.5
        cpp.append(tiles(np.clip(np.floor(v), 0, 255)[::-1]))
        cpp_rays += rays
    r = Renderer(scene, RenderConfig(width=w, height=h, mesh_rays_per_pass=1 << 13, seed=0), device="cpu")
    assert r.engine == "regen" and r.plan(spp) == (24, 1, 16)
    img = r.render_image(spp)
    diff = np.abs(tiles(img) - np.mean(cpp, axis=0))
    assert diff.max() < 4.5, f"tile means drifted: max {diff.max():.2f}\n{np.round(diff, 1)}"
    # Same ray accounting as the reference-style native tracer.
    assert abs(r.rays_traced() / (cpp_rays / 4) - 1.0) < 0.03

