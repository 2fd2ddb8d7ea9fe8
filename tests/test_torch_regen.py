"""The port's regen engine on the CPU (K2 and K3 through their twins).

- determinism: the same seed gives the same sums;
- the lane order does not matter: the draws are keyed on the frame slot,
  so the per-iteration state permutation (``RT_PERMUTE_STATE=1`` or
  ``permute=True``; the default keeps the lanes in slot order) and the tail
  compaction leave every slot's sum unchanged (exactly equal on >= 99.9% of
  slots: torch's vectorised CPU loops may round the last lanes of a tensor
  differently from the others, which can flip a branch on a rare slot), and
  so does cutting the frame into other bands;
- the counter ``regen.rows_gathered`` counts the compactions' widths, and
  under the permutation each step's width too; ``RT_DEFER_SHADOW=1`` turns
  the permutation on and defers;
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
from torch.profiler import ProfilerActivity, profile

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.loader import load_scene
from raytracer_tpu_torch.ops import bvh_traverse, keys
from raytracer_tpu_torch.ops.intersect import scene_precompute
from raytracer_tpu_torch.render import wavefront
from raytracer_tpu_torch.render.renderer import Renderer
from raytracer_tpu_torch.render.wavefront import render_band_regen, tail_widths
from raytracer_tpu_torch.utils.timing import counters, reset_counters
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


@pytest.mark.parametrize("tail_compact", [False, True])
@pytest.mark.parametrize("how", ["argument", "hook"])
def test_permutation_leaves_slot_sums_unchanged(unicorn, monkeypatch, how, tail_compact):
    """The default (the lanes in slot order) against the permuted step, asked
    for by ``permute=True`` or by ``RT_PERMUTE_STATE=1``."""
    cfg = RenderConfig(width=24, height=16, tail_compact=tail_compact)
    keys.LAUNCHES = 0
    off, rays_off = _band(unicorn, cfg, 0, 16, 2, 99)
    plain, rays_plain = _band(unicorn, cfg, 0, 16, 2, 99, permute=False)
    assert torch.equal(plain, off) and int(rays_plain) == int(rays_off)
    if how == "hook":
        monkeypatch.setenv("RT_PERMUTE_STATE", "1")
        on, rays_on = _band(unicorn, cfg, 0, 16, 2, 99)
    else:
        on, rays_on = _band(unicorn, cfg, 0, 16, 2, 99, permute=True)
    assert _exact_share(on, off) >= EXACT_SHARE
    assert int(rays_on) == int(rays_off)
    assert keys.LAUNCHES == 0 and bvh_traverse.LAUNCHES == 0  # CPU: twins only


def _counted_band(pair, cfg, **kw):
    """A band of one sample under a profiler -> (sums, the program's counters)."""
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        sums, _ = _band(pair, cfg, 0, cfg.height, 1, 7, **kw)
    got = counters()
    reset_counters()
    return sums, got


def _compacted_widths(n, cfg):
    """The widths the tail compactions compact: the band's, then each stage's but the last."""
    return sum(([n] + tail_widths(n, cfg, True))[:-1])


def test_rows_gathered_counts_the_compactions_and_the_permutation(unicorn, monkeypatch):
    cfg = RenderConfig(width=32, height=24)
    n = 32 * 24 * 4
    _, default = _counted_band(unicorn, cfg)
    assert default["regen.rows_gathered"] == _compacted_widths(n, cfg) == n + 2048
    monkeypatch.setenv("RT_PERMUTE_STATE", "1")
    _, permuted = _counted_band(unicorn, cfg)
    assert permuted["regen.lanes_stepped"] == default["regen.lanes_stepped"] > 0
    assert permuted["regen.rows_gathered"] == _compacted_widths(n, cfg) + permuted["regen.lanes_stepped"]
    # Without the tail compaction nothing is gathered by default.
    _, none = _counted_band(unicorn, dataclasses.replace(cfg, tail_compact=False), permute=False)
    assert "regen.rows_gathered" not in none and none["regen.steps"] > 0


@pytest.mark.parametrize("permute_env", [None, "0"])
def test_deferred_shadow_defers_under_the_default(unicorn, monkeypatch, permute_env):
    """``RT_DEFER_SHADOW=1`` turns the permutation on for its band: every
    shadow query resolves presorted, one trace a step beside the main trace,
    and each step gathers the state; ``permute=False`` keeps it from
    deferring."""
    cfg = RenderConfig(width=32, height=24)
    n = 32 * 24 * 4
    calls = []
    real = wavefront.trace_t

    def trace_t(*a, **kw):
        calls.append(kw.get("presorted", False))
        return real(*a, **kw)

    monkeypatch.setattr(wavefront, "trace_t", trace_t)
    base, _ = _counted_band(unicorn, cfg)
    assert calls and not any(calls)  # the default's shadow rays sort themselves
    monkeypatch.setenv("RT_DEFER_SHADOW", "1")
    if permute_env is not None:
        monkeypatch.setenv("RT_PERMUTE_STATE", permute_env)
    calls.clear()
    sums, got = _counted_band(unicorn, cfg)
    assert calls and all(calls) and len(calls) == got["regen.steps"]
    assert got["regen.rows_gathered"] == _compacted_widths(n, cfg) + got["regen.lanes_stepped"]
    assert _exact_share(sums, base) >= 0.99  # the same terms, banked a step later
    calls.clear()
    plain, got = _counted_band(unicorn, cfg, permute=False)
    assert calls and not any(calls) and got["regen.rows_gathered"] == _compacted_widths(n, cfg)
    assert torch.equal(plain, base)


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

