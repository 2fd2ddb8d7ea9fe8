"""The port's bounce megakernel against the JAX Pallas kernel.

On the CPU the port runs the kernel's plain PyTorch twin, and the JAX
package runs ``_mega_kernel`` in Pallas interpret mode, which draws its
random numbers from the same counter hash. So the two are compared lane by
lane, on the packed scene table, the launch scalars and the band sums.

Lane tolerance against JAX: XLA's CPU backend contracts a*b+c into FMAs and
computes rsqrt, sqrt, sin and cos with its own approximations (measured on
random f32 inputs: 25%, 36%, 0.7% and 5% of results differ in the last bits
from torch's), and the sphere discriminant's cancellation amplifies such
last-bit differences. So most lanes agree to ~1e-4 and a lane whose path
branches differently (a silhouette or a shadow edge) differs by O(0.1). The
stated bounds: |port - jax| <= 1e-2 * max(1, |jax|) and equal per-lane ray
counts on >= 99% of lanes, band means within 1e-3 relative.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu.ops.pallas.megakernel as jax_mk
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu.models.loader import load_scene as jax_load_scene
from raytracer_tpu.ops.intersect import scene_precompute
from raytracer_tpu_torch.models.loader import load_scene
from raytracer_tpu_torch.ops import megakernel as mk
from tests.torch_cpu import jax_cfg, one_torch_thread  # noqa: F401  (autouse)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
LANE_RTOL_VS_JAX = 1e-2
LANE_SHARE = 0.99
MEAN_RTOL_VS_JAX = 1e-3

# (scene, width, height, y0, rows, samples): interpret mode is slow (cubes'
# 24 unrolled triangles take ~30 s to trace), so the bands are tiny.
CASES = {
    "cornell_box": ("cornell_box", 32, 24, 10, 2, 8),
    "cubes": ("cubes", 16, 12, 5, 1, 4),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def band(request):
    """One JAX interpret-mode band with its ``_mega_raw`` call captured, and
    the same band through the port's twin at the captured seed."""
    name, w, h, y0, rows, ns = CASES[request.param]
    cfg = RenderConfig(width=w, height=h)
    path = os.path.join(SCENES, f"{name}.toml")
    js = jax_load_scene(path)
    real = jax_mk._mega_raw
    captured = {}

    def spy(pf, pi, **static):
        out = real(pf, pi, **static)
        captured.update(pf=np.asarray(pf), pi=np.asarray(pi), static=static,
                        lane_rays=np.asarray(out[3]).reshape(-1))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mk, "_mega_raw", spy)
        sums_j, rays_j = jax_mk.render_band_mega(
            js, scene_precompute(js), jax_cfg(cfg), jnp.int32(y0), rows, jnp.int32(ns),
            jax.random.key(11), interpret=True,
        )
    scene = load_scene(path, device="cpu")
    seed = int(captured["pi"][3])
    pf, static = mk.pack_params(scene, cfg)
    n = rows * w * 4
    acc_t, lane_rays_t = mk.mega_twin(pf, static, y0, ns, n, seed, "cpu")
    sums_t, rays_t = mk.render_band_mega(scene, cfg, y0, rows, ns, seed)
    return dict(
        name=name, cfg=cfg, y0=y0, rows=rows, ns=ns, n=n, scene=scene,
        jax=(np.asarray(sums_j), int(rays_j)), port=(sums_t.numpy(), int(rays_t)),
        lane_rays=(captured["lane_rays"][:n], lane_rays_t.numpy()),
        acc_twin=acc_t.numpy(), captured=captured, pf=pf.numpy(), static=static,
    )


def test_hash3_and_uniform_bit_equal_jax():
    rng = np.random.default_rng(7)
    a, b, c = (rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32) for _ in range(3))
    want = np.asarray(jax_mk._hash3(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    got = mk.hash3(*(torch.from_numpy(x.astype(np.int64)) for x in (a, b, c)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    seed, it = np.uint32(0x9E3779B9), np.uint32(17)
    for draw in range(7):
        want = np.asarray(jax_mk._uniform(jnp.uint32(seed), jnp.asarray(a), jnp.uint32(it), draw))
        got = mk.uniform(int(seed), torch.from_numpy(a.astype(np.int64)), int(it), draw)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_band_seed_is_a_deterministic_i32():
    seeds = {mk.band_seed(0, y0, salt) for y0 in range(0, 450, 50) for salt in range(8)}
    assert len(seeds) == 72
    assert all(-(2**31) <= s < 2**31 for s in seeds)
    assert mk.band_seed(3, 50, 1) == mk.band_seed(3, 50, 1) != mk.band_seed(4, 50, 1)


def test_packing_equals_jax(band):
    cap, static = band["captured"], band["static"]
    want = cap["pf"]
    assert band["pf"].shape == want.shape
    ns, npl, nt, no = static.n_spheres, static.n_planes, static.n_tris, static.n_objects
    tri = slice(20 + 5 * ns + 7 * npl, 20 + 5 * ns + 7 * npl + 13 * nt)
    rest = np.ones(want.shape, bool)
    rest[tri] = False
    np.testing.assert_array_equal(band["pf"][rest], want[rest])
    np.testing.assert_allclose(band["pf"][tri], want[tri], rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(
        cap["pi"], np.asarray([band["y0"], band["ns"], band["n"], cap["pi"][3]], np.int32)
    )
    js = cap["static"]
    assert (js["n_spheres"], js["n_planes"], js["n_tris"], js["n_objects"]) == (ns, npl, nt, no)
    assert (js["width"], js["height"]) == (static.width, static.height)
    assert js["cfg_tuple"] == static.cfg_tuple
    assert js["hw_rng"] is False


def test_lanes_match_jax_interpret(band):
    (sj, rj), (sp, rp) = band["jax"], band["port"]
    cfg, rows = band["cfg"], band["rows"]
    assert sp.shape == sj.shape == (rows, cfg.width, 4, 3)
    np.testing.assert_array_equal(sp.reshape(-1, 3), band["acc_twin"])
    d = np.abs(sp - sj).reshape(-1, 3).max(axis=1)
    tol = LANE_RTOL_VS_JAX * np.maximum(1.0, np.abs(sj).reshape(-1, 3).max(axis=1))
    assert (d <= tol).mean() >= LANE_SHARE, (d.max(), (d > tol).mean())
    lr_j, lr_t = band["lane_rays"]
    assert (lr_j == lr_t).mean() >= LANE_SHARE
    assert abs(sp.mean() - sj.mean()) <= MEAN_RTOL_VS_JAX * abs(sj.mean())
    assert rp == int(lr_t.sum()) and abs(rp - rj) <= 1e-3 * rj


def test_cpu_band_launches_no_kernel(band):
    before = mk.LAUNCHES
    mk.render_band_mega(band["scene"], band["cfg"], 0, 1, 2, 1)
    assert mk.LAUNCHES == before
    pf, static = mk.pack_params(band["scene"], band["cfg"])
    with pytest.raises(ValueError):
        mk.mega_cuda(pf, static, 0, 2, 8, 1, device="cpu")


def test_gating_equals_jax():
    cfg = RenderConfig()
    for name in ("cornell_box", "cubes"):
        path = os.path.join(SCENES, f"{name}.toml")
        scene, ref = load_scene(path, device="cpu"), jax_load_scene(path)
        for c in (cfg, RenderConfig(use_mis=True)):
            assert mk.supports_megakernel(scene, c) == jax_mk.supports_megakernel(ref, jax_cfg(c))
    assert mk.MEGA_MAX_TRIS == jax_mk.MEGA_MAX_TRIS


def test_all_bands_in_one_launch_equal_band_by_band(band):
    """The frame form (several bands, each lane keeping its band's slot and
    seed) gives every band's lanes exactly as the one-band form does."""
    scene, cfg, rows, ns = band["scene"], band["cfg"], band["rows"], band["ns"]
    y0s = [0, rows, 3 * rows]
    seeds = [mk.band_seed(5, y0, 0) for y0 in y0s]
    sums, rays = mk.render_bands_mega(scene, cfg, y0s, rows, ns, seeds)
    assert sums.shape == (3, rows, cfg.width, 4, 3)
    total = 0
    for b, (y0, seed) in enumerate(zip(y0s, seeds)):
        one, r = mk.render_band_mega(scene, cfg, y0, rows, ns, seed)
        assert torch.equal(sums[b], one)
        total += int(r)
    assert int(rays) == total


def test_twin_counts_its_rays(band):
    pf, static = mk.pack_params(band["scene"], band["cfg"])
    counts = {}
    acc, lane_rays = mk.mega_twin(pf, static, band["y0"], band["ns"], band["n"], 11, "cpu", counts=counts)
    again, _ = mk.mega_twin(pf, static, band["y0"], band["ns"], band["n"], 11, "cpu")
    assert torch.equal(acc, again)
    assert counts["samples"] == band["n"] * band["ns"]
    assert counts["bounces"] + counts["shadow"] == int(lane_rays.sum())
    assert counts["bounces"] >= counts["samples"] and counts["shadow"] > 0
