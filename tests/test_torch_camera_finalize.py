"""Camera rays, finalize and the band plans of the port against the JAX
package, on inputs made with numpy from a seed."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.models.camera import camera_rays3 as jax_camera_rays3
from raytracer_tpu.models.loader import load_scene as jax_load_scene
from raytracer_tpu.render.renderer import Renderer as JaxRenderer
from raytracer_tpu.render.renderer import finalize as np_finalize
from raytracer_tpu.render.renderer import finalize_device_dyn as jax_finalize_dyn
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.camera import camera_rays3
from raytracer_tpu_torch.models.loader import load_scene
from raytracer_tpu_torch.render.renderer import Renderer, finalize, finalize_device, finalize_device_dyn
from tests.torch_cpu import jax_cfg

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
CORNELL = os.path.join(SCENES, "cornell_box.toml")


@pytest.fixture(scope="module")
def scenes():
    return jax_load_scene(CORNELL), load_scene(CORNELL, device="cpu")


def test_camera_rays3_matches_jax(scenes):
    ref, port = scenes
    rng = np.random.default_rng(3)
    n, w, h = 4096, 600, 450
    px = rng.integers(0, w, n).astype(np.float32)
    py = rng.integers(0, h, n).astype(np.float32)
    sx = rng.integers(0, 2, n).astype(np.float32)
    sy = rng.integers(0, 2, n).astype(np.float32)
    u1, u2 = rng.random((2, n), dtype=np.float32)
    args = (px, py, sx, sy, u1, u2)
    ro_j, rd_j = jax_camera_rays3(ref, w, h, 0.5135, *map(jnp.asarray, args))
    ro_t, rd_t = camera_rays3(port, w, h, 0.5135, *map(torch.from_numpy, args))
    for a, b in zip(ro_t + rd_t, ro_j + rd_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("num_samples", [1, 3, 16, 64])
def test_finalize_bit_equal_numpy(num_samples):
    rng = np.random.default_rng(num_samples)
    # Sums spread over [0, 2*num_samples): clamps at both ends are exercised.
    sums = (rng.random((50, 60, 4, 3), dtype=np.float32) * 2.0 * num_samples).astype(np.float32)
    want = np_finalize(sums, num_samples)
    np.testing.assert_array_equal(finalize(sums, num_samples), want)
    t = torch.from_numpy(sums)
    np.testing.assert_array_equal(finalize_device(t, num_samples).numpy(), want)
    np.testing.assert_array_equal(finalize_device_dyn(t, torch.tensor(num_samples)).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jax_finalize_dyn(jnp.asarray(sums), jnp.int32(num_samples))), want
    )


@pytest.mark.parametrize("size", [(600, 450), (1920, 1080)])
def test_plans_equal_jax(scenes, size):
    ref, port = scenes
    cfg = RenderConfig(width=size[0], height=size[1])
    jr, tr = JaxRenderer(ref, jax_cfg(cfg)), Renderer(port, cfg, device="cpu")
    for spp in (0, 2, 4, 16, 64, 256, 1024):
        assert tr.plan(spp) == jr.plan(spp), spp
        assert tr.plan_delivery(spp) == jr.plan_delivery(spp), spp
        assert tr.plan_progressive(spp) == jr.plan_progressive(spp), spp
        assert list(tr.iter_bands(spp)) == list(jr.iter_bands(spp)), spp
        assert tr.samples_rendered(spp) == jr.samples_rendered(spp), spp
