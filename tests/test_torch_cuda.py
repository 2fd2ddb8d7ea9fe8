"""Tests of the port that need an NVIDIA GPU; they skip without one.

This file imports no jax, so it also runs on a machine that has only
PyTorch: ``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``
(``tests/conftest.py`` imports jax).
"""

import os

import pytest
import torch

from raytracer_tpu.config import RenderConfig
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
