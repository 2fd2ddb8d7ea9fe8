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
