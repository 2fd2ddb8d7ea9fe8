"""The coherence key's plain PyTorch twin (K3) against the JAX package's
``_coherence_key`` (its XLA form on the CPU), bit for bit, on ~50k
flying_unicorn rays: camera rays, random rays (some axis-aligned, to hit
the 1e-12 guard) and parked rays, with the loader's 32 cut boxes, with
cuts of 1 and 64 boxes and with ``RT_MAX_CUT=256`` (the CUDA kernel takes
32 with its cut count at compile time, any other count up to 64 at run time
from its by-value table, and up to 8191 from a device table; the twin is
one loop). Plus the permutation built on it."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu_torch.config import Epsilons, RenderConfig
from raytracer_tpu.models.loader import load_scene as jax_load_scene
from raytracer_tpu.ops.bvh import _coherence_key
from raytracer_tpu_torch.models.camera import camera_rays3
from raytracer_tpu_torch.models.loader import load_scene
from raytracer_tpu_torch.ops import keys
from raytracer_tpu_torch.ops.bvh import treetop_cut
from tests.torch_cpu import jax_eps, one_torch_thread  # noqa: F401  (autouse)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
EPS = Epsilons()


@pytest.fixture(scope="module")
def scenes():
    path = os.path.join(SCENES, "flying_unicorn.toml")
    return jax_load_scene(path), load_scene(path, device="cpu")


def _camera_rays(scene, n, rng):
    cfg = RenderConfig()
    pix = rng.integers(0, cfg.width * cfg.height, n)
    sub = rng.integers(0, 4, n)
    f = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    ro, rd = camera_rays3(
        scene, cfg.width, cfg.height, cfg.fov_scale,
        f(pix % cfg.width), f(pix // cfg.width), f(sub % 2), f(sub // 2),
        f(rng.random(n)), f(rng.random(n)),
    )
    return torch.stack(ro, 1).numpy().copy(), torch.stack(rd, 1).numpy()


def _rays(scene, rng):
    lo, hi = scene.bvh_lo[0].numpy(), scene.bvh_hi[0].numpy()
    cro, crd = _camera_rays(scene, 20000, rng)
    ro = rng.uniform(lo - 10, hi + 10, (25000, 3))
    d = rng.normal(size=(25000, 3))
    d[:300] = np.eye(3)[np.arange(300) % 3] * np.sign(rng.normal(size=(300, 1)))
    d[300:600, rng.integers(0, 3)] = 0.0
    rd = d / np.linalg.norm(d, axis=1, keepdims=True)
    park_ro = np.full((5000, 3), 3.0e7)
    park_rd = np.tile([1.0, 0.0, 0.0], (5000, 1))
    ro = np.concatenate([cro, ro, park_ro]).astype(np.float32)
    rd = np.concatenate([crd, rd, park_rd]).astype(np.float32)
    return ro, rd


def test_key_twin_is_bit_equal_to_jax(scenes):
    ref, port = scenes
    ro, rd = _rays(port, np.random.default_rng(3))
    want = np.asarray(_coherence_key(ref, jnp.asarray(ro), jnp.asarray(rd), jax_eps(EPS)))
    got = keys.coherence_key_twin(port, torch.from_numpy(ro), torch.from_numpy(rd), EPS)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # The fields are all exercised: parked rays miss, camera rays that see
    # the unicorn enter the cut, the rest spread over it, every octant occurs.
    k = got.numpy()
    assert (k[-5000:] >> 30 == 1).all() and (k[:20000] >> 30 == 0).sum() > 1000
    assert len(np.unique((k >> 17) & 0x1FFF)) > 16
    assert len(np.unique((k >> 13) & 7)) == 8


@pytest.mark.parametrize("n_cut", [1, 32, 64])
def test_key_twin_is_bit_equal_to_jax_for_each_cut_count(scenes, n_cut):
    """The same treetop cut of ``n_cut`` boxes handed to both packages (1:
    the root alone; 32: the loader's; 64: the most the kernel's table holds)."""
    ref, port = scenes
    tree = [getattr(port, k).numpy() for k in ("bvh_lo", "bvh_hi", "bvh_skip", "bvh_first", "bvh_count")]
    cut = treetop_cut(tree, n_cut)
    assert len(cut) == n_cut <= keys.KEY_MAX_CUT
    lo, hi = tree[0][cut], tree[1][cut]
    if n_cut == 32:
        np.testing.assert_array_equal(lo, port.bvh_cut_lo.numpy())
    ref_n = ref.replace(bvh_cut_lo=jnp.asarray(lo), bvh_cut_hi=jnp.asarray(hi))
    port_n = dataclasses.replace(port, bvh_cut_lo=torch.from_numpy(lo), bvh_cut_hi=torch.from_numpy(hi))
    ro, rd = _rays(port, np.random.default_rng(7 + n_cut))
    ro, rd = ro[::3], rd[::3]
    want = np.asarray(_coherence_key(ref_n, jnp.asarray(ro), jnp.asarray(rd), jax_eps(EPS)))
    got = keys.coherence_key_twin(port_n, torch.from_numpy(ro), torch.from_numpy(rd), EPS).numpy()
    np.testing.assert_array_equal(got, want)
    entries = np.unique((got >> 17) & 0x1FFF)
    assert entries.max() < n_cut and len(entries) > min(n_cut, 16) // 2
    assert keys._key_table(port_n).shape == (n_cut + 1, 6)


def test_key_accepts_soa_and_array_layouts(scenes):
    _, port = scenes
    ro, rd = _rays(port, np.random.default_rng(4))
    ro, rd = ro[::5], rd[::5]
    a = keys.coherence_key(port, torch.from_numpy(ro), torch.from_numpy(rd), EPS)
    b = keys.coherence_key(port, tuple(torch.from_numpy(ro).unbind(1)), tuple(torch.from_numpy(rd).unbind(1)), EPS)
    assert torch.equal(a, b)


def test_order_is_a_stable_sort(scenes):
    _, port = scenes
    ro, rd = _rays(port, np.random.default_rng(5))
    ro_t, rd_t = torch.from_numpy(ro), torch.from_numpy(rd)
    key = keys.coherence_key(port, ro_t, rd_t, EPS)
    order = keys.coherence_order(port, ro_t, rd_t, EPS)
    np.testing.assert_array_equal(order.numpy(), np.argsort(key.numpy(), kind="stable"))


def test_cuda_wrapper_refuses_cpu_rays(scenes):
    _, port = scenes
    ro, rd = _rays(port, np.random.default_rng(6))
    with pytest.raises(ValueError, match="CUDA device"):
        keys.coherence_key_cuda(port, torch.from_numpy(ro[:8]), torch.from_numpy(rd[:8]), EPS)


def test_key_table_is_built_once_per_scene(scenes):
    _, port = scenes
    table = keys._key_table(port)
    assert keys._key_table(port) is table
    assert table.device.type == "cpu" and table.shape == (port.bvh_cut_lo.shape[0] + 1, 6)
    np.testing.assert_array_equal(table[:-1, :3].numpy(), port.bvh_cut_lo.numpy())
    np.testing.assert_array_equal(table[-1].numpy(), torch.cat([port.bvh_lo[0], port.bvh_hi[0]]).numpy())


def test_key_twin_with_256_cut_boxes_is_bit_equal_to_jax(monkeypatch):
    """``RT_MAX_CUT=256`` on the unicorn, read by both loaders: the cuts
    agree, and the keys of the twin equal JAX's (the kernel's device table
    takes 65..8191 boxes)."""
    monkeypatch.setenv("RT_MAX_CUT", "256")
    path = os.path.join(SCENES, "flying_unicorn.toml")
    ref, port = jax_load_scene(path), load_scene(path, device="cpu")
    assert port.bvh_cut_lo.shape[0] == 256 > keys.KEY_MAX_CUT
    np.testing.assert_array_equal(np.asarray(ref.bvh_cut_lo), port.bvh_cut_lo.numpy())
    ro, rd = _rays(port, np.random.default_rng(256))
    ro, rd = ro[::4], rd[::4]
    want = np.asarray(_coherence_key(ref, jnp.asarray(ro), jnp.asarray(rd), jax_eps(EPS)))
    got = keys.coherence_key(port, torch.from_numpy(ro), torch.from_numpy(rd), EPS).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique((got >> 17) & 0x1FFF)) > 64


def test_the_key_takes_1_to_8191_cut_boxes(scenes):
    """The wrapper accepts every count the 13-bit entry field can name and
    refuses 8192; past KEY_MAX_CUT the kernel reads a device table."""
    _, port = scenes
    for n_cut in (1, 65, 256, 8191):
        keys.check_cut_count(n_cut)
    for n_cut in (0, 8192):
        with pytest.raises(ValueError, match="1..8191"):
            keys.check_cut_count(n_cut)
    rng = np.random.default_rng(8191)
    root_lo, root_hi = port.bvh_lo[0].numpy(), port.bvh_hi[0].numpy()
    lo = rng.uniform(root_lo, root_hi, (8192, 3)).astype(np.float32)
    hi = lo + (rng.uniform(0.05, 0.3, (8192, 3)) * (root_hi - root_lo)).astype(np.float32)
    ro, rd = _rays(port, rng)
    ro_t, rd_t = torch.from_numpy(ro[::500]), torch.from_numpy(rd[::500])
    for n_cut in (8191, 8192):
        many = dataclasses.replace(port, bvh_cut_lo=torch.from_numpy(lo[:n_cut]),
                                   bvh_cut_hi=torch.from_numpy(hi[:n_cut]))
        if n_cut == 8192:
            with pytest.raises(ValueError, match="1..8191"):
                keys.coherence_key(many, ro_t, rd_t, EPS)
            with pytest.raises(ValueError, match="1..8191"):
                keys.coherence_key_cuda(many, ro_t, rd_t, EPS)
        else:
            got = keys.coherence_key(many, ro_t, rd_t, EPS)
            assert ((got >> 17) & 0x1FFF).max() > keys.KEY_MAX_CUT
            assert keys._key_table(many).shape == (8192, 6)
