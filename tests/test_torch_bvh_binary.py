"""The binary skip-link walk's plain PyTorch twin (K4) against the JAX
package, and the variant dispatch.

- on a random triangle soup, against JAX's ``bvh_intersect_pallas`` under
  ``RT_BVH_KERNEL=binary`` (the Pallas ``_traverse_kernel`` in interpret
  mode) and against its XLA ``bvh_intersect``: nearest hits, hits bounded
  by ``t_init``, and any-hit with ``resolved0``;
- on crewmate_phong rays, against XLA only (interpret mode is slow there);
- the walk finds the same nearest t as K2's twin on unicorn and crewmate
  rays;
- ``RT_BVH_KERNEL`` routes the traversal; the CUDA wrapper refuses CPU
  rays; the node packer refuses a table the walk could not finish. (The
  node table itself is held against JAX's in tests/test_torch_scene.py.)

Tolerances are those of tests/test_pallas_bvh.py:83-85: hit masks equal,
t within rtol 3e-4 / atol 1e-4, triangle indices equal on hits; any-hit
agrees on occlusion of the unresolved lanes only (either side may stop at
any hit below the bound). The JAX kernels test Moller-Trumbore on the f32
vertices or the same f64-precomputed gradient rows, so t differs in the
last bits.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu_torch.config import Epsilons
from raytracer_tpu.models.loader import load_scene as jax_load_scene
from raytracer_tpu.ops.bvh import bvh_intersect as jax_bvh_intersect
from raytracer_tpu.ops.pallas.bvh_kernel import bvh_intersect_pallas
from raytracer_tpu_torch.models.loader import load_scene
from raytracer_tpu_torch.ops import bvh_binary as bb
from raytracer_tpu_torch.ops import bvh_traverse as bt
from tests.test_bvh import _scene_with_mesh_bvh, random_tri_soup
from tests.test_torch_traverse import _port_soup_scene, _random_rays, _unicorn_rays
from tests.torch_cpu import jax_eps, one_torch_thread  # noqa: F401  (autouse)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
EPS = Epsilons()


@pytest.fixture(scope="module")
def soup():
    tris = random_tri_soup(600, seed=6)
    return _scene_with_mesh_bvh(tris), _port_soup_scene(tris)


@pytest.fixture(scope="module", params=["flying_unicorn", "crewmate_phong"])
def mesh(request):
    return load_scene(os.path.join(SCENES, f"{request.param}.toml"), device="cpu")


def _port(port, ro, rd, monkeypatch, **kw):
    monkeypatch.setenv("RT_BVH_KERNEL", "binary")
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    t, i = bt.bvh_intersect(port, torch.from_numpy(ro), torch.from_numpy(rd), EPS, **tkw)
    return t.numpy(), i.numpy()


def _assert_agrees(tj, ij, tp, ip, bound):
    hj, hp = tj < bound, tp < bound
    np.testing.assert_array_equal(hp, hj)
    np.testing.assert_allclose(tp[hp], tj[hj], rtol=3e-4, atol=1e-4)
    np.testing.assert_array_equal(ip[hp], ij[hj])
    # A ray that finds nothing below its bound keeps it.
    np.testing.assert_array_equal(tp[~hp], bound[~hp])


def _soup_bound(n, seed):
    """Half the rays unbounded (nearest hit), half bounded by a t_init."""
    bound = np.random.default_rng(seed).uniform(1.0, 25.0, n).astype(np.float32)
    bound[::2] = bt.INF
    return bound


@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
def test_nearest_and_bounded_match_jax_on_a_soup(soup, ref, monkeypatch):
    jax_scene, port = soup
    ro, rd = _random_rays(700, 7)
    bound = _soup_bound(700, 8)
    monkeypatch.setenv("RT_BVH_KERNEL", "binary")
    args = (jax_scene, jnp.asarray(ro), jnp.asarray(rd), jax_eps(EPS))
    if ref == "xla":
        tj, ij = jax_bvh_intersect(*args, t_init=jnp.asarray(bound))
    else:
        tj, ij = bvh_intersect_pallas(*args, t_init=jnp.asarray(bound), interpret=True)
    tp, ip = _port(port, ro, rd, monkeypatch, t_init=bound)
    hits = tp < bound
    assert hits[::2].sum() > 20 and hits[1::2].sum() > 10
    _assert_agrees(np.asarray(tj), np.asarray(ij), tp, ip, bound)


@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
def test_any_hit_with_resolved0_matches_jax_on_a_soup(soup, ref, monkeypatch):
    jax_scene, port = soup
    ro, rd = _random_rays(700, 10)
    rng = np.random.default_rng(11)
    bound = rng.uniform(1.0, 25.0, 700).astype(np.float32)
    resolved = rng.random(700) < 0.3
    monkeypatch.setenv("RT_BVH_KERNEL", "binary")
    args = (jax_scene, jnp.asarray(ro), jnp.asarray(rd), jax_eps(EPS))
    if ref == "xla":
        tj, _ = jax_bvh_intersect(*args, t_init=jnp.asarray(bound), any_hit=True,
                                  resolved0=jnp.asarray(resolved))
    else:
        tj, _ = bvh_intersect_pallas(*args, t_init=jnp.asarray(bound), any_hit=True,
                                     resolved0=jnp.asarray(resolved, jnp.float32), interpret=True)
    tp, _ = _port(port, ro, rd, monkeypatch, t_init=bound, any_hit=True, resolved0=resolved)
    m = ~resolved
    np.testing.assert_array_equal((tp < bound)[m], (np.asarray(tj) < bound)[m])
    assert (tp < bound)[m].sum() > 10
    # A resolved ray does not walk: it keeps its bound.
    np.testing.assert_array_equal(tp[resolved], bound[resolved])


def test_nearest_matches_xla_on_crewmate(monkeypatch):
    path = os.path.join(SCENES, "crewmate_phong.toml")
    ref, port = jax_load_scene(path), load_scene(path, device="cpu")
    ro, rd = _unicorn_rays(port, 2048, 31)
    tj, ij = jax_bvh_intersect(ref, jnp.asarray(ro), jnp.asarray(rd), jax_eps(EPS))
    tp, ip = _port(port, ro, rd, monkeypatch)
    assert (tp < 1e30).sum() > 600
    _assert_agrees(np.asarray(tj), np.asarray(ij), tp, ip, np.full(2048, bt.INF, np.float32))


def test_walk_and_k2_find_the_same_nearest_hits(mesh):
    """K4 and K2 are both exact nearest-hit searches with the same t
    expression: t agrees bit for bit except where a slab rounding or a tie
    sends one walk elsewhere."""
    port = mesh
    ro, rd = _unicorn_rays(port, 4096, 32)
    args = (port, torch.from_numpy(ro).unbind(1), torch.from_numpy(rd).unbind(1),
            torch.full((4096,), bt.INF), torch.zeros(4096, dtype=torch.bool), False, EPS)
    t4, i4 = bb.bvh_binary_twin(*args)
    t2, i2 = bt.bvh_traverse_twin(*args)
    assert (t4 < 1e30).sum() > 1000
    assert (t4 == t2).double().mean().item() >= 0.999
    diff = i4 != i2
    assert torch.equal(bt.leaf_t(port, args[1], args[2], i4)[diff], bt.leaf_t(port, args[1], args[2], i2)[diff])


def test_variant_routes_the_traversal(mesh, monkeypatch):
    port = mesh
    ro, rd = _unicorn_rays(port, 64, 33)
    called = []
    for name in ("bvh_binary_twin", "bvh_traverse_twin"):
        real = getattr(bt, name)
        monkeypatch.setattr(bt, name, lambda *a, _n=name, _f=real: called.append(_n) or _f(*a))
    for variant, want in (("binary", "bvh_binary_twin"), (None, "bvh_traverse_twin"),
                          ("widemxu", "bvh_traverse_twin"), ("skiplink", "bvh_binary_twin")):
        if variant is None:
            monkeypatch.delenv("RT_BVH_KERNEL", raising=False)
        else:
            monkeypatch.setenv("RT_BVH_KERNEL", variant)
        called.clear()
        bt.bvh_intersect(port, torch.from_numpy(ro), torch.from_numpy(rd), EPS)
        assert called == [want], variant


def test_cuda_wrapper_refuses_cpu_rays(mesh):
    port = mesh
    ro, rd = _unicorn_rays(port, 8, 34)
    with pytest.raises(ValueError, match="CUDA device"):
        bb.bvh_binary_cuda(port, torch.from_numpy(ro), torch.from_numpy(rd),
                           torch.full((8,), bt.INF), torch.zeros(8, dtype=torch.bool), False, EPS)


def test_node_packer_rejects_a_walk_that_cannot_end(mesh):
    from raytracer_tpu_torch.ops.bvh import pack_binary_nodes

    port = mesh
    tree = [getattr(port, k).numpy().copy() for k in ("bvh_lo", "bvh_hi", "bvh_skip", "bvh_first", "bvh_count")]
    tree[2][3] = 3  # a skip link back onto its own node
    with pytest.raises(ValueError, match="skip"):
        pack_binary_nodes(tree)


def test_twin_counts_its_visits():
    """The visit counter changes nothing; it counts real leaf triangles."""
    port = load_scene(os.path.join(SCENES, "crewmate_phong.toml"), device="cpu")
    ro, rd = _unicorn_rays(port, 512, 19)
    args = (port, torch.from_numpy(ro), torch.from_numpy(rd), torch.full((512,), bb.INF),
            torch.zeros(512, dtype=torch.bool), False, EPS)
    visits = {}
    t1, i1 = bb.bvh_binary_twin(*args, visits=visits)
    t2, i2 = bb.bvh_binary_twin(*args)
    assert torch.equal(t1, t2) and torch.equal(i1, i2)
    assert visits["nodes"] >= 512 and visits["leaves"] > 0
    assert visits["leaves"] <= visits["tris"] <= visits["leaves"] * bt.MAX_LEAF
    assert 0 < visits["cand"] <= visits["tris"]
