"""The binary skip-link walk's plain PyTorch twin (K4) against the JAX
package, and the variant dispatch.

- on a random triangle soup, against JAX's ``bvh_intersect_pallas`` under
  ``RT_BVH_KERNEL=binary`` (the Pallas ``_traverse_kernel`` in interpret
  mode) and against its XLA ``bvh_intersect``: nearest hits, hits bounded
  by ``t_init``, and any-hit with ``resolved0``;
- on crewmate_phong rays, against XLA only (interpret mode is slow there);
- the walk finds the same nearest t as K2's twin on unicorn and crewmate
  rays;
- the 32-byte node table and the eight octant layouts against the five tree
  arrays; the ordered walk (the kernel's) against the fixed-order walk and
  against JAX's K4, nearest and any-hit: t equal bit for bit between the
  two walks of the twin (the minimum over the same triangles), indices
  equal except where two triangles tie in t;
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
from raytracer_tpu_torch.ops import bvh
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
    assert visits["leaves"] <= visits["tris"] <= visits["leaves"] * bvh.MAX_LEAF
    assert 0 < visits["cand"] <= visits["tris"]


# --- the 32-byte node table and the octant layouts -------------------------------


def _tree(port):
    return [getattr(port, k).numpy() for k in ("bvh_lo", "bvh_hi", "bvh_skip", "bvh_first", "bvh_count")]


def _two_leaf_tree():
    """A root over a low and a high leaf on x, low first: the tree's own
    order is the +x octants' near-child-first order."""
    lo = np.array([[0, 0, 0], [0, 0, 0], [2, 0, 0]], np.float32)
    hi = np.array([[3, 1, 1], [1, 1, 1], [3, 1, 1]], np.float32)
    return [lo, hi, np.array([3, 2, 3], np.int32), np.array([-1, 0, 64], np.int32), np.array([0, 5, 7], np.int32)]


def test_nodes8_holds_the_tree_with_link_for_skip_or_first(mesh):
    lo, hi, skip, first, count = _tree(mesh)
    rows = mesh.bvh_binary_nodes8.numpy()
    n = lo.shape[0]
    assert rows.shape == (n, 8) and rows.dtype == np.float32
    np.testing.assert_array_equal(rows[:, 0:3], lo)
    np.testing.assert_array_equal(rows[:, 4:7], hi)
    np.testing.assert_array_equal(rows[:, 7], count)
    leaf = count > 0
    np.testing.assert_array_equal(rows[leaf, 3], first[leaf])  # a leaf's link: its first row
    np.testing.assert_array_equal(rows[~leaf, 3], skip[~leaf])  # an inner node's: its skip link
    np.testing.assert_array_equal(skip[leaf], np.arange(n)[leaf] + 1)  # which a leaf does not need
    np.testing.assert_array_equal(rows, bvh.pack_binary_nodes8(_tree(mesh)))


def test_octant_layouts_are_preorders_of_the_same_tree(mesh):
    tree = _tree(mesh)
    lo, hi, skip, first, count = tree
    n = lo.shape[0]
    orders = bvh.octant_orders(tree)
    tables = mesh.bvh_octant_nodes.numpy()
    assert orders.shape == (8, n) and tables.shape == (8, n, 8)
    size = skip - np.arange(n)
    for o in range(8):
        order, rows = orders[o], tables[o]
        np.testing.assert_array_equal(np.sort(order), np.arange(n))  # every node once
        np.testing.assert_array_equal(rows, bvh.pack_binary_nodes8(tree, order))
        np.testing.assert_array_equal(rows[:, 0:3], lo[order])
        np.testing.assert_array_equal(rows[:, 7], count[order])
        leaf = rows[:, 7] > 0
        # The same leaves, each with its own rows of the leaf table.
        np.testing.assert_array_equal(np.sort(rows[leaf, 3]), np.sort(first[count > 0]))
        np.testing.assert_array_equal(rows[leaf, 3], first[order][leaf])
        # Skip links past their node, at most one past the end, over a subtree of the same size.
        link = rows[~leaf, 3]
        at = np.arange(n)[~leaf]
        assert (link > at).all() and (link <= n).all()
        np.testing.assert_array_equal(link - at, size[order][~leaf])
        # A pre-order: an inner node's children are the next node and the one its sibling's subtree ends at.
        pos = np.empty(n, np.int64)
        pos[order] = np.arange(n)
        inner = np.nonzero(count == 0)[0]
        kids = np.stack([pos[inner + 1], pos[skip[inner + 1]]], axis=1)
        np.testing.assert_array_equal(kids.min(axis=1), pos[inner] + 1)
        near_size = np.where(kids[:, 0] < kids[:, 1], size[inner + 1], size[skip[inner + 1]])
        np.testing.assert_array_equal(kids.max(axis=1), pos[inner] + 1 + near_size)
        if (order == np.arange(n)).all():
            np.testing.assert_array_equal(rows, mesh.bvh_binary_nodes8.numpy())
    # Opposite octants put opposite children first wherever they differ at all.
    assert not (orders[0] == orders[7]).all()


def test_an_octant_in_the_trees_own_order_gets_nodes8():
    tree = _two_leaf_tree()
    orders = bvh.octant_orders(tree)
    tables = bvh.pack_octant_nodes(tree)
    own = bvh.pack_binary_nodes8(tree)
    for o in range(8):
        if o & 1:  # -x: the high leaf is near
            np.testing.assert_array_equal(orders[o], [0, 2, 1])
            np.testing.assert_array_equal(tables[o][:, 3], [3, 64, 0])
        else:
            np.testing.assert_array_equal(orders[o], [0, 1, 2])
            np.testing.assert_array_equal(tables[o], own)
    np.testing.assert_array_equal(own[:, 3], [3, 0, 64])
    np.testing.assert_array_equal(own[:, 7], [0, 5, 7])


def _twin_args(port, ro, rd, bound=None, resolved=None, any_hit=False):
    n = ro.shape[0]
    t_init = torch.full((n,), bt.INF) if bound is None else torch.from_numpy(bound)
    res = torch.zeros(n, dtype=torch.bool) if resolved is None else torch.from_numpy(resolved)
    return (port, torch.from_numpy(ro).unbind(1), torch.from_numpy(rd).unbind(1), t_init, res, any_hit, EPS)


def _assert_same_hits_but_for_ties(port, args, got, want):
    """t bit-equal; indices equal except where the two triangles tie in t."""
    assert torch.equal(got[0], want[0])
    diff = got[1] != want[1]
    assert torch.equal(bt.leaf_t(port, args[1], args[2], got[1])[diff],
                       bt.leaf_t(port, args[1], args[2], want[1])[diff])


@pytest.mark.parametrize("bounded", [False, True])
def test_ordered_walk_equals_fixed_order_walk_on_mesh_rays(mesh, bounded):
    ro, rd = _unicorn_rays(mesh, 3000, 41)
    bound = np.random.default_rng(42).uniform(1.0, 120.0, 3000).astype(np.float32) if bounded else None
    args = _twin_args(mesh, ro, rd, bound)
    v_ord, v_fix = {}, {}
    ordered = bb.bvh_binary_twin(*args, visits=v_ord)
    fixed = bb.bvh_binary_twin(*args, visits=v_fix, ordered=False)
    assert (ordered[0] < args[3]).sum() > 500
    _assert_same_hits_but_for_ties(mesh, args, ordered, fixed)
    # Near child first finds the near hit early and prunes the rest.
    assert v_ord["leaves"] < v_fix["leaves"] and v_ord["nodes"] < v_fix["nodes"]


def test_ordered_walk_equals_fixed_order_walk_on_a_soup(soup):
    _, port = soup
    ro, rd = _random_rays(700, 43)
    args = _twin_args(port, ro, rd, _soup_bound(700, 44))
    ordered = bb.bvh_binary_twin(*args)
    assert (ordered[0] < args[3]).sum() > 30
    _assert_same_hits_but_for_ties(port, args, ordered, bb.bvh_binary_twin(*args, ordered=False))


def test_any_hit_agrees_on_occlusion_in_both_orders(mesh):
    """Any-hit may stop at any hit below the bound, so the two orders agree
    on occlusion, not on t; each t is a real hit at or beyond the nearest."""
    ro, rd = _unicorn_rays(mesh, 2000, 45)
    rng = np.random.default_rng(46)
    bound = rng.uniform(1.0, 120.0, 2000).astype(np.float32)
    resolved = rng.random(2000) < 0.2
    args = _twin_args(mesh, ro, rd, bound, resolved, any_hit=True)
    t_ord, _ = bb.bvh_binary_twin(*args)
    t_fix, _ = bb.bvh_binary_twin(*args, ordered=False)
    t_near, _ = bb.bvh_binary_twin(*_twin_args(mesh, ro, rd, bound))
    b, m = args[3], ~args[4]
    assert ((t_ord < b)[m]).sum() > 100
    assert torch.equal((t_ord < b)[m], (t_fix < b)[m]) and torch.equal((t_ord < b)[m], (t_near < b)[m])
    assert (t_ord[m] >= t_near[m]).all() and (t_fix[m] >= t_near[m]).all()
    assert torch.equal(t_ord[~m], b[~m]) and torch.equal(t_fix[~m], b[~m])  # resolved: no walk


@pytest.mark.parametrize("ordered", [True, False])
def test_both_orders_match_the_pallas_walk_on_a_soup(soup, ordered, monkeypatch):
    """JAX's K4 in interpret mode against the twin called directly in either
    order, nearest and bounded hits: the tolerances of ``_assert_agrees``."""
    jax_scene, port = soup
    ro, rd = _random_rays(500, 47)
    bound = _soup_bound(500, 48)
    monkeypatch.setenv("RT_BVH_KERNEL", "binary")
    tj, ij = bvh_intersect_pallas(jax_scene, jnp.asarray(ro), jnp.asarray(rd), jax_eps(EPS),
                                  t_init=jnp.asarray(bound), interpret=True)
    tp, ip = bb.bvh_binary_twin(*_twin_args(port, ro, rd, bound), ordered=ordered)
    ip = ip.clamp(0, port.tri_a.shape[0] - 1)
    _assert_agrees(np.asarray(tj), np.asarray(ij), tp.numpy(), ip.numpy(), bound)
