"""The port's BVH host build against the JAX package: the binary tree, the
8-wide collapse, the treetop cut, the node table and the leaf-triangle
table, equal exactly, on the real mesh scenes and on a random soup."""

import os

import numpy as np
import pytest

import raytracer_tpu.ops.bvh as jax_bvh
from raytracer_tpu.models.loader import load_scene as jax_load_scene
from raytracer_tpu_torch.models.convert import leaf_tris_from_packed
from raytracer_tpu_torch.models.loader import load_scene
from raytracer_tpu_torch.ops import bvh

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
TREE_FIELDS = ("bvh_lo", "bvh_hi", "bvh_skip", "bvh_first", "bvh_count", "bvh_cut_lo", "bvh_cut_hi")


@pytest.fixture(scope="module", params=["flying_unicorn", "crewmate_phong"])
def pair(request):
    path = os.path.join(SCENES, f"{request.param}.toml")
    return jax_load_scene(path), load_scene(path, device="cpu")


def soup(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-10, 10, (n, 1, 3)) + rng.uniform(-0.8, 0.8, (n, 3, 3))


def test_constants_equal_jax():
    assert (bvh.MAX_LEAF, bvh.C_LEAF, bvh.SAH_BINS, bvh.BVH8_WIDTH) == (
        jax_bvh.MAX_LEAF, jax_bvh.C_LEAF, jax_bvh.SAH_BINS, jax_bvh.BVH8_WIDTH,
    )


def test_tree_equals_jax(pair):
    ref, port = pair
    assert port.use_bvh and ref.use_bvh
    assert port.bvh_tri_start == ref.bvh_tri_start
    assert port.bvh8_max_stack == ref.bvh8_max_stack
    for k in TREE_FIELDS + ("bvh8_nodes_flat",):
        want = np.asarray(getattr(ref, k))
        got = getattr(port, k).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_triangle_order_equals_jax(pair):
    """Brute-forced prefix, then the mesh in leaf order with degenerate pads."""
    ref, port = pair
    for k in ("tri_a", "tri_b", "tri_c", "tri_obj", "tri_valid"):
        np.testing.assert_array_equal(getattr(port, k).numpy(), np.asarray(getattr(ref, k)), err_msg=k)
    first = port.bvh_first.numpy()[port.bvh_count.numpy() > 0]
    assert (first % bvh.MAX_LEAF == 0).all()
    assert (port.n_triangles - port.bvh_tri_start) % bvh.MAX_LEAF == 0


def test_leaf_table_equals_jax_packing(pair):
    ref, port = pair
    rows = port.n_triangles - port.bvh_tri_start
    want = leaf_tris_from_packed(np.asarray(ref.bvh_tris_packed), rows)
    got = port.bvh_leaf_tris.numpy()
    assert got.shape == (rows, 12) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # Padded slots are all-zero rows, so the |denom| cutoff rejects them.
    pads = ~port.tri_valid.numpy()[port.bvh_tri_start:]
    assert pads.any() and not got[pads].any()


@pytest.mark.parametrize("n,seed", [(600, 5), (2500, 6)])
def test_build_functions_equal_jax_on_a_soup(n, seed):
    tris = soup(n, seed)
    (tree, order), (jtree, jorder) = bvh.build_bvh(tris), jax_bvh.build_bvh(tris)
    np.testing.assert_array_equal(order, jorder)
    for a, b in zip(tree, jtree):
        np.testing.assert_array_equal(a, b)
    wide, jwide = bvh.collapse_bvh8(tree), jax_bvh.collapse_bvh8(jtree)
    for a, b in zip(wide[:4], jwide[:4]):
        np.testing.assert_array_equal(a, b)
    assert wide[4] == jwide[4]
    np.testing.assert_array_equal(bvh.treetop_cut(tree), jax_bvh.treetop_cut(jtree))
    np.testing.assert_array_equal(
        bvh.pack_bvh8_nodes(*wide[:4]), jax_bvh.pack_bvh8_for_pallas(*jwide[:4])[1]
    )
    padded = np.where(order[:, None, None] >= 0, tris[np.maximum(order, 0)], 0.0)
    _, packed = jax_bvh.pack_for_pallas(jtree, padded)
    np.testing.assert_array_equal(
        bvh.pack_leaf_tris(padded), leaf_tris_from_packed(packed, padded.shape[0])
    )


def test_collapse_covers_every_leaf_once():
    tree, _ = bvh.build_bvh(soup(500, 11))
    lo, hi, skip, first, count = tree
    w_lo, w_hi, w_child, w_count, max_stack = bvh.collapse_bvh8(tree)
    leaf = w_count > 0
    got = sorted(zip(w_child[leaf].tolist(), w_count[leaf].tolist()))
    assert got == sorted(zip(first[count > 0].tolist(), count[count > 0].tolist()))
    assert (w_child[w_count == -1] > 0).all() and max_stack >= 8


def test_cut_is_bounded():
    tree, _ = bvh.build_bvh(soup(3000, 12))
    cut = bvh.treetop_cut(tree)
    assert 1 < len(cut) <= bvh.MAX_CUT and (np.diff(cut) > 0).all()
    with pytest.raises(ValueError, match="13-bit"):
        bvh.treetop_cut(tree, max_cut=9000)
