"""The 8-wide traversal's plain PyTorch twin (K2) against the JAX package's
``bvh_intersect`` (its XLA packet traversal on the CPU), on a random
triangle soup and on flying_unicorn rays, nearest and any-hit.

Tolerances are those of tests/test_pallas_bvh.py:83-85: hit masks equal,
t within rtol 3e-4 / atol 1e-4, triangle indices equal on hits. (The XLA
traversal tests Moller-Trumbore on the f32 vertices, the twin the
f64-precomputed gradient rows, so t differs in the last bits.)"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.models.loader import load_scene as jax_load_scene
from raytracer_tpu.ops.bvh import bvh_intersect as jax_bvh_intersect
from raytracer_tpu_torch.config import Epsilons
from raytracer_tpu_torch.models.loader import load_scene
from raytracer_tpu_torch.models.scene import build_scene_arrays
from raytracer_tpu_torch.ops import bvh
from raytracer_tpu_torch.ops import bvh_traverse as bt
from raytracer_tpu_torch.ops import keys
from tests.test_bvh import _scene_with_mesh_bvh, random_tri_soup
from tests.torch_cpu import jax_eps, one_torch_thread  # noqa: F401  (autouse)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
EPS = Epsilons()


def _port_soup_scene(tris):
    tree, order = bvh.build_bvh(tris)
    tris = np.where(order[:, None, None] >= 0, tris[np.maximum(order, 0)], 0.0)
    triangles = [
        dict(a=t[0], b=t[1], c=t[2], obj=0, valid=bool(o >= 0)) for t, o in zip(tris, order)
    ]
    mats = [
        dict(emitted=[0, 0, 0], brdf_type=0, c_d=[1, 1, 1], c_s=[0, 0, 0], k_d=1, k_s=0, power=0),
        dict(emitted=[1, 1, 1], brdf_type=0, c_d=[0, 0, 0], c_s=[0, 0, 0], k_d=1, k_s=0, power=0),
    ]
    spheres = [dict(pos=[0, 0, 100], r=1.0, obj=1)]
    return build_scene_arrays(
        "bvhtest", np.zeros(3), np.array([0, 0, -1.0]), spheres, [], triangles, mats,
        bvh=tree, bvh_tri_start=0, device="cpu",
    )


@pytest.fixture(scope="module")
def soup():
    tris = random_tri_soup(1500, seed=6)
    return _scene_with_mesh_bvh(tris), _port_soup_scene(tris)


@pytest.fixture(scope="module")
def unicorn():
    path = os.path.join(SCENES, "flying_unicorn.toml")
    return jax_load_scene(path), load_scene(path, device="cpu")


def _random_rays(n, seed, lo=-12.0, hi=12.0):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    return ro, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _unicorn_rays(port, n, seed):
    """Half camera rays (from the scene's camera through the unicorn's box),
    half random rays from inside the box."""
    rng = np.random.default_rng(seed)
    lo, hi = port.bvh_lo[0].numpy(), port.bvh_hi[0].numpy()
    cam = port.cam_pos.numpy()
    target = rng.uniform(lo, hi, (n // 2, 3))
    d1 = target - cam
    ro = np.concatenate([np.tile(cam, (n // 2, 1)), rng.uniform(lo, hi, (n - n // 2, 3))])
    d = np.concatenate([d1, rng.normal(size=(n - n // 2, 3))])
    return ro.astype(np.float32), (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _both(pair, ro, rd, **kw):
    ref, port = pair
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tj, ij = jax_bvh_intersect(ref, jnp.asarray(ro), jnp.asarray(rd), jax_eps(EPS), **jkw)
    tp, ip = bt.bvh_intersect(port, torch.from_numpy(ro), torch.from_numpy(rd), EPS, **tkw)
    return np.asarray(tj), np.asarray(ij), tp.numpy(), ip.numpy()


def _assert_nearest_agrees(tj, ij, tp, ip):
    hj, hp = tj < 1e30, tp < 1e30
    np.testing.assert_array_equal(hj, hp)
    np.testing.assert_allclose(tp[hp], tj[hj], rtol=3e-4, atol=1e-4)
    np.testing.assert_array_equal(ip[hp], ij[hj])


def test_nearest_matches_jax_on_a_soup(soup):
    ro, rd = _random_rays(700, 7)
    tj, ij, tp, ip = _both(soup, ro, rd)
    assert 50 < (tp < 1e30).sum() < 650
    _assert_nearest_agrees(tj, ij, tp, ip)


def test_t_init_bounds_the_search_on_a_soup(soup):
    ro, rd = _random_rays(700, 8)
    bound = np.random.default_rng(9).uniform(1.0, 25.0, 700).astype(np.float32)
    tj, ij, tp, ip = _both(soup, ro, rd, t_init=bound)
    # Rays that find nothing below their bound keep it.
    np.testing.assert_array_equal(tp >= bound, tj >= bound)
    np.testing.assert_array_equal(tp[tp >= bound], bound[tp >= bound])
    hit = tp < bound
    assert hit.sum() > 20
    np.testing.assert_allclose(tp[hit], tj[hit], rtol=3e-4, atol=1e-4)
    np.testing.assert_array_equal(ip[hit], ij[hit])


def test_any_hit_with_resolved0_on_a_soup(soup):
    ro, rd = _random_rays(700, 10)
    rng = np.random.default_rng(11)
    bound = rng.uniform(1.0, 25.0, 700).astype(np.float32)
    resolved = rng.random(700) < 0.3
    tj, _, tp, _ = _both(soup, ro, rd, t_init=bound, any_hit=True, resolved0=resolved)
    # any_hit may stop at ANY sub-bound hit: only occlusion agrees, and
    # resolved lanes are don't-care.
    np.testing.assert_array_equal((tp < bound)[~resolved], (tj < bound)[~resolved])
    assert (tp < bound)[~resolved].sum() > 10
    # An any-hit t is a real hit of the nearest search's bound.
    _, _, tn, _ = _both(soup, ro, rd, t_init=bound)
    assert (tp[~resolved] >= tn[~resolved]).all()


def test_presorted_equals_sorted(soup):
    _, port = soup
    ro, rd = _random_rays(700, 12)
    ro_t, rd_t = torch.from_numpy(ro), torch.from_numpy(rd)
    t1, i1 = bt.bvh_intersect(port, ro_t, rd_t, EPS)
    t2, i2 = bt.bvh_intersect(port, ro_t, rd_t, EPS, presorted=True)
    assert torch.equal(t1, t2) and torch.equal(i1, i2)


def test_nearest_matches_jax_on_unicorn(unicorn):
    ro, rd = _unicorn_rays(unicorn[1], 2048, 13)
    tj, ij, tp, ip = _both(unicorn, ro, rd)
    assert (tp < 1e30).sum() > 600
    _assert_nearest_agrees(tj, ij, tp, ip)


def test_bounded_any_hit_matches_jax_on_unicorn(unicorn):
    ro, rd = _unicorn_rays(unicorn[1], 1024, 14)
    rng = np.random.default_rng(15)
    bound = rng.uniform(1.0, 60.0, 1024).astype(np.float32)
    resolved = rng.random(1024) < 0.2
    tj, _, tp, _ = _both(unicorn, ro, rd, t_init=bound, any_hit=True, resolved0=resolved)
    m = ~resolved
    np.testing.assert_array_equal((tp < bound)[m], (tj < bound)[m])
    assert (tp < bound)[m].sum() > 50


def test_index_is_clipped_and_stack_checked(unicorn):
    _, port = unicorn
    ro, rd = _unicorn_rays(port, 256, 16)
    _, idx = bt.bvh_intersect(port, torch.from_numpy(ro), torch.from_numpy(rd), EPS)
    assert idx.min() >= 0 and idx.max() < port.tri_a.shape[0]
    assert port.bvh8_max_stack <= bt.BVH8_MAX_STACK
    import dataclasses

    deep = dataclasses.replace(port, bvh8_max_stack=bt.BVH8_MAX_STACK + 1)
    with pytest.raises(ValueError, match="stack"):
        bt.bvh_traverse_twin(deep, torch.from_numpy(ro), torch.from_numpy(rd),
                             torch.full((256,), bt.INF), torch.zeros(256, dtype=torch.bool), False, EPS)


def test_cuda_wrapper_refuses_cpu_rays(unicorn):
    _, port = unicorn
    ro, rd = _unicorn_rays(port, 8, 17)
    with pytest.raises(ValueError, match="CUDA device"):
        bt.bvh_traverse_cuda(port, torch.from_numpy(ro), torch.from_numpy(rd),
                             torch.full((8,), bt.INF), torch.zeros(8, dtype=torch.bool), False, EPS)


def test_twin_counts_its_visits(unicorn):
    """The visit counter changes nothing and counts real leaf triangles."""
    _, port = unicorn
    ro, rd = _unicorn_rays(port, 512, 18)
    args = (port, torch.from_numpy(ro), torch.from_numpy(rd), torch.full((512,), bt.INF),
            torch.zeros(512, dtype=torch.bool), False, EPS)
    visits = {}
    t1, i1 = bt.bvh_traverse_twin(*args, visits=visits)
    t2, i2 = bt.bvh_traverse_twin(*args)
    assert torch.equal(t1, t2) and torch.equal(i1, i2)
    assert visits["nodes"] >= 512 and visits["leaves"] > 0
    # Real triangles only: fewer than the leaves' padded rows.
    assert visits["leaves"] <= visits["tris"] < visits["leaves"] * bvh.MAX_LEAF


@pytest.mark.parametrize("name", ["flying_unicorn", "crewmate_phong"])
def test_every_leaf_starts_its_own_group(name):
    """K2 encodes a leaf by its last row: each leaf of the wide nodes starts
    its own MAX_LEAF group and holds 1..MAX_LEAF triangles, and the group and
    count come back from the last row."""
    port = load_scene(os.path.join(SCENES, f"{name}.toml"), device="cpu")
    nd = port.bvh8_nodes_flat.view(-1, 8, 8).numpy()
    child, count = nd[..., 6].astype(np.int64), nd[..., 7].astype(np.int64)
    bvh.check_leaf_groups(child, count)
    leaf = count > 0
    last = child[leaf] + count[leaf] - 1
    np.testing.assert_array_equal(last // bvh.MAX_LEAF, child[leaf] // bvh.MAX_LEAF)
    np.testing.assert_array_equal(last % bvh.MAX_LEAF + 1, count[leaf])
    bad = child.copy()
    bad[leaf.nonzero()[0][0], leaf.nonzero()[1][0]] += 1
    with pytest.raises(ValueError, match="group"):
        bvh.check_leaf_groups(bad, count)


@pytest.mark.parametrize("leaf_tris", [bvh.MAX_LEAF, 10 ** 6])
def test_leaf_tris_at_all_rows_is_the_default_walk(unicorn, leaf_tris):
    """RT_LEAF_TRIS at or past the leaf size tests every triangle: the twin
    equals today's on every ray, and so does the dispatch under the env."""
    _, port = unicorn
    ro, rd = _unicorn_rays(port, 512, 19)
    args = (port, torch.from_numpy(ro), torch.from_numpy(rd), torch.full((512,), bt.INF),
            torch.zeros(512, dtype=torch.bool), False, EPS)
    t0, i0 = bt.bvh_traverse_twin(*args)
    t1, i1 = bt.bvh_traverse_twin(*args, leaf_tris=leaf_tris)
    assert torch.equal(t0, t1) and torch.equal(i0, i1) and (t0 < 1e30).sum() > 100


@pytest.mark.parametrize("leaf_tris", [0, 8])
def test_leaf_tris_tests_the_first_rows_only(unicorn, monkeypatch, leaf_tris):
    """RT_LEAF_TRIS=k, a timing probe: every leaf tests its first k rows, so
    a t is a real hit or t_init, never nearer than the full walk's, and the
    twin counts at most k triangles a leaf; the dispatch reads the env."""
    _, port = unicorn
    ro, rd = _unicorn_rays(port, 512, 20)
    args = (port, torch.from_numpy(ro), torch.from_numpy(rd), torch.full((512,), bt.INF),
            torch.zeros(512, dtype=torch.bool), False, EPS)
    t_all, _ = bt.bvh_traverse_twin(*args)
    visits = {}
    t, idx = bt.bvh_traverse_twin(*args, visits=visits, leaf_tris=leaf_tris)
    assert (t >= t_all).all() and visits["leaves"] > 0
    assert visits["tris"] <= leaf_tris * visits["leaves"]
    if leaf_tris == 0:
        assert (t == bt.INF).all() and (idx == 0).all() and visits["cand"] == 0
    else:
        hit = t < 1e30
        assert hit.sum() > 50
        assert torch.equal(bt.leaf_t(port, args[1][hit], args[2][hit], idx[hit]), t[hit])
        assert ((idx[hit] - port.bvh_tri_start) % bvh.MAX_LEAF < leaf_tris).all()
    monkeypatch.setenv("RT_LEAF_TRIS", str(leaf_tris))
    t_env, i_env = bt.bvh_traverse(*args)
    assert torch.equal(t_env, t) and torch.equal(i_env, idx)


@pytest.mark.parametrize("group", [8, 3])
def test_sort_group_in_the_wrapper_changes_no_hit(soup, monkeypatch, group):
    """RT_SORT_GROUP=G sorts groups of G rays by their least key (3 does not
    divide the 704 rays: the per-ray order): t and index bit-equal."""
    _, port = soup
    ro, rd = (torch.from_numpy(a) for a in _random_rays(704, 21))
    t0, i0 = bt.bvh_intersect(port, ro, rd, EPS)
    monkeypatch.setenv("RT_SORT_GROUP", str(group))
    t1, i1 = bt.bvh_intersect(port, ro, rd, EPS)
    assert torch.equal(t0, t1) and torch.equal(i0, i1) and (t0 < 1e30).sum() > 50


@pytest.mark.parametrize("live_frac", [0.3, 0.9])
def test_shadow_compaction_matches_jax_interpret(monkeypatch, live_frac):
    """RT_SHADOW_COMPACT on bounded any-hit queries, as
    tests/test_pallas_bvh.py:116-150 runs JAX's wrapper in interpret mode: a
    third of the rays live (the walk on half the width) and nine tenths
    (the full width). "1" gives the uncompacted t and index on every ray,
    and JAX's occlusion; "force" leaves the rays sorted past the half width
    at their t_init, as JAX's does."""
    from raytracer_tpu.ops.pallas.bvh_kernel import bvh_intersect_pallas

    monkeypatch.setenv("RT_BVH_KERNEL", "widesmem")
    tris = random_tri_soup(150, seed=23)
    ref, port = _scene_with_mesh_bvh(tris), _port_soup_scene(tris)
    rng = np.random.default_rng(24)
    n = 2500  # three packets: the half width is two
    live = rng.random(n) < live_frac
    ro = np.where(live[:, None], rng.uniform(-12, 12, (n, 3)), 3.0e7).astype(np.float32)
    # Live rays aim at a triangle, so that they enter a cut box: nine tenths
    # live then overflow the half width.
    aim = tris[rng.integers(0, len(tris), n)].mean(axis=1) - ro
    d = np.where(live[:, None], aim, [1.0, 0.0, 0.0])
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    bound = np.where(live, rng.uniform(1.0, 25.0, n), 0.0).astype(np.float32)
    occ = {}
    for mode in ("0", "1", "force"):
        monkeypatch.setenv("RT_SHADOW_COMPACT", mode)
        t, i = bt.bvh_intersect(port, torch.from_numpy(ro), torch.from_numpy(rd), EPS,
                                t_init=torch.from_numpy(bound), any_hit=True, resolved0=torch.from_numpy(~live))
        occ[mode] = (t.numpy() < bound, t, i)
    assert torch.equal(occ["1"][1], occ["0"][1]) and torch.equal(occ["1"][2], occ["0"][2])
    assert occ["1"][0][live].sum() > 5 and not occ["1"][0][~live].any()
    for mode in ("1", "force"):
        monkeypatch.setenv("RT_SHADOW_COMPACT", mode)
        t_j, _ = bvh_intersect_pallas(ref, jnp.asarray(ro), jnp.asarray(rd), jax_eps(EPS),
                                      t_init=jnp.asarray(bound), any_hit=True,
                                      resolved0=jnp.asarray((~live).astype(np.float32)), interpret=True)
        np.testing.assert_array_equal(occ[mode][0], np.asarray(t_j) < bound)
    # "force": the rays sorted past the half width keep t_init and index 0,
    # the head is the uncompacted walk.
    key = keys.coherence_key(port, torch.from_numpy(ro), torch.from_numpy(rd), EPS)
    key = key | (torch.from_numpy(~live).to(torch.int32) << 30)
    order = torch.argsort(key, stable=True)
    head, tail = order[:2 * bt.PACKET], order[2 * bt.PACKET:]
    _, t_f, i_f = occ["force"]
    assert torch.equal(t_f[tail], torch.from_numpy(bound)[tail]) and (i_f[tail] == 0).all()
    assert torch.equal(t_f[head], occ["0"][1][head]) and torch.equal(i_f[head], occ["0"][2][head])
    # A third live fit the half width; nine tenths do not ("1" then walks
    # every ray, "force" drops some).
    assert int(((key >> 30) == 0).sum()) > 2 * bt.PACKET if live_frac > 0.5 else bool((key[tail] >> 30).all())
