"""BVH host build: binned-SAH binary tree, 8-wide collapse, treetop cut,
and the tables the Hopper traversal kernels read.

The build functions are numpy copies of ``raytracer_tpu/ops/bvh.py``
(that module imports jax): ``build_bvh`` :69, ``collapse_bvh8`` :343 and
``treetop_cut`` :466, with the same constants, so the trees are equal to
the JAX package's node for node.

The TPU packings (``pack_for_pallas`` :222, ``pack_bvh8_for_pallas`` :433)
lay the tree out in [.., 128]-lane VMEM tiles. The Hopper kernels
(``ops/csrc/bvh8.cu``, ``ops/csrc/bvh_binary.cu``) read plain rows instead:

- ``pack_bvh8_nodes``: one [64] f32 row per wide node, child slot s at
  fields 8s..8s+7 = (lo.xyz, hi.xyz, child, count): the JAX package's
  ``bvh8_nodes_flat``;
- ``pack_binary_nodes``: one [12] f32 row per binary node, three float4s
  (lo.xyz, skip), (hi.xyz, count), (first, 0, 0, 0): the fields that JAX's
  ``pack_for_pallas`` puts in the lanes of ``bvh_nodes_packed``;
- ``pack_binary_nodes8``: the same node in 32 bytes, two float4s
  (lo.xyz, link), (hi.xyz, count): ``link`` is ``skip`` for an inner node
  and ``first`` for a leaf, whose skip link in pre-order is always the next
  node; ``octant_orders`` and ``pack_octant_nodes`` lay the same tree out
  once per direction octant, near child first (K4 reads these);
- ``pack_leaf_tris``: one [12] f32 row per triangle of the leaf-ordered,
  leaf-padded layout, (n_unit.xyz, n_d, q1.xyz, q1_a, q2.xyz, q2_a),
  computed in f64 from the f64 vertices and rounded once: the rows of the
  JAX package's ``bvh_tris_packed``.
"""

from __future__ import annotations

import os
import sys

import numpy as np

# Leaf size and leaf cost of the SAH, as in the JAX package (tuned there for
# 1024-ray TPU packets; a sweep for per-thread traversal is ROADMAP work).
# RT_MAX_LEAF and RT_C_LEAF in the environment re-sweep them, as they do in
# ``raytracer_tpu/ops/bvh.py``; they are read when this module is imported.
# ``build_bvh``, ``ops/bvh_traverse.py`` and ``ops/bvh_binary.py`` read
# ``MAX_LEAF`` here at each call, so a sweep patches this one name (a scene
# is traversed at the leaf size it was built with). K4 loads leaf rows four
# at a time, so a leaf size is a positive multiple of 4.
MAX_LEAF = int(os.environ.get("RT_MAX_LEAF", "64"))
if MAX_LEAF < 4 or MAX_LEAF % 4:
    raise ValueError(f"RT_MAX_LEAF={MAX_LEAF}: the leaf size must be a positive multiple of 4")
C_LEAF = float(os.environ.get("RT_C_LEAF", "3.0"))
SAH_BINS = 16
BVH8_WIDTH = 8
MAX_CUT = 32  # default treetop-cut size of the coherence key


def max_cut_from_env() -> int:
    """The treetop-cut size the loader builds: RT_MAX_CUT, default
    ``MAX_CUT``, read at each scene build as ``raytracer_tpu/models/
    scene.py`` reads it. The key takes at most ``ops/keys.py::
    KEY_CUT_LIMIT`` boxes (8191), as ``treetop_cut`` does."""
    return int(os.environ.get("RT_MAX_CUT", str(MAX_CUT)))


def _half_area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    d = np.maximum(hi - lo, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]


def build_bvh(tri_pts: np.ndarray, max_leaf: int | None = None):
    """Binned-SAH BVH over ``tri_pts`` [F,3,3] f64, flattened in DFS
    pre-order with skip links (``skip[i]`` = first node past i's subtree).

    Returns ((lo[Nn,3] f32, hi[Nn,3] f32, skip[Nn] i32, first[Nn] i32,
    count[Nn] i32), order[F'] i64): ``order`` lists input triangle ids in
    leaf order, each leaf padded with -1 to ``max_leaf`` aligned slots, and
    ``first`` indexes that padded layout.
    """
    if max_leaf is None:
        max_leaf = MAX_LEAF  # read at call time so a sweep can patch it
    n_tris = tri_pts.shape[0]
    centroids = tri_pts.mean(axis=1)
    tri_lo = tri_pts.min(axis=1)
    tri_hi = tri_pts.max(axis=1)

    los: list = []
    his: list = []
    skips: list[int] = []
    firsts: list[int] = []
    counts: list[int] = []
    order: list[int] = []

    def alloc() -> int:
        los.append(None)
        his.append(None)
        skips.append(-1)
        firsts.append(-1)
        counts.append(0)
        return len(skips) - 1

    def subtree_cost(n: int) -> float:
        groups = -(-n // max_leaf)
        return C_LEAF * groups + max(2 * groups - 1, 1) - groups

    def sah_split(idx: np.ndarray):
        cen = centroids[idx]
        lo_t, hi_t = tri_lo[idx], tri_hi[idx]
        best_cost = np.inf
        best = None
        for axis in range(3):
            cmin = cen[:, axis].min()
            cmax = cen[:, axis].max()
            if cmax - cmin < 1e-12:
                continue
            b = np.minimum(
                ((cen[:, axis] - cmin) / (cmax - cmin) * SAH_BINS).astype(np.int64),
                SAH_BINS - 1,
            )
            n_b = np.bincount(b, minlength=SAH_BINS)
            bb_lo = np.full((SAH_BINS, 3), np.inf)
            bb_hi = np.full((SAH_BINS, 3), -np.inf)
            np.minimum.at(bb_lo, b, lo_t)
            np.maximum.at(bb_hi, b, hi_t)
            nl = np.cumsum(n_b)[:-1]
            nr = len(idx) - nl
            al = _half_area(
                np.minimum.accumulate(bb_lo, 0)[:-1],
                np.maximum.accumulate(bb_hi, 0)[:-1],
            )
            ar = _half_area(
                np.minimum.accumulate(bb_lo[::-1], 0)[::-1][1:],
                np.maximum.accumulate(bb_hi[::-1], 0)[::-1][1:],
            )
            valid = (nl > 0) & (nr > 0)
            cost = np.where(
                valid,
                al * [subtree_cost(n) for n in nl] + ar * [subtree_cost(n) for n in nr],
                np.inf,
            )
            i = int(np.argmin(cost))
            if cost[i] < best_cost:
                best_cost = cost[i]
                best = (axis, cmin, cmax, i)
        if best is None:
            # All centroids coincide: median split, or a leaf if it fits.
            if len(idx) <= max_leaf:
                return None
            half = len(idx) // 2
            return idx[:half], idx[half:]
        if len(idx) <= max_leaf:
            area = _half_area(lo_t.min(axis=0), hi_t.max(axis=0))
            if C_LEAF * area <= best_cost + area:  # a split adds a node visit
                return None
        axis, cmin, cmax, i = best
        b = np.minimum(
            ((cen[:, axis] - cmin) / (cmax - cmin) * SAH_BINS).astype(np.int64),
            SAH_BINS - 1,
        )
        return idx[b <= i], idx[b > i]

    def build(idx: np.ndarray) -> None:
        my = alloc()
        pts = tri_pts[idx].reshape(-1, 3)
        los[my] = pts.min(axis=0)
        his[my] = pts.max(axis=0)
        split = sah_split(idx) if len(idx) > 1 else None
        if split is None:
            firsts[my] = len(order)
            counts[my] = len(idx)
            order.extend(idx.tolist())
            order.extend([-1] * (-len(idx) % max_leaf))  # align leaf groups
        else:
            build(split[0])
            build(split[1])
        skips[my] = len(skips)  # the whole subtree has been emitted

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))
    try:
        build(np.arange(n_tris))
    finally:
        sys.setrecursionlimit(old_limit)

    bvh = (
        np.asarray(los, np.float32),
        np.asarray(his, np.float32),
        np.asarray(skips, np.int32),
        np.asarray(firsts, np.int32),
        np.asarray(counts, np.int32),
    )
    return bvh, np.asarray(order, np.int64)


def collapse_bvh8(bvh, width: int = BVH8_WIDTH):
    """Collapse the binary tree into ``width``-ary nodes by repeatedly
    expanding the largest-area internal member of a node's group.

    Child slot encoding: count > 0 -> leaf (child = first triangle of the
    padded layout), count == -1 -> internal (child = wide node id),
    count == 0 -> empty. Returns (w_lo [Nw,8,3], w_hi, w_child [Nw,8] i32,
    w_count [Nw,8] i32, max_stack), where ``max_stack`` bounds a traversal
    stack (pop 1, push <= width per visit, along one root-to-leaf path).
    """
    lo, hi, skip, first, count = bvh
    w_lo: list = []
    w_hi: list = []
    w_child: list = []
    w_count: list = []
    max_depth = 0

    def alloc() -> int:
        w_lo.append(np.zeros((width, 3), np.float32))
        w_hi.append(np.zeros((width, 3), np.float32))
        w_child.append(np.zeros(width, np.int32))
        w_count.append(np.zeros(width, np.int32))
        return len(w_count) - 1

    def kids(i: int) -> tuple[int, int]:
        return i + 1, int(skip[i + 1])  # DFS pre-order children

    def build(i: int, depth: int) -> int:
        nonlocal max_depth
        max_depth = max(max_depth, depth)
        my = alloc()
        if count[i] > 0:
            group = [i]  # the whole (sub)tree is one leaf
        else:
            group = list(kids(i))
            while len(group) < width:
                best_j, best_area = -1, -1.0
                for j, c in enumerate(group):
                    if count[c] > 0:
                        continue
                    a = float(_half_area(lo[c], hi[c]))
                    if a > best_area:
                        best_j, best_area = j, a
                if best_j < 0:
                    break
                c = group.pop(best_j)
                a, b = kids(c)
                group[best_j:best_j] = [a, b]  # keep spatial discovery order
        for s, c in enumerate(group):
            w_lo[my][s] = lo[c]
            w_hi[my][s] = hi[c]
            if count[c] > 0:
                w_child[my][s] = first[c]
                w_count[my][s] = count[c]
            else:
                w_child[my][s] = build(c, depth + 1)
                w_count[my][s] = -1
        return my

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))
    try:
        build(0, 1)
    finally:
        sys.setrecursionlimit(old_limit)
    max_stack = (width - 1) * max_depth + 1
    return np.stack(w_lo), np.stack(w_hi), np.stack(w_child), np.stack(w_count), max_stack


def treetop_cut(bvh, max_cut: int = MAX_CUT) -> np.ndarray:
    """Node ids of about ``max_cut`` disjoint subtrees covering the tree,
    found by expanding the largest-area internal node first (sorted)."""
    if max_cut > 8191:
        raise ValueError(f"max_cut {max_cut} exceeds the sort key's 13-bit field")
    lo, hi, skip, first, count = bvh
    cut = [0]
    while len(cut) < max_cut:
        best_j, best_area = -1, -1.0
        for j, i in enumerate(cut):
            if count[i] > 0:  # leaf
                continue
            area = _half_area(lo[i], hi[i])
            if area > best_area:
                best_j, best_area = j, float(area)
        if best_j < 0:
            break
        i = cut.pop(best_j)
        c1 = i + 1
        cut.extend([c1, int(skip[c1])])
    return np.array(sorted(cut), np.int32)


def check_leaf_groups(w_child: np.ndarray, w_count: np.ndarray, max_leaf: int | None = None) -> None:
    """Raise unless every leaf slot of the wide nodes starts its own
    ``max_leaf``-aligned group and holds 1..max_leaf triangles: K2 encodes
    a leaf by its last row and recovers the group and the count from it."""
    if max_leaf is None:
        max_leaf = MAX_LEAF
    leaf = w_count > 0
    if (w_child[leaf] % max_leaf != 0).any() or (w_count[leaf] > max_leaf).any():
        raise ValueError(f"a BVH8 leaf does not start its own {max_leaf}-row group")


def pack_bvh8_nodes(w_lo, w_hi, w_child, w_count) -> np.ndarray:
    """[Nw, 64] f32 node table (ints exact in f32 below 2^24)."""
    n, width = w_lo.shape[:2]
    if width * 8 != 64:
        raise ValueError(f"node width {width} does not fill a 64-float row")
    if (np.abs(w_child) >= 2**24).any():
        raise ValueError("BVH8 child index exceeds the f32-exact integer range")
    check_leaf_groups(w_child, w_count)
    flat = np.zeros((n, 64), np.float32)
    for s in range(width):
        flat[:, 8 * s : 8 * s + 3] = w_lo[:, s]
        flat[:, 8 * s + 3 : 8 * s + 6] = w_hi[:, s]
        flat[:, 8 * s + 6] = w_child[:, s].astype(np.float32)
        flat[:, 8 * s + 7] = w_count[:, s].astype(np.float32)
    return flat


def _check_binary_tree(bvh) -> None:
    """Raise on a tree the skip-link walk could not finish (a skip link must
    point past its node and at most one past the last node) or whose integer
    fields are not exact in f32 (below 2^24)."""
    lo, hi, skip, first, count = bvh
    n = lo.shape[0]
    ids = np.arange(n)
    if ((skip <= ids) | (skip > n)).any():
        raise ValueError("BVH skip links must point past their node, at most to the end")
    if (np.abs(np.stack([skip, first, count])) >= 2**24).any():
        raise ValueError("BVH node field exceeds the f32-exact integer range")


def pack_binary_nodes(bvh) -> np.ndarray:
    """[Nn, 12] f32 node table of the binary tree for the skip-link walk
    (ints exact in f32 below 2^24). Raises on a table the walk could not
    finish: a skip link must point past its node and at most one past the
    last node."""
    _check_binary_tree(bvh)
    lo, hi, skip, first, count = bvh
    n = lo.shape[0]
    rows = np.zeros((n, 12), np.float32)
    rows[:, 0:3] = lo
    rows[:, 3] = skip
    rows[:, 4:7] = hi
    rows[:, 7] = count
    rows[:, 8] = first
    return rows


def octant_orders(bvh) -> np.ndarray:
    """[8, Nn] i64: for each direction octant o (bit k set: the direction is
    negative along axis k, the coherence key's octant), the pre-order layout
    of the same tree in which every inner node's near child comes first.
    ``orders[o][j]`` is the tree's own id of the node at position j.

    The near child of an inner node is the one whose box centre comes first,
    in the octant's direction, along the axis on which the two children's
    centres lie farthest apart; children level on that axis keep the tree's
    own order. A subtree keeps its size whatever the order inside it, so a
    node's position follows from its parent's.
    """
    _check_binary_tree(bvh)
    lo, hi, skip, first, count = bvh
    n = lo.shape[0]
    size = skip.astype(np.int64) - np.arange(n)
    inner = np.nonzero(count == 0)[0]
    c1 = inner + 1
    c2 = skip[c1].astype(np.int64)
    centre = (lo.astype(np.float64) + hi.astype(np.float64)) * 0.5
    gap = centre[c2] - centre[c1]  # > 0 on an axis: the first child lies lower
    axis = np.abs(gap).argmax(axis=1)
    along = gap[np.arange(inner.size), axis]
    orders = np.empty((8, n), np.int64)
    for o in range(8):
        negative = (o >> axis) & 1
        swap = np.where(negative == 1, along > 0, along < 0)
        pos = np.zeros(n, np.int64)
        # Parents come before their children in the tree's own pre-order.
        for i, a, b, sw in zip(inner.tolist(), c1.tolist(), c2.tolist(), swap.tolist()):
            near, far = (b, a) if sw else (a, b)
            pos[near] = pos[i] + 1
            pos[far] = pos[i] + 1 + size[near]
        orders[o, pos] = np.arange(n)
    return orders


def pack_binary_nodes8(bvh, order: np.ndarray | None = None) -> np.ndarray:
    """[Nn, 8] f32 node table of the binary tree, 32 bytes a node:
    (lo.xyz, link), (hi.xyz, count). ``link`` is the skip link of an inner
    node and ``first`` of a leaf (a leaf's skip link is the next node).
    ``order`` ([Nn], one row of ``octant_orders``) lays the nodes out in
    that pre-order, skip links recomputed; None keeps the tree's own."""
    _check_binary_tree(bvh)
    lo, hi, skip, first, count = bvh
    n = lo.shape[0]
    if order is None:
        order = np.arange(n)
    size = skip.astype(np.int64)[order] - order
    rows = np.zeros((n, 8), np.float32)
    rows[:, 0:3] = lo[order]
    rows[:, 3] = np.where(count[order] > 0, first[order], np.arange(n) + size)
    rows[:, 4:7] = hi[order]
    rows[:, 7] = count[order]
    return rows


def pack_octant_nodes(bvh) -> np.ndarray:
    """[8, Nn, 8] f32: ``pack_binary_nodes8`` in each octant's order."""
    return np.stack([pack_binary_nodes8(bvh, order) for order in octant_orders(bvh)])


def pack_leaf_tris(tri_pts_ordered: np.ndarray) -> np.ndarray:
    """[F', 12] f32 barycentric-gradient rows of the leaf-ordered triangles
    ([F',3,3] f64, padding slots all-zero: their rows are zero, so the
    kernel's |denom| cutoff rejects them)."""
    a = tri_pts_ordered[:, 0].astype(np.float64)
    b = tri_pts_ordered[:, 1].astype(np.float64)
    c = tri_pts_ordered[:, 2].astype(np.float64)
    e1, e2 = b - a, c - a
    ng = np.cross(e1, e2)
    nn = np.maximum((ng * ng).sum(1), 1e-30)
    n_unit = ng / np.sqrt(nn)[:, None]
    q1 = np.cross(e2, ng) / nn[:, None]
    q2 = np.cross(ng, e1) / nn[:, None]
    return np.concatenate(
        [
            n_unit, (a * n_unit).sum(1)[:, None],
            q1, (a * q1).sum(1)[:, None],
            q2, (a * q2).sum(1)[:, None],
        ],
        axis=1,
    ).astype(np.float32)
