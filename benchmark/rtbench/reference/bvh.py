"""The benchmark's own bounding-volume hierarchy and a plain walk that
counts its work: the yardstick of a BVH traversal kernel's roofline.

The tree is binary, built by an object median along the longest axis of
the centroids' box, with leaves of at most ``LEAF`` triangles; boxes are
the corners' float64 bounds widened by ``PAD`` of the scene's extent, so
that no hit is lost to rounding. The walk is nearest-hit (or any-hit below
a cap, for a shadow ray), pops the nearer child first, and counts the
boxes it tests, the triangles it tests, and the candidates among them
(triangles whose plane distance could still win, the only ones whose
barycentric coordinates the search needs).
"""

from __future__ import annotations

import numpy as np
import torch

LEAF = 4
PAD = 1e-6


class Tree:
    def __init__(self, tris: np.ndarray):
        """``tris`` f64 [F, 3, 3]."""
        lo_t, hi_t = tris.min(axis=1), tris.max(axis=1)
        cen = (lo_t + hi_t) / 2.0
        pad = PAD * float(np.max(hi_t.max(0) - lo_t.min(0)))
        lo, hi, left, right, first, count = [], [], [], [], [], []
        order = []
        stack = [(np.arange(len(tris)), -1, 0)]
        while stack:
            ids, parent, side = stack.pop()
            k = len(lo)
            lo.append(lo_t[ids].min(0) - pad), hi.append(hi_t[ids].max(0) + pad)
            left.append(-1), right.append(-1), first.append(0), count.append(0)
            if parent >= 0:
                (left if side == 0 else right)[parent] = k
            if len(ids) <= LEAF:
                first[k], count[k] = len(order), len(ids)
                order.extend(ids.tolist())
                continue
            c = cen[ids]
            axis = int(np.argmax(c.max(0) - c.min(0)))
            srt = ids[np.argsort(c[:, axis], kind="stable")]
            half = len(srt) // 2
            stack.append((srt[half:], k, 1))
            stack.append((srt[:half], k, 0))
        self.lo, self.hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
        self.left, self.right = np.asarray(left), np.asarray(right)
        self.first, self.count = np.asarray(first), np.asarray(count)
        self.order = np.asarray(order)
        self.depth = self._depth()

    def _depth(self) -> int:
        d, stack = 0, [(0, 1)]
        while stack:
            k, h = stack.pop()
            d = max(d, h)
            if self.count[k] == 0:
                stack += [(int(self.left[k]), h + 1), (int(self.right[k]), h + 1)]
        return d

    def table_bytes(self) -> int:
        """Bytes of the tree as a kernel would read it: a box (24 bytes) and
        two links a node, and 48 bytes of intersection rows a triangle."""
        return len(self.lo) * 32 + len(self.order) * 48


def walk_counts(tree: Tree, tri_rows: torch.Tensor, ro: torch.Tensor, rd: torch.Tensor,
                cap: torch.Tensor | None, tmin: float, parallel: float) -> dict:
    """Walk rays ``ro``/``rd`` [N, 3] (f32) through ``tree``; ``cap`` makes
    each an any-hit query below it. ``tri_rows`` [F, 12] are the
    triangles' intersection rows in the input order. -> counts."""
    dev = ro.device
    n = ro.shape[0]
    lo = torch.as_tensor(tree.lo, device=dev)
    hi = torch.as_tensor(tree.hi, device=dev)
    left = torch.as_tensor(tree.left, device=dev)
    right = torch.as_tensor(tree.right, device=dev)
    first = torch.as_tensor(tree.first, device=dev)
    count = torch.as_tensor(tree.count, device=dev)
    rows = tri_rows[torch.as_tensor(tree.order, device=dev)]
    inv = 1.0 / torch.where(rd.abs() < 1e-12, torch.full_like(rd, 1e-12), rd)
    best = cap.clone() if cap is not None else torch.full((n,), float("inf"), device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    stack = torch.zeros((n, tree.depth + 2), dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    counts = {"rays": n, "boxes": 0, "tris": 0, "cand": 0}
    while True:
        ids = ((sp > 0) & ~done).nonzero().squeeze(1)
        if ids.numel() == 0:
            break
        sp[ids] -= 1
        node = stack[ids, sp[ids]]
        o, iv = ro[ids], inv[ids]
        t0 = (lo[node] - o) * iv
        t1 = (hi[node] - o) * iv
        tn = torch.minimum(t0, t1).amax(1)
        tf = torch.maximum(t0, t1).amin(1)
        hit = (tn <= tf) & (tf > tmin) & (tn < best[ids])
        counts["boxes"] += int(ids.numel())
        cnt = count[node]
        leaf = hit & (cnt > 0)
        inner = hit & (cnt == 0)
        li = ids[leaf]
        if li.numel():
            fst, c = first[node[leaf]], cnt[leaf]
            slot = fst[:, None] + torch.arange(4, device=dev)[None]
            real = torch.arange(4, device=dev)[None] < c[:, None]
            f = rows[slot.clamp_max(rows.shape[0] - 1)]
            o3, d3 = ro[li][:, None], rd[li][:, None]
            denom = (f[..., 0:3] * d3).sum(-1)
            t = (f[..., 3] - (f[..., 0:3] * o3).sum(-1)) / denom
            tb = best[li]
            cand = real & (denom.abs() >= parallel) & (t > tmin) & (t < tb[:, None])
            u = (f[..., 4:7] * o3).sum(-1) + t * (f[..., 4:7] * d3).sum(-1) - f[..., 7]
            v = (f[..., 8:11] * o3).sum(-1) + t * (f[..., 8:11] * d3).sum(-1) - f[..., 11]
            ok = cand & (u >= 0) & (v >= 0) & (u + v <= 1)
            counts["tris"] += int(c.sum())
            counts["cand"] += int(cand.sum())
            tmin_l = torch.where(ok, t, float("inf")).amin(1)
            best[li] = torch.minimum(tb, tmin_l)
            if cap is not None:
                done[li] = done[li] | ok.any(1)
        ni = ids[inner]
        if ni.numel():
            nd = node[inner]
            a, b = left[nd], right[nd]
            # The nearer child (by the centre of its box along the ray) pops first.
            ca = ((lo[a] + hi[a]) * 0.5 * rd[ni]).sum(1)
            cb = ((lo[b] + hi[b]) * 0.5 * rd[ni]).sum(1)
            near = torch.where(ca <= cb, a, b)
            far = torch.where(ca <= cb, b, a)
            stack[ni, sp[ni]] = far
            stack[ni, sp[ni] + 1] = near
            sp[ni] += 2
    return counts
