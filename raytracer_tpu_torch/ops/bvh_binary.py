"""Nearest (or any) triangle hit by a skip-link walk of the binary BVH (K4).

Port of ``raytracer_tpu/ops/pallas/bvh_kernel.py::_traverse_kernel`` (K4),
the kernel that ``bvh_intersect_pallas`` runs when ``RT_BVH_KERNEL`` names
no wide variant. Same contract as K2 (``ops/bvh_traverse.py``); three
parts, as for K1-K3:

- the plain PyTorch twin ``bvh_binary_twin``: every ray holds its own node
  pointer and all rays step in lockstep (one node each per step), with the
  kernel's expressions and tie rules; ``ordered=False`` walks the tree's
  own pre-order (the first port's walk) instead of the ray's octant layout;
- the CUDA kernel (``ops/csrc/bvh_binary.cu``), one thread per ray walking
  its octant's layout of the tree by itself, built at first use and counted
  in ``LAUNCHES``;
- the dispatch, in ``ops/bvh_traverse.py::bvh_traverse``: K4 runs when
  ``RT_BVH_KERNEL`` names no wide variant, the twin for CPU rays and the
  kernel for CUDA rays, with no fallback either way; the coherence sort
  around the walk is ``bvh_intersect``'s, as for K2.

The walk reads the scene's ``bvh_octant_nodes`` [8,Nn,8] (``ops/bvh.py::
pack_octant_nodes``: per direction octant a pre-order layout of the tree
with every inner node's near child first; 32 bytes a node, (lo.xyz, link),
(hi.xyz, count), ``link`` an inner node's skip link or a leaf's first row)
and the leaf-triangle table ``bvh_leaf_tris`` [F',12] that K2 reads; a
leaf's rows run from ``first`` to ``first + count - 1``. Every order finds
the same nearest t (the minimum over the same triangles); the index may
differ from the fixed-order walk's where two triangles tie in t.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from raytracer_tpu_torch.config import Epsilons
from raytracer_tpu_torch.models.scene import SceneArrays
from raytracer_tpu_torch.models.vecmath import as3
from raytracer_tpu_torch.ops.bvh import MAX_LEAF

INF = 3.0e38

# Floats of a node row of ``bvh_octant_nodes`` (NODE_F4 float4s in
# ops/csrc/bvh_binary.cu).
NODE_FLOATS = 8

# Kernel launches since import (or since a caller reset it).
LAUNCHES = 0
_launch_lock = threading.Lock()


def bvh_binary_twin(
    scene: SceneArrays, ro, rd, t_init: torch.Tensor, resolved0: torch.Tensor,
    any_hit: bool, eps: Epsilons, visits: dict | None = None, ordered: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch walk on the rays' device -> (t f32[N], idx i32[N]).

    ``ordered`` (the kernel's walk): each ray walks the layout of its
    direction octant, near child first; else every ray walks the tree's own
    pre-order (``bvh_binary_nodes8``).

    ``idx`` is the global triangle index (``bvh_tri_start`` + leaf row), 0
    where no triangle was found; not clipped. ``visits``, when given, is a
    dict into which the walk adds ``nodes`` (nodes whose box was tested),
    ``leaves`` (leaves entered), ``tris`` (their real triangles) and
    ``cand`` (real triangles whose t could still win on entry).
    """
    ro, rd = as3(ro), as3(rd)
    dev = ro[0].device
    n = ro[0].shape[0]
    tris = scene.bvh_leaf_tris.to(dev)
    n_nodes = scene.bvh_binary_nodes8.shape[0]
    if ordered:
        nodes = scene.bvh_octant_nodes.to(dev).reshape(8 * n_nodes, 8)
        octant = (rd[0] < 0).long() + 2 * (rd[1] < 0).long() + 4 * (rd[2] < 0).long()
        table = octant * n_nodes  # first row of each ray's layout
    else:
        nodes = scene.bvh_binary_nodes8.to(dev)
        table = torch.zeros(n, dtype=torch.int64, device=dev)
    tiny = torch.tensor(1e-12, dtype=torch.float32, device=dev)
    inv = [1.0 / torch.where(torch.abs(d) < 1e-12, tiny, d) for d in rd]
    t_init = t_init.to(torch.float32)
    t_best = t_init.clone()
    i_best = torch.zeros(n, dtype=torch.int32, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    if any_hit:
        node = torch.where(resolved0.to(torch.bool), n_nodes, node)  # resolved: no walk
    slots = torch.arange(MAX_LEAF, device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    if visits is not None:
        for k in ("nodes", "leaves", "tris", "cand"):
            visits.setdefault(k, 0)
    while True:
        act = node < n_nodes
        if any_hit:
            act = act & ~(t_best < t_init)
        ids = act.nonzero().squeeze(1)
        if ids.numel() == 0:
            break
        x = node[ids]
        nd = nodes[table[ids] + x]  # [K, 8]: lo.xyz link | hi.xyz count
        o = [c[ids] for c in ro]
        tnear = torch.full((ids.numel(),), -INF, dtype=torch.float32, device=dev)
        tfar = torch.full((ids.numel(),), INF, dtype=torch.float32, device=dev)
        for k in range(3):
            iv = inv[k][ids]
            t0 = (nd[:, k] - o[k]) * iv
            t1 = (nd[:, 4 + k] - o[k]) * iv
            tnear = torch.maximum(tnear, torch.minimum(t0, t1))
            tfar = torch.minimum(tfar, torch.maximum(t0, t1))
        tb = t_best[ids]
        hit = (tnear <= tfar) & (tfar > eps.tri_tmin) & (tnear < tb)
        count = nd[:, 7].to(torch.int64)
        leaf = hit & (count > 0)
        if visits is not None:
            visits["nodes"] += int(ids.numel())
            visits["leaves"] += int(leaf.sum())
            visits["tris"] += int(count[leaf].sum())
        if leaf.any():
            li = ids[leaf]
            first = nd[leaf, 3].to(torch.int64)
            cnt = count[leaf]
            rows = (first[:, None] + slots[None, :]).clamp_max(tris.shape[0] - 1)
            f = tris[rows]  # [L, MAX_LEAF, 12]
            ol = [c[li][:, None] for c in ro]
            dl = [c[li][:, None] for c in rd]

            def dot(k, v):
                return f[..., k] * v[0] + f[..., k + 1] * v[1] + f[..., k + 2] * v[2]

            denom = dot(0, dl)
            safe_denom = torch.where(torch.abs(denom) < 1e-30, 1e-30, denom)
            t = (f[..., 3] - dot(0, ol)) / safe_denom
            u = dot(4, ol) + t * dot(4, dl) - f[..., 7]
            v = dot(8, ol) + t * dot(8, dl) - f[..., 11]
            tbl = tb[leaf]
            if visits is not None:
                visits["cand"] += int(
                    ((torch.abs(denom) >= eps.tri_parallel) & (t > eps.tri_tmin)
                     & (slots[None, :] < cnt[:, None]) & (t < tbl[:, None])).sum()
                )
            ok = (
                (torch.abs(denom) >= eps.tri_parallel)
                & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
                & (t > eps.tri_tmin)
                & (slots[None, :] < cnt[:, None])
                & (t < tbl[:, None])
            )
            # The kernel scans a leaf's rows in order with a strict <: the
            # first row of the smallest t wins, as torch.min's index does.
            tmin, jmin = torch.where(ok, t, inf).min(dim=1)
            upd = tmin < tbl
            t_best[li] = torch.where(upd, tmin, tbl)
            new_i = (scene.bvh_tri_start + first + jmin).to(torch.int32)
            i_best[li] = torch.where(upd, new_i, i_best[li])
        # On to the next node after a hit and past a leaf; a missed inner
        # node's link skips its subtree.
        node[ids] = torch.where(hit | (count > 0), x + 1, nd[:, 3].to(torch.int64))
    return t_best, i_best


@functools.lru_cache(maxsize=1)
def _launch_fn():
    from raytracer_tpu_torch.ops import _build

    fn = _build.load_library("bvh_binary").rt_bvh_binary_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 8  # ro.xyz, rd.xyz, t_init, resolved0
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]  # nodes, tris
        + [ctypes.c_int] * 3  # n, base, any_hit
        + [ctypes.c_float, ctypes.c_float]  # tri_tmin, tri_parallel
        + [ctypes.c_void_p] * 3  # t_out, idx_out, stream
    )
    fn.restype = ctypes.c_int
    return fn


def bvh_binary_cuda(
    scene: SceneArrays, ro, rd, t_init: torch.Tensor, resolved0: torch.Tensor,
    any_hit: bool, eps: Epsilons,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the rays' device and current stream; same
    outputs as ``bvh_binary_twin``. Raises on any fault."""
    global LAUNCHES
    ro, rd = as3(ro), as3(rd)
    dev = ro[0].device
    if dev.type != "cuda":
        raise ValueError(f"bvh_binary_cuda launches on a CUDA device, not {dev}")
    cols = [c.to(torch.float32).contiguous() for c in (*ro, *rd, t_init)]
    res = resolved0.to(torch.uint8).contiguous()
    n = cols[0].numel()
    nodes, tris = scene.bvh_octant_nodes, scene.bvh_leaf_tris
    if any(c.device != dev or c.numel() != n for c in cols + [res]):
        raise ValueError(f"ray columns must be [N] tensors on {dev}")
    for name, a in (("octant node table", nodes), ("leaf table", tris)):
        if a.device != dev or a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError(f"the scene's {name} must be contiguous f32 on {dev}")
        if a.data_ptr() % 16:
            raise ValueError(f"the scene's {name} is not 16-byte aligned")
    if nodes.dim() != 3 or nodes.shape[0] != 8 or nodes.shape[2] != NODE_FLOATS:
        raise ValueError(f"the scene's octant node table must be [8, nodes, {NODE_FLOATS}], not {tuple(nodes.shape)}")
    # The kernel loads a leaf's rows four at a time: whole groups of
    # MAX_LEAF rows keep the last load inside the table.
    if tris.dim() != 2 or tris.shape[1] != 12 or tris.shape[0] % MAX_LEAF:
        raise ValueError(f"the scene's leaf table must be [groups * {MAX_LEAF}, 12], not {tuple(tris.shape)}")
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    idx_out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return t_out, idx_out
    launch = _launch_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            *(c.data_ptr() for c in cols), res.data_ptr(),
            nodes.data_ptr(), nodes.shape[1], tris.data_ptr(), tris.shape[0],
            n, scene.bvh_tri_start, int(any_hit), eps.tri_tmin, eps.tri_parallel,
            t_out.data_ptr(), idx_out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"bvh_binary launch failed with CUDA error {rc}")
    with _launch_lock:
        LAUNCHES += 1
    return t_out, idx_out

