"""Nearest (or any) triangle hit over the 8-wide BVH (K2), and the BVH
traversal's variant dispatch and wrapper.

Port of ``raytracer_tpu/ops/pallas/bvh_kernel.py::_traverse8_kernel`` (K2)
and of its wrapper ``bvh_intersect_pallas`` :551-776. Four parts:

- the plain PyTorch twin ``bvh_traverse_twin``: every ray walks its own
  stack, all rays step in lockstep (one pop each per step), with the same
  expressions, child order and tie rules as the kernel;
- the CUDA kernel (``ops/csrc/bvh8.cu``), one thread per ray, built at
  first use and counted in ``LAUNCHES``;
- ``bvh_traverse``, the dispatch: ``RT_BVH_KERNEL`` (read at each call,
  as ``bvh_kernel.py:589`` reads it) selects K2 for the wide variants
  ``wide``, ``widemxu`` and ``widesmem`` (the default; the three are TPU
  layouts of one function) and K4 (``ops/bvh_binary.py``) for any other
  value. CPU rays run the twin, CUDA rays the kernel, with no fallback;
- ``bvh_intersect``, the wrapper with the JAX contract: unless
  ``presorted``, it sorts the rays by the coherence key (K3), traverses,
  and unsorts; a ray that finds no triangle below its ``t_init`` keeps
  ``t_init``; the index is clipped to [0, T-1].

The JAX wrapper's measurement hooks, each read at each call with JAX's
name and meaning (``utils/env.py``; a value outside a hook's set raises):

- ``RT_LEAF_TRIS=k`` (``bvh_kernel.py:300-303``): K2 and its twin test only
  the first k triangles of each leaf (k = 0 times the walk without its
  leaf tests; a timing probe, its t are bounds, not hits). K4 has no such
  argument, so under ``RT_BVH_KERNEL=binary`` it raises;
- ``RT_SORT_GROUP=G`` (``bvh_kernel.py:722-729``): the wrapper's sort
  orders groups of G consecutive rays by their least key and moves them
  whole (``keys.group_order``), where G divides the ray count;
- ``RT_SHADOW_COMPACT`` = ``1`` / ``force`` (``bvh_kernel.py:639-685``), for
  any-hit queries only: resolved rays join the key's miss bit, so they sort
  to the tail, and the walk launches on the first half (rounded up to
  JAX's 1024-ray packets) when the live rays fit there (``force``: always,
  a timing probe). The tail keeps its ``t_init`` and index 0, as the walk
  would return them. The live count is read on the host, under this hook
  only. The regen engine's shadow rays are not any-hit queries (JAX keeps
  ``any_hit`` off, ``render/wavefront.py:510-514``), so a frame is not
  changed by it.

Not ported: ``RT_BVH_VSORT`` (torch has no multi-operand sort; the default
chain is already one stable key sort and one row gather).
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading

import torch

from raytracer_tpu_torch.config import Epsilons
from raytracer_tpu_torch.models.scene import SceneArrays
from raytracer_tpu_torch.models.vecmath import as3
from raytracer_tpu_torch.ops import bvh
from raytracer_tpu_torch.ops.bvh_binary import bvh_binary_cuda, bvh_binary_twin
from raytracer_tpu_torch.ops.keys import coherence_key, coherence_order, group_order, sort_group
from raytracer_tpu_torch.utils import env

INF = 3.0e38

# RT_BVH_KERNEL values that run K2; any other value runs K4.
WIDE_VARIANTS = ("wide", "widemxu", "widesmem")

# JAX's ray packet (8 x 128): RT_SHADOW_COMPACT's half width is rounded up
# to whole packets, as bvh_kernel.py:655-656 rounds it.
PACKET = 1024

# Largest stack bound the kernel takes (BVH8_MAX_STACK in ops/csrc/bvh8.cu);
# a launch traps a walk deeper than the scene's bvh8_max_stack.
BVH8_MAX_STACK = 64

# Kernel against twin on the card (K2 and K4): t bit-equal on at least this
# share of rays, and where the indices differ, the two triangles' t equal (a
# tie that the two walks broke in another order). Both evaluate the same f32
# expressions without FMA contraction, so they agree bit for bit unless a
# compiler reorders a comparison.
T_EXACT_SHARE = 0.9999

# Kernel launches since import (or since a caller reset it).
LAUNCHES = 0
_launch_lock = threading.Lock()


def _check_stack(scene: SceneArrays) -> None:
    if scene.bvh8_max_stack > BVH8_MAX_STACK:
        raise ValueError(
            f"scene {scene.name!r} needs a traversal stack of {scene.bvh8_max_stack}; "
            f"the kernel is built with {BVH8_MAX_STACK}"
        )


def _leaf_rows(leaf_tris: int | None) -> int:
    """The rows a leaf tests: ``leaf_tris`` (``RT_LEAF_TRIS``), at most the
    leaf size, which None stands for."""
    if leaf_tris is not None and leaf_tris < 0:
        raise ValueError(f"leaf_tris {leaf_tris} < 0")
    return bvh.MAX_LEAF if leaf_tris is None else min(leaf_tris, bvh.MAX_LEAF)


def _inv_dir(d: torch.Tensor) -> torch.Tensor:
    tiny = torch.tensor(1e-12, dtype=torch.float32, device=d.device)
    return 1.0 / torch.where(torch.abs(d) < 1e-12, tiny, d)


def bvh_traverse_twin(
    scene: SceneArrays, ro, rd, t_init: torch.Tensor, resolved0: torch.Tensor,
    any_hit: bool, eps: Epsilons, visits: dict | None = None, leaf_tris: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch traversal on the rays' device -> (t f32[N], idx i32[N]).

    ``idx`` is the global triangle index (``bvh_tri_start`` + leaf slot), 0
    where no triangle was found; not clipped. ``visits``, when given, is a
    dict into which the walk adds its counts: ``nodes`` (wide nodes
    visited), ``leaves`` (leaves visited), ``tris`` (the real triangles of
    the visited leaves that were tested, padding not counted) and ``cand``
    (triangles whose t could still win when their leaf was entered: the
    only ones whose u and v the search needs). ``leaf_tris`` (``RT_LEAF_TRIS``;
    None: all) tests only the first ``leaf_tris`` triangles of each leaf.
    """
    _check_stack(scene)
    ro, rd = as3(ro), as3(rd)
    dev = ro[0].device
    n = ro[0].shape[0]
    ml = bvh.MAX_LEAF
    k_test = _leaf_rows(leaf_tris)
    nodes = scene.bvh8_nodes_flat.to(dev).view(-1, 8, 8)
    tris = scene.bvh_leaf_tris.to(dev).view(-1, ml, 12)
    inv = [_inv_dir(d) for d in rd]
    t_best = t_init.to(torch.float32).clone()
    i_best = torch.zeros(n, dtype=torch.int32, device=dev)
    res0 = resolved0.to(torch.bool)
    stack = torch.zeros((n, scene.bvh8_max_stack + 8), dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)  # stack[:, 0] = root
    slots = torch.arange(8, device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    if visits is not None:
        for k in ("nodes", "leaves", "tris", "cand"):
            visits.setdefault(k, 0)
        group_count = _leaf_group_counts(scene, dev)
    while True:
        act = sp > 0
        if any_hit:
            act = act & ~(res0 | (t_best < t_init))
        ids = act.nonzero().squeeze(1)
        if ids.numel() == 0:
            break
        sp[ids] -= 1
        x = stack[ids, sp[ids]]
        is_leaf = x < 0

        li = ids[is_leaf]
        if visits is not None:
            visits["nodes"] += int(ids.numel() - li.numel())
            visits["leaves"] += int(li.numel())
            visits["tris"] += int(group_count[-x[is_leaf] - 1].clamp(max=k_test).sum())
        if li.numel() and k_test:
            g = -x[is_leaf] - 1
            f = tris[g, :k_test]  # [L, k_test, 12]
            o = [c[li][:, None] for c in ro]
            d = [c[li][:, None] for c in rd]

            def dot(k, v):
                return f[..., k] * v[0] + f[..., k + 1] * v[1] + f[..., k + 2] * v[2]

            denom = dot(0, d)
            t = (f[..., 3] - dot(0, o)) / denom
            u = dot(4, o) + t * dot(4, d) - f[..., 7]
            v = dot(8, o) + t * dot(8, d) - f[..., 11]
            tb = t_best[li]
            if visits is not None:
                visits["cand"] += int(
                    ((torch.abs(denom) >= eps.tri_parallel) & (t > eps.tri_tmin) & (t < tb[:, None])).sum()
                )
            ok = (
                (torch.abs(denom) >= eps.tri_parallel)
                & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                & (t > eps.tri_tmin) & (t < tb[:, None])
            )
            # Leaf slots in order with a strict <: the first slot of the
            # smallest t wins, as torch.min's index does.
            tmin, jmin = torch.where(ok, t, inf).min(dim=1)
            upd = tmin < tb
            t_best[li] = torch.where(upd, tmin, tb)
            new_i = (scene.bvh_tri_start + g * ml + jmin).to(torch.int32)
            i_best[li] = torch.where(upd, new_i, i_best[li])

        ni = ids[~is_leaf]
        if ni.numel():
            nd = nodes[x[~is_leaf]]  # [K, 8 slots, 8 fields]
            tnear = tfar = None
            for k in range(3):
                t0 = (nd[..., k] - ro[k][ni][:, None]) * inv[k][ni][:, None]
                t1 = (nd[..., 3 + k] - ro[k][ni][:, None]) * inv[k][ni][:, None]
                lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
                tnear = lo if tnear is None else torch.maximum(tnear, lo)
                tfar = hi if tfar is None else torch.minimum(tfar, hi)
            child = nd[..., 6].to(torch.int64)
            cnt = nd[..., 7].to(torch.int64)
            hit = (
                (cnt != 0) & (tnear <= tfar) & (tfar > eps.tri_tmin)
                & (tnear < t_best[ni][:, None])
            )
            pv = torch.where(cnt > 0, -torch.div(child, ml, rounding_mode="floor") - 1, child)
            # Push the hit children farthest first (descending entry
            # distance, ties in slot order), so the nearest pops first.
            order = torch.sort(torch.where(hit, -tnear, inf), dim=1, stable=True).indices
            pv = torch.gather(pv, 1, order)
            nh = hit.sum(dim=1)
            put = slots[None, :] < nh[:, None]
            rows = ni[:, None].expand(-1, 8)[put]
            cols = (sp[ni][:, None] + slots[None, :])[put]
            stack[rows, cols] = pv[put]
            sp[ni] += nh
    return t_best, i_best


def _leaf_group_counts(scene: SceneArrays, dev) -> torch.Tensor:
    """Real triangles of each leaf group (0 for a group no leaf starts)."""
    nd = scene.bvh8_nodes_flat.to(dev).view(-1, 8, 8)
    leaf = nd[..., 7] > 0
    n_groups = scene.bvh_leaf_tris.shape[0] // bvh.MAX_LEAF
    counts = torch.zeros(n_groups + 1, dtype=torch.int64, device=dev)
    counts[nd[..., 6][leaf].long() // bvh.MAX_LEAF] = nd[..., 7][leaf].long()
    return counts


@functools.lru_cache(maxsize=1)
def _lib():
    from raytracer_tpu_torch.ops import _build

    lib = _build.load_library("bvh8")
    lib.rt_bvh8_max_stack.restype = ctypes.c_int
    if lib.rt_bvh8_max_stack() != BVH8_MAX_STACK:
        raise RuntimeError("ops/csrc/bvh8.cu and ops/bvh_traverse.py disagree on the stack bound")
    fn = lib.rt_bvh8_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 8  # ro.xyz, rd.xyz, t_init, resolved0
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]  # nodes, tris
        + [ctypes.c_int] * 6  # n, base, max_leaf, any_hit, stack_depth, leaf_tris
        + [ctypes.c_float, ctypes.c_float]  # tri_tmin, tri_parallel
        + [ctypes.c_void_p] * 3  # t_out, idx_out, stream
    )
    fn.restype = ctypes.c_int
    return lib


def bvh_traverse_cuda(
    scene: SceneArrays, ro, rd, t_init: torch.Tensor, resolved0: torch.Tensor,
    any_hit: bool, eps: Epsilons, leaf_tris: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the rays' device and current stream; same
    outputs as ``bvh_traverse_twin`` (``leaf_tris`` as there). Raises on any
    fault."""
    global LAUNCHES
    _check_stack(scene)
    rows = _leaf_rows(leaf_tris)
    ro, rd = as3(ro), as3(rd)
    dev = ro[0].device
    if dev.type != "cuda":
        raise ValueError(f"bvh_traverse_cuda launches on a CUDA device, not {dev}")
    cols = [c.to(torch.float32).contiguous() for c in (*ro, *rd, t_init)]
    res = resolved0.to(torch.uint8).contiguous()
    n = cols[0].numel()
    nodes, tris = scene.bvh8_nodes_flat, scene.bvh_leaf_tris
    if any(c.device != dev or c.numel() != n for c in cols + [res]):
        raise ValueError(f"ray columns must be [N] tensors on {dev}")
    for name, a in (("node table", nodes), ("leaf table", tris)):
        if a.device != dev or a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError(f"the scene's {name} must be contiguous f32 on {dev}")
        if a.data_ptr() % 16:
            raise ValueError(f"the scene's {name} is not 16-byte aligned")
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    idx_out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return t_out, idx_out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().rt_bvh8_launch(
            *(c.data_ptr() for c in cols), res.data_ptr(),
            nodes.data_ptr(), nodes.shape[0], tris.data_ptr(), tris.shape[0],
            n, scene.bvh_tri_start, bvh.MAX_LEAF, int(any_hit),
            scene.bvh8_max_stack, rows, eps.tri_tmin, eps.tri_parallel,
            t_out.data_ptr(), idx_out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"bvh8 launch failed with CUDA error {rc}")
    with _launch_lock:
        LAUNCHES += 1
    return t_out, idx_out


def bvh_traverse(scene, ro, rd, t_init, resolved0, any_hit, eps):
    """K2 or K4 as ``RT_BVH_KERNEL`` selects (default ``widesmem``: K2):
    the twin for CPU rays, the kernel for CUDA rays. K2 takes
    ``RT_LEAF_TRIS``."""
    dev = as3(ro)[0].device
    binary = os.environ.get("RT_BVH_KERNEL", "widesmem") not in WIDE_VARIANTS
    leaf_tris = env.count("RT_LEAF_TRIS", 0)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if binary and leaf_tris is not None:
        raise ValueError("RT_LEAF_TRIS is a probe of K2's leaves; RT_BVH_KERNEL selects K4, which has none")
    if binary:
        fn = bvh_binary_twin if dev.type == "cpu" else bvh_binary_cuda
    else:
        fn = bvh_traverse_twin if dev.type == "cpu" else bvh_traverse_cuda
    kw = {} if leaf_tris is None else {"leaf_tris": leaf_tris}
    return fn(scene, ro, rd, t_init, resolved0, any_hit, eps, **kw)


def leaf_t(scene: SceneArrays, ro, rd, idx: torch.Tensor) -> torch.Tensor:
    """t of each ray against its triangle ``idx`` (a global index of the
    BVH's range) by the leaf expression, without the hit conditions."""
    ro, rd = as3(ro), as3(rd)
    f = scene.bvh_leaf_tris.to(ro[0].device)[(idx.long() - scene.bvh_tri_start).clamp_min(0)]
    denom = f[:, 0] * rd[0] + f[:, 1] * rd[1] + f[:, 2] * rd[2]
    return (f[:, 3] - (f[:, 0] * ro[0] + f[:, 1] * ro[1] + f[:, 2] * ro[2])) / denom


def bvh_intersect(
    scene: SceneArrays, ro, rd, eps: Epsilons,
    t_init: torch.Tensor | None = None, any_hit: bool = False,
    resolved0: torch.Tensor | None = None, presorted: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest BVH hit -> (t[N], global triangle index[N]).

    ``ro``/``rd`` are [N,3] tensors or component tuples. ``t_init`` bounds
    the search (hits at or beyond it may be dropped; default INF);
    ``any_hit`` lets a ray stop at its first hit below ``t_init`` or at once
    when ``resolved0``. ``presorted`` callers (the regen engine under
    ``RT_PERMUTE_STATE=1``, which permutes its lane state by the same key)
    skip the sort and the unsort.
    """
    ro3, rd3 = as3(ro), as3(rd)
    dev = ro3[0].device
    n = ro3[0].shape[0]
    if t_init is None:
        t_init = torch.full((n,), INF, dtype=torch.float32, device=dev)
    if resolved0 is None:
        resolved0 = torch.zeros(n, dtype=torch.bool, device=dev)
    fields = [*ro3, *rd3, t_init.to(torch.float32), resolved0.to(torch.bool)]

    def walk(fs):
        return bvh_traverse(scene, fs[0:3], fs[3:6], fs[6], fs[7], any_hit, eps)

    compact = env.choice("RT_SHADOW_COMPACT", "0", ("0", "1", "force")) if any_hit and n > PACKET else "0"
    g = 1 if presorted or compact != "0" else sort_group(n)
    if presorted:
        t, idx = walk(fields)
    elif compact != "0":
        t, idx = _compacted(scene, fields, walk, eps, compact == "force")
    elif g > 1:
        # Groups of g rays move whole, and move back whole.
        order_g = group_order(scene, ro3, rd3, eps, g)
        t, idx = walk([f.view(-1, g)[order_g].view(-1) for f in fields])
        t = torch.empty_like(t).view(-1, g).index_put_((order_g,), t.view(-1, g)).view(-1)
        idx = torch.empty_like(idx).view(-1, g).index_put_((order_g,), idx.view(-1, g)).view(-1)
    else:
        order = coherence_order(scene, ro3, rd3, eps)
        t, idx = walk([f[order] for f in fields])
        t = torch.empty_like(t).index_put_((order,), t)
        idx = torch.empty_like(idx).index_put_((order,), idx)
    return t, idx.clamp(0, scene.tri_a.shape[0] - 1)


def _compacted(scene, fields, walk, eps, force: bool):
    """``RT_SHADOW_COMPACT``: the rays sorted with the resolved ones in the
    key's miss group, the walk on the sorted head of half width when the
    live rays fit there (``force``: always), the tail at its ``t_init`` and
    index 0; unsorted -> (t, idx)."""
    n = fields[0].shape[0]
    key = coherence_key(scene, fields[0:3], fields[3:6], eps) | (fields[7].to(torch.int32) << 30)
    order = torch.argsort(key, stable=True)
    n_half = (-(-n // PACKET) + 1) // 2 * PACKET
    # A host read of the live count, made under this hook only.
    if force or int(((key >> 30) == 0).sum()) <= n_half:
        head, tail = order[:n_half], order[n_half:]
        t_h, i_h = walk([f[head] for f in fields])
        t = torch.cat([t_h, fields[6][tail]])
        idx = torch.cat([i_h, torch.zeros(tail.numel(), dtype=i_h.dtype, device=i_h.device)])
    else:
        t, idx = walk([f[order] for f in fields])
    return torch.empty_like(t).index_put_((order,), t), torch.empty_like(idx).index_put_((order,), idx)
