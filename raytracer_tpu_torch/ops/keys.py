"""The traversal-coherence sort key (K3) and the permutation built on it.

Port of ``raytracer_tpu/ops/pallas/key_kernel.py::_key_kernel`` (K3), which
is bit-identical to ``raytracer_tpu/ops/bvh.py::_coherence_key`` :559. Per
ray, an i32 ``miss<<30 | entry<<17 | octant<<13 | morton12``:

- ``entry``: the treetop-cut subtree whose box the ray enters first
  (nearest slab entry, ties to the lower cut index), ``miss`` when it
  enters none (``_cut_entry`` :518);
- ``octant``: the signs of the direction;
- ``morton12``: 4 bits per axis of the origin in the root box
  (``_morton12`` :501), quantised by a true division.

Three parts, as for K1: the plain PyTorch twin (``coherence_key_twin``),
the CUDA kernel (``ops/csrc/coherence_key.cu``: the cut loop unrolled over
the loader's 32 boxes with the table as constant operands, the same source
with a run-time count for any other; built at first use, counted in
``LAUNCHES``), and the wrapper
``coherence_key``, which runs the twin for CPU tensors and the kernel for
CUDA tensors and never falls back. ``coherence_order`` sorts by the key.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import weakref

import torch

from raytracer_tpu_torch.config import Epsilons
from raytracer_tpu_torch.models.scene import SceneArrays
from raytracer_tpu_torch.models.vecmath import as3

# Cut boxes the kernel's by-value table holds (KEY_MAX_CUT in
# ops/csrc/coherence_key.cu); the loader builds 32 (ops/bvh.py::MAX_CUT),
# the count the kernel unrolls (KEY_STATIC_CUT there).
KEY_MAX_CUT = 64

# Kernel launches since import (or since a caller reset it).
LAUNCHES = 0
_launch_lock = threading.Lock()

# The host table of each scene, built at its first launch: the copy from the
# device blocks the host, so it is made once per scene, not once per launch.
_tables: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _key_table(scene: SceneArrays) -> torch.Tensor:
    """[C+1, 6] f32 on the CPU: the cut boxes (lo.xyz, hi.xyz), then the
    root box, which the Morton quantisation uses."""
    table = _tables.get(scene)
    if table is None:
        root = torch.cat([scene.bvh_lo[0], scene.bvh_hi[0]])[None]
        cuts = torch.cat([scene.bvh_cut_lo, scene.bvh_cut_hi], dim=1)
        table = _tables[scene] = torch.cat([cuts, root]).to(torch.float32).cpu().contiguous()
    return table


def coherence_key_twin(scene: SceneArrays, ro, rd, eps: Epsilons) -> torch.Tensor:
    """Plain PyTorch key, on the rays' device: [N] i32."""
    ro, rd = as3(ro), as3(rd)
    dev = ro[0].device
    clo = scene.bvh_cut_lo.to(dev)
    chi = scene.bvh_cut_hi.to(dev)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    inv = [
        1.0 / torch.where(torch.abs(d) < 1e-12, torch.tensor(1e-12, dtype=torch.float32, device=dev), d)
        for d in rd
    ]
    best_t = torch.full_like(ro[0], float("inf"))
    best_i = torch.zeros(ro[0].shape, dtype=torch.int32, device=dev)
    for c in range(clo.shape[0]):
        tnear = tfar = None
        for k in range(3):
            t0 = (clo[c, k] - ro[k]) * inv[k]
            t1 = (chi[c, k] - ro[k]) * inv[k]
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            tnear = lo if tnear is None else torch.maximum(tnear, lo)
            tfar = hi if tfar is None else torch.minimum(tfar, hi)
        hit = (tnear <= tfar) & (tfar > eps.tri_tmin)
        tn = torch.where(hit, tnear, inf)
        take = tn < best_t  # strict: ties keep the lower cut index
        best_t = torch.where(take, tn, best_t)
        best_i = torch.where(take, c, best_i)
    miss = (best_t == inf).to(torch.int32)
    octant = (
        (rd[0] < 0).to(torch.int32)
        + 2 * (rd[1] < 0).to(torch.int32)
        + 4 * (rd[2] < 0).to(torch.int32)
    )
    root_lo = scene.bvh_lo[0].to(dev)
    root_hi = scene.bvh_hi[0].to(dev)
    morton = torch.zeros_like(best_i)
    for k in range(3):
        # A true division, as in _morton12: a reciprocal multiply can differ
        # by an ulp and flip a quantisation bucket.
        span = torch.clamp_min(root_hi[k] - root_lo[k], 1e-6)
        q = torch.clamp((ro[k] - root_lo[k]) / span * 15.0, 0.0, 15.0).to(torch.int32)
        q = (q | (q << 4)) & 0x0C3
        q = (q | (q << 2)) & 0x249
        morton = morton | (q << k)
    return (miss << 30) | (best_i << 17) | (octant << 13) | morton


@functools.lru_cache(maxsize=1)
def _launch_fn():
    from raytracer_tpu_torch.ops import _build

    fn = _build.load_library("coherence_key").rt_key_launch
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_int]  # table, n_cut
        + [ctypes.c_void_p] * 6  # ro.xyz, rd.xyz
        + [ctypes.c_int, ctypes.c_float]  # n, tri_tmin
        + [ctypes.c_void_p, ctypes.c_void_p]  # key, stream
    )
    fn.restype = ctypes.c_int
    return fn


def coherence_key_cuda(scene: SceneArrays, ro, rd, eps: Epsilons) -> torch.Tensor:
    """Launch the CUDA kernel on the rays' device and current stream: [N] i32.
    Raises on any fault; never falls back."""
    global LAUNCHES
    ro, rd = as3(ro), as3(rd)
    dev = ro[0].device
    if dev.type != "cuda":
        raise ValueError(f"coherence_key_cuda launches on a CUDA device, not {dev}")
    cols = [c.to(torch.float32).contiguous() for c in (*ro, *rd)]
    n = cols[0].numel()
    if any(c.device != dev or c.numel() != n for c in cols):
        raise ValueError("ray components must be [N] tensors on one device")
    table = _key_table(scene)
    n_cut = table.shape[0] - 1
    if not 1 <= n_cut <= KEY_MAX_CUT:
        raise ValueError(f"{n_cut} cut boxes; the kernel takes 1..{KEY_MAX_CUT}")
    key = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return key
    launch = _launch_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            table.data_ptr(), n_cut, *(c.data_ptr() for c in cols),
            n, eps.tri_tmin, key.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"coherence key launch failed with CUDA error {rc}")
    with _launch_lock:
        LAUNCHES += 1
    return key


def coherence_key(scene: SceneArrays, ro, rd, eps: Epsilons) -> torch.Tensor:
    """[N] i32 key: the twin for CPU rays, the kernel for CUDA rays."""
    dev = as3(ro)[0].device
    if dev.type == "cpu":
        return coherence_key_twin(scene, ro, rd, eps)
    if dev.type == "cuda":
        return coherence_key_cuda(scene, ro, rd, eps)
    raise ValueError(f"unsupported device {dev}")


def coherence_order(scene: SceneArrays, ro, rd, eps: Epsilons) -> torch.Tensor:
    """[N] i64 permutation that sorts the rays by key (stable: equal keys
    keep their order)."""
    return torch.argsort(coherence_key(scene, ro, rd, eps), stable=True)
