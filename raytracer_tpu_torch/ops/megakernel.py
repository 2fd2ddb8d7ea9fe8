"""The bounce megakernel: the whole per-lane path-trace loop of a row band.

Port of ``raytracer_tpu/ops/pallas/megakernel.py`` (K1, ``_mega_kernel``).
One lane is one (pixel, subpixel) of the band, ``slot = pixel*4 + sub``;
each lane streams its samples through regenerate -> nearest hit over S
spheres, P planes and <=32 triangles -> arrival emission -> NEE on the
sphere light with a shadow test -> Russian roulette -> cosine or mirror
bounce, and banks finished paths into its RGB sum.

Three parts, as in the JAX module:

- the host packing (``pack_params``): the ``pf`` f32 scalar table in the
  JAX order, ``n_valid = rows*W*4``, the band seed and ``cfg_tuple``;
- the CUDA kernel (``ops/csrc/megakernel.cu``), one thread per lane, built
  at first use (``ops/_build.py``) and counted in ``LAUNCHES``; one launch
  renders one band or several (``mega_cuda_bands``), each lane keeping the
  slot and seed of its band;
- the plain PyTorch twin (``mega_twin``), which steps every lane in
  lockstep with the same expressions as the kernel.

``render_bands_mega`` (several bands of equal height, in one launch: the
frame path) and ``render_band_mega`` (one band: the served path) run the
twin for CPU tensors and the kernel for CUDA tensors; on CUDA they launch
the kernel or raise, they never fall back.

Random numbers come from the counter hash ``hash3``/``uniform`` over
(lane ^ seed, iteration, draw), draws 0-6 as in the JAX kernel. The TPU
build draws from the TPU's hardware generator instead; the hash is what the
JAX kernel uses in interpret mode, so the tests compare the port with JAX
lane by lane.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple

import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.camera import camera_basis, tent_jitter
from raytracer_tpu_torch.models.scene import BRDF_SPECULAR, LIGHT_SPHERE, SceneArrays
from raytracer_tpu_torch.models.vecmath import (
    add3,
    cross3,
    dot3,
    mul3,
    normalize3,
    scale3,
    sub3,
    where3,
)
from raytracer_tpu_torch.ops.intersect import tri_precompute

INF = 3.0e38
INV_PI = float(1.0 / math.pi)
TWO_PI = float(2.0 * math.pi)
M32 = 0xFFFFFFFF

# Same gate as the JAX package: the kernel loops over at most this many
# triangles (no BVH); widen it only with a parity test on a bigger scene.
MEGA_MAX_TRIS = 32

# Lane tolerance of the kernel against its twin on the card: per lane,
# |kernel - twin| <= LANE_RTOL * max(1, |twin|) on at least LANE_SHARE of
# the lanes, and the band means within BAND_RTOL. Both round after every
# f32 operation (the kernel is built with FMA contraction off) and both
# call CUDA's IEEE sqrtf, division, sinf and cosf, so lanes agree bit for
# bit on an H100; the margin covers a libm-level difference that flips one
# branch (a hit at a silhouette, a shadow edge) on a few lanes.
LANE_RTOL = 1e-4
LANE_SHARE = 0.99
BAND_RTOL = 1e-3

# Floats the kernel's by-value scene table holds (MEGA_PF_MAX in
# ops/csrc/megakernel.cu): cornell_box needs 167, cubes 469.
MEGA_PF_MAX = 960

# Kernel launches since import (or since a caller reset it): the smoke test
# zeroes it, drives the main path, and checks that the kernel ran.
LAUNCHES = 0
_launch_lock = threading.Lock()


def supports_megakernel(scene: SceneArrays, cfg: RenderConfig) -> bool:
    """The megakernel covers sphere/plane/small-triangle geometry (no BVH),
    diffuse/specular materials, a sphere light and NEE without MIS."""
    return (
        not scene.use_bvh
        and scene.n_triangles <= MEGA_MAX_TRIS
        and not scene.has_phong
        and scene.light_type == LIGHT_SPHERE
        and not cfg.use_mis
    )


# --- counter hash --------------------------------------------------------
# u32 arithmetic in int64: CPU torch has no >> for uint32. Each product of
# two values below 2^32 may wrap int64, but its low 32 bits stay exact, so
# masking with M32 after every multiply gives the u32 result.


def hash3(a, b, c):
    """murmur3-finalizer mix of three u32 counters (int64 tensors or ints)."""
    h = ((a * 0xCC9E2D51) & M32) ^ ((b * 0x1B873593) & M32) ^ ((c * 0x85EBCA6B) & M32)
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & M32
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & M32
    return h ^ (h >> 16)


def uniform(seed, lane, it, draw) -> torch.Tensor:
    """Uniform [0,1) f32 from the counter hash (24 random bits)."""
    bits = hash3(lane ^ seed, it, draw)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def band_seed(base_seed: int, y0: int, salt: int) -> int:
    """The i32 seed of one band dispatch, derived from (cfg.seed, y0, salt)
    with the kernel's own hash (the JAX package folds y0 and salt into a
    jax.random key instead)."""
    h = hash3(base_seed & M32, y0 & M32, salt & M32)
    return h - (1 << 32) if h >= 1 << 31 else h


# --- host packing ----------------------------------------------------------


class MegaStatic(NamedTuple):
    """The kernel's static arguments (``_mega_raw``'s, less the TPU grid)."""

    n_spheres: int
    n_planes: int
    n_tris: int
    n_objects: int
    width: int
    height: int
    cfg_tuple: tuple


def cfg_tuple(cfg: RenderConfig) -> tuple:
    eps = cfg.eps
    return (
        float(cfg.fov_scale), int(cfg.rr_start_depth), float(cfg.rr_survival),
        int(cfg.max_depth), float(eps.sphere_tmin), float(eps.plane_parallel),
        float(eps.hit_offset), float(eps.visibility_margin),
        float(eps.tri_tmin), float(eps.tri_parallel),
    )


@functools.lru_cache(maxsize=16)
def pack_params(scene: SceneArrays, cfg: RenderConfig) -> tuple[torch.Tensor, MegaStatic]:
    """``pf`` f32[20+5S+7P+13T+10O] on the CPU, in the JAX order: camera
    (pos, dir, cx, cy), light (pos, r, emission, area), then per sphere
    (pos, r, obj), per plane (pos, n, obj), per triangle (n_unit, n_d, q1,
    q1_a, q2, q2_a, obj) and per object (is_specular, c_d*k_d/pi, c_s,
    emitted). Computed on the scene's device and cached per (scene, cfg):
    it does not depend on the band, and the kernel takes it by value from
    host memory.
    """
    ns, npl, nt, no = scene.n_spheres, scene.n_planes, scene.n_triangles, scene.n_objects
    f32 = torch.float32

    def col(x):
        return x.to(f32)[:, None]

    cx, cy = camera_basis(scene, cfg.width, cfg.height, cfg.fov_scale)
    parts = [
        scene.cam_pos, scene.cam_dir, cx, cy,
        scene.light_sph_pos, scene.light_sph_r[None],
        scene.obj_emitted[scene.light_idx], scene.light_area[None],
        torch.cat([scene.sph_pos[:ns], col(scene.sph_r[:ns]), col(scene.sph_obj[:ns])], 1).reshape(-1),
        torch.cat([scene.pln_pos[:npl], scene.pln_n[:npl], col(scene.pln_obj[:npl])], 1).reshape(-1),
    ]
    if nt:
        tp = tri_precompute(scene.tri_a[:nt], scene.tri_b[:nt], scene.tri_c[:nt])
        # Invalid (padded) slots are zeroed: n_unit=0 -> denom=0 -> the
        # parallel cutoff rejects every test, as in the JAX packing.
        vm = col(scene.tri_valid[:nt])
        parts.append(torch.cat([
            tp.n_unit * vm, col(tp.n_d) * vm, tp.q1 * vm, col(tp.q1_a) * vm,
            tp.q2 * vm, col(tp.q2_a) * vm, col(scene.tri_obj[:nt]),
        ], 1).reshape(-1))
    is_spec = (scene.brdf_type[:no] == BRDF_SPECULAR).to(f32)
    f_d = scene.c_d[:no] * (scene.k_d[:no] * INV_PI)[:, None]
    parts.append(torch.cat(
        [is_spec[:, None], f_d, scene.c_s[:no], scene.obj_emitted[:no]], 1
    ).reshape(-1))
    pf = torch.cat([p.to(f32) for p in parts]).cpu().contiguous()
    static = MegaStatic(ns, npl, nt, no, cfg.width, cfg.height, cfg_tuple(cfg))
    return pf, static


# --- plain PyTorch twin ----------------------------------------------------


def mega_twin(
    pf: torch.Tensor, static: MegaStatic, y0: int, num_samples: int, n_valid: int,
    seed: int, device: torch.device | str = "cpu", counts: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel for one band, computed on
    ``device``.

    Steps all ``n_valid`` lanes in lockstep, one loop iteration per kernel
    iteration, until no lane has work or ``hard_cap`` iterations ran. A lane
    without work changes no state, so each lane sees the same iteration
    numbers (and random draws) as in the kernel's per-thread loop.
    Returns (acc f32[n_valid, 3], rays i32[n_valid]). ``counts``, when
    given, is a dict into which the loop adds ``samples`` (camera rays),
    ``bounces`` (main traces) and ``shadow`` (shadow rays).
    """
    ns, npl, nt, no, width, height, ct = static
    (_fov, rr_start_depth, rr_survival, max_depth, sphere_tmin, plane_parallel,
     hit_offset, visibility_margin, tri_tmin, tri_parallel) = ct
    dev = torch.device(device)
    pf = pf.to(dev)
    n = n_valid
    f32, i32, i64 = torch.float32, torch.int32, torch.int64

    def sc(k):  # one f32 scalar of the table, as a 0-dim tensor
        return pf[k]

    def v3(k):
        return (pf[k], pf[k + 1], pf[k + 2])

    cam_pos, cam_dir, cx, cy = v3(0), v3(3), v3(6), v3(9)
    light_pos, light_r, light_e, light_area = v3(12), sc(15), v3(16), sc(19)
    p = 20
    sph = [(v3(p + 5 * s), sc(p + 5 * s + 3), sc(p + 5 * s + 4)) for s in range(ns)]
    p += 5 * ns
    pln = [(v3(p + 7 * s), v3(p + 7 * s + 3), sc(p + 7 * s + 6)) for s in range(npl)]
    p += 7 * npl
    tri = []
    for s in range(nt):
        b = p + 13 * s
        tri.append((v3(b), sc(b + 3), v3(b + 4), sc(b + 7), v3(b + 8), sc(b + 11), sc(b + 12)))
    p += 13 * nt
    mats = pf[p : p + 10 * no].view(no, 10)

    slot = torch.arange(n, dtype=i64, device=dev)
    seed_u = seed & M32
    pix = slot // 4
    sub = slot % 4
    px = (pix % width).to(f32)
    py = (y0 + pix // width).to(f32)
    sx = (sub % 2).to(f32)
    sy = (sub // 2).to(f32)
    w_t = torch.tensor(float(width), dtype=f32, device=dev)
    h_t = torch.tensor(float(height), dtype=f32, device=dev)

    z = torch.zeros(n, dtype=f32, device=dev)
    one = torch.ones(n, dtype=f32, device=dev)
    zero3 = (z, z, z)
    hard_cap = num_samples * (max_depth + 2) + 64

    def sphere_t(c, r, ro, rd):
        oc = sub3(c, ro)
        b = dot3(oc, rd)
        det = b * b - dot3(oc, oc) + r * r
        sq = torch.sqrt(torch.clamp_min(det, 0.0))
        t_near = b - sq
        t_far = b + sq
        t = torch.where(t_near > sphere_tmin, t_near,
                        torch.where(t_far > sphere_tmin, t_far, INF))
        return det, t

    def plane_t(c, nrm, ro, rd):
        d_n = dot3(nrm, rd)
        t = (dot3(nrm, c) - dot3(nrm, ro)) / d_n
        return (torch.abs(d_n) >= plane_parallel) & (t >= 0.0), t

    def tri_t(nrm, n_d, q1, q1a, q2, q2a, ro, rd):
        denom = dot3(nrm, rd)
        t = (n_d - dot3(nrm, ro)) / denom
        u = dot3(q1, ro) + t * dot3(q1, rd) - q1a
        v_ = dot3(q2, ro) + t * dot3(q2, rd) - q2a
        ok = ((torch.abs(denom) >= tri_parallel)
              & (u >= 0.0) & (u <= 1.0) & (v_ >= 0.0) & (u + v_ <= 1.0)
              & (t > tri_tmin))
        return ok, t

    def trace(ro, rd):
        """Nearest hit -> (obj, two-sided normal, offset position, valid)."""
        t_best = torch.full_like(z, INF)
        vv = zero3
        is_sph = torch.zeros(n, dtype=torch.bool, device=dev)
        obj = torch.zeros_like(z)
        for (c, r, ob) in sph:
            det, t = sphere_t(c, r, ro, rd)
            t = torch.where(det >= 0.0, t, INF)
            take = t < t_best
            t_best = torch.where(take, t, t_best)
            vv = where3(take, c, vv)
            is_sph = is_sph | take
            obj = torch.where(take, ob, obj)
        for (c, nrm, ob) in pln:
            ok, t = plane_t(c, nrm, ro, rd)
            t = torch.where(ok, t, INF)
            take = t < t_best
            t_best = torch.where(take, t, t_best)
            vv = where3(take, nrm, vv)
            is_sph = is_sph & ~take
            obj = torch.where(take, ob, obj)
        for (nrm, n_d, q1, q1a, q2, q2a, ob) in tri:
            ok, t = tri_t(nrm, n_d, q1, q1a, q2, q2a, ro, rd)
            t = torch.where(ok, t, INF)
            take = t < t_best
            t_best = torch.where(take, t, t_best)
            vv = where3(take, nrm, vv)
            is_sph = is_sph & ~take
            obj = torch.where(take, ob, obj)
        valid = t_best < INF
        pos = add3(ro, scale3(rd, t_best))
        n_sph = normalize3(sub3(pos, vv), eps=1e-20)
        nn = where3(is_sph, n_sph, vv)
        flip = dot3(nn, rd) > 0.0
        nn = where3(flip, scale3(nn, -1.0), nn)
        off = torch.where(is_sph, 0.0, hit_offset)
        pos = add3(pos, scale3(nn, off))
        return obj.to(i64), nn, pos, valid

    def occluded(ro, rd, bound):
        """Any hit strictly below ``bound``."""
        occ = torch.zeros(n, dtype=torch.bool, device=dev)
        for (c, r, _ob) in sph:
            det, t = sphere_t(c, r, ro, rd)
            occ = occ | ((det >= 0.0) & (t < bound))
        for (c, nrm, _ob) in pln:
            ok, t = plane_t(c, nrm, ro, rd)
            occ = occ | (ok & (t < bound))
        for (nrm, n_d, q1, q1a, q2, q2a, _ob) in tri:
            ok, t = tri_t(nrm, n_d, q1, q1a, q2, q2a, ro, rd)
            occ = occ | (ok & (t < bound))
        return occ

    rays = torch.zeros(n, dtype=i32, device=dev)
    active = torch.zeros(n, dtype=torch.bool, device=dev)
    j = torch.zeros(n, dtype=i64, device=dev)
    depth = torch.zeros(n, dtype=i64, device=dev)
    ro = rd = L = beta = emis = acc = zero3

    for it in range(hard_cap):
        def u(draw, it=it):
            return uniform(seed_u, slot, it, draw)

        # 1) regenerate: idle lanes start their next sample
        got = ~active & (j < num_samples)
        dx = tent_jitter(u(0))
        dy = tent_jitter(u(1))
        fx = ((sx + 0.5 + dx) / 2.0 + px) / w_t - 0.5
        fy = ((sy + 0.5 + dy) / 2.0 + py) / h_t - 0.5
        crd = normalize3(add3(add3(scale3(cx, fx), scale3(cy, fy)), cam_dir))
        ro = where3(got, cam_pos, ro)
        rd = where3(got, crd, rd)
        depth = torch.where(got, 0, depth)
        L = where3(got, zero3, L)
        beta = where3(got, (one, one, one), beta)
        emis = where3(got, (one, one, one), emis)
        j = torch.where(got, j + 1, j)
        active = active | got

        # 2) main trace
        rays = rays + active.to(i32)
        if counts is not None:
            counts["samples"] = counts.get("samples", 0) + int(got.sum())
            counts["bounces"] = counts.get("bounces", 0) + int(active.sum())
        obj, nrm, x, hit_valid = trace(ro, rd)
        valid = active & hit_valid
        done_miss = active & ~hit_valid

        # 3) arrival emission
        m = mats[obj]  # [n, 10]: is_spec, f_d(3), c_s(3), em(3)
        em = (m[:, 7], m[:, 8], m[:, 9])
        L = where3(valid, add3(L, mul3(emis, em)), L)

        o = scale3(rd, -1.0)
        depth = torch.where(active, depth + 1, depth)
        is_spec = m[:, 0] > 0.5
        f_d = (m[:, 1], m[:, 2], m[:, 3])
        c_s = (m[:, 4], m[:, 5], m[:, 6])

        # 4) NEE: uniform sphere-light sample + shadow test
        zl = 2.0 * u(2) - 1.0
        rl = torch.sqrt(torch.clamp_min(1.0 - zl * zl, 0.0))
        phil = TWO_PI * u(3)
        ny = (rl * torch.cos(phil), rl * torch.sin(phil), zl)
        y = add3(light_pos, scale3(ny, light_r))
        to_y = sub3(y, x)
        dist = torch.sqrt(torch.clamp_min(dot3(to_y, to_y), 1e-20))
        wi_d = scale3(to_y, 1.0 / dist)
        r2 = torch.clamp_min(dist * dist, 1e-20)
        nee = valid & ~is_spec
        rays = rays + nee.to(i32)
        if counts is not None:
            counts["shadow"] = counts.get("shadow", 0) + int(nee.sum())
        occ = occluded(x, wi_d, dist - visibility_margin)
        cos_x = dot3(nrm, wi_d)
        cos_y = dot3(ny, scale3(wi_d, -1.0))
        scale = torch.where(~occ, 1.0, 0.0) * cos_x * cos_y * (light_area / r2)
        direct = tuple(light_e[k] * f_d[k] * scale for k in range(3))
        L = where3(nee, add3(L, mul3(beta, direct)), L)

        # 5) RR + BSDF sample
        p_rr = torch.where(depth <= rr_start_depth, 1.0, rr_survival)
        cont = valid & (u(4) < p_rr) & (depth < max_depth)
        zc = torch.sqrt(u(5))
        rc = torch.sqrt(torch.clamp_min(1.0 - zc * zc, 0.0))
        phic = TWO_PI * u(6)
        use_y_ax = torch.abs(nrm[0]) > 0.1
        helper = (torch.where(use_y_ax, 0.0, 1.0), torch.where(use_y_ax, 1.0, 0.0), z)
        ub = normalize3(cross3(helper, nrm))
        vb = cross3(nrm, ub)
        wi_diff = add3(
            add3(scale3(ub, rc * torch.cos(phic)), scale3(vb, rc * torch.sin(phic))),
            scale3(nrm, zc),
        )
        wi_spec = sub3(scale3(nrm, 2.0 * dot3(o, nrm)), o)
        wi = where3(is_spec, wi_spec, wi_diff)
        cos_c = dot3(nrm, wi_diff)
        pdf_b = torch.clamp_min(cos_c, 0.0) * INV_PI
        pdf_floor = torch.clamp_min(pdf_b, 1e-12)
        w_nonspec = tuple(
            torch.where(pdf_b > 1e-12, f_d[k] * cos_c / pdf_floor, 0.0) for k in range(3)
        )
        inv_p = 1.0 / p_rr
        weight = scale3(where3(is_spec, c_s, w_nonspec), inv_p)
        beta_next = mul3(beta, weight)
        live = cont & ((beta_next[0] > 0.0) | (beta_next[1] > 0.0) | (beta_next[2] > 0.0))
        emis = where3(is_spec, scale3(beta, inv_p), zero3)
        beta = beta_next

        # 6) completion: bank finished paths
        completed = done_miss | (valid & ~live)
        acc = where3(completed, add3(acc, L), acc)
        active = live
        ro = where3(live, x, ro)
        rd = where3(live, wi, rd)
        if not bool((live | (j < num_samples)).any()):
            break
    return torch.stack(acc, dim=-1), rays


# --- CUDA kernel -------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _launch_fn():
    """``rt_mega_launch`` from the built library (built on first use)."""
    from raytracer_tpu_torch.ops import _build

    fn = _build.load_library("megakernel").rt_mega_launch
    fn.argtypes = (
        [ctypes.c_void_p]  # pf
        + [ctypes.c_int] * 7  # n_pf, ns, np, nt, no, width, height
        + [ctypes.c_void_p] + [ctypes.c_int] * 3  # bands, n_bands, n_band, num_samples
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int]  # rr_start_depth, rr_survival, max_depth
        + [ctypes.c_float] * 6  # epsilons
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]  # acc, rays, stream
    )
    fn.restype = ctypes.c_int
    return fn


def _i32(v: int) -> int:
    v &= M32
    return v - (1 << 32) if v >= 1 << 31 else v


def mega_cuda_bands(
    pf: torch.Tensor, static: MegaStatic, bands: list[tuple[int, int]], num_samples: int,
    n_band: int, device: torch.device | str = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel once for ``bands``, a list of (y0, seed) of
    bands of ``n_band`` lanes each, on ``device`` and its current stream.

    ``pf`` is the host table from ``pack_params``. Returns (acc
    f32[len(bands) * n_band, 3], rays i32[len(bands) * n_band]) on
    ``device``, band after band; lane ``b * n_band + s`` equals lane ``s`` of
    band ``b`` launched alone. Raises on any fault, never falls back.
    """
    global LAUNCHES
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"mega_cuda_bands launches on a CUDA device, not {dev}")
    if pf.device.type != "cpu" or pf.dtype != torch.float32 or not pf.is_contiguous():
        raise ValueError("mega_cuda_bands needs the contiguous f32 host table of pack_params")
    if pf.numel() > MEGA_PF_MAX:
        raise ValueError(
            f"scene table of {pf.numel()} floats exceeds the kernel's {MEGA_PF_MAX}"
        )
    ns, npl, nt, no, width, height, ct = static
    if nt > MEGA_MAX_TRIS:
        raise ValueError(f"{nt} triangles exceed MEGA_MAX_TRIS={MEGA_MAX_TRIS}")
    if n_band % 4 or len(bands) * n_band >= 1 << 31:
        raise ValueError(f"{len(bands)} bands of {n_band} lanes: not whole pixels or too many")
    (_fov, rr_start_depth, rr_survival, max_depth, sphere_tmin, plane_parallel,
     hit_offset, visibility_margin, tri_tmin, tri_parallel) = ct
    n = len(bands) * n_band
    acc = torch.empty((n, 3), dtype=torch.float32, device=dev)
    rays = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return acc, rays
    launch = _launch_fn()
    # The band table goes to the card from pinned memory, queued on the
    # launch's stream (no synchronous pageable copy per launch).
    table = torch.tensor([(_i32(y0), _i32(seed)) for y0, seed in bands], dtype=torch.int32)
    with torch.cuda.device(dev):
        table = table.pin_memory().to(dev, non_blocking=True)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            pf.data_ptr(), pf.numel(), ns, npl, nt, no, width, height,
            table.data_ptr(), len(bands), n_band, num_samples,
            rr_start_depth, rr_survival, max_depth,
            sphere_tmin, plane_parallel, hit_offset, visibility_margin,
            tri_tmin, tri_parallel, acc.data_ptr(), rays.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"megakernel launch failed with CUDA error {rc}")
    with _launch_lock:
        LAUNCHES += 1
    return acc, rays


def mega_cuda(
    pf: torch.Tensor, static: MegaStatic, y0: int, num_samples: int, n_valid: int,
    seed: int, device: torch.device | str = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """One band of ``n_valid`` lanes through ``mega_cuda_bands``: the kernel
    with the arguments of ``mega_twin``."""
    return mega_cuda_bands(pf, static, [(y0, seed)], num_samples, n_valid, device)


# --- band entry points ---------------------------------------------------------


def render_bands_mega(
    scene: SceneArrays, cfg: RenderConfig, y0s: list[int], rows: int, num_samples: int,
    seeds: list[int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Render the bands of ``rows`` rows starting at render rows ``y0s``,
    band ``b`` at seed ``seeds[b]`` -> (sums f32[len(y0s), rows, W, 4, 3],
    rays traced i64 scalar), both on the scene's device.

    CPU scene: the plain twin, band by band. CUDA scene: one launch of the
    CUDA kernel for all the bands, or an error.
    """
    if not supports_megakernel(scene, cfg):
        raise ValueError(f"scene {scene.name!r} is outside the megakernel subset")
    if len(seeds) != len(y0s):
        raise ValueError(f"{len(y0s)} bands but {len(seeds)} seeds")
    pf, static = pack_params(scene, cfg)
    n = rows * cfg.width * 4
    dev = scene.device
    if dev.type == "cpu":
        outs = [mega_twin(pf, static, y0, num_samples, n, seed, dev) for y0, seed in zip(y0s, seeds)]
        acc = torch.cat([o[0] for o in outs]) if outs else torch.empty((0, 3))
        rays = torch.cat([o[1] for o in outs]) if outs else torch.empty((0,), dtype=torch.int32)
    elif dev.type == "cuda":
        acc, rays = mega_cuda_bands(pf, static, list(zip(y0s, seeds)), num_samples, n, dev)
    else:
        raise ValueError(f"unsupported device {dev}")
    return acc.view(len(y0s), rows, cfg.width, 4, 3), rays.sum()


def render_band_mega(
    scene: SceneArrays, cfg: RenderConfig, y0: int, rows: int, num_samples: int,
    seed: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Render one row band -> (sums f32[rows, W, 4, 3], rays traced i64
    scalar), both on the scene's device: ``render_bands_mega`` of one band."""
    sums, rays = render_bands_mega(scene, cfg, [y0], rows, num_samples, [seed])
    return sums[0], rays
