"""The reference path tracer: plain PyTorch, one lane per (pixel, subpixel).

It computes again, from the scene files alone, what a frame of the
program holds at a given set of rows: the upstream server's estimator
(camera rays with a tent filter on a 2x2 subpixel grid; nearest hit over
spheres, planes and mesh triangles with two-sided normals; next-event
estimation on the sphere light with a shadow ray; Russian roulette from
``rr_start_depth`` at ``rr_survival``, capped at ``max_depth``; cosine or
mirror bounces), then the clamp, average, gamma and u8 finalize.

To be comparable pixel by pixel it draws its random numbers where the
program's documented layout puts them: a counter hash of (lane seed, lane
iteration, draw index), draws 0-1 camera jitter, 2-3 the light sample, 4
the roulette, 5-6 the bounce. Two schedules exist, as the program's two
engines define them:

- ``"k1"`` (sphere/plane scenes): a lane renders its samples back to back;
  its counter is the lane's slot in its row band, its seed the band's seed
  (a hash of the render seed and the band's first row), and it banks a
  path's radiance when the path ends;
- ``"regen"`` (mesh scenes): one sample per lane a dispatch, dispatch p
  seeded by a hash of (render seed, 0, p); the counter is the lane's slot
  in the frame; contributions bank as they arrive, and a shadow ray is
  traced only toward the light's near side.

Each schedule writes its arithmetic in the order its engine states, so an
f32 run agrees with the program except where rounding flips a branch.
``dtype`` other than float32 computes every float in that type: the
lower-precision control.

Mesh triangles are tested by brute force over all of them (in blocks), so
the nearest hit does not depend on any acceleration structure.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rtbench.reference.scene import SPECULAR, RefScene

M32 = 0xFFFFFFFF
INF = 3.0e38
INV_PI = float(1.0 / math.pi)
TWO_PI = float(2.0 * math.pi)
PARK_RO = 3.0e7
PARK_RD = (1.0, 0.0, 0.0)
TRI_BLOCK = 4096


@dataclasses.dataclass(frozen=True)
class Params:
    """The render settings a configuration states."""

    width: int = 600
    height: int = 450
    rr_start_depth: int = 5
    rr_survival: float = 0.9
    max_depth: int = 24
    fov_scale: float = 0.5135
    sphere_tmin: float = 2e-3
    plane_parallel: float = 1e-4
    tri_parallel: float = 1e-4
    tri_tmin: float = 1e-3
    hit_offset: float = 1e-3
    visibility_margin: float = 1e-2


# --- counter hash ------------------------------------------------------------
# u32 arithmetic in int64, masked after every multiply.


def hash3(a, b, c):
    h = ((a * 0xCC9E2D51) & M32) ^ ((b * 0x1B873593) & M32) ^ ((c * 0x85EBCA6B) & M32)
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & M32
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & M32
    return h ^ (h >> 16)


def band_seed(base: int, y0: int, salt: int) -> int:
    """The seed of a band or dispatch, as a signed 32-bit value."""
    h = hash3(base & M32, y0 & M32, salt & M32)
    return h - (1 << 32) if h >= 1 << 31 else h


def uniform(seed_u, slot, it: int, draw: int, dtype=torch.float32) -> torch.Tensor:
    bits = hash3(slot ^ seed_u, it, draw)
    return (bits >> 8).to(dtype) * (1.0 / (1 << 24))


# --- scene on a device ----------------------------------------------------------


class DevScene:
    """The scene's arrays as tensors of ``dtype`` on ``device``."""

    def __init__(self, sc: RefScene, p: Params, device, dtype=torch.float32):
        self.sc, self.p, self.dtype, self.device = sc, p, dtype, torch.device(device)

        def t(x, dt=dtype):
            return torch.as_tensor(np.asarray(x)).to(self.device, dt)

        self.sph = [(tuple(t(c)[k] for k in range(3)), t(r), int(o))
                    for c, r, o in zip(sc.sph_pos, sc.sph_r, sc.sph_obj)]
        self.pln = [(tuple(t(c)[k] for k in range(3)), tuple(t(n)[k] for k in range(3)), int(o))
                    for c, n, o in zip(sc.pln_pos, sc.pln_n, sc.pln_obj)]
        self.is_spec = t(sc.brdf == SPECULAR, torch.bool)
        self.c_d, self.c_s, self.k_d, self.emitted = t(sc.c_d), t(sc.c_s), t(sc.k_d), t(sc.emitted)
        self.light_pos = tuple(t(sc.light_pos)[k] for k in range(3))
        self.light_r = t(sc.light_r)
        self.light_area = t(sc.light_area)
        self.light_e = self.emitted[sc.light_idx]
        # Mesh triangles: the intersection rows in float64, rounded once
        # (unit normal, plane offset, two barycentric gradients and their
        # offsets), and the shading normal from the float32 corners.
        self.n_tris = len(sc.tris)
        if self.n_tris:
            a, b, c = (sc.tris[:, k].astype(np.float64) for k in range(3))
            e1, e2 = b - a, c - a
            ng = np.cross(e1, e2)
            nn = np.maximum((ng * ng).sum(1), 1e-30)
            n_unit = ng / np.sqrt(nn)[:, None]
            q1 = np.cross(e2, ng) / nn[:, None]
            q2 = np.cross(ng, e1) / nn[:, None]
            rows = np.concatenate([n_unit, (a * n_unit).sum(1)[:, None], q1, (a * q1).sum(1)[:, None],
                                   q2, (a * q2).sum(1)[:, None]], axis=1).astype(np.float32)
            self.tri_rows = t(rows)
            a32, b32, c32 = (t(sc.tris[:, k].astype(np.float32)) for k in range(3))
            e1, e2 = b32 - a32, c32 - a32
            ng = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                              e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                              e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=-1)
            nn = torch.clamp_min(ng[:, 0] * ng[:, 0] + ng[:, 1] * ng[:, 1] + ng[:, 2] * ng[:, 2], 1e-30)
            self.tri_n = ng / torch.sqrt(nn)[:, None]
            self.tri_obj = int(sc.tri_obj[0])
            if np.any(sc.tri_obj != self.tri_obj):
                raise NotImplementedError("meshes of more than one object")
        # Camera basis.
        w = torch.tensor(float(p.width), dtype=dtype, device=self.device)
        h = torch.tensor(float(p.height), dtype=dtype, device=self.device)
        fov = torch.tensor(p.fov_scale, dtype=dtype, device=self.device)
        zero = torch.zeros((), dtype=dtype, device=self.device)
        cx = torch.stack([fov, zero, zero]) * (w / h)
        d = t(sc.cam_dir)
        cc = torch.stack([cx[1] * d[2] - cx[2] * d[1], cx[2] * d[0] - cx[0] * d[2], cx[0] * d[1] - cx[1] * d[0]])
        n2 = cc[0] * cc[0] + cc[1] * cc[1] + cc[2] * cc[2]
        cy = cc / torch.sqrt(n2) * fov
        self.cx = tuple(cx[k] for k in range(3))
        self.cy = tuple(cy[k] for k in range(3))
        self.cam_pos = tuple(t(sc.cam_pos)[k] for k in range(3))
        self.cam_dir = tuple(d[k] for k in range(3))
        self.w, self.h = w, h


# --- vector helpers (component tuples) ------------------------------------------


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul3(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale3(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def normalize3(v, eps=0.0):
    n2 = dot3(v, v)
    if eps:
        n2 = torch.clamp_min(n2, eps)
    return scale3(v, torch.sqrt(n2).reciprocal())


def where3(m, a, b):
    ax = a if isinstance(a, tuple) else (a, a, a)
    bx = b if isinstance(b, tuple) else (b, b, b)
    return tuple(torch.where(m, ax[k], bx[k]) for k in range(3))


def tent(u):
    r = 2.0 * u
    return torch.where(r < 1.0, torch.sqrt(r) - 1.0, 1.0 - torch.sqrt(torch.clamp_min(2.0 - r, 0.0)))


def camera(ds: DevScene, px, py, sx, sy, u0, u1):
    """A camera ray through subpixel (sx, sy) of pixel (px, py), render rows
    counted from the bottom."""
    fx = ((sx + 0.5 + tent(u0)) / 2.0 + px) / ds.w - 0.5
    fy = ((sy + 0.5 + tent(u1)) / 2.0 + py) / ds.h - 0.5
    d = add3(add3(scale3(ds.cx, fx), scale3(ds.cy, fy)), ds.cam_dir)
    return normalize3(d)


# --- lanes ---------------------------------------------------------------------------


@dataclasses.dataclass
class Lanes:
    """Lanes to render: counter slot, seed and pixel of each."""

    slot: torch.Tensor  # i64
    seed: torch.Tensor  # i64, the seed as u32
    px: torch.Tensor  # pixel column
    py: torch.Tensor  # render row (0 = bottom)
    sub: torch.Tensor  # subpixel 0..3


def mesh_nearest(ds: DevScene, ro, rd, t_init):
    """The nearest mesh hit strictly below ``t_init`` -> (t, triangle), t =
    t_init and triangle -1 where there is none. Brute force in blocks."""
    t_best = t_init.clone()
    i_best = torch.full_like(t_init, -1, dtype=torch.int64)
    p = ds.p
    for t0 in range(0, ds.n_tris, TRI_BLOCK):
        f = ds.tri_rows[t0:t0 + TRI_BLOCK]

        def dot(k, v):
            return f[:, k, None] * v[0][None] + f[:, k + 1, None] * v[1][None] + f[:, k + 2, None] * v[2][None]

        denom = dot(0, rd)
        t = (f[:, 3, None] - dot(0, ro)) / denom
        u = dot(4, ro) + t * dot(4, rd) - f[:, 7, None]
        v = dot(8, ro) + t * dot(8, rd) - f[:, 11, None]
        ok = ((torch.abs(denom) >= p.tri_parallel) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t > p.tri_tmin) & (t < t_best[None]))
        tmin, jmin = torch.where(ok, t, float("inf")).min(dim=0)
        upd = tmin < t_best
        t_best = torch.where(upd, tmin, t_best)
        i_best = torch.where(upd, t0 + jmin, i_best)
    return t_best, i_best


def _sphere_group(ds: DevScene, ro, rd):
    """Regen's sphere test -> (t [S, N], per-sphere attributes)."""
    p = ds.p
    ts = []
    for c, r, _o in ds.sph:
        b = dot3(c, rd) - dot3(ro, rd)
        opop = dot3(c, c) - 2.0 * dot3(c, ro) + dot3(ro, ro)
        det = b * b - opop + r * r
        sq = torch.sqrt(torch.clamp_min(det, 0.0))
        t_near, t_far = b - sq, b + sq
        t = torch.where(t_near > p.sphere_tmin, t_near, torch.where(t_far > p.sphere_tmin, t_far, INF))
        ts.append(torch.where(det >= 0.0, t, INF))
    return torch.stack(ts)


def _plane_group(ds: DevScene, ro, rd):
    p = ds.p
    ts = []
    for c, n, _o in ds.pln:
        dn = dot3(n, rd)
        t = (dot3(c, n) - dot3(n, ro)) / dn
        ts.append(torch.where((torch.abs(dn) >= p.plane_parallel) & (t >= 0.0), t, INF))
    return torch.stack(ts)


def regen_trace(ds: DevScene, ro, rd, t_cap=None):
    """The mesh engine's nearest hit -> (t, position, normal, object, valid),
    or with ``t_cap`` the visibility distance alone."""
    dt = ds.dtype
    n = ro[0].shape[0]
    inf = torch.full((n,), INF, dtype=dt, device=ds.device)
    ts, tsa = _sphere_group(ds, ro, rd).min(dim=0) if ds.sph else (inf, None)
    tp, tpa = _plane_group(ds, ro, rd).min(dim=0) if ds.pln else (inf, None)
    tt, tta = inf, None
    if ds.n_tris:
        t_init = torch.minimum(ts, tp)
        if t_cap is not None:
            t_init = torch.minimum(t_init, t_cap)
        bt, bi = mesh_nearest(ds, ro, rd, t_init)
        use_b = bt < tt
        tt = torch.where(use_b, bt, tt)
        tta = bi
    if t_cap is not None:
        return torch.minimum(torch.minimum(ts, tp), tt)
    t_best, group = torch.min(torch.stack([ts, tp, tt]), dim=0)
    valid = t_best < INF
    # The winner's attribute: a sphere's centre, a plane's or a triangle's normal.
    att = torch.zeros((n, 3), dtype=dt, device=ds.device)
    obj = torch.zeros(n, dtype=torch.int64, device=ds.device)
    for g, (tab, arg) in enumerate(((ds.sph, tsa), (ds.pln, tpa))):
        for i, (vec, *rest) in enumerate(tab):
            m = (group == g) & (arg == i)
            vv = vec if g == 0 else rest[0]
            att = torch.where(m[:, None], torch.stack(vv)[None].expand(n, 3), att)
            obj = torch.where(m, rest[-1], obj)
    if tta is not None:
        m = (group == 2) & (tta >= 0)
        att = torch.where(m[:, None], ds.tri_n[tta.clamp_min(0)], att)
        obj = torch.where(m, ds.tri_obj, obj)
    v3 = (att[:, 0], att[:, 1], att[:, 2])
    is_sph = group == 0
    pos_raw = tuple(ro[k] + t_best * rd[k] for k in range(3))
    d = sub3(pos_raw, v3)
    inv_l = 1.0 / torch.sqrt(torch.clamp_min(dot3(d, d), 1e-20))
    n_geo = where3(is_sph, scale3(d, inv_l), v3)
    sign = torch.where(dot3(n_geo, rd) <= 0.0, 1.0, -1.0).to(dt)
    n_ff = scale3(n_geo, sign)
    off = torch.where(is_sph, 0.0, ds.p.hit_offset).to(dt)
    pos = tuple(pos_raw[k] + off * n_ff[k] for k in range(3))
    return t_best, pos, n_ff, obj, valid


def k1_trace(ds: DevScene, ro, rd):
    """The sphere/plane engine's nearest hit -> (object, normal, position, valid)."""
    p, dt = ds.p, ds.dtype
    n = ro[0].shape[0]
    z = torch.zeros(n, dtype=dt, device=ds.device)
    t_best = torch.full_like(z, INF)
    vv = (z, z, z)
    is_sph = torch.zeros(n, dtype=torch.bool, device=ds.device)
    obj = torch.zeros(n, dtype=torch.int64, device=ds.device)
    for c, r, ob in ds.sph:
        det, t = _k1_sphere(p, c, r, ro, rd)
        t = torch.where(det >= 0.0, t, INF)
        take = t < t_best
        t_best = torch.where(take, t, t_best)
        vv = where3(take, c, vv)
        is_sph = is_sph | take
        obj = torch.where(take, ob, obj)
    for c, nrm, ob in ds.pln:
        ok, t = _k1_plane(p, c, nrm, ro, rd)
        t = torch.where(ok, t, INF)
        take = t < t_best
        t_best = torch.where(take, t, t_best)
        vv = where3(take, nrm, vv)
        is_sph = is_sph & ~take
        obj = torch.where(take, ob, obj)
    valid = t_best < INF
    pos = add3(ro, scale3(rd, t_best))
    nn = where3(is_sph, normalize3(sub3(pos, vv), eps=1e-20), vv)
    flip = dot3(nn, rd) > 0.0
    nn = where3(flip, scale3(nn, -1.0), nn)
    off = torch.where(is_sph, 0.0, p.hit_offset).to(dt)
    return obj, nn, add3(pos, scale3(nn, off)), valid


def _k1_sphere(p, c, r, ro, rd):
    oc = sub3(c, ro)
    b = dot3(oc, rd)
    det = b * b - dot3(oc, oc) + r * r
    sq = torch.sqrt(torch.clamp_min(det, 0.0))
    t_near, t_far = b - sq, b + sq
    return det, torch.where(t_near > p.sphere_tmin, t_near, torch.where(t_far > p.sphere_tmin, t_far, INF))


def _k1_plane(p, c, nrm, ro, rd):
    d_n = dot3(nrm, rd)
    t = (dot3(nrm, c) - dot3(nrm, ro)) / d_n
    return (torch.abs(d_n) >= p.plane_parallel) & (t >= 0.0), t


def k1_occluded(ds: DevScene, ro, rd, bound):
    occ = torch.zeros(ro[0].shape[0], dtype=torch.bool, device=ds.device)
    for c, r, _o in ds.sph:
        det, t = _k1_sphere(ds.p, c, r, ro, rd)
        occ = occ | ((det >= 0.0) & (t < bound))
    for c, nrm, _o in ds.pln:
        ok, t = _k1_plane(ds.p, c, nrm, ro, rd)
        occ = occ | (ok & (t < bound))
    return occ


def render_k1(ds: DevScene, lanes: Lanes, num_samples: int, counts: dict | None = None):
    """The sphere/plane schedule -> (radiance sums [n, 3], rays [n])."""
    p, dt, dev = ds.p, ds.dtype, ds.device
    n = lanes.slot.shape[0]
    px, py = lanes.px.to(dt), lanes.py.to(dt)
    sx, sy = (lanes.sub % 2).to(dt), (lanes.sub // 2).to(dt)
    z = torch.zeros(n, dtype=dt, device=dev)
    one = torch.ones(n, dtype=dt, device=dev)
    zero3 = (z, z, z)
    rays = torch.zeros(n, dtype=torch.int64, device=dev)
    active = torch.zeros(n, dtype=torch.bool, device=dev)
    j = torch.zeros(n, dtype=torch.int64, device=dev)
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    ro = rd = L = beta = emis = acc = zero3
    hard_cap = num_samples * (p.max_depth + 2) + 64
    for it in range(hard_cap):
        def u(draw, it=it):
            return uniform(lanes.seed, lanes.slot, it, draw, dt)

        got = ~active & (j < num_samples)
        crd = camera(ds, px, py, sx, sy, u(0), u(1))
        ro = where3(got, ds.cam_pos, ro)
        rd = where3(got, crd, rd)
        depth = torch.where(got, 0, depth)
        L = where3(got, zero3, L)
        beta = where3(got, (one, one, one), beta)
        emis = where3(got, (one, one, one), emis)
        j = torch.where(got, j + 1, j)
        active = active | got

        rays = rays + active.to(torch.int64)
        obj, nrm, x, hit_valid = k1_trace(ds, ro, rd)
        valid = active & hit_valid
        done_miss = active & ~hit_valid
        em = ds.emitted[obj]
        L = where3(valid, add3(L, mul3(emis, (em[:, 0], em[:, 1], em[:, 2]))), L)
        o = scale3(rd, -1.0)
        depth = torch.where(active, depth + 1, depth)
        is_spec = ds.is_spec[obj]
        fd = ds.c_d[obj] * (ds.k_d[obj] * INV_PI)[:, None]
        f_d = (fd[:, 0], fd[:, 1], fd[:, 2])
        cs = ds.c_s[obj]
        c_s = (cs[:, 0], cs[:, 1], cs[:, 2])

        zl = 2.0 * u(2) - 1.0
        rl = torch.sqrt(torch.clamp_min(1.0 - zl * zl, 0.0))
        phil = TWO_PI * u(3)
        ny = (rl * torch.cos(phil), rl * torch.sin(phil), zl)
        y = add3(ds.light_pos, scale3(ny, ds.light_r))
        to_y = sub3(y, x)
        dist = torch.sqrt(torch.clamp_min(dot3(to_y, to_y), 1e-20))
        wi_d = scale3(to_y, 1.0 / dist)
        r2 = torch.clamp_min(dist * dist, 1e-20)
        nee = valid & ~is_spec
        rays = rays + nee.to(torch.int64)
        occ = k1_occluded(ds, x, wi_d, dist - p.visibility_margin)
        cos_x = dot3(nrm, wi_d)
        cos_y = dot3(ny, scale3(wi_d, -1.0))
        scale = torch.where(~occ, 1.0, 0.0).to(dt) * cos_x * cos_y * (ds.light_area / r2)
        direct = tuple(ds.light_e[k] * f_d[k] * scale for k in range(3))
        L = where3(nee, add3(L, mul3(beta, direct)), L)

        p_rr = torch.where(depth <= p.rr_start_depth, 1.0, p.rr_survival).to(dt)
        cont = valid & (u(4) < p_rr) & (depth < p.max_depth)
        zc = torch.sqrt(u(5))
        rc = torch.sqrt(torch.clamp_min(1.0 - zc * zc, 0.0))
        phic = TWO_PI * u(6)
        use_y_ax = torch.abs(nrm[0]) > 0.1
        helper = (torch.where(use_y_ax, 0.0, 1.0).to(dt), torch.where(use_y_ax, 1.0, 0.0).to(dt), z)
        ub = normalize3(cross3(helper, nrm))
        vb = cross3(nrm, ub)
        wi_diff = add3(add3(scale3(ub, rc * torch.cos(phic)), scale3(vb, rc * torch.sin(phic))), scale3(nrm, zc))
        wi_spec = sub3(scale3(nrm, 2.0 * dot3(o, nrm)), o)
        wi = where3(is_spec, wi_spec, wi_diff)
        cos_c = dot3(nrm, wi_diff)
        pdf_b = torch.clamp_min(cos_c, 0.0) * INV_PI
        pdf_floor = torch.clamp_min(pdf_b, 1e-12)
        w_nonspec = tuple(torch.where(pdf_b > 1e-12, f_d[k] * cos_c / pdf_floor, 0.0) for k in range(3))
        inv_p = 1.0 / p_rr
        weight = scale3(where3(is_spec, c_s, w_nonspec), inv_p)
        beta_next = mul3(beta, weight)
        live = cont & ((beta_next[0] > 0.0) | (beta_next[1] > 0.0) | (beta_next[2] > 0.0))
        emis = where3(is_spec, scale3(beta, inv_p), zero3)
        beta = beta_next
        completed = done_miss | (valid & ~live)
        acc = where3(completed, add3(acc, L), acc)
        if counts is not None:
            counts["camera"] = counts.get("camera", 0) + int(got.sum())
            counts["bounce"] = counts.get("bounce", 0) + int(active.sum())
            counts["shadow"] = counts.get("shadow", 0) + int(nee.sum())
        active = live
        ro = where3(live, x, ro)
        rd = where3(live, wi, rd)
        if not bool((live | (j < num_samples)).any()):
            break
    return torch.stack(acc, dim=-1), rays


def render_regen(ds: DevScene, lanes: Lanes, seed: int, counts: dict | None = None, record: list | None = None):
    """The mesh schedule, one sample a lane under dispatch seed ``seed`` ->
    (radiance sums [n, 3], rays [n]). ``record``, when given, receives each
    traced batch as (origins, directions, caps or None) for the work count."""
    p, dt, dev = ds.p, ds.dtype, ds.device
    n = lanes.slot.shape[0]
    seed_u = seed & M32
    px, py = lanes.px.to(dt), lanes.py.to(dt)
    sx, sy = (lanes.sub % 2).to(dt), (lanes.sub // 2).to(dt)
    acc = torch.zeros((n, 3), dtype=dt, device=dev)
    beta = torch.ones((n, 3), dtype=dt, device=dev)
    emis = torch.ones((n, 3), dtype=dt, device=dev)
    rays = torch.zeros(n, dtype=torch.int64, device=dev)
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    if not ds.n_tris:
        raise NotImplementedError("the mesh schedule needs a mesh")
    idx = torch.arange(n, device=dev)  # the lanes still on a path
    ro = rd = None
    hard_cap = p.max_depth + 2 + 64
    for it in range(hard_cap):
        if idx.numel() == 0:
            break
        slot = lanes.slot[idx]

        def u(draw, it=it, slot=slot):
            return uniform(seed_u, slot, it, draw, dt)

        if it == 0:
            crd = camera(ds, px, py, sx, sy, u(0), u(1))
            ro = tuple(ds.cam_pos[k].expand(n) for k in range(3))
            rd = crd
        b, em3 = beta[idx], emis[idx]
        rays[idx] += 1
        if record is not None:
            record.append((torch.stack(ro, 1), torch.stack(rd, 1), None))
        t_hit, x, nrm, obj, valid = regen_trace(ds, ro, rd)
        a = acc[idx]
        a = torch.where(valid[:, None], a + em3 * ds.emitted[obj], a)
        o3 = (-rd[0], -rd[1], -rd[2])
        d = depth[idx] + 1
        is_spec = ds.is_spec[obj]
        ul = u(2)
        zl = 2.0 * ul - 1.0
        rl = torch.sqrt(torch.clamp_min(1.0 - zl * zl, 0.0))
        phi = TWO_PI * u(3)
        ny = (rl * torch.cos(phi), rl * torch.sin(phi), zl)
        y = tuple(ds.light_pos[k] + ny[k] * ds.light_r for k in range(3))
        pdf_l = torch.full_like(ul, 1.0) / ds.light_area
        to_y = sub3(y, x)
        dist = torch.sqrt(dot3(to_y, to_y))
        wi_d = scale3(to_y, 1.0 / torch.clamp_min(dist, 1e-20))
        r2 = torch.clamp_min(dist * dist, 1e-20)
        cos_y = -dot3(ny, wi_d)
        nee = valid & ~is_spec
        rays[idx] += nee.to(torch.int64)
        shadow = nee & (cos_y > 0.0)  # a sample on the light's far side is self-occluded
        cap = torch.where(shadow, dist - p.visibility_margin, 0.0).to(dt)
        s_ro = where3(shadow, x, PARK_RO)
        s_rd = where3(shadow, wi_d, PARK_RD)
        vis = torch.zeros_like(shadow)
        sidx = shadow.nonzero().squeeze(1)
        if sidx.numel():
            sub_ro = tuple(c[sidx] for c in s_ro)
            sub_rd = tuple(c[sidx] for c in s_rd)
            if record is not None:
                record.append((torch.stack(sub_ro, 1), torch.stack(sub_rd, 1), cap[sidx]))
            sh_t = regen_trace(ds, sub_ro, sub_rd, t_cap=cap[sidx])
            vis[sidx] = ~(sh_t < INF) | (sh_t + p.visibility_margin >= dist[sidx])
        vis = vis & (cos_y > 0.0)
        fd = torch.where(is_spec[:, None], 0.0, ds.c_d[obj] * (ds.k_d[obj] * INV_PI)[:, None]).to(dt)
        cos_x = dot3(nrm, wi_d)
        scale = torch.where(vis, 1.0, 0.0).to(dt) * cos_x * cos_y / (r2 * pdf_l)
        direct = ds.light_e[None, :] * fd * scale[:, None]
        a = a + torch.where(nee[:, None], b * direct, 0.0)
        # Roulette and the bounce.
        pr = torch.where(d <= p.rr_start_depth, 1.0, p.rr_survival).to(dt)
        cont = valid & (u(4) < pr) & (d < p.max_depth)
        ub = u(5)
        use_y = torch.abs(nrm[0]) > 0.1
        hx = torch.where(use_y, 0.0, 1.0).to(dt)
        hy = torch.where(use_y, 1.0, 0.0).to(dt)
        cx, cy, cz = hy * nrm[2], -hx * nrm[2], hx * nrm[1] - hy * nrm[0]
        inv = torch.sqrt(cx * cx + cy * cy + cz * cz).reciprocal()
        un = (cx * inv, cy * inv, cz * inv)
        vn = cross3(nrm, un)
        zc = torch.sqrt(ub)
        rc = torch.sqrt(torch.clamp_min(1.0 - zc * zc, 0.0))
        phic = TWO_PI * u(6)
        dx, dy = rc * torch.cos(phic), rc * torch.sin(phic)
        i_diff = tuple(un[k] * dx + vn[k] * dy + nrm[k] * zc for k in range(3))
        pdf_diff = torch.clamp_min(dot3(nrm, i_diff), 0.0) * INV_PI
        d2 = 2.0 * dot3(o3, nrm)
        i_spec = (d2 * nrm[0] - o3[0], d2 * nrm[1] - o3[1], d2 * nrm[2] - o3[2])
        wi = where3(is_spec, i_spec, i_diff)
        pdf_b = torch.where(is_spec, 1.0, pdf_diff).to(dt)
        cos_c = dot3(nrm, wi)
        w_ns = torch.where((pdf_b > 1e-12)[:, None], fd * (cos_c / torch.clamp_min(pdf_b, 1e-12))[:, None], 0.0)
        weight = torch.where(is_spec[:, None], ds.c_s[obj], w_ns) / pr[:, None]
        beta_next = b * weight
        alive = cont & (beta_next > 0.0).any(dim=1)
        acc[idx] = a
        beta[idx] = beta_next
        emis[idx] = torch.where(is_spec[:, None], b / pr[:, None], 0.0).to(dt)
        depth[idx] = d
        if counts is not None:
            counts["camera"] = counts.get("camera", 0) + (n if it == 0 else 0)
            counts["bounce"] = counts.get("bounce", 0) + int(idx.numel())
            counts["shadow"] = counts.get("shadow", 0) + int(nee.sum())
            counts["shadow_traced"] = counts.get("shadow_traced", 0) + int(sidx.numel())
        keep = alive.nonzero().squeeze(1)
        idx = idx[keep]
        ro = tuple(c[keep] for c in x)
        rd = tuple(c[keep] for c in wi)
    return acc, rays


def finalize(sums: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Per-subpixel sums [..., 4, 3] -> u8 [..., 3]: mean, clamp, average of
    the four subpixels, clamp, gamma 1/2.2, x255 + 0.5, floor."""
    ns = torch.as_tensor(num_samples, device=sums.device).to(sums.dtype)
    mean = sums / torch.clamp_min(ns, 1.0)
    c = torch.clamp(mean, 0.0, 1.0)
    pixel = (c[..., 0, :] + c[..., 1, :] + c[..., 2, :] + c[..., 3, :]) * 0.25
    v = torch.clamp(pixel, 0.0, 1.0) ** (1.0 / 2.2) * 255.0 + 0.5
    return torch.clamp(torch.floor(v), 0, 255).to(torch.uint8)
