"""The reference with the upstream server's third material, Phong: its scene
loader and its estimator on the mesh schedule (``"regen"``).

Plain PyTorch, numpy and tomllib in float32 (TF32 off), independent of the
program. It takes what it shares with the diffuse and mirror reference from
``render``, ``frame`` and ``scene`` by import: the counter hash and the
draws, the camera, the nearest hit over spheres, planes and mesh triangles
(``regen_trace``, brute force), the lanes of the check rows, the sample
count, the finalize, the OBJ parser and the mesh transforms.

The Phong material (the upstream's ``src/scene.rs:17-99``, scene schema
``brdf = { type = "phong", kd, ks, power, color_d, color_s }``): the value
``color_d * kd / pi + color_s * ks * (power + 2) / (2 pi) * max(o . r, 0)^power``,
r the light direction mirrored about the normal; the sample picks with
``u5`` the cosine lobe (``u5 < kd``), the power-cosine lobe around the
mirror direction (``u5 < kd + ks``) or nothing, and draws the lobe from
``u6`` and ``u7``. The estimator is ``render.render_regen``'s (NEE with the
light's far side culled, Russian roulette, contributions banked as they
arrive) with the Phong value in the light sample's term and in the
bounce's weight, written in the order the program's regen engine states
its arithmetic, so that a float32 run agrees with it pixel for pixel.

Departures from the upstream, each the program's too:

- the lobes are rotated into world space (the cosine lobe about the
  normal, the power-cosine lobe about the mirror direction); the upstream
  returns the local-frame direction (``src/scene.rs:74-95``), a bug the
  program fixes by default (``fix_phong_frame``);
- a sample that picks nothing returns the direction 0 with density 1, so
  its weight is 0 and the path ends;
- the light sample and the roulette are the mesh schedule's (the light's
  far side culled before its shadow ray, contributions banked at once).

Covered: everything ``scene`` covers, and Phong materials. ``dtype`` other
than float32 computes every float in that type: the lower-precision
control.
"""

from __future__ import annotations

import dataclasses
import os
import tomllib

import numpy as np
import torch

from rtbench.reference import frame as F
from rtbench.reference import render as R
from rtbench.reference import scene as RS
from rtbench.reference.render import INV_PI, TWO_PI, cross3, dot3, sub3, where3

PHONG = 2


@dataclasses.dataclass(frozen=True)
class PhongScene(RS.RefScene):
    k_s: np.ndarray  # f32[O] weight of the power-cosine lobe
    power: np.ndarray  # f32[O] its exponent (0 off Phong materials)


def _material(b: dict) -> tuple:
    """A ``brdf`` table -> (kind, colour d, colour s, kd, ks, power)."""
    if b["type"] == "diffuse":
        return RS.DIFFUSE, b["kd"], [0, 0, 0], 1.0, 0.0, 0.0
    if b["type"] == "specular":
        return RS.SPECULAR, [0, 0, 0], b["ks"], 0.0, 1.0, 0.0
    if b["type"] == "phong":
        return PHONG, b["color_d"], b["color_s"], float(b["kd"]), float(b["ks"]), float(b["power"])
    raise NotImplementedError(f"brdf {b['type']!r}")


def load(path: str) -> PhongScene:
    """The scene of a TOML file, read as ``scene.load`` reads it, with
    Phong materials; meshes resolve under ``<its dir>/assets/``."""
    with open(path, "rb") as fh:
        doc = tomllib.load(fh)
    assets = os.path.join(os.path.dirname(os.path.abspath(path)), "assets")
    f32 = np.float32
    sph, pln, tris, tri_obj, mats, emitted = [], [], [], [], [], []
    for i, o in enumerate(doc.get("objects", [])):
        mats.append(_material(o["brdf"]))
        emitted.append(o.get("emitted", [0.0, 0.0, 0.0]))
        g = o["geometry"]
        transforms = o.get("transforms", [])
        if g["type"] == "sphere":
            pos, r = np.asarray(g["pos"], np.float64), float(g["r"])
            for t in transforms:
                ((kind, val),) = t.items()
                if kind == "translate":
                    pos = pos + np.asarray(val, np.float64)
                elif kind == "scale":
                    r *= float(val)
            sph.append((pos, r, i))
        elif g["type"] == "plane":
            pos, n = np.asarray(g["pos"], np.float64), np.asarray(g["n"], np.float64)
            for t in transforms:
                ((kind, val),) = t.items()
                if kind == "translate":
                    pos = pos + np.asarray(val, np.float64)
                elif kind.startswith("rotate_"):
                    n = RS._rotate(n, kind, float(val))
            pln.append((pos, n, i))
        elif g["type"] == "mesh":
            with open(os.path.join(assets, g["path"])) as fh:
                verts, faces = RS.parse_obj(fh.read())
            t = RS._mesh_transforms(verts, transforms)[faces]
            tris.append(t)
            tri_obj.append(np.full(len(t), i, np.int64))
        else:
            raise NotImplementedError(f"geometry {g['type']!r}")
    emitted = np.asarray(emitted, f32).reshape(-1, 3)
    light = [i for i in range(len(emitted)) if np.any(np.abs(emitted[i]) > 1e-5)]
    if not light:
        raise ValueError(f"{path}: no emissive object")
    lights = [s for s in sph if s[2] == light[0]]
    if not lights:
        raise NotImplementedError("the light is not a sphere")
    lr = f32(lights[0][1])
    kind, c_d, c_s, k_d, k_s, power = zip(*mats)
    return PhongScene(
        cam_pos=np.asarray(doc["camera"]["pos"], f32),
        cam_dir=np.asarray(doc["camera"]["dir"], f32),
        sph_pos=np.asarray([s[0] for s in sph], f32).reshape(-1, 3),
        sph_r=np.asarray([s[1] for s in sph], f32),
        sph_obj=np.asarray([s[2] for s in sph], np.int64),
        pln_pos=np.asarray([p[0] for p in pln], f32).reshape(-1, 3),
        pln_n=np.asarray([p[1] for p in pln], f32).reshape(-1, 3),
        pln_obj=np.asarray([p[2] for p in pln], np.int64),
        tris=np.concatenate(tris) if tris else np.zeros((0, 3, 3)),
        tri_obj=np.concatenate(tri_obj) if tri_obj else np.zeros(0, np.int64),
        brdf=np.asarray(kind, np.int64),
        c_d=np.asarray(c_d, f32).reshape(-1, 3),
        c_s=np.asarray(c_s, f32).reshape(-1, 3),
        k_d=np.asarray(k_d, f32),
        emitted=emitted,
        light_idx=light[0],
        light_pos=np.asarray(lights[0][0], f32),
        light_r=lr,
        light_area=f32(4.0 * np.pi * lr * lr),
        k_s=np.asarray(k_s, f32),
        power=np.asarray(power, f32),
    )


class DevScene(R.DevScene):
    """``render.DevScene`` with the Phong materials' arrays."""

    def __init__(self, sc: PhongScene, p: R.Params, device, dtype=torch.float32):
        super().__init__(sc, p, device, dtype)
        self.k_s = torch.as_tensor(sc.k_s).to(self.device, dtype)
        self.power = torch.as_tensor(sc.power).to(self.device, dtype)
        self.is_phong = torch.as_tensor(sc.brdf == PHONG).to(self.device)


def dev_scene(path: str, p: R.Params, device, dtype=torch.float32) -> DevScene:
    return DevScene(load(path), p, device, dtype)


def _frame(n):
    """The tangent frame (u, v, n) about ``n``: helper axis y if |n.x| > 0.1, else x."""
    use_y = torch.abs(n[0]) > 0.1
    hx = torch.where(use_y, 0.0, 1.0).to(n[0].dtype)
    hy = torch.where(use_y, 1.0, 0.0).to(n[0].dtype)
    cx, cy, cz = hy * n[2], -hx * n[2], hx * n[1] - hy * n[0]
    inv = torch.sqrt(cx * cx + cy * cy + cz * cz).reciprocal()
    u = (cx * inv, cy * inv, cz * inv)
    return u, cross3(n, u), n


def _rotate(fr, d):
    """The local direction ``d`` in world space of the frame ``fr``."""
    u, v, w = fr
    return tuple(u[k] * d[0] + v[k] * d[1] + w[k] * d[2] for k in range(3))


def _mirror(v, n):
    d2 = 2.0 * dot3(v, n)
    return (d2 * n[0] - v[0], d2 * n[1] - v[1], d2 * n[2] - v[2])


def value(ds: DevScene, obj, nrm, o3, wi):
    """The material's value [n, 3] toward ``wi`` seen from ``o3``: 0 on a
    mirror, the cosine term on a diffuse surface, and the power-cosine lobe
    added on a Phong one."""
    f = ds.c_d[obj] * (ds.k_d[obj] * INV_PI)[:, None]
    p = ds.power[obj]
    cos_r = torch.clamp_min(dot3(o3, _mirror(wi, nrm)), 0.0)
    lobe = torch.where(p > 0.0, cos_r ** p, 0.0)
    spec = ds.c_s[obj] * (ds.k_s[obj] * (p + 2.0) / TWO_PI * lobe)[:, None]
    f = f + torch.where(ds.is_phong[obj][:, None], spec, 0.0)
    return torch.where(ds.is_spec[obj][:, None], 0.0, f)


def sample(ds: DevScene, obj, nrm, o3, u5, u6, u7):
    """The bounce's direction and density: the mirror direction (density 1),
    the cosine lobe from (u5, u6), or on a Phong surface the lobe u5 picks,
    drawn from (u6, u7)."""
    fr = _frame(nrm)
    z = torch.sqrt(u5)
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = TWO_PI * u6
    i_diff = _rotate(fr, (r * torch.cos(phi), r * torch.sin(phi), z))
    pdf_diff = torch.clamp_min(dot3(nrm, i_diff), 0.0) * INV_PI
    i_spec = _mirror(o3, nrm)
    k_d, k_s, p = ds.k_d[obj], ds.k_s[obj], ds.power[obj]
    pick_d = u5 < k_d
    pick_s = ~pick_d & (u5 < k_d + k_s)
    rp = torch.sqrt(torch.clamp_min(1.0 - u6, 0.0))
    phip = TWO_PI * u7
    cos_p, sin_p = torch.cos(phip), torch.sin(phip)
    ph_d = _rotate(fr, (rp * cos_p, rp * sin_p, torch.sqrt(u6)))
    zs = u6 ** (1.0 / (p + 1.0))
    rs = torch.sqrt(torch.clamp_min(1.0 - u6 ** (2.0 / (p + 1.0)), 0.0))
    pdf_s = (p + 1.0) / TWO_PI * zs ** p
    axis = R.normalize3(i_spec, eps=1e-20)
    ph_s = _rotate(_frame(axis), (rs * cos_p, rs * sin_p, zs))
    i_phong = where3(pick_d, ph_d, where3(pick_s, ph_s, 0.0))
    pdf_phong = torch.where(pick_d, torch.clamp_min(dot3(nrm, ph_d), 0.0) * INV_PI,
                            torch.where(pick_s, pdf_s, 1.0))
    is_spec, is_phong = ds.is_spec[obj], ds.is_phong[obj]
    wi = where3(is_spec, i_spec, where3(is_phong, i_phong, i_diff))
    pdf = torch.where(is_spec, 1.0, torch.where(is_phong, pdf_phong, pdf_diff))
    return wi, pdf


def render_regen(ds: DevScene, lanes: R.Lanes, seed: int, counts: dict | None = None, record: list | None = None):
    """The mesh schedule with Phong materials, one sample a lane under
    dispatch seed ``seed`` -> (radiance sums [n, 3], rays [n]); draws 0-6 as
    ``render.render_regen`` places them, and 7 the Phong lobe's third.
    ``counts`` and ``record`` as there."""
    p, dt, dev = ds.p, ds.dtype, ds.device
    n = lanes.slot.shape[0]
    seed_u = seed & R.M32
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
    for it in range(p.max_depth + 2 + 64):
        if idx.numel() == 0:
            break
        slot = lanes.slot[idx]

        def u(draw, it=it, slot=slot):
            return R.uniform(seed_u, slot, it, draw, dt)

        if it == 0:
            ro = tuple(ds.cam_pos[k].expand(n) for k in range(3))
            rd = R.camera(ds, px, py, sx, sy, u(0), u(1))
        b, em3 = beta[idx], emis[idx]
        rays[idx] += 1
        if record is not None:
            record.append((torch.stack(ro, 1), torch.stack(rd, 1), None))
        _t, x, nrm, obj, valid = R.regen_trace(ds, ro, rd)
        a = acc[idx]
        a = torch.where(valid[:, None], a + em3 * ds.emitted[obj], a)
        o3 = (-rd[0], -rd[1], -rd[2])
        d = depth[idx] + 1
        is_spec = ds.is_spec[obj]
        # Next-event estimation on the sphere light.
        ul = u(2)
        zl = 2.0 * ul - 1.0
        rl = torch.sqrt(torch.clamp_min(1.0 - zl * zl, 0.0))
        phi = TWO_PI * u(3)
        ny = (rl * torch.cos(phi), rl * torch.sin(phi), zl)
        y = tuple(ds.light_pos[k] + ny[k] * ds.light_r for k in range(3))
        pdf_l = torch.full_like(ul, 1.0) / ds.light_area
        to_y = sub3(y, x)
        dist = torch.sqrt(dot3(to_y, to_y))
        wi_d = R.scale3(to_y, 1.0 / torch.clamp_min(dist, 1e-20))
        r2 = torch.clamp_min(dist * dist, 1e-20)
        cos_y = -dot3(ny, wi_d)
        nee = valid & ~is_spec
        rays[idx] += nee.to(torch.int64)
        shadow = nee & (cos_y > 0.0)  # a sample on the light's far side is self-occluded
        cap = torch.where(shadow, dist - p.visibility_margin, 0.0).to(dt)
        vis = torch.zeros_like(shadow)
        sidx = shadow.nonzero().squeeze(1)
        if sidx.numel():
            sub_ro = tuple(c[sidx] for c in x)
            sub_rd = tuple(c[sidx] for c in wi_d)
            if record is not None:
                record.append((torch.stack(sub_ro, 1), torch.stack(sub_rd, 1), cap[sidx]))
            sh_t = R.regen_trace(ds, sub_ro, sub_rd, t_cap=cap[sidx])
            vis[sidx] = ~(sh_t < R.INF) | (sh_t + p.visibility_margin >= dist[sidx])
        vis = vis & (cos_y > 0.0)
        fd = value(ds, obj, nrm, o3, wi_d)
        cos_x = dot3(nrm, wi_d)
        scale = torch.where(vis, 1.0, 0.0).to(dt) * cos_x * cos_y / (r2 * pdf_l)
        direct = ds.light_e[None, :] * fd * scale[:, None]
        a = a + torch.where(nee[:, None], b * direct, 0.0)
        # Roulette and the bounce.
        pr = torch.where(d <= p.rr_start_depth, 1.0, p.rr_survival).to(dt)
        cont = valid & (u(4) < pr) & (d < p.max_depth)
        wi, pdf_b = sample(ds, obj, nrm, o3, u(5), u(6), u(7))
        fc = value(ds, obj, nrm, o3, wi)
        cos_c = dot3(nrm, wi)
        w_ns = torch.where((pdf_b > 1e-12)[:, None], fc * (cos_c / torch.clamp_min(pdf_b, 1e-12))[:, None], 0.0)
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


def render_rows(ds: DevScene, schedule: str, rows: list[int], spp: int, seed: int, cards: int = 1,
                counts: dict | None = None, record: list | None = None) -> torch.Tensor:
    """u8 pixels [len(rows), W, 3] of render rows ``rows`` (0 = bottom) of
    the frame of ``spp`` under render seed ``seed``: ``frame.render_rows``
    for the mesh schedule, the one schedule of a Phong scene."""
    if schedule != "regen":
        raise NotImplementedError(f"schedule {schedule!r} with Phong materials")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = ds.p
    ns = F.samples(spp)
    if ns == 0:
        return torch.zeros((len(rows), p.width, 3), dtype=torch.uint8)
    lanes = F.lanes_of_rows(p, rows, ds.device, None, seed)
    sums = None
    for d in range(ns):
        out, _ = render_regen(ds, lanes, R.band_seed(seed, 0, d), counts, record)
        sums = out if sums is None else sums + out
    return R.finalize(sums.view(len(rows), p.width, 4, 3), ns).cpu()
