"""The reference's scene: a scene TOML and its OBJ meshes read again with
tomllib and numpy, independently of the program.

The schema is the upstream server's (``[camera] pos/dir``, ``[[objects]]``
with an optional ``emitted``, a tagged ``brdf`` and ``geometry``, and an
ordered ``transforms`` list). Host arithmetic is float64 and the arrays
the renderer reads are float32, rounded where the upstream scene format
says they are stored: positions, radii, normals, colours, and each mesh
triangle's corners after its transforms. Meshes rotate and scale about
their bounding-box centre; sphere rotations and plane scales are no-ops;
a plane rotation turns only its normal. The light is the first object
whose emission exceeds 1e-5 in some channel.

Covered: spheres, planes, OBJ meshes; diffuse and specular materials; a
sphere light. Anything else raises ``NotImplementedError`` (no cell of the
benchmark uses it).
"""

from __future__ import annotations

import dataclasses
import math
import os
import tomllib

import numpy as np

DIFFUSE, SPECULAR = 0, 1


@dataclasses.dataclass(frozen=True)
class RefScene:
    cam_pos: np.ndarray  # f32[3]
    cam_dir: np.ndarray  # f32[3], as written (not normalised)
    sph_pos: np.ndarray  # f32[S,3]
    sph_r: np.ndarray  # f32[S]
    sph_obj: np.ndarray  # i64[S]
    pln_pos: np.ndarray  # f32[P,3]
    pln_n: np.ndarray  # f32[P,3]
    pln_obj: np.ndarray  # i64[P]
    tris: np.ndarray  # f64[F,3,3] mesh triangles (corners a, b, c) after transforms
    tri_obj: np.ndarray  # i64[F]
    brdf: np.ndarray  # i64[O]
    c_d: np.ndarray  # f32[O,3] diffuse colour
    c_s: np.ndarray  # f32[O,3] mirror colour
    k_d: np.ndarray  # f32[O]
    emitted: np.ndarray  # f32[O,3]
    light_idx: int
    light_pos: np.ndarray  # f32[3]
    light_r: np.float32
    light_area: np.float32


def parse_obj(text: str) -> tuple[np.ndarray, np.ndarray]:
    """OBJ text -> (vertices f64[V,3], faces i64[F,3], 0-based): ``v`` lines
    and the first index of the first three ``f`` tokens; the rest is ignored."""
    verts, faces = [], []
    for line in text.splitlines():
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "v":
            verts.append([float(x) for x in tok[1:4]])
        elif tok[0] == "f":
            faces.append([int(t.split("/")[0]) - 1 for t in tok[1:4]])
    v = np.asarray(verts, np.float64).reshape(-1, 3)
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    if len(f) and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError("face index out of range")
    return v, f


def _rotate(v: np.ndarray, axis: str, a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    out = v.copy()
    if axis == "rotate_x":
        out[..., 1] = v[..., 1] * c - v[..., 2] * s
        out[..., 2] = v[..., 1] * s + v[..., 2] * c
    elif axis == "rotate_y":
        out[..., 0] = v[..., 0] * c + v[..., 2] * s
        out[..., 2] = v[..., 2] * c - v[..., 0] * s
    else:
        out[..., 0] = v[..., 0] * c - v[..., 1] * s
        out[..., 1] = v[..., 0] * s + v[..., 1] * c
    return out


def _mesh_transforms(verts: np.ndarray, transforms: list) -> np.ndarray:
    for t in transforms:
        ((kind, val),) = t.items()
        if kind == "translate":
            verts = verts + np.asarray(val, np.float64)
        elif kind == "scale":
            c = (verts.min(axis=0) + verts.max(axis=0)) / 2.0
            verts = c + (verts - c) * float(val)
        elif kind in ("rotate_x", "rotate_y", "rotate_z"):
            c = (verts.min(axis=0) + verts.max(axis=0)) / 2.0
            verts = c + _rotate(verts - c, kind, float(val))
        else:
            raise NotImplementedError(f"transform {kind!r}")
    return verts


def load(path: str) -> RefScene:
    """The scene of a TOML file; meshes resolve under ``<its dir>/assets/``."""
    with open(path, "rb") as fh:
        doc = tomllib.load(fh)
    assets = os.path.join(os.path.dirname(os.path.abspath(path)), "assets")
    f32 = np.float32
    sph, pln, tris, tri_obj = [], [], [], []
    brdf, c_d, c_s, k_d, emitted = [], [], [], [], []
    for i, o in enumerate(doc.get("objects", [])):
        b = o["brdf"]
        if b["type"] == "diffuse":
            brdf.append(DIFFUSE), c_d.append(b["kd"]), c_s.append([0, 0, 0]), k_d.append(1.0)
        elif b["type"] == "specular":
            brdf.append(SPECULAR), c_d.append([0, 0, 0]), c_s.append(b["ks"]), k_d.append(0.0)
        else:
            raise NotImplementedError(f"brdf {b['type']!r}")
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
                    n = _rotate(n, kind, float(val))
            pln.append((pos, n, i))
        elif g["type"] == "mesh":
            with open(os.path.join(assets, g["path"])) as fh:
                verts, faces = parse_obj(fh.read())
            t = _mesh_transforms(verts, transforms)[faces]
            tris.append(t)
            tri_obj.append(np.full(len(t), i, np.int64))
        else:
            raise NotImplementedError(f"geometry {g['type']!r}")
    emitted = np.asarray(emitted, f32).reshape(-1, 3)
    light = [i for i in range(len(emitted)) if np.any(np.abs(emitted[i]) > 1e-5)]
    if not light:
        raise ValueError(f"{path}: no emissive object")
    light_idx = light[0]
    lights = [s for s in sph if s[2] == light_idx]
    if not lights:
        raise NotImplementedError("the light is not a sphere")
    lr = f32(lights[0][1])
    return RefScene(
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
        brdf=np.asarray(brdf, np.int64),
        c_d=np.asarray(c_d, f32).reshape(-1, 3),
        c_s=np.asarray(c_s, f32).reshape(-1, 3),
        k_d=np.asarray(k_d, f32),
        emitted=emitted,
        light_idx=light_idx,
        light_pos=np.asarray(lights[0][0], f32),
        light_r=lr,
        light_area=f32(4.0 * np.pi * lr * lr),
    )
