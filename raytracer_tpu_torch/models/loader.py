"""TOML scene loading -> ``SceneArrays``.

Port of ``raytracer_tpu/models/loader.py``: the reference's scene schema
(``[camera] pos/dir``, ``[[objects]]`` with optional ``emitted``, a tagged
``brdf`` and ``geometry``, and an ordered ``transforms`` list), with the
same transform semantics: meshes rotate and scale about their bounding-box
centre, sphere rotation and plane scale are no-ops, plane rotation turns
only the normal. Host math is f64; tensors are f32.

``cube`` and ``prism`` expand to triangles through the port's ``models/obj.py``
(a copy of the JAX package's) and are brute-forced; ``mesh`` geometry loads an OBJ from
``<scenes_dir>/assets/`` and goes behind one BVH over all mesh triangles
(``ops/bvh.py``). The triangle batch is the brute-forced prefix, then the
mesh triangles in the BVH's leaf order with degenerate pads, as in the JAX
loader.
"""

from __future__ import annotations

import math
import os
import tomllib
from typing import Any

import numpy as np
import torch

from raytracer_tpu_torch.config import SCENE_NAMES
from raytracer_tpu_torch.models import obj as objlib
from raytracer_tpu_torch.models.scene import (
    BRDF_DIFFUSE,
    BRDF_PHONG,
    BRDF_SPECULAR,
    SceneArrays,
    build_scene_arrays,
)
from raytracer_tpu_torch.ops.bvh import build_bvh
from raytracer_tpu_torch.utils.device import DEFAULT_DEVICE


class SceneLoadError(ValueError):
    pass


def _rot_x(v: np.ndarray, a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    out = v.copy()
    out[..., 1] = v[..., 1] * c - v[..., 2] * s
    out[..., 2] = v[..., 1] * s + v[..., 2] * c
    return out


def _rot_y(v: np.ndarray, a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    out = v.copy()
    out[..., 0] = v[..., 0] * c + v[..., 2] * s
    out[..., 2] = v[..., 2] * c - v[..., 0] * s
    return out


def _rot_z(v: np.ndarray, a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    out = v.copy()
    out[..., 0] = v[..., 0] * c - v[..., 1] * s
    out[..., 1] = v[..., 0] * s + v[..., 1] * c
    return out


_ROT = {"rotate_x": _rot_x, "rotate_y": _rot_y, "rotate_z": _rot_z}


def _bbox_center(verts: np.ndarray) -> np.ndarray:
    return (verts.min(axis=0) + verts.max(axis=0)) / 2.0


def _apply_transforms_mesh(verts: np.ndarray, transforms: list[dict]) -> np.ndarray:
    for t in transforms:
        (kind, val), = t.items()
        if kind == "translate":
            verts = verts + np.asarray(val, np.float64)
        elif kind == "scale":
            c = _bbox_center(verts)
            verts = c + (verts - c) * float(val)
        elif kind in _ROT:
            c = _bbox_center(verts)
            verts = c + _ROT[kind](verts - c, float(val))
        else:
            raise SceneLoadError(f"unknown transform {kind!r}")
    return verts


def _parse_brdf(spec: dict) -> dict[str, Any]:
    kind = spec.get("type")
    if kind == "diffuse":
        return dict(brdf_type=BRDF_DIFFUSE, c_d=spec["kd"], c_s=[0, 0, 0], k_d=1.0, k_s=0.0, power=0.0)
    if kind == "specular":
        return dict(brdf_type=BRDF_SPECULAR, c_d=[0, 0, 0], c_s=spec["ks"], k_d=0.0, k_s=1.0, power=0.0)
    if kind == "phong":
        return dict(
            brdf_type=BRDF_PHONG,
            c_d=spec["color_d"],
            c_s=spec["color_s"],
            k_d=float(spec["kd"]),
            k_s=float(spec["ks"]),
            power=float(spec["power"]),
        )
    raise SceneLoadError(f"unknown brdf type {kind!r}")


def load_scene_dict(
    doc: dict, name: str = "", scenes_dir: str | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> SceneArrays:
    """Build SceneArrays on ``device`` from a parsed TOML document; mesh
    paths resolve under ``<scenes_dir>/assets/``."""
    cam = doc["camera"]
    camera_pos = np.asarray(cam["pos"], np.float64)
    camera_dir = np.asarray(cam["dir"], np.float64)

    spheres, planes, materials = [], [], []
    brute_tris: list[dict] = []  # cube/prism triangles, brute-forced
    mesh_tris: list[dict] = []  # loaded meshes, behind the BVH
    for i, ospec in enumerate(doc.get("objects", [])):
        mat = _parse_brdf(ospec["brdf"])
        mat["emitted"] = ospec.get("emitted", [0.0, 0.0, 0.0])
        materials.append(mat)

        gspec = ospec["geometry"]
        gtype = gspec.get("type")
        transforms = ospec.get("transforms", [])

        if gtype == "sphere":
            pos = np.asarray(gspec["pos"], np.float64)
            r = float(gspec["r"])
            for t in transforms:
                (kind, val), = t.items()
                if kind == "translate":
                    pos = pos + np.asarray(val, np.float64)
                elif kind == "scale":
                    r *= float(val)
                # rotations are no-ops for spheres (src/geometry.rs:447)
            spheres.append(dict(pos=pos, r=r, obj=i))
        elif gtype == "plane":
            pos = np.asarray(gspec["pos"], np.float64)
            n = np.asarray(gspec["n"], np.float64)
            for t in transforms:
                (kind, val), = t.items()
                if kind == "translate":
                    pos = pos + np.asarray(val, np.float64)
                elif kind in _ROT:
                    n = _ROT[kind](n, float(val))
                # scale is a no-op for planes (src/geometry.rs:508)
            planes.append(dict(pos=pos, n=n, obj=i))
        elif gtype in ("cube", "prism", "mesh"):
            if gtype == "cube":
                verts, idx = objlib.cube(np.asarray(gspec["pos"], np.float64), float(gspec["size"]))
            elif gtype == "prism":
                s = gspec["size"]
                verts, idx = objlib.prism(
                    np.asarray(gspec["pos"], np.float64), float(s[0]), float(s[1]), float(s[2])
                )
            else:
                if scenes_dir is None:
                    raise SceneLoadError("mesh geometry requires scenes_dir")
                verts, _normals, idx = objlib.load_obj(
                    os.path.join(scenes_dir, "assets", gspec["path"])
                )
            tris = _apply_transforms_mesh(verts, transforms)[idx]  # [F,3,3]
            dest = mesh_tris if gtype == "mesh" else brute_tris
            for f in range(tris.shape[0]):
                dest.append(dict(a=tris[f, 0], b=tris[f, 1], c=tris[f, 2], obj=i))
        else:
            raise SceneLoadError(f"unknown geometry type {gtype!r}")

    bvh = None
    bvh_tri_start = len(brute_tris)
    triangles = brute_tris + mesh_tris
    if mesh_tris:
        tri_pts = np.stack(
            [np.stack([t[k] for t in mesh_tris]) for k in ("a", "b", "c")], axis=1
        )  # [F,3,3]
        bvh, order = build_bvh(tri_pts)
        degenerate = dict(a=np.zeros(3), b=np.zeros(3), c=np.zeros(3), obj=0, valid=False)
        triangles = brute_tris + [mesh_tris[j] if j >= 0 else degenerate for j in order]

    return build_scene_arrays(
        name=name,
        camera_pos=camera_pos,
        camera_dir=camera_dir,
        spheres=spheres,
        planes=planes,
        triangles=triangles,
        materials=materials,
        bvh=bvh,
        bvh_tri_start=bvh_tri_start,
        device=device,
    )


def load_scene(
    path: str, device: str | torch.device = DEFAULT_DEVICE, scenes_dir: str | None = None
) -> SceneArrays:
    """Load a ``.toml`` scene file onto ``device``; mesh paths resolve under
    ``<scenes_dir>/assets/`` (default: the file's own directory)."""
    if scenes_dir is None:
        scenes_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "rb") as fh:
        doc = tomllib.load(fh)
    name = os.path.splitext(os.path.basename(path))[0]
    return load_scene_dict(doc, name=name, scenes_dir=scenes_dir, device=device)


def load_all_scenes(
    scenes_dir: str, names=None, device: str | torch.device = DEFAULT_DEVICE
) -> dict[str, SceneArrays]:
    """Eagerly load the named scenes (default: ``SCENE_NAMES``)."""
    names = names or SCENE_NAMES
    return {
        name: load_scene(os.path.join(scenes_dir, f"{name}.toml"), device, scenes_dir)
        for name in names
    }
