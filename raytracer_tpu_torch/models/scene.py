"""Scene data model: structure-of-arrays scene of torch tensors.

Port of ``raytracer_tpu/models/scene.py``. Primitive batches are padded to a
multiple of PAD with validity masks, and the first emissive object is the
light, exactly as in the reference package, so every kept field equals the
JAX ``SceneArrays`` field of the same name.

Not ported in this slice: the BVH arrays and their TPU packings (a scene
that needs a BVH raises ``NotImplementedError``), and the dummy buffers the
JAX package adds to dodge an XLA shard_map bug.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from raytracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

# BRDF type tags and light kinds (same values as the JAX package).
BRDF_DIFFUSE = 0
BRDF_SPECULAR = 1
BRDF_PHONG = 2
LIGHT_SPHERE = 0
LIGHT_MESH = 1

PAD = 8  # pad primitive batches to a multiple of this


def needs_bvh(what: str) -> NotImplementedError:
    """The error for anything that needs a BVH, which this port lacks."""
    return NotImplementedError(
        f"{what} needs a BVH, which raytracer_tpu_torch does not have yet "
        "(ROADMAP.md queue 1, slice two: BVH host build, kernels K2 and K3)"
    )


def _pad(a: np.ndarray, n: int, fill: float = 0.0) -> np.ndarray:
    if a.shape[0] == n:
        return a
    pad_width = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad_width, constant_values=fill)


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


# Names of the tensor fields, in declaration order (also the keys that
# ``models.convert.scene_from_numpy`` reads).
TENSOR_FIELDS = (
    "sph_pos", "sph_r", "sph_obj", "sph_valid",
    "pln_pos", "pln_n", "pln_obj", "pln_valid",
    "tri_a", "tri_b", "tri_c", "tri_obj", "tri_valid",
    "obj_emitted", "brdf_type", "c_d", "c_s", "k_d", "k_s", "phong_power",
    "light_sph_pos", "light_sph_r", "light_tri_idx", "light_tri_cdf", "light_area",
    "cam_pos", "cam_dir",
)
META_FIELDS = (
    "name", "light_idx", "light_type", "n_objects", "n_spheres", "n_planes",
    "n_triangles", "has_phong", "use_bvh",
)


@dataclasses.dataclass(frozen=True, eq=False)
class SceneArrays:
    """SoA scene: tensors on one device + static metadata.

    Shapes and dtypes are those of the JAX ``SceneArrays``: [S,3]/[S] f32
    spheres, [P,3] planes, [T,3] triangle corners, per-object materials
    [O,...], ``*_obj`` i32 object ids, ``*_valid`` bool masks.
    """

    sph_pos: torch.Tensor  # [S,3]
    sph_r: torch.Tensor  # [S]
    sph_obj: torch.Tensor  # [S] i32
    sph_valid: torch.Tensor  # [S] bool
    pln_pos: torch.Tensor  # [P,3]
    pln_n: torch.Tensor  # [P,3]
    pln_obj: torch.Tensor  # [P] i32
    pln_valid: torch.Tensor  # [P] bool
    tri_a: torch.Tensor  # [T,3]
    tri_b: torch.Tensor  # [T,3]
    tri_c: torch.Tensor  # [T,3]
    tri_obj: torch.Tensor  # [T] i32
    tri_valid: torch.Tensor  # [T] bool
    obj_emitted: torch.Tensor  # [O,3]
    brdf_type: torch.Tensor  # [O] i32
    c_d: torch.Tensor  # [O,3]
    c_s: torch.Tensor  # [O,3]
    k_d: torch.Tensor  # [O]
    k_s: torch.Tensor  # [O]
    phong_power: torch.Tensor  # [O]
    light_sph_pos: torch.Tensor  # [3]
    light_sph_r: torch.Tensor  # []
    light_tri_idx: torch.Tensor  # [Lt] i32
    light_tri_cdf: torch.Tensor  # [Lt] f32
    light_area: torch.Tensor  # []
    cam_pos: torch.Tensor  # [3]
    cam_dir: torch.Tensor  # [3]

    name: str = ""
    light_idx: int = 0
    light_type: int = LIGHT_SPHERE
    n_objects: int = 0
    n_spheres: int = 0
    n_planes: int = 0
    n_triangles: int = 0
    has_phong: bool = True
    use_bvh: bool = False  # always False until the BVH is ported

    @property
    def device(self) -> torch.device:
        return self.sph_pos.device

    def to(self, device: str | torch.device) -> "SceneArrays":
        """A copy with every tensor on ``device`` (self if already there)."""
        dev = resolve_device(device)
        if self.device == dev:
            return self
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(dev) for f in TENSOR_FIELDS}
        )


def build_scene_arrays(
    name: str,
    camera_pos: np.ndarray,
    camera_dir: np.ndarray,
    spheres: list[dict[str, Any]],
    planes: list[dict[str, Any]],
    triangles: list[dict[str, Any]],
    materials: list[dict[str, Any]],
    device: str | torch.device = DEFAULT_DEVICE,
) -> SceneArrays:
    """Assemble padded tensors on ``device`` from host-side lists.

    ``spheres``: [{pos, r, obj}], ``planes``: [{pos, n, obj}],
    ``triangles``: [{a, b, c, obj}], ``materials``: per-object dicts with
    keys emitted, brdf_type, c_d, c_s, k_d, k_s, power.
    """
    dev = resolve_device(device)
    f = np.float32

    ns, np_, nt = len(spheres), len(planes), len(triangles)
    S, P, T = _round_up(ns, PAD), _round_up(np_, PAD), _round_up(nt, PAD)

    def stack(items, key, dim):
        if not items:
            return np.zeros((0, dim) if dim else (0,), f)
        arr = np.asarray([it[key] for it in items], f)
        return arr.reshape(len(items), dim) if dim else arr

    def mask(n_real, n_pad):
        m = np.zeros(n_pad, bool)
        m[:n_real] = True
        return m

    no = len(materials)
    obj_emitted = np.asarray([m["emitted"] for m in materials], f).reshape(no, 3)
    brdf_type = np.asarray([m["brdf_type"] for m in materials], np.int32)

    # First emissive object is THE light (reference src/scene.rs:129-137).
    emissive = [i for i in range(no) if np.any(np.abs(obj_emitted[i]) > 1e-5)]
    if not emissive:
        raise ValueError(f"scene {name!r} has no emissive object")
    light_idx = emissive[0]

    light_sph = [s for s in spheres if s["obj"] == light_idx]
    light_tris = [(i, t) for i, t in enumerate(triangles) if t["obj"] == light_idx]
    if light_sph:
        light_type = LIGHT_SPHERE
        lpos = np.asarray(light_sph[0]["pos"], f)
        lr = f(light_sph[0]["r"])
        larea = f(4.0 * np.pi * lr * lr)
        lt_idx = np.zeros(PAD, np.int32)
        lt_cdf = np.ones(PAD, f)
    elif light_tris:
        light_type = LIGHT_MESH
        lpos = np.zeros(3, f)
        lr = f(0.0)
        areas = []
        for _, t in light_tris:
            ab = np.asarray(t["b"], np.float64) - np.asarray(t["a"], np.float64)
            ac = np.asarray(t["c"], np.float64) - np.asarray(t["a"], np.float64)
            areas.append(0.5 * np.linalg.norm(np.cross(ab, ac)))
        areas = np.asarray(areas)
        larea = f(areas.sum())
        cdf = np.cumsum(areas) / areas.sum()
        nl = _round_up(len(light_tris), PAD)
        lt_idx = _pad(np.asarray([i for i, _ in light_tris], np.int32), nl)
        lt_cdf = _pad(cdf.astype(f), nl, fill=2.0)  # pad > 1 so never selected
    else:
        raise ValueError(f"light object {light_idx} in {name!r} has unsupported geometry")

    host = dict(
        sph_pos=_pad(stack(spheres, "pos", 3), S),
        sph_r=_pad(stack(spheres, "r", 0), S),
        sph_obj=_pad(np.asarray([s["obj"] for s in spheres], np.int32), S),
        sph_valid=mask(ns, S),
        pln_pos=_pad(stack(planes, "pos", 3), P),
        pln_n=_pad(stack(planes, "n", 3), P),
        pln_obj=_pad(np.asarray([p["obj"] for p in planes], np.int32), P),
        pln_valid=mask(np_, P),
        tri_a=_pad(stack(triangles, "a", 3), T),
        tri_b=_pad(stack(triangles, "b", 3), T),
        tri_c=_pad(stack(triangles, "c", 3), T),
        tri_obj=_pad(np.asarray([t["obj"] for t in triangles], np.int32), T),
        tri_valid=mask(nt, T) & _pad(
            np.asarray([t.get("valid", True) for t in triangles], bool), T
        ),
        obj_emitted=obj_emitted,
        brdf_type=brdf_type,
        c_d=np.asarray([m["c_d"] for m in materials], f).reshape(no, 3),
        c_s=np.asarray([m["c_s"] for m in materials], f).reshape(no, 3),
        k_d=np.asarray([m["k_d"] for m in materials], f),
        k_s=np.asarray([m["k_s"] for m in materials], f),
        phong_power=np.asarray([m["power"] for m in materials], f),
        light_sph_pos=lpos,
        light_sph_r=np.asarray(lr),
        light_tri_idx=lt_idx,
        light_tri_cdf=lt_cdf,
        light_area=np.asarray(larea),
        cam_pos=np.asarray(camera_pos, f),
        cam_dir=np.asarray(camera_dir, f),
    )
    return SceneArrays(
        **{k: torch.as_tensor(v).to(dev) for k, v in host.items()},
        name=name,
        light_idx=light_idx,
        light_type=light_type,
        n_objects=no,
        n_spheres=ns,
        n_planes=np_,
        n_triangles=nt,
        has_phong=bool((brdf_type == BRDF_PHONG).any()),
        use_bvh=False,
    )
