"""Scene data model: structure-of-arrays scene of torch tensors.

Port of ``raytracer_tpu/models/scene.py``. Primitive batches are padded to a
multiple of PAD with validity masks, and the first emissive object is the
light, exactly as in the reference package, so every kept field equals the
JAX ``SceneArrays`` field of the same name.

Mesh scenes carry the BVH of ``ops/bvh.py``: the binary tree and its
treetop cut (equal to the JAX fields of the same names), the 8-wide node
table ``bvh8_nodes_flat`` (equal to JAX's), the binary node table
``bvh_binary_nodes`` (the rows of JAX's ``bvh_nodes_packed``), the same
nodes in 32 bytes each (``bvh_binary_nodes8``, and ``bvh_octant_nodes``:
one near-child-first layout per direction octant, which K4 walks) and the
leaf-triangle table ``bvh_leaf_tris`` that the Hopper kernels read (the
rows of JAX's ``bvh_tris_packed``). Scenes without a BVH hold the JAX
package's one-row zero placeholders in the shared fields and an empty leaf
table. The TPU tile packings (``bvh_nodes_packed``, ``bvh8_nodes_packed``,
``bvh_tris_packed``, ``bvh_tris_mxu``) are not kept.
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
    "bvh_lo", "bvh_hi", "bvh_skip", "bvh_first", "bvh_count",
    "bvh_cut_lo", "bvh_cut_hi", "bvh8_nodes_flat", "bvh_binary_nodes",
    "bvh_binary_nodes8", "bvh_octant_nodes", "bvh_leaf_tris",
)
META_FIELDS = (
    "name", "light_idx", "light_type", "n_objects", "n_spheres", "n_planes",
    "n_triangles", "has_phong", "use_bvh", "bvh_tri_start", "bvh8_max_stack",
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
    # BVH over the mesh triangles [bvh_tri_start, n_triangles) (ops/bvh.py)
    bvh_lo: torch.Tensor  # [Nn,3] node AABB min
    bvh_hi: torch.Tensor  # [Nn,3] node AABB max
    bvh_skip: torch.Tensor  # [Nn] i32 first node past the subtree
    bvh_first: torch.Tensor  # [Nn] i32 first triangle of a leaf
    bvh_count: torch.Tensor  # [Nn] i32 leaf triangle count (0 internal)
    bvh_cut_lo: torch.Tensor  # [C,3] treetop-cut boxes (coherence key)
    bvh_cut_hi: torch.Tensor  # [C,3]
    bvh8_nodes_flat: torch.Tensor  # [Nw,64] f32 wide nodes (K2)
    bvh_binary_nodes: torch.Tensor  # [Nn,12] f32 binary nodes (JAX's rows)
    bvh_binary_nodes8: torch.Tensor  # [Nn,8] f32 binary nodes, 32 bytes each
    bvh_octant_nodes: torch.Tensor  # [8,Nn,8] f32 near-child-first layouts (K4)
    bvh_leaf_tris: torch.Tensor  # [F',12] f32 leaf triangle rows (K2, K4)

    name: str = ""
    light_idx: int = 0
    light_type: int = LIGHT_SPHERE
    n_objects: int = 0
    n_spheres: int = 0
    n_planes: int = 0
    n_triangles: int = 0
    has_phong: bool = True
    use_bvh: bool = False
    # Triangles below this index (cube/prism objects) are brute-forced.
    bvh_tri_start: int = 0
    # Stack depth the 8-wide traversal needs (pops 1 / pushes <= 7 net per
    # visit along one root-to-leaf path).
    bvh8_max_stack: int = 1

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
    bvh: Any | None = None,
    bvh_tri_start: int = 0,
    device: str | torch.device = DEFAULT_DEVICE,
) -> SceneArrays:
    """Assemble padded tensors on ``device`` from host-side lists.

    ``spheres``: [{pos, r, obj}], ``planes``: [{pos, n, obj}],
    ``triangles``: [{a, b, c, obj}], ``materials``: per-object dicts with
    keys emitted, brdf_type, c_d, c_s, k_d, k_s, power. ``bvh`` is
    ``ops.bvh.build_bvh``'s tree over ``triangles[bvh_tri_start:]``, which
    must already be in its leaf order (with degenerate pads).
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
        **_bvh_fields(bvh, triangles[bvh_tri_start:]),
    )
    max_stack = host.pop("max_stack")
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
        use_bvh=bvh is not None,
        bvh_tri_start=bvh_tri_start,
        bvh8_max_stack=int(max_stack),
    )


def _bvh_fields(bvh, tail: list[dict[str, Any]]) -> dict[str, Any]:
    """The BVH fields (and ``max_stack``) for the tree over ``tail``."""
    from raytracer_tpu_torch.ops.bvh import (
        collapse_bvh8,
        pack_binary_nodes,
        pack_binary_nodes8,
        pack_bvh8_nodes,
        pack_leaf_tris,
        pack_octant_nodes,
        max_cut_from_env,
        treetop_cut,
    )

    if bvh is None:
        z3 = np.zeros((1, 3), np.float32)
        zi = np.zeros((1,), np.int32)
        return dict(
            bvh_lo=z3, bvh_hi=z3, bvh_skip=zi, bvh_first=zi, bvh_count=zi,
            bvh_cut_lo=z3, bvh_cut_hi=z3,
            bvh8_nodes_flat=np.zeros((1, 64), np.float32),
            bvh_binary_nodes=np.zeros((1, 12), np.float32),
            bvh_binary_nodes8=np.zeros((1, 8), np.float32),
            bvh_octant_nodes=np.zeros((8, 1, 8), np.float32),
            bvh_leaf_tris=np.zeros((0, 12), np.float32),
            max_stack=1,
        )
    lo, hi, skip, first, count = bvh
    cut = treetop_cut(bvh, max_cut=max_cut_from_env())
    tri_pts = np.stack(
        [np.stack([t[k] for t in tail]) for k in ("a", "b", "c")], axis=1
    ).astype(np.float64)
    w_lo, w_hi, w_child, w_count, max_stack = collapse_bvh8(bvh)
    return dict(
        bvh_lo=lo, bvh_hi=hi, bvh_skip=skip, bvh_first=first, bvh_count=count,
        bvh_cut_lo=lo[cut], bvh_cut_hi=hi[cut],
        bvh8_nodes_flat=pack_bvh8_nodes(w_lo, w_hi, w_child, w_count),
        bvh_binary_nodes=pack_binary_nodes(bvh),
        bvh_binary_nodes8=pack_binary_nodes8(bvh),
        bvh_octant_nodes=pack_octant_nodes(bvh),
        bvh_leaf_tris=pack_leaf_tris(tri_pts),
        max_stack=max_stack,
    )
