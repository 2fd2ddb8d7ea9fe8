"""Parameter carry-over from the JAX package's scene to the port's.

``scene_from_numpy`` takes the fields of a JAX ``SceneArrays`` as numpy
arrays (``{name: np.asarray(field)}``) and its static metadata, and builds
the port's ``SceneArrays`` from them, so that both packages compute on the
very same scene. The leaf-triangle table the port keeps is unpacked from
JAX's ``bvh_tris_packed`` tiles, and the binary node table is packed from
the tree's five arrays (``ops.bvh.pack_binary_nodes``); the other TPU
packings are ignored. The wide node table is checked for K2's leaf layout
(``ops.bvh.check_leaf_groups``). The mesh-light fields (``light_tri_idx``,
``light_tri_cdf``, ``light_area``) are carried as they are.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from raytracer_tpu_torch.models.scene import META_FIELDS, TENSOR_FIELDS, SceneArrays
from raytracer_tpu_torch.ops.bvh import check_leaf_groups, pack_binary_nodes
from raytracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def leaf_tris_from_packed(packed: np.ndarray, n_rows: int) -> np.ndarray:
    """JAX's ``bvh_tris_packed`` [TR, 12*MAX_LEAF, 128] -> [n_rows, 12]
    (triangle k of leaf group g sits at fields 12k..12k+11 of lane g%128)."""
    tr, fields, lanes = packed.shape
    return packed.transpose(0, 2, 1).reshape(tr * lanes * (fields // 12), 12)[:n_rows]


def scene_from_numpy(
    d: Mapping[str, np.ndarray],
    meta: Mapping[str, Any],
    device: str | torch.device = DEFAULT_DEVICE,
) -> SceneArrays:
    """Port ``SceneArrays`` on ``device`` from JAX scene fields as numpy."""
    dev = resolve_device(device)
    host = dict(d)
    if "bvh_leaf_tris" not in host:
        n_rows = meta["n_triangles"] - meta["bvh_tri_start"] if meta["use_bvh"] else 0
        host["bvh_leaf_tris"] = leaf_tris_from_packed(np.asarray(d["bvh_tris_packed"]), n_rows)
    if "bvh_binary_nodes" not in host:
        tree = [np.asarray(d[k]) for k in ("bvh_lo", "bvh_hi", "bvh_skip", "bvh_first", "bvh_count")]
        host["bvh_binary_nodes"] = (
            pack_binary_nodes(tree) if meta["use_bvh"] else np.zeros((1, 12), np.float32)
        )
    if meta["use_bvh"]:
        nodes = np.asarray(host["bvh8_nodes_flat"]).reshape(-1, 8, 8)
        check_leaf_groups(nodes[..., 6].astype(np.int64), nodes[..., 7].astype(np.int64))
    tensors = {
        k: torch.from_numpy(np.array(host[k], copy=True)).to(dev) for k in TENSOR_FIELDS
    }
    return SceneArrays(**tensors, **{k: meta[k] for k in META_FIELDS})
