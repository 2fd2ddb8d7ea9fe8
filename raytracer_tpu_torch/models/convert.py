"""Parameter carry-over from the JAX package's scene to the port's.

``scene_from_numpy`` takes the fields of a JAX ``SceneArrays`` as numpy
arrays (``{name: np.asarray(field)}``) and its static metadata, and builds
the port's ``SceneArrays`` from them, so that both packages compute on the
very same scene. Fields the port does not keep (the BVH and its packings)
are ignored.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from raytracer_tpu_torch.models.scene import (
    META_FIELDS,
    TENSOR_FIELDS,
    SceneArrays,
    needs_bvh,
)
from raytracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def scene_from_numpy(
    d: Mapping[str, np.ndarray],
    meta: Mapping[str, Any],
    device: str | torch.device = DEFAULT_DEVICE,
) -> SceneArrays:
    """Port ``SceneArrays`` on ``device`` from JAX scene fields as numpy."""
    if meta.get("use_bvh"):
        raise needs_bvh(f"scene {meta.get('name', '')!r}")
    dev = resolve_device(device)
    tensors = {
        k: torch.from_numpy(np.array(d[k], copy=True)).to(dev) for k in TENSOR_FIELDS
    }
    return SceneArrays(**tensors, **{k: meta[k] for k in META_FIELDS})
