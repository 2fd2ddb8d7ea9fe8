"""The port's scene loader and parameter carry-over against the JAX package:
every kept field equal, exactly, for the scenes of the port's first slice."""

import os

import numpy as np
import pytest
import torch

from raytracer_tpu.models.loader import load_scene as jax_load_scene
from raytracer_tpu.ops.intersect import tri_precompute as jax_tri_precompute
from raytracer_tpu_torch.models.convert import scene_from_numpy
from raytracer_tpu_torch.models.loader import load_scene
from raytracer_tpu_torch.models.scene import META_FIELDS, TENSOR_FIELDS
from raytracer_tpu_torch.ops.intersect import tri_precompute

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


@pytest.fixture(scope="module", params=["cornell_box", "cubes"])
def pair(request):
    path = os.path.join(SCENES, f"{request.param}.toml")
    return jax_load_scene(path), load_scene(path, device="cpu")


def _jax_fields(scene):
    return {k: np.asarray(getattr(scene, k)) for k in TENSOR_FIELDS}


def test_fields_equal_jax(pair):
    ref, port = pair
    for k, want in _jax_fields(ref).items():
        got = getattr(port, k).numpy()
        assert got.dtype == want.dtype, k
        assert got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for k in META_FIELDS:
        assert getattr(port, k) == getattr(ref, k), k


def test_scene_from_numpy_equals_loader(pair):
    ref, port = pair
    meta = {k: getattr(ref, k) for k in META_FIELDS}
    conv = scene_from_numpy(_jax_fields(ref), meta, device="cpu")
    for k in TENSOR_FIELDS:
        assert torch.equal(getattr(conv, k), getattr(port, k)), k
    for k in META_FIELDS:
        assert getattr(conv, k) == getattr(port, k), k


def test_tri_precompute_matches_jax(pair):
    ref, port = pair
    want = jax_tri_precompute(ref.tri_a, ref.tri_b, ref.tri_c)
    got = tri_precompute(port.tri_a, port.tri_b, port.tri_c)
    for name in want._fields:
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=1e-6, atol=1e-12, err_msg=name,
        )


def test_mesh_scene_raises_slice_two():
    with pytest.raises(NotImplementedError, match="slice two"):
        load_scene(os.path.join(SCENES, "flying_unicorn.toml"), device="cpu")
