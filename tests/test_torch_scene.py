"""The port's scene loader and parameter carry-over against the JAX package:
every kept field equal, exactly, for the default scenes and crewmate_phong,
and the binary node table (K4) equal to the rows of JAX's
``bvh_nodes_packed``."""

import os

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu.models.loader import load_scene as jax_load_scene
from raytracer_tpu.ops.intersect import tri_precompute as jax_tri_precompute
from raytracer_tpu_torch.models.convert import scene_from_numpy
from raytracer_tpu_torch.models.loader import SCENE_NAMES, load_all_scenes, load_scene
from raytracer_tpu_torch.models.scene import META_FIELDS, TENSOR_FIELDS
from raytracer_tpu_torch.ops.bvh import MAX_LEAF
from raytracer_tpu_torch.ops.intersect import tri_precompute
from raytracer_tpu_torch.render.renderer import select_band_engine

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


@pytest.fixture(
    scope="module", params=["cornell_box", "cubes", "flying_unicorn", "crewmate_phong"]
)
def pair(request):
    path = os.path.join(SCENES, f"{request.param}.toml")
    return jax_load_scene(path), load_scene(path, device="cpu")


@pytest.fixture(scope="module", params=["cornell_box", "cubes"])
def flat_pair(request):
    path = os.path.join(SCENES, f"{request.param}.toml")
    return jax_load_scene(path), load_scene(path, device="cpu")


def _jax_fields(scene):
    """The JAX scene's fields as numpy, for the port's fields it has (the
    leaf-triangle table is carried over from its ``bvh_tris_packed``)."""
    d = {k: np.asarray(getattr(scene, k)) for k in TENSOR_FIELDS if hasattr(scene, k)}
    d["bvh_tris_packed"] = np.asarray(scene.bvh_tris_packed)
    return d


def test_fields_equal_jax(pair):
    ref, port = pair
    for k in TENSOR_FIELDS:
        if not hasattr(ref, k):
            continue
        want = np.asarray(getattr(ref, k))
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


def test_binary_node_table_equals_jax(pair):
    """Row i of ``bvh_binary_nodes`` holds (lo, skip, hi, count, first) of
    binary node i: the fields 0-8 (lo, hi, skip, first, count) of lane
    i%128 in tile i//128 of JAX's ``bvh_nodes_packed``."""
    ref, port = pair
    nodes = port.bvh_binary_nodes.numpy()
    n = ref.bvh_lo.shape[0]
    assert nodes.shape == (n, 12) and nodes.dtype == np.float32
    jax_rows = np.asarray(ref.bvh_nodes_packed).transpose(0, 2, 1).reshape(-1, 16)[:n, :9]
    np.testing.assert_array_equal(nodes[:, [0, 1, 2, 4, 5, 6, 3, 8, 7]], jax_rows)
    assert (nodes[:, 9:] == 0).all()
    if port.use_bvh:
        leaves = nodes[:, 7] > 0
        assert (nodes[leaves, 8] % MAX_LEAF == 0).all()
        assert (nodes[leaves, 8] + nodes[leaves, 7] <= port.bvh_leaf_tris.shape[0]).all()
        assert (nodes[:, 3] > np.arange(n)).all() and (nodes[:, 3] <= n).all()


def test_tri_precompute_matches_jax(flat_pair):
    ref, port = flat_pair
    want = jax_tri_precompute(ref.tri_a, ref.tri_b, ref.tri_c)
    got = tri_precompute(port.tri_a, port.tri_b, port.tri_c)
    for name in want._fields:
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=1e-6, atol=1e-12, err_msg=name,
        )


def test_mesh_scene_raises_slice_two():
    """Mesh scenes load (behind a BVH) and render through the regen engine,
    Phong ones too (crewmate_phong), with or without MIS."""
    unicorn = load_scene(os.path.join(SCENES, "flying_unicorn.toml"), device="cpu")
    assert unicorn.use_bvh and select_band_engine(unicorn, RenderConfig()) == "regen"
    crewmate = load_scene(os.path.join(SCENES, "crewmate_phong.toml"), device="cpu")
    assert crewmate.use_bvh and crewmate.has_phong
    assert select_band_engine(crewmate, RenderConfig()) == "regen"
    assert select_band_engine(crewmate, RenderConfig(use_mis=True)) == "regen"


def test_default_scenes_are_the_references():
    assert SCENE_NAMES == ("cornell_box", "cubes", "flying_unicorn")
    scenes = load_all_scenes(SCENES, device="cpu")
    assert tuple(scenes) == SCENE_NAMES and scenes["flying_unicorn"].use_bvh


def test_mesh_paths_resolve_under_scenes_dir(tmp_path):
    doc = open(os.path.join(SCENES, "flying_unicorn.toml")).read()
    (tmp_path / "u.toml").write_text(doc)
    with pytest.raises(FileNotFoundError):
        load_scene(str(tmp_path / "u.toml"), device="cpu")
    s = load_scene(str(tmp_path / "u.toml"), device="cpu", scenes_dir=SCENES)
    assert s.n_triangles == 44288
