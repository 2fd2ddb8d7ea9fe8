"""The port's native host library (``utils/native.py``) on the CPU.

- The build: ``native/*.cpp`` compiled in place into ``build/
  raytracer_tpu_torch/librt_native-<hash>.so`` and nowhere else; builders
  racing on an empty directory leave one library and no temporary file; a
  missing compiler raises ``RuntimeError`` (no fallback).
- OBJ: ``parse_obj_file`` equal to the numpy ``parse_obj`` and to JAX's
  ``parse_obj`` on the three assets, and on JAX's ill-formed cases
  (``tests/test_loader.py:202-231``): leading whitespace is tolerated, a face
  index out of range raises ``MeshLoadError``; ``load_obj`` goes through it.
- Wire: the native packer's bytes equal the Python packer's at widths 600,
  599 and 61, one row and a batch of rows.
- The CPU tracer: ``cpu_render_band`` bit-equal to JAX's binding at a fixed
  seed and thread count, where ``native/librt_native.so`` (untracked, built
  by ``make -C native``) exists, has ``rt_cpu_render_band`` and is newer than
  both sources; and its band mean within MC noise of the port's regen
  engine on the same band (one native band mean at this size has a standard
  deviation of ~0.0026; the bound is 0.012 against the mean of four seeds).
"""

import os
import threading

import numpy as np
import pytest
import torch

from raytracer_tpu.models import obj as jax_obj
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models import obj
from raytracer_tpu_torch.models.loader import load_scene
from raytracer_tpu_torch.ops import _build
from raytracer_tpu_torch.ops.intersect import scene_precompute
from raytracer_tpu_torch.render.wavefront import render_band_regen
from raytracer_tpu_torch.server import wire
from raytracer_tpu_torch.utils import native
from tests.torch_cpu import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(ROOT, "scenes")
ASSETS = ("chair.obj", "crewmate.obj", "flying-unicorn.obj")


def test_the_library_builds_into_build_from_the_sources_in_place():
    path, _ = native.build()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("librt_native-") and path.endswith(".so")
    assert native.sources() == [os.path.join(ROOT, "native", s) for s in ("rt_native.cpp", "cpu_tracer.cpp")]
    assert native.build() == (path, "")  # built once


def test_racing_builders_leave_one_library(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    out, errors = [], []

    def run():
        try:
            out.append(native.build()[0])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(out)) == 1
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(out[0])]


def test_a_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="not found"):
        native.build()
    monkeypatch.setenv("CXX", "false")  # found, and fails: its output is raised
    with pytest.raises(RuntimeError, match="failed"):
        native.build()
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("asset", ASSETS)
def test_obj_parse_equals_numpy_and_jax(asset):
    path = os.path.join(SCENES, "assets", asset)
    got = native.parse_obj_file(path)
    with open(path) as fh:
        text = fh.read()
    for want in (obj.parse_obj(text), jax_obj.parse_obj(text), obj.load_obj_plain(path)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    for g, w in zip(obj.load_obj(path), got):
        np.testing.assert_array_equal(g, w)
    assert got[2].shape[0] > 100


def test_obj_parse_of_jax_ill_formed_cases(tmp_path):
    text = "\nv 0 0 0\n  v 1 0 0\n\tv 0 1 0\nvn 0 0 1\n  f 1/1/1 2/2/1 3/3/1\nf 3 2 1\n"
    p = tmp_path / "ws.obj"
    p.write_text(text)
    for g, w in zip(native.parse_obj_file(str(p)), obj.parse_obj(text)):
        np.testing.assert_array_equal(g, w)
    bad = tmp_path / "bad.obj"
    bad.write_text("v 0 0 0\nf 1 2 9\n")
    with pytest.raises(obj.MeshLoadError):
        native.parse_obj_file(str(bad))
    with pytest.raises(obj.MeshLoadError):
        obj.load_obj(str(bad))


@pytest.mark.parametrize("width", [600, 599, 61])
def test_packed_bytes_equal_the_python_packer(width):
    rgb = np.random.default_rng(width).integers(0, 256, (5, width, 3), np.uint8)
    for i in range(5):
        assert wire.pack_row(449 - i, rgb[i]) == wire.pack_row_plain(449 - i, rgb[i])
    assert wire.pack_row(7, rgb[0], 17) == wire.pack_row_plain(7, rgb[0], 17)
    blob = wire.pack_rows_batched(449, rgb)
    assert blob == wire.pack_rows_batched_plain(449, rgb)
    assert blob == b"".join(m for i in range(5) for m in wire.pack_row(449 - i, rgb[i]))


def _jax_library_is_current() -> bool:
    so = os.path.join(ROOT, "native", "librt_native.so")
    if not os.path.exists(so):
        return False
    if os.path.getmtime(so) < max(os.path.getmtime(s) for s in native.sources()):
        return False
    import ctypes

    return hasattr(ctypes.CDLL(so), "rt_cpu_render_band")


@pytest.mark.parametrize("name,y0,rows", [("cornell_box", 100, 6), ("crewmate_phong", 200, 3)])
def test_cpu_tracer_bit_equal_to_jax_binding(name, y0, rows):
    if not _jax_library_is_current():
        pytest.skip("native/librt_native.so is missing, stale or lacks rt_cpu_render_band")
    from raytracer_tpu.models.loader import load_scene as jax_load_scene
    from raytracer_tpu.utils import native as jax_native

    path = os.path.join(SCENES, f"{name}.toml")
    got, got_rays = native.cpu_render_band(load_scene(path, device="cpu"), 600, 450, y0, rows, 4, seed=3,
                                           n_threads=2)
    want, want_rays = jax_native.cpu_render_band(jax_load_scene(path), 600, 450, y0, rows, 4, seed=3,
                                                 n_threads=2)
    assert got_rays == want_rays > 600 * rows * 4
    np.testing.assert_array_equal(got, want)


def test_cpu_tracer_mean_matches_the_regen_engine():
    scene = load_scene(os.path.join(SCENES, "cornell_box.toml"), device="cpu")
    w, h, y0, rows, spp = 48, 36, 10, 12, 64
    sums, _ = render_band_regen(scene, scene_precompute(scene), RenderConfig(width=w, height=h), y0, rows,
                                spp // 4, 5)
    port = float(torch.clamp(sums / (spp // 4), 0.0, 1.0).mean(dim=2).mean())
    nat = [native.cpu_render_band(scene, w, h, y0, rows, spp, seed=s, n_threads=2) for s in (1, 2, 3, 4)]
    assert all(out.shape == (rows, w, 3) and rays > rows * w * spp for out, rays in nat)
    assert abs(port - float(np.mean([out.mean() for out, _ in nat]))) < 0.012


def test_a_mesh_light_has_no_native_render():
    from raytracer_tpu_torch.models.loader import load_scene_dict
    from tests.test_materials_extra import CUBE_LIGHT, _box_scene

    scene = load_scene_dict(_box_scene([], CUBE_LIGHT), name="ml", device="cpu")
    assert native.cpu_render_band(scene, 8, 6, 0, 6, 4) is None
