"""The port's own copies of the JAX package's JAX-free modules, held against
the originals on the CPU: the render configuration, the OBJ parser and the
prism geometry, the wire packing and ``RenderStats``."""

import dataclasses
import glob
import os

import numpy as np
import pytest

from raytracer_tpu import config as jax_config
from raytracer_tpu.models import obj as jax_obj
from raytracer_tpu.server import wire as jax_wire
from raytracer_tpu.utils.timing import RenderStats as JaxRenderStats
from raytracer_tpu_torch import config
from raytracer_tpu_torch.models import obj
from raytracer_tpu_torch.server import wire
from raytracer_tpu_torch.utils.timing import RenderStats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(ROOT, "scenes")


# --- config -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["Epsilons", "RenderConfig"])
def test_dataclasses_equal_field_for_field(name):
    mine, theirs = getattr(config, name), getattr(jax_config, name)
    fm, ft = dataclasses.fields(mine), dataclasses.fields(theirs)
    assert [(f.name, str(f.type)) for f in fm] == [(f.name, str(f.type)) for f in ft]
    a, b = mine(), theirs()
    for f in fm:
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(va):
            assert dataclasses.asdict(va) == dataclasses.asdict(vb)
        else:
            assert (type(va), va) == (type(vb), vb), f.name
    assert mine.__dataclass_params__.frozen and theirs.__dataclass_params__.frozen


def test_f32_epsilons_unchanged():
    assert dataclasses.asdict(config.Epsilons()) == {
        "sphere_tmin": 2e-3, "plane_parallel": 1e-4, "tri_parallel": 1e-4, "tri_tmin": 1e-3,
        "hit_offset": 1e-3, "visibility_margin": 1e-2, "specular_match": 1e-3,
    }


def test_scene_names_and_port(monkeypatch):
    assert config.SCENE_NAMES == jax_config.SCENE_NAMES
    assert config.DEFAULT_PORT == jax_config.DEFAULT_PORT
    monkeypatch.delenv("PORT", raising=False)
    assert config.port_from_env() == jax_config.port_from_env() == 8080
    monkeypatch.setenv("PORT", "9123")
    assert config.port_from_env() == jax_config.port_from_env() == 9123


@pytest.mark.parametrize(
    "path", [os.path.join(ROOT, "config.toml")] + sorted(glob.glob(os.path.join(SCENES, "*.toml")))
)
def test_config_from_toml_equals_jax(path):
    """config.toml gives equal configs; a scene TOML is no config file, and
    both loaders refuse it with the same message."""
    try:
        want = jax_config.config_from_toml(path)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            config.config_from_toml(path)
        assert str(got.value) == str(e)
        return
    got = config.config_from_toml(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_config_from_toml_keys(tmp_path):
    p = tmp_path / "c.toml"
    p.write_text('width = 64\nheight = 48\nuse_mis = true\nmax_bounces = 3\nseed = 9\nengine = "regen"\n'
                 'samples_per_pixel = 16\nscene = "cubes"\nshow_window = false\n')
    got = config.config_from_toml(str(p))
    assert (got.width, got.height, got.use_mis, got.rr_start_depth, got.seed, got.engine) == (
        64, 48, True, 3, 9, "regen")
    assert dataclasses.asdict(got) == dataclasses.asdict(jax_config.config_from_toml(str(p)))
    p.write_text("fov = 1.0\n")
    with pytest.raises(ValueError, match="unknown config key 'fov'"):
        config.config_from_toml(str(p))


# --- wire -------------------------------------------------------------------


@pytest.mark.parametrize("width,ppm", [(600, 60), (150, 60), (61, 60), (1920, 240), (7, 60)])
def test_wire_bytes_equal_jax(width, ppm):
    rng = np.random.default_rng(width)
    rgb = rng.integers(0, 256, (5, width, 3), dtype=np.uint8)
    for y in (0, 17, 449, 1079):
        assert wire.pack_row(y, rgb[0], ppm) == jax_wire.pack_row(y, rgb[0], ppm)
    assert wire.pack_chunk(60, 3, rgb[1, :min(width, 60)]) == jax_wire.pack_chunk(60, 3, rgb[1, :min(width, 60)])
    blob = wire.pack_rows_batched(449, rgb, ppm)
    assert blob == jax_wire.pack_rows_batched(449, rgb, ppm)
    # The port's own parser round-trips the batched buffer and each message.
    got = np.zeros_like(rgb)
    n = 0
    for mtype, x, y, px in wire.parse_chunks(blob):
        assert mtype == wire.MSG_RENDERED_PIXELS and px.shape[0] <= ppm
        got[449 - y, x : x + px.shape[0]] = px
        n += 1
    assert n == 5 * -(-width // ppm)
    np.testing.assert_array_equal(got, rgb)
    for msg in wire.pack_row(3, rgb[2], ppm):
        mtype, x, y, px = wire.parse_chunk(msg)
        assert (mtype, y) == (0, 3)
        np.testing.assert_array_equal(px, rgb[2, x : x + px.shape[0]])
    assert (wire.PIXELS_PER_MSG, wire.MSG_RENDERED_PIXELS) == (jax_wire.PIXELS_PER_MSG, jax_wire.MSG_RENDERED_PIXELS)


# --- OBJ and prisms -----------------------------------------------------------


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(SCENES, "assets", "*.obj"))))
def test_obj_parse_equals_jax(path):
    got = obj.load_obj(path)
    want = jax_obj.load_obj(path)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with open(path) as fh:
        text = fh.read()
    for g, w in zip(obj.parse_obj(text), jax_obj.parse_obj(text)):
        np.testing.assert_array_equal(g, w)


def test_obj_errors_equal_jax():
    for text in ("v 1 2\n", "vn 0 1\n", "v 0 0 0\nf 1 2\n", "v 0 0 0\nf 1 2 3\n", "v a b c\n"):
        with pytest.raises(jax_obj.MeshLoadError) as want:
            jax_obj.parse_obj(text)
        with pytest.raises(obj.MeshLoadError) as got:
            obj.parse_obj(text)
        assert str(got.value) == str(want.value)


def test_cube_and_prism_equal_jax():
    p = np.asarray([-1.5, 2.0, 0.25])
    for got, want in ((obj.cube(p, 3.0), jax_obj.cube(p, 3.0)),
                      (obj.prism(p, 1.0, 2.0, 4.5), jax_obj.prism(p, 1.0, 2.0, 4.5))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    # The reference's inconsistent winding is kept exactly.
    np.testing.assert_array_equal(obj._PRISM_INDICES, jax_obj._PRISM_INDICES)


# --- RenderStats ----------------------------------------------------------------


def test_render_stats_summary_keys_equal_jax():
    a, b = RenderStats(rays=10, samples=4, pixels=6, bands=2), JaxRenderStats(rays=10, samples=4, pixels=6, bands=2)
    with a.phase("render"):
        pass
    with b.phase("render"):
        pass
    sa, sb = a.summary(), b.summary()
    assert sorted(sa) == sorted(sb)
    assert {k: sa[k] for k in ("rays", "samples", "pixels", "bands")} == {
        k: sb[k] for k in ("rays", "samples", "pixels", "bands")}
    assert sorted(sa["phases"]) == sorted(sb["phases"]) == ["render"]
