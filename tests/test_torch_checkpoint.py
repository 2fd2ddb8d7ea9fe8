"""Checkpoint and resume in the port (``render/checkpoint.py``), on the CPU.

The five cases of ``tests/test_checkpoint.py`` on the port; checkpoints
cross between the two packages (same ``.npz`` keys, equal fingerprint
strings for equal configurations); and a render cancelled and resumed
equals the uninterrupted one on every element (the same chunks under the
same salts).
"""

import os

import numpy as np
import pytest

from raytracer_tpu.models.loader import load_scene as jax_load_scene
from raytracer_tpu.render import checkpoint as jax_ck
from raytracer_tpu.render.renderer import Renderer as JaxRenderer
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.loader import load_scene, load_scene_dict
from raytracer_tpu_torch.render import checkpoint as ck_mod
from raytracer_tpu_torch.render.checkpoint import RenderCheckpoint, render_with_checkpoint
from raytracer_tpu_torch.render.renderer import Renderer, finalize
from tests.torch_cpu import jax_cfg, one_torch_thread  # noqa: F401  (autouse)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
CFG = RenderConfig(width=48, height=36, rays_per_pass=1 << 13)


@pytest.fixture(scope="module")
def renderer():
    scene = load_scene(os.path.join(SCENES, "cornell_box.toml"), device="cpu")
    return Renderer(scene, CFG, device="cpu")


def _cancel_after(n_calls: int):
    calls = {"n": 0}

    def cancelled():
        calls["n"] += 1
        return calls["n"] > n_calls

    return cancelled


def test_resume_accumulates_to_full_quality(renderer):
    full = render_with_checkpoint(renderer, "cornell_box", 32)
    part = render_with_checkpoint(renderer, "cornell_box", 16)
    assert part.num_samples == 4
    resumed = render_with_checkpoint(renderer, "cornell_box", 32, checkpoint=part)
    assert resumed.num_samples == 8 == full.num_samples
    assert abs(full.image().astype(np.float64).mean() - resumed.image().astype(np.float64).mean()) < 3.0
    # The resumed chunk is salted by the count before it: not the first again.
    assert not np.array_equal(resumed.sums, 2 * render_with_checkpoint(renderer, "cornell_box", 16).sums)


def test_save_load_roundtrip(tmp_path, renderer):
    ck = render_with_checkpoint(renderer, "cornell_box", 8)
    p = str(tmp_path / "ck.npz")
    ck.save(p)
    back = RenderCheckpoint.load(p, "cornell_box", renderer.cfg)
    np.testing.assert_array_equal(back.sums, ck.sums)
    assert back.num_samples == ck.num_samples == 2 and back.sums.dtype == np.float32
    np.testing.assert_array_equal(back.image(), ck.image())
    np.testing.assert_array_equal(ck.image(), finalize(ck.sums, 2)[::-1])


def test_load_rejects_config_mismatch(tmp_path, renderer):
    ck = render_with_checkpoint(renderer, "cornell_box", 8)
    p = str(tmp_path / "ck.npz")
    ck.save(p)
    other = RenderConfig(width=48, height=36, use_mis=True, rays_per_pass=1 << 13)
    with pytest.raises(ValueError, match="different scene/config"):
        RenderCheckpoint.load(p, "cornell_box", other)
    with pytest.raises(ValueError, match="different scene/config"):
        RenderCheckpoint.load(p, "cubes", renderer.cfg)
    small = Renderer(renderer.scene, RenderConfig(width=24, height=18), device="cpu")
    with pytest.raises(ValueError, match="resolution"):
        render_with_checkpoint(small, "cornell_box", 8, checkpoint=ck)


def test_cancel_preserves_progress(renderer):
    # 256 spp = 64 samples = 4 chunks of 16; the frame is one band here, so
    # a chunk asks cancelled() twice: the fifth call is inside chunk three.
    assert renderer.plan(256) == (36, 16, 4)
    ck = render_with_checkpoint(renderer, "cornell_box", 256, cancelled=_cancel_after(4))
    assert ck.num_samples == 32
    done = render_with_checkpoint(renderer, "cornell_box", 256, checkpoint=ck)
    assert done.num_samples == 64


def test_cancel_then_resume_equals_the_uninterrupted_render(tmp_path):
    """Several bands, a cancel inside a chunk (its bands are dropped), a
    save and a load between: the same sums as without the interruption."""
    scene = load_scene(os.path.join(SCENES, "cornell_box.toml"), device="cpu")
    cfg = RenderConfig(width=32, height=24, rays_per_pass=1 << 10)
    r = Renderer(scene, cfg, device="cpu")
    rows, k, _ = r.plan(24)
    assert (rows, k) == (8, 4)  # 3 bands; 6 samples = chunks of 4 and 2
    whole = render_with_checkpoint(r, "cornell_box", 24)
    assert whole.num_samples == 6
    part = render_with_checkpoint(r, "cornell_box", 24, cancelled=_cancel_after(6))
    assert part.num_samples == 4  # cancelled at the second band of chunk two
    p = str(tmp_path / "part.npz")
    part.save(p)
    done = render_with_checkpoint(r, "cornell_box", 24, checkpoint=RenderCheckpoint.load(p, "cornell_box", cfg))
    assert done.num_samples == 6
    np.testing.assert_array_equal(done.sums, whole.sums)
    np.testing.assert_array_equal(done.image(), whole.image())


def _chair(device="cpu"):
    from tests.test_server_mesh import chair_scene  # the JAX scene, for its document

    doc = dict(
        camera=dict(pos=[50.0, 52.0, 295.6], dir=[0.0, -0.042612, -1.0]),
        objects=[
            dict(brdf=dict(type="diffuse", kd=[0.75, 0.75, 0.75]),
                 geometry=dict(type="plane", pos=[0.0, 0.0, 0.0], n=[0.0, 1.0, 0.0])),
            dict(brdf=dict(type="diffuse", kd=[0.75, 0.75, 0.75]),
                 geometry=dict(type="plane", pos=[0.0, 0.0, 0.0], n=[0.0, 0.0, -1.0])),
            dict(brdf=dict(type="diffuse", kd=[0.8, 0.6, 0.4]),
                 geometry=dict(type="mesh", path="chair.obj"),
                 transforms=[{"scale": 12.0}, {"translate": [50.0, 15.0, 70.0]}]),
            dict(emitted=[50.0, 50.0, 50.0], brdf=dict(type="diffuse", kd=[0.0, 0.0, 0.0]),
                 geometry=dict(type="sphere", pos=[50.0, 70.0, 100.0], r=4.0)),
        ],
    )
    s = load_scene_dict(doc, name="chair_test", scenes_dir=SCENES, device=device)
    assert s.use_bvh and s.n_triangles == chair_scene().n_triangles
    return s


def test_mesh_scene_checkpoint_roundtrip(tmp_path):
    """BVH scene: save, load and resume under another mesh band budget (the
    fingerprint leaves the batching knobs out)."""
    scene = _chair()
    cfg = RenderConfig(width=48, height=36, rays_per_pass=1 << 11, mesh_rays_per_pass=1 << 11)
    part = render_with_checkpoint(Renderer(scene, cfg, device="cpu"), "chair_test", 8)
    path = str(tmp_path / "chair.npz")
    part.save(path)
    cfg2 = RenderConfig(width=48, height=36, rays_per_pass=1 << 11, mesh_rays_per_pass=1 << 12)
    loaded = RenderCheckpoint.load(path, "chair_test", cfg2)
    resumed = render_with_checkpoint(Renderer(scene, cfg2, device="cpu"), "chair_test", 16, checkpoint=loaded)
    assert resumed.num_samples == 4
    assert resumed.image().max() == 255


@pytest.mark.parametrize("cfg", [
    RenderConfig(), CFG, RenderConfig(use_mis=True, seed=3, engine="simple", max_depth=8),
], ids=["default", "small", "mis-simple"])
def test_fingerprints_equal_jax(cfg):
    assert ck_mod.FORMAT == jax_ck.FORMAT
    assert ck_mod._fingerprint("cornell_box", cfg) == jax_ck._fingerprint("cornell_box", jax_cfg(cfg))
    retuned = RenderConfig(**{**cfg.__dict__, "rays_per_pass": 1 << 9, "mesh_rays_per_pass": 1 << 9})
    assert ck_mod._fingerprint("s", retuned) == ck_mod._fingerprint("s", cfg)


def test_checkpoints_cross_between_the_packages(tmp_path, renderer):
    """A checkpoint saved by the JAX package loads and resumes in the port,
    and one saved by the port loads and resumes in the JAX package."""
    jr = JaxRenderer(jax_load_scene(os.path.join(SCENES, "cornell_box.toml")), jax_cfg(CFG))
    from_jax = str(tmp_path / "jax.npz")
    jpart = jax_ck.render_with_checkpoint(jr, "cornell_box", 16)
    jpart.save(from_jax)
    with np.load(from_jax) as data:
        assert sorted(data.files) == ["fingerprint", "format", "num_samples", "sums"]
    loaded = RenderCheckpoint.load(from_jax, "cornell_box", CFG)
    np.testing.assert_array_equal(loaded.sums, jpart.sums)
    np.testing.assert_array_equal(loaded.image(), jpart.image())
    done = render_with_checkpoint(renderer, "cornell_box", 32, checkpoint=loaded)
    assert done.num_samples == 8

    from_port = str(tmp_path / "port.npz")
    part = render_with_checkpoint(renderer, "cornell_box", 16)
    part.save(from_port)
    with np.load(from_port) as data:
        assert sorted(data.files) == ["fingerprint", "format", "num_samples", "sums"]
    jloaded = jax_ck.RenderCheckpoint.load(from_port, "cornell_box", jax_cfg(CFG))
    np.testing.assert_array_equal(jloaded.sums, part.sums)
    jdone = jax_ck.render_with_checkpoint(jr, "cornell_box", 32, checkpoint=jloaded)
    assert jdone.num_samples == 8
    # Two valid estimates of one image, half of each from either package.
    assert abs(done.image().astype(np.float64).mean() - jdone.image().astype(np.float64).mean()) < 3.0
