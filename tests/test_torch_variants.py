"""The measurement hooks of the port's regen engine and of its BVH wrapper
(``render/wavefront.py``, ``ops/bvh_traverse.py``, ``ops/keys.py``) on the
CPU, each against the port's default frame and against the JAX package
under the same hook.

Scene: the chair room of ``tests/test_server_mesh.py:28`` (a 212-triangle
chair behind the BVH, two planes, a sphere light), 60x45; a band of 12 rows
(2,880 lanes, tail compaction at 2,048 and 1,024) for the frames that must
be bit-equal, and whole frames of 8 spp for the statistical ones.

- ``RT_PERMUTE_STATE`` (0, the default, and 1, the permuted step, also
  with ``RT_SORT_GROUP=8``), ``RT_SORT_GROUP`` (8, and 7, which does not
  divide the lanes; in the traversal's own sort by default) and
  ``RT_SHADOW_COMPACT=1`` leave every slot's sums and the ray count
  bit-equal, under K2's twin and under K4's (``RT_BVH_KERNEL=binary``):
  draws are keyed on the slot, and a walk's t and index do not depend on
  the lane order;
- ``RT_STATE_BF16=1``: ``pack2``/``unpack2`` bit-equal to JAX's own
  ``_pack2``/``_unpack2`` (``wavefront.py:235-245``, run from its code
  object); the frame's mean within 0.5 u8 of the default's and its MAD to
  it at most MAD(seed 7, seed 8) + 1.0;
- ``RT_DEFER_SHADOW=1``: the same terms in another grouping: the frame
  equal to the default on >= 99% of pixels, mean within 0.05, one K3 a loop
  iteration (the shadow queries ride the main order);
- ``RT_SHADOW_REVERSE=1``: shadow rays leave the light, presorted, against
  the scene without the light sphere; the frame's mean within 0.5 u8 of the
  default's, MAD at most MAD(seed 7, seed 8) + 1.0;
- ``RT_ABLATE=shadow`` traces no shadow ray; ``RT_ABLATE=rng`` draws
  JAX's table (its values within an ulp: JAX's own eager and jitted
  ``linspace`` differ by one); both warn;
- against JAX on the chair room lit by an octahedron mesh light behind the
  BVH: the image mean within 1.5 u8 (``tests/test_wavefront.py:196``) and
  the MAD at most 1.15 x MAD(port seed 7, port seed 8) + 0.5
  (``tests/test_torch_fused.py``'s bound). The port draws another stream
  than JAX, so two renders differ by Monte-Carlo noise (MAD ~15 here), and
  that noise is the yardstick.

Each JAX frame compiles JAX's engine anew (15-25 s on the CPU), so the
frames under ``RT_ABLATE=shadow``, ``RT_SHADOW_REVERSE`` and
``RT_DEFER_SHADOW`` against JAX's under the same hook are in
``tests/test_torch_variants_jax.py``; the traversal wrapper's
``RT_SHADOW_COMPACT`` against JAX's in interpret mode, and
``RT_LEAF_TRIS``, in ``tests/test_torch_traverse.py``.
"""

import importlib
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.models.loader import load_scene_dict as jax_load_scene_dict
from raytracer_tpu.render import renderer as jax_renderer
from raytracer_tpu.render import wavefront as jax_wavefront
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.loader import load_scene, load_scene_dict
from raytracer_tpu_torch.models.scene import LIGHT_MESH
from raytracer_tpu_torch.ops import keys
from raytracer_tpu_torch.ops.intersect import scene_precompute
from raytracer_tpu_torch.render import wavefront
from raytracer_tpu_torch.render.renderer import Renderer
from tests.test_torch_phong_mis import _octahedron_obj
from tests.torch_cpu import jax_cfg, one_torch_thread  # noqa: F401  (autouse)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
W, H, SPP = 60, 45, 8
BAND_ROWS, BAND_SAMPLES, BAND_SEED = 12, 4, 11
SPHERE_LIGHT = dict(emitted=[50.0, 50.0, 50.0], brdf=dict(type="diffuse", kd=[0.0, 0.0, 0.0]),
                    geometry=dict(type="sphere", pos=[50.0, 70.0, 100.0], r=4.0))
# Statistical bounds (module docstring).
MEAN_TO_DEFAULT, MAD_MARGIN = 0.5, 1.0
MEAN_TO_JAX, MAD_SCALE_JAX, MAD_MARGIN_JAX = 1.5, 1.15, 0.5
DEFER_SHARE, DEFER_MEAN = 0.99, 0.05


def chair_doc(light=SPHERE_LIGHT) -> dict:
    """The chair room of tests/test_server_mesh.py:28, with ``light``."""
    return dict(
        camera=dict(pos=[50.0, 52.0, 295.6], dir=[0.0, -0.042612, -1.0]),
        objects=[
            dict(brdf=dict(type="diffuse", kd=[0.75, 0.75, 0.75]),
                 geometry=dict(type="plane", pos=[0.0, 0.0, 0.0], n=[0.0, 1.0, 0.0])),
            dict(brdf=dict(type="diffuse", kd=[0.75, 0.75, 0.75]),
                 geometry=dict(type="plane", pos=[0.0, 0.0, 0.0], n=[0.0, 0.0, -1.0])),
            dict(brdf=dict(type="diffuse", kd=[0.8, 0.6, 0.4]),
                 geometry=dict(type="mesh", path="chair.obj"),
                 transforms=[{"scale": 12.0}, {"translate": [50.0, 15.0, 70.0]}]),
            light,
        ],
    )


def mesh_light_doc(scenes_dir) -> dict:
    """The chair room lit by a consistently wound octahedron mesh light in
    place of the sphere (``scenes_dir/assets/octa.obj``, with the chair)."""
    assets = os.path.join(scenes_dir, "assets")
    os.makedirs(assets, exist_ok=True)
    with open(os.path.join(SCENES, "assets", "chair.obj")) as src, open(os.path.join(assets, "chair.obj"), "w") as dst:
        dst.write(src.read())
    with open(os.path.join(assets, "octa.obj"), "w") as fh:
        fh.write(_octahedron_obj([50.0, 70.0, 100.0], 5.0))
    return chair_doc(dict(emitted=[50.0, 50.0, 50.0], brdf=dict(type="diffuse", kd=[0.0, 0.0, 0.0]),
                          geometry=dict(type="mesh", path="octa.obj")))


@pytest.fixture(scope="module")
def chair():
    scene = load_scene_dict(chair_doc(), name="chair", scenes_dir=SCENES, device="cpu")
    assert scene.use_bvh and scene.light_type != LIGHT_MESH
    return scene


def _cfg(seed=7, tail_compact=True) -> RenderConfig:
    return RenderConfig(width=W, height=H, rays_per_pass=1 << 12, mesh_rays_per_pass=1 << 12, seed=seed,
                        tail_compact=tail_compact)


def port_frame(scene, monkeypatch, env=None, **cfg) -> np.ndarray:
    """The port's frame under the hooks ``env`` (unset after)."""
    with monkeypatch.context() as m:
        for k, v in (env or {}).items():
            m.setenv(k, v)
        return Renderer(scene, _cfg(**cfg), device="cpu").render_image(SPP).astype(np.float64)


def _band(scene, monkeypatch, env=None):
    with monkeypatch.context() as m:
        for k, v in (env or {}).items():
            m.setenv(k, v)
        return wavefront.render_band_regen(scene, scene_precompute(scene), _cfg(), BAND_ROWS, BAND_ROWS,
                                           BAND_SAMPLES, BAND_SEED)


def _mad(a, b) -> float:
    return float(np.abs(a - b).mean())


def port_seeds(scene, **cfg) -> dict:
    """The port's default frames of seeds 7 and 8, and MAD(seed 7, seed 8)."""
    mp = pytest.MonkeyPatch()
    out = {sd: port_frame(scene, mp, seed=sd, **cfg) for sd in (7, 8)}
    out["mad"] = _mad(out[7], out[8])
    return out


@pytest.fixture(scope="module")
def defaults(chair):
    return port_seeds(chair)


@pytest.mark.parametrize("kernel", ["widesmem", "binary"])
@pytest.mark.parametrize("hook,value", [
    ("RT_PERMUTE_STATE", "0"), ("RT_SORT_GROUP", "8"), ("RT_SORT_GROUP", "7"), ("RT_SHADOW_COMPACT", "1"),
    ("RT_PERMUTE_STATE", "1"), ("RT_PERMUTE_STATE+RT_SORT_GROUP", "1+8"),
])
def test_frame_is_bit_equal_to_the_default(chair, monkeypatch, kernel, hook, value):
    monkeypatch.setenv("RT_BVH_KERNEL", kernel)
    want, want_rays = _band(chair, monkeypatch)
    got, rays = _band(chair, monkeypatch, dict(zip(hook.split("+"), value.split("+"))))
    assert torch.equal(got, want) and int(rays) == int(want_rays) and want.abs().sum() > 0


def test_sort_group_moves_whole_groups(chair, monkeypatch):
    """Under RT_PERMUTE_STATE=1 and RT_SORT_GROUP=8 the permutation orders
    the groups of 8 lanes of every loop width (the band's and each
    compaction stage's)."""
    orders = []
    real = keys.group_order

    def spy(*a, **kw):
        orders.append(real(*a, **kw))
        return orders[-1]

    monkeypatch.setattr(wavefront, "group_order", spy)
    _band(chair, monkeypatch, {"RT_PERMUTE_STATE": "1", "RT_SORT_GROUP": "8"})
    assert orders and all(o.numel() * 8 in (2880, 2048, 1024) for o in orders)
    assert all(torch.equal(torch.sort(o).values, torch.arange(o.numel())) for o in orders)


def _jax_nested(name: str, **free):
    """JAX's own function ``name`` nested in its render_band_regen, run from
    its code object with its free variables bound to ``free``."""
    code = next(c for c in jax_wavefront.render_band_regen.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == name)
    return types.FunctionType(code, vars(jax_wavefront), name, None,
                              tuple(types.CellType(free[v]) for v in code.co_freevars))


def test_bf16_pair_is_bit_equal_to_jax():
    pack2_j = _jax_nested("_pack2", _bc_u16=lambda a: jax.lax.bitcast_convert_type(a, jnp.uint16))
    unpack2_j = _jax_nested("_unpack2", _bc_bf16=lambda a: jax.lax.bitcast_convert_type(a, jnp.bfloat16))
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 4000, 3)) * 10.0 ** rng.uniform(-38, 38, (2, 4000, 3))).astype(np.float32)
    # Rounding ties, the two zeros, subnormals, bf16's largest and past it.
    special = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 0.0, -0.0, 1e-40, -3e-39, 3.38e38, 3.4e38,
                        1.0, 0.5, 65504.0], np.float32)
    x[:, :special.size // 3] = special.reshape(-1, 3)
    x[1, :special.size // 3] = special[::-1].reshape(-1, 3)
    got = wavefront.pack2(torch.from_numpy(x[0]), torch.from_numpy(x[1])).numpy()
    want = np.asarray(pack2_j(jnp.asarray(x[0]), jnp.asarray(x[1])))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    for p, j in zip(wavefront.unpack2(torch.from_numpy(got)), unpack2_j(jnp.asarray(want))):
        np.testing.assert_array_equal(p.numpy().view(np.uint32), np.asarray(j).view(np.uint32))


def test_bf16_state_frame_is_statistically_the_default(chair, defaults, monkeypatch):
    got = port_frame(chair, monkeypatch, {"RT_STATE_BF16": "1"})
    base = defaults[7]
    same = float((got == base).all(axis=2).mean())
    print(f"RT_STATE_BF16=1: mean {got.mean():.4f} against {base.mean():.4f}, equal on {same:.4%} of pixels")
    assert abs(got.mean() - base.mean()) <= MEAN_TO_DEFAULT
    assert _mad(got, base) <= defaults["mad"] + MAD_MARGIN
    assert same < 1.0  # the pair does round


def _trace_spy(monkeypatch):
    """Counts the regen engine's shadow traces (``trace_t``) and K3 keys."""
    calls = {"trace_t": [], "keys": 0}
    real_t, real_k = wavefront.trace_t, keys.coherence_key_twin

    def trace_t(scene, *a, **kw):
        calls["trace_t"].append((scene, kw.get("presorted", False)))
        return real_t(scene, *a, **kw)

    def key(*a, **kw):
        calls["keys"] += 1
        return real_k(*a, **kw)

    monkeypatch.setattr(wavefront, "trace_t", trace_t)
    monkeypatch.setattr(keys, "coherence_key_twin", key)
    return calls


def test_deferred_shadow_regroups_the_default(chair, defaults, monkeypatch):
    calls = _trace_spy(monkeypatch)
    got = port_frame(chair, monkeypatch, {"RT_DEFER_SHADOW": "1"})
    base = defaults[7]
    same = float((got == base).all(axis=2).mean())
    print(f"RT_DEFER_SHADOW=1: equal to the default on {same:.4%} of pixels, mean {got.mean():.4f} against "
          f"{base.mean():.4f}")
    assert same >= DEFER_SHARE and abs(got.mean() - base.mean()) <= DEFER_MEAN
    # Every shadow query resolves presorted beside the next main trace: one
    # K3 launch (the permutation's) a loop iteration.
    assert calls["trace_t"] and all(presorted for _, presorted in calls["trace_t"])
    assert calls["keys"] == len(calls["trace_t"])


def test_reversed_shadow_is_statistically_the_default(chair, defaults, monkeypatch):
    calls = _trace_spy(monkeypatch)
    got = port_frame(chair, monkeypatch, {"RT_SHADOW_REVERSE": "1"})
    base = defaults[7]
    same = float((got == base).all(axis=2).mean())
    print(f"RT_SHADOW_REVERSE=1: equal to the default on {same:.4%} of pixels, mean {got.mean():.4f} against "
          f"{base.mean():.4f}, MAD {_mad(got, base):.4f}")
    assert abs(got.mean() - base.mean()) <= MEAN_TO_DEFAULT
    assert _mad(got, base) <= defaults["mad"] + MAD_MARGIN
    # Presorted, against the scene whose light sphere is masked out (the
    # main trace keeps it); no K3 for shadows.
    light = chair.sph_obj == chair.light_idx
    assert calls["trace_t"] and all(presorted for _, presorted in calls["trace_t"])
    assert all(bool((s.sph_valid == (chair.sph_valid & ~light)).all()) for s, _ in calls["trace_t"])
    assert bool(chair.sph_valid[light].all())
    assert calls["keys"] == len(calls["trace_t"])


def test_ablate_shadow_traces_no_shadow_ray(chair, defaults, monkeypatch):
    calls = _trace_spy(monkeypatch)
    with pytest.warns(RuntimeWarning, match="RT_ABLATE=shadow"):
        got = port_frame(chair, monkeypatch, {"RT_ABLATE": "shadow"})
    assert not calls["trace_t"] and calls["keys"] > 0
    # Nothing is occluded: the frame is brighter than the default.
    assert got.mean() > defaults[7].mean()


@pytest.mark.parametrize("name", ["chair", "mesh_light", "crewmate_phong"])
def test_ablate_rng_draw_table_matches_jax(name, tmp_path, monkeypatch):
    if name == "chair":
        scene = load_scene_dict(chair_doc(), name=name, scenes_dir=SCENES, device="cpu")
    elif name == "mesh_light":
        scene = load_scene_dict(mesh_light_doc(str(tmp_path)), name=name, scenes_dir=str(tmp_path), device="cpu")
    else:
        scene = load_scene(os.path.join(SCENES, f"{name}.toml"), device="cpu")
    table = wavefront.ablate_draws(scene)
    # JAX's layout (wavefront.py:192-197): [light..., rr, bsdf...].
    light = 3 if scene.light_type != 0 else 2
    bsdf = 3 if scene.has_phong else 2
    lin = np.asarray(jax.jit(lambda: jnp.linspace(0.1, 0.9, light + 1 + bsdf))())
    want = {2: 0, 3: 1, 4: light, 5: light + 1, 6: light + 2}
    want.update({8: 2} if light == 3 else {})
    want.update({7: light + 3} if bsdf == 3 else {})
    assert sorted(table) == sorted(want)
    got = np.array([table[d] for d in sorted(want)], np.float32)
    np.testing.assert_array_max_ulp(got, lin[[want[d] for d in sorted(want)]], maxulp=1)
    # A frame under the probe: shading draws are constants, camera jitter
    # is not, so the frame renders and differs from the default.
    cfg = RenderConfig(width=16, height=12, rays_per_pass=1 << 10, mesh_rays_per_pass=1 << 10)
    monkeypatch.setenv("RT_ABLATE", "rng")
    with pytest.warns(RuntimeWarning, match="RT_ABLATE=rng"):
        img = Renderer(scene, cfg, device="cpu").render_image(4)
    assert np.isfinite(img).all() and img.shape == (12, 16, 3)


def jax_frame(scene, env: dict, **cfg) -> np.ndarray:
    """JAX's frame with ``env`` set: its engine reads four hooks at import,
    so it is reloaded and its jit cache cleared, before and after
    (``tests/test_wavefront.py:185-198``)."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        importlib.reload(jax_wavefront)
        jax_renderer._streaming_jit.cache_clear()
        return jax_renderer.Renderer(scene, jax_cfg(_cfg(**cfg))).render_image(SPP).astype(np.float64)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        importlib.reload(jax_wavefront)
        jax_renderer._streaming_jit.cache_clear()


def test_mesh_light_bvh_frame_matches_jax(tmp_path, monkeypatch):
    doc = mesh_light_doc(str(tmp_path))
    scene = load_scene_dict(doc, name="octa", scenes_dir=str(tmp_path), device="cpu")
    assert scene.light_type == LIGHT_MESH and scene.use_bvh
    want = jax_frame(jax_load_scene_dict(doc, name="octa", scenes_dir=str(tmp_path)), {}, tail_compact=False)
    got = port_seeds(scene, tail_compact=False)
    print(f"mesh light: port mean {got[7].mean():.4f}, JAX {want.mean():.4f}, MAD {_mad(got[7], want):.4f} "
          f"(port seeds {got['mad']:.4f})")
    assert got[7].mean() > 5.0
    assert_matches_jax(got[7], want, got["mad"])


def assert_matches_jax(got, want, mad_seeds: float) -> None:
    assert abs(got.mean() - want.mean()) < MEAN_TO_JAX
    assert _mad(got, want) <= MAD_SCALE_JAX * mad_seeds + MAD_MARGIN_JAX


@pytest.mark.parametrize("env,match", [
    ({"RT_ABLATE": "light"}, "RT_ABLATE"),
    ({"RT_STATE_BF16": "2"}, "RT_STATE_BF16"),
    ({"RT_PERMUTE_STATE": "no"}, "RT_PERMUTE_STATE"),
    ({"RT_SHADOW_REVERSE": "on"}, "RT_SHADOW_REVERSE"),
    ({"RT_DEFER_SHADOW": "yes"}, "RT_DEFER_SHADOW"),
    ({"RT_SORT_GROUP": "0"}, "RT_SORT_GROUP"),
    ({"RT_SHADOW_COMPACT": "2"}, "RT_SHADOW_COMPACT"),
    ({"RT_LEAF_TRIS": "-1"}, "RT_LEAF_TRIS"),
    ({"RT_LEAF_TRIS": "8", "RT_BVH_KERNEL": "binary"}, "RT_LEAF_TRIS"),
])
def test_a_hook_the_port_cannot_honour_raises(chair, monkeypatch, env, match):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    pre = scene_precompute(chair)
    with pytest.raises(ValueError, match=match):
        if "RT_SHADOW_COMPACT" in env:
            from raytracer_tpu_torch.ops.bvh_traverse import bvh_intersect

            n = 2048
            ro, rd = torch.zeros((n, 3)), torch.nn.functional.normalize(torch.ones((n, 3)), dim=1)
            bvh_intersect(chair, ro, rd, _cfg().eps, t_init=torch.ones(n), any_hit=True)
        else:
            wavefront.render_band_regen(chair, pre, _cfg(), 0, 1, 1, 0)
