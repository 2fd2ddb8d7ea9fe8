"""The port's lockstep engine ``"simple"`` (``render/integrator.py::radiance``,
``render/renderer.py::_pass_sums`` and ``_render_band_impl``) on the CPU.

- ``sample_light`` (sphere and mesh light) and one ``bounce`` of the loop
  against the JAX package's own functions on the same state and the same
  seven uniforms, made with numpy from a seed. Tolerance 2e-6 absolute,
  3e-5 relative, on at least 99.5% of the lanes: XLA's CPU sin, cos, pow
  and rsqrt round differently from torch's, and a last-bit difference
  flips a visibility test or a nearest hit on a few lanes;
  ``_jax_bounce`` below is this file's transcription of the JAX loop body
  from JAX's ``brdf``, ``trace`` and ``sample_light`` functions, not JAX's
  own ``radiance``;
- ``radiance`` against JAX's own ``radiance`` at ``max_depth=1`` on the same
  camera rays: the ray count exactly (at depth 1 it depends on no draw) and
  the mean of the lanes' differences within four standard errors of it
  (other random numbers);
- the engine against JAX's ``Renderer(engine="simple")`` on cornell_box
  72x54 at 64 spp with the bound of ``tests/test_wavefront.py:29``: the
  means within 1.5 u8, the MAD below 1.15 x the floor between two JAX
  seeds + 0.5 (the two packages draw different random numbers);
- against the port's regen engine, with and without MIS (|mean| < 2.0, 1.5);
- plans equal to JAX's for ``engine="simple"``; determinism; the light pixel.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.models import vecmath as jax_vm
from raytracer_tpu.models.loader import load_scene as jax_load_scene
from raytracer_tpu.models.loader import load_scene_dict as jax_load_scene_dict
from raytracer_tpu.ops import brdf as jax_brdf
from raytracer_tpu.ops.intersect import scene_precompute as jax_scene_precompute
from raytracer_tpu.ops.intersect import trace as jax_trace
from raytracer_tpu.ops.intersect import trace_t as jax_trace_t
from raytracer_tpu.render.integrator import radiance as jax_radiance
from raytracer_tpu.render.integrator import sample_light as jax_sample_light
from raytracer_tpu.render.renderer import Renderer as JaxRenderer
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models import vecmath as vm
from raytracer_tpu_torch.models.camera import camera_rays3
from raytracer_tpu_torch.models.loader import load_scene, load_scene_dict
from raytracer_tpu_torch.models.scene import BRDF_SPECULAR
from raytracer_tpu_torch.ops.intersect import scene_precompute, trace_soa
from raytracer_tpu_torch.render.integrator import PathState, bounce, radiance, sample_light
from raytracer_tpu_torch.render.renderer import Renderer, _render_band_impl, finalize
from tests.test_materials_extra import CUBE_LIGHT, _box_scene
from tests.torch_cpu import jax_cfg, one_torch_thread  # noqa: F401  (autouse)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
ATOL, RTOL, LANE_SHARE = 2e-6, 3e-5, 0.995


@pytest.fixture(scope="module")
def cornell():
    path = os.path.join(SCENES, "cornell_box.toml")
    return jax_load_scene(path), load_scene(path, device="cpu")


def _close_share(got, want, scale=1.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ok = np.abs(got - want) <= ATOL * scale + RTOL * np.abs(want)
    return ok.reshape(ok.shape[0], -1).all(axis=1).mean()


@pytest.mark.parametrize("light", ["sphere", "mesh"])
def test_sample_light_matches_jax(cornell, light):
    if light == "sphere":
        ref, port = cornell
    else:
        doc = _box_scene([], CUBE_LIGHT)
        ref, port = jax_load_scene_dict(doc, name="ml"), load_scene_dict(doc, name="ml", device="cpu")
    u = np.random.default_rng(7).random((3, 4096)).astype(np.float32)
    yj, nj, pj = jax_sample_light(ref, *map(jnp.asarray, u))
    yp, np_, pp = sample_light(port, *map(torch.from_numpy, u))
    assert yp.shape == np_.shape == (4096, 3)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(np_.numpy(), np.asarray(nj), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(pj))


def _jax_bounce(scene, pre, cfg, x, n, obj, o, us, p):
    """One body of ``raytracer_tpu/render/integrator.py:130-216`` on lanes
    that are all alive with L = 0 and beta = 1, from the JAX package's own
    functions -> (L, beta, next x, next n, alive)."""
    eps = cfg.eps
    light_e = scene.obj_emitted[scene.light_idx]
    mat = jax_brdf.gather_mat(scene, obj)
    is_spec = mat.brdf_type == BRDF_SPECULAR
    y, ny, pdf_l = jax_sample_light(scene, us[0], us[1], us[2])
    to_y = y - x
    dist = jax_vm.length(to_y)
    wi_d = to_y / jnp.maximum(dist, 1e-20)[:, None]
    r2 = jnp.maximum(dist * dist, 1e-20)
    sh_t, sh_valid = jax_trace_t(scene, pre, x, wi_d, eps, t_max=dist - eps.visibility_margin)
    vis = (~sh_valid) | (sh_t + eps.visibility_margin >= dist)
    f_d = jax_brdf.eval_nonspecular(mat, n, o, wi_d, scene.has_phong)
    cos_x = jax_vm.dot(n, wi_d)
    cos_y = jax_vm.dot(ny, -wi_d)
    if cfg.use_mis:
        pdf_l_sa = pdf_l * r2 / jnp.maximum(cos_y, 1e-8)
        pdf_b_at = jax_brdf.pdf(mat, n, o, wi_d)
        ok = vis & (cos_y > 0.0) & (cos_x > 0.0)
        direct = jnp.where(ok[:, None], light_e[None, :] * f_d * (cos_x / (pdf_l_sa + pdf_b_at))[:, None], 0.0)
    else:
        direct = light_e[None, :] * f_d * (jnp.where(vis, 1.0, 0.0) * cos_x * cos_y / (r2 * pdf_l))[:, None]
    L = jnp.where((~is_spec)[:, None], direct, 0.0)
    cont = us[3] < p
    wi, pdf_b = jax_brdf.sample(mat, n, o, us[4], us[5], us[6], cfg.fix_phong_frame, scene.has_phong)
    nxt = jax_trace(scene, pre, x, wi, eps)
    good = cont & nxt.valid
    f_c = jax_brdf.eval_nonspecular(mat, n, o, wi, scene.has_phong)
    cos_c = jax_vm.dot(n, wi)
    w_nonspec = jnp.where((pdf_b > 1e-12)[:, None], f_c * (cos_c / jnp.maximum(pdf_b, 1e-12))[:, None], 0.0)
    weight = jnp.where(is_spec[:, None], mat.c_s, w_nonspec) / p
    nxt_e = scene.obj_emitted[nxt.obj]
    if cfg.use_mis:
        hit_light = nxt.obj == scene.light_idx
        cos_yb = jnp.maximum(jax_vm.dot(nxt.n, -wi), 1e-8)
        pdf_l_sa_b = (nxt.t * nxt.t) / (cos_yb * scene.light_area)
        w_b = jnp.where(hit_light, pdf_b / (pdf_b + pdf_l_sa_b), 1.0)
        emis = jnp.where(is_spec[:, None], nxt_e / p, weight * w_b[:, None] * nxt_e)
        L = L + jnp.where(good[:, None], emis, 0.0)
    else:
        L = L + jnp.where((good & is_spec)[:, None], nxt_e / p, 0.0)
    beta = jnp.where(good[:, None], weight, 0.0)
    alive = good & jnp.any(beta > 0.0, axis=-1)
    rays = jnp.sum(~is_spec) + jnp.sum(cont)
    return L, beta, nxt.pos, nxt.n, alive, int(rays)


@pytest.mark.parametrize("use_mis", [False, True], ids=["nee", "mis"])
@pytest.mark.parametrize("p", [1.0, 0.9])
def test_one_bounce_matches_jax(cornell, use_mis, p):
    ref, port = cornell
    cfg = RenderConfig(use_mis=use_mis)
    n_lanes = 6000
    rng = np.random.default_rng(11)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    pre = scene_precompute(port)
    ro, rd = camera_rays3(
        port, cfg.width, cfg.height, cfg.fov_scale,
        f(rng.integers(0, cfg.width, n_lanes)), f(rng.integers(0, cfg.height, n_lanes)),
        f(rng.integers(0, 2, n_lanes)), f(rng.integers(0, 2, n_lanes)),
        f(rng.random(n_lanes)), f(rng.random(n_lanes)),
    )
    hit = trace_soa(port, pre, ro, rd, cfg.eps)
    assert hit.valid.all()  # cornell_box is closed
    us = rng.random((7, n_lanes)).astype(np.float32)
    state = PathState(
        L=torch.zeros(n_lanes, 3), beta=torch.ones(n_lanes, 3), x=hit.pos, n=hit.n, obj=hit.obj,
        o=vm.neg3(rd), alive=torch.ones(n_lanes, dtype=torch.bool),
        rays=torch.zeros((), dtype=torch.int64),
    )
    out = bounce(port, pre, cfg, state, [torch.from_numpy(u) for u in us], p)
    j = lambda v3: jnp.asarray(vm.stack3(v3).numpy())  # noqa: E731
    L, beta, x, nrm, alive, rays = _jax_bounce(
        ref, jax_scene_precompute(ref), jax_cfg(cfg), j(hit.pos), j(hit.n),
        jnp.asarray(hit.obj.numpy().astype(np.int32)), j(vm.neg3(rd)), jnp.asarray(us), p,
    )
    assert (out.alive.numpy() == np.asarray(alive)).mean() >= LANE_SHARE
    assert 0.3 < out.alive.double().mean() <= 1.0
    assert (out.L > 0).any(dim=1).double().mean() > 0.3  # the light is seen
    assert _close_share(out.L, L, scale=50.0) >= LANE_SHARE  # the light emits 50
    assert _close_share(out.beta, beta) >= LANE_SHARE
    both = out.alive.numpy() & np.asarray(alive)
    assert _close_share(vm.stack3(out.x).numpy()[both], np.asarray(x)[both], scale=100.0) >= LANE_SHARE
    assert _close_share(vm.stack3(out.n).numpy()[both], np.asarray(nrm)[both]) >= LANE_SHARE
    assert int(out.rays) == rays


@pytest.mark.parametrize("use_mis", [False, True], ids=["nee", "mis"])
def test_depth_one_radiance_matches_jax_radiance(cornell, use_mis):
    """JAX's own loop body in the comparison: both ``radiance`` functions on
    the same camera rays with ``max_depth=1`` (one bounce, no roulette)."""
    import jax

    ref, port = cornell
    cfg = RenderConfig(use_mis=use_mis, max_depth=1)
    n_lanes = 60000
    rng = np.random.default_rng(13)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    ro, rd = camera_rays3(
        port, cfg.width, cfg.height, cfg.fov_scale,
        f(rng.integers(0, cfg.width, n_lanes)), f(rng.integers(0, cfg.height, n_lanes)),
        f(rng.integers(0, 2, n_lanes)), f(rng.integers(0, 2, n_lanes)),
        f(rng.random(n_lanes)), f(rng.random(n_lanes)),
    )
    got, got_rays = radiance(port, scene_precompute(port), cfg, ro, rd, 17)
    want, want_rays = jax_radiance(
        ref, jax_scene_precompute(ref), jax_cfg(cfg),
        jnp.asarray(vm.stack3(ro).numpy()), jnp.asarray(vm.stack3(rd).numpy()), jax.random.PRNGKey(17),
    )
    got, want = got.double().numpy(), np.asarray(want, np.float64)
    assert got.shape == want.shape == (n_lanes, 3)
    assert int(got_rays) == int(want_rays) > 2 * n_lanes
    # Lane by lane the two share their camera ray and first hit (the emission
    # seen directly cancels), and differ by independent draws.
    diff = got - want
    stderr = diff.std(axis=0) / np.sqrt(n_lanes)
    assert (want.mean(axis=0) > 0.1).all() and (stderr < 0.02 * want.mean(axis=0)).all()
    assert (np.abs(diff.mean(axis=0)) < 4.0 * stderr).all()


def _image(renderer, spp):
    return renderer.render_image(spp).astype(np.float64)


def test_simple_engine_matches_jax_simple_engine(cornell):
    ref, port = cornell
    base = dict(width=72, height=54, rays_per_pass=1 << 14, engine="simple")
    a = _image(JaxRenderer(ref, jax_cfg(RenderConfig(seed=0, **base))), 64)
    a2 = _image(JaxRenderer(ref, jax_cfg(RenderConfig(seed=1, **base))), 64)
    r = Renderer(port, RenderConfig(seed=0, **base), device="cpu")
    assert r.engine == "simple" and r.plan(64) == (6, 16, 1)
    b = _image(r, 64)
    floor = np.abs(a - a2).mean()
    assert abs(a.mean() - b.mean()) < 1.5
    assert np.abs(a - b).mean() < 1.15 * floor + 0.5
    # The ray count is the reference's: within MC noise of JAX's.
    jr = JaxRenderer(ref, jax_cfg(RenderConfig(seed=0, **base)))
    jr.render_image(64)
    assert abs(r.rays_traced() / jr.rays_traced() - 1.0) < 0.01


@pytest.mark.parametrize("use_mis,bound", [(False, 1.5), (True, 2.0)], ids=["nee", "mis"])
def test_simple_engine_matches_regen_engine(cornell, use_mis, bound):
    _, port = cornell
    base = dict(width=48, height=36, rays_per_pass=1 << 13, use_mis=use_mis)
    a = _image(Renderer(port, RenderConfig(engine="simple", **base), device="cpu"), 32)
    b = _image(Renderer(port, RenderConfig(engine="regen", **base), device="cpu"), 32)
    assert abs(a.mean() - b.mean()) < bound


@pytest.mark.parametrize("scene_name", ["cornell_box", "flying_unicorn"])
@pytest.mark.parametrize("cfg", [
    RenderConfig(engine="simple"),
    RenderConfig(engine="simple", width=1920, height=1080),
    RenderConfig(engine="simple", width=72, height=54, rays_per_pass=1 << 14),
], ids=["600x450", "1080p", "72x54"])
def test_simple_plans_equal_jax(scene_name, cfg):
    path = os.path.join(SCENES, f"{scene_name}.toml")
    jr = JaxRenderer(jax_load_scene(path), jax_cfg(cfg))
    r = Renderer(load_scene(path, device="cpu"), cfg, device="cpu")
    assert r.engine == "simple"
    for spp in (0, 2, 4, 16, 64, 100, 256, 1024):
        assert r.plan(spp) == jr.plan(spp), spp
        assert r.plan_delivery(spp) == jr.plan_delivery(spp), spp
        assert r.plan_progressive(spp) == jr.plan_progressive(spp), spp
        assert list(r.iter_bands(spp)) == list(jr.iter_bands(spp)), spp
    if scene_name == "cornell_box" and cfg == RenderConfig(engine="simple"):
        # 2^17 lanes over 600 x 4 x 16 lanes a row: 3 rows, raised to 450 / 9.
        assert r.plan(256) == (50, 16, 4) and r.plan(4) == (50, 1, 1)


def test_simple_engine_is_deterministic_and_seeded(cornell):
    _, port = cornell
    cfg = RenderConfig(width=40, height=30, rays_per_pass=1 << 12, engine="simple")
    a = Renderer(port, cfg, device="cpu").render_image(16)
    b = Renderer(port, cfg, device="cpu").render_image(16)
    np.testing.assert_array_equal(a, b)
    pre = scene_precompute(port)
    s1, r1 = _render_band_impl(port, pre, cfg, 10, 3, 2, 2, 5)
    s2, r2 = _render_band_impl(port, pre, cfg, 10, 3, 2, 2, 5)
    s3, _ = _render_band_impl(port, pre, cfg, 10, 3, 2, 2, 6)
    assert torch.equal(s1, s2) and int(r1) == int(r2) > 3 * 40 * 4 * 4
    assert s1.shape == (3, 40, 4, 3) and not torch.equal(s1, s3)
    # Two passes of 2 draw under two pass seeds: not one pass twice.
    one, _ = _render_band_impl(port, pre, cfg, 10, 3, 2, 1, 5)
    assert not torch.allclose(s1, 2 * one)


def test_light_pixel_sees_emission(cornell):
    """A ray at the light sphere returns the emission (50) at depth 0, and
    the band's sums finalize to white there (tests/test_integrator.py:135, :166)."""
    _, port = cornell
    cfg = RenderConfig(width=608, height=456, rays_per_pass=1 << 15)
    pre = scene_precompute(port)
    n = 64
    ro, rd = camera_rays3(
        port, cfg.width, cfg.height, cfg.fov_scale,
        torch.full((n,), 300.0), torch.full((n,), 340.0), torch.zeros(n), torch.zeros(n),
        torch.rand(n, generator=torch.Generator().manual_seed(3)),
        torch.rand(n, generator=torch.Generator().manual_seed(4)),
    )
    rad, rays = radiance(port, pre, cfg, ro, rd, 9)
    assert rad.shape == (n, 3) and rad.mean() > 40.0 and int(rays) >= n
    sums, _ = _render_band_impl(port, pre, cfg, 340, 1, 8, 1, 0)
    assert (finalize(sums.numpy(), 8)[0, 300] == 255).all()
