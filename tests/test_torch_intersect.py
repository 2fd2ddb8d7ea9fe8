"""The port's generic trace, BRDF and light sampling against the JAX package.

- ``trace_soa``/``trace_t`` on cornell_box, cubes and flying_unicorn (its
  BVH through K2's twin), to the tolerances of tests/test_bvh.py:107-111:
  valid masks equal, t within rtol 2e-4 / atol 1e-4, object ids equal;
- ``gather_mat``, ``eval_nonspecular3``, ``sample3`` and ``sample_light3``
  on the same uniforms, rtol 1e-5 (the JAX frame uses rsqrt, the port
  1/sqrt), with and without the Phong arms.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu_torch.config import Epsilons
from raytracer_tpu.models.loader import load_scene as jax_load_scene
from raytracer_tpu.ops import brdf as jax_brdf
from raytracer_tpu.ops import intersect as jax_ix
from raytracer_tpu.render.integrator import sample_light3 as jax_sample_light3
from raytracer_tpu_torch.models.loader import load_scene
from raytracer_tpu_torch.ops import brdf
from raytracer_tpu_torch.ops import intersect as ix
from raytracer_tpu_torch.render.integrator import sample_light3
from tests.torch_cpu import jax_eps, one_torch_thread  # noqa: F401  (autouse)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
EPS = Epsilons()
# Rays per scene: the JAX BVH oracle (an XLA packet walk) is slow on the CPU.
N_RAYS = {"cornell_box": 4096, "cubes": 4096, "flying_unicorn": 1024}


@pytest.fixture(scope="module", params=sorted(N_RAYS))
def case(request):
    name = request.param
    path = os.path.join(SCENES, f"{name}.toml")
    ref, port = jax_load_scene(path), load_scene(path, device="cpu")
    n = N_RAYS[name]
    rng = np.random.default_rng(len(name))
    # Half the rays leave the camera into the room, half start anywhere in it.
    cam = port.cam_pos.numpy()
    tgt = rng.uniform([1, 0, 0], [99, 81.6, 170], (n // 2, 3))
    ro = np.concatenate([np.tile(cam, (n // 2, 1)), rng.uniform([2, 1, 1], [98, 80, 160], (n - n // 2, 3))])
    d = np.concatenate([tgt - cam, rng.normal(size=(n - n // 2, 3))])
    rd = d / np.linalg.norm(d, axis=1, keepdims=True)
    return ref, port, ro.astype(np.float32), rd.astype(np.float32)


def test_trace_soa_matches_jax(case):
    ref, port, ro, rd = case
    want = jax_ix.trace(ref, jax_ix.scene_precompute(ref), jnp.asarray(ro), jnp.asarray(rd), jax_eps(EPS))
    got = ix.trace(port, ix.scene_precompute(port), torch.from_numpy(ro), torch.from_numpy(rd), EPS)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.mean() > 0.9
    np.testing.assert_allclose(got.t.numpy()[valid], np.asarray(want.t)[valid], rtol=2e-4, atol=1e-4)
    np.testing.assert_array_equal(got.obj.numpy()[valid], np.asarray(want.obj)[valid])
    np.testing.assert_allclose(got.n.numpy()[valid], np.asarray(want.n)[valid], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.pos.numpy()[valid], np.asarray(want.pos)[valid], rtol=2e-4, atol=1e-2)
    if port.use_bvh:  # the mesh is hit, through the BVH
        tri = got.obj.numpy()[valid] == port.tri_obj[port.bvh_tri_start].item()
        assert tri.sum() > 20


def test_trace_t_bounded_matches_jax(case):
    ref, port, ro, rd = case
    n = ro.shape[0]
    t_max = np.random.default_rng(1).uniform(0.0, 120.0, n).astype(np.float32)
    t_max[: n // 8] = 0.0  # parked / non-NEE lanes pass 0
    tj, vj = jax_ix.trace_t(ref, jax_ix.scene_precompute(ref), jnp.asarray(ro), jnp.asarray(rd),
                            jax_eps(EPS), t_max=jnp.asarray(t_max))
    tp, vp = ix.trace_t(port, ix.scene_precompute(port), torch.from_numpy(ro), torch.from_numpy(rd),
                        EPS, t_max=torch.from_numpy(t_max))
    tj, tp = np.asarray(tj), tp.numpy()
    # The visibility test's answer, "a hit below the bound", agrees.
    np.testing.assert_array_equal(tp < t_max, tj < t_max)
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    below = tp < t_max
    np.testing.assert_allclose(tp[below], tj[below], rtol=2e-4, atol=1e-4)


@pytest.fixture(scope="module")
def shading():
    path = os.path.join(SCENES, "cornell_box.toml")
    ref, port = jax_load_scene(path), load_scene(path, device="cpu")
    rng = np.random.default_rng(21)
    n = 5000
    obj = rng.integers(0, port.n_objects, n).astype(np.int32)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    o = rng.normal(size=(n, 3))
    o /= np.linalg.norm(o, axis=1, keepdims=True)
    u = rng.random((3, n)).astype(np.float32)
    return ref, port, obj, nrm.astype(np.float32), o.astype(np.float32), u


def _j3(a):
    return tuple(jnp.asarray(a[:, k]) for k in range(3))


def _t3(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, k])) for k in range(3))


def test_gather_mat_matches_jax(shading):
    ref, port, obj, *_ = shading
    want = jax_brdf.gather_mat(ref, jnp.asarray(obj))
    got = brdf.gather_mat(port, torch.from_numpy(obj).long())
    for k in want._fields:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), err_msg=k)


def test_eval_and_sample_match_jax(shading):
    ref, port, obj, nrm, o, u = shading
    jm = jax_brdf.gather_mat(ref, jnp.asarray(obj))
    pm = brdf.gather_mat(port, torch.from_numpy(obj).long())
    ju = [jnp.asarray(x) for x in u]
    pu = [torch.from_numpy(x) for x in u]
    wi_j, pdf_j = jax_brdf.sample3(jm, _j3(nrm), _j3(o), *ju, True, False)
    wi_p, pdf_p = brdf.sample3(pm, _t3(nrm), _t3(o), *pu, True, False)
    for k in range(3):
        np.testing.assert_allclose(wi_p[k].numpy(), np.asarray(wi_j[k]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pdf_p.numpy(), np.asarray(pdf_j), rtol=1e-5, atol=1e-6)
    wi = np.stack([np.asarray(c) for c in wi_j], 1)
    f_j = jax_brdf.eval_nonspecular3(jm, _j3(nrm), _j3(o), _j3(wi), False)
    f_p = brdf.eval_nonspecular3(pm, _t3(nrm), _t3(o), _t3(wi), False)
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_j), rtol=1e-5)
    assert (f_p.numpy()[pm.brdf_type.numpy() == 1] == 0).all()


def test_phong_raises_slice_three(shading):
    """The Phong arms now evaluate (``has_phong=True``), and agree with JAX's
    on a scene whose lanes are diffuse and mirror: the Phong lobe is masked
    off them exactly. tests/test_torch_phong_mis.py holds Phong lanes."""
    ref, port, obj, nrm, o, u = shading
    jm = jax_brdf.gather_mat(ref, jnp.asarray(obj))
    pm = brdf.gather_mat(port, torch.from_numpy(obj).long())
    wi_j, pdf_j = jax_brdf.sample3(jm, _j3(nrm), _j3(o), *[jnp.asarray(x) for x in u], True, True)
    wi_p, pdf_p = brdf.sample3(pm, _t3(nrm), _t3(o), *[torch.from_numpy(x) for x in u], True, True)
    for k in range(3):
        np.testing.assert_allclose(wi_p[k].numpy(), np.asarray(wi_j[k]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pdf_p.numpy(), np.asarray(pdf_j), rtol=1e-5, atol=1e-6)
    wi = np.stack([np.asarray(c) for c in wi_j], 1)
    f_j = jax_brdf.eval_nonspecular3(jm, _j3(nrm), _j3(o), _j3(wi), True)
    f_p = brdf.eval_nonspecular3(pm, _t3(nrm), _t3(o), _t3(wi), True)
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_j), rtol=1e-5)
    f_off = brdf.eval_nonspecular3(pm, _t3(nrm), _t3(o), _t3(wi), False)
    assert torch.equal(f_p, f_off)


def test_sample_light_matches_jax(shading):
    ref, port, _, _, _, u = shading
    yj, nj, pj = jax_sample_light3(ref, *[jnp.asarray(x) for x in u])
    yp, np_, pp = sample_light3(port, *[torch.from_numpy(x) for x in u])
    for k in range(3):
        np.testing.assert_allclose(yp[k].numpy(), np.asarray(yj[k]), rtol=1e-5)
        np.testing.assert_allclose(np_[k].numpy(), np.asarray(nj[k]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pp.numpy(), np.asarray(pj), rtol=1e-5)
