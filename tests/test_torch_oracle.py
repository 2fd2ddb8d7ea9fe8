"""The port's intersection, BRDF and estimator on the CPU against the
independent scalar f64 oracle of ``tests/oracle.py`` (numpy only), as
``tests/test_integrator.py`` and ``tests/test_oracle_phong.py`` hold the JAX
package against it.

Deterministic parts, f32 against f64 on the same inputs:

- ``trace`` against ``Oracle.intersect`` on cornell_box (spheres, planes)
  and on the Phong oracle scene (planes, a two-triangle quad, spheres): the
  same object on every ray that is not within ``EDGE`` of a second surface,
  t within rtol 1e-4 + atol 2e-3 (the port's f32 epsilons move a hit by up to
  ``hit_offset`` 1e-3), normals within 1e-3 (the f32 sphere discriminant
  cancels: a hit point off by 1e-3 on a sphere of radius 4 to 16.5);
- ``eval_nonspecular3`` against ``Oracle.f_eval`` for diffuse and Phong
  materials: rtol 1e-4 (f32 rounding of a cosine raised to a power of up to
  80).

Statistical part, with the tolerance of the JAX package's own oracle tests
(``|ours - oracle| < 4.5 sem + 0.02`` per channel, tests/test_integrator.py:81,
tests/test_oracle_phong.py:117): the regen engine's mean radiance of a
pixel (``render_band_regen`` over the pixel's row, 8 seeds of 16 samples a
lane, 512 samples a pixel; the standard error from the 8 seed means)
against 384 oracle paths through the same pixel, for cornell_box with NEE and with MIS and for the Phong scene.
"""

import math
import os
import tomllib

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.config import Epsilons, RenderConfig
from raytracer_tpu_torch.models.loader import load_scene
from raytracer_tpu_torch.models.scene import build_scene_arrays
from raytracer_tpu_torch.ops import brdf
from raytracer_tpu_torch.ops.intersect import scene_precompute, trace
from raytracer_tpu_torch.render.wavefront import render_band_regen
from tests.oracle import Oracle
from tests.test_oracle_phong import CAM_DIR, CAM_POS, PHONG_BALL, PHONG_QUAD, PLANES, QUAD, WALL_KD
from tests.torch_cpu import one_torch_thread  # noqa: F401  (autouse)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
EPS = Epsilons()
# A ray whose two nearest surfaces lie closer together than this may pick
# either under the two packages' epsilons (f32 re-tuned against f64).
EDGE = 0.05
SEEDS, SAMPLES = 8, 16  # x 4 subpixel lanes: 512 samples a pixel
N_ORACLE = 384


@pytest.fixture(scope="module")
def cornell():
    path = os.path.join(SCENES, "cornell_box.toml")
    with open(path, "rb") as fh:
        doc = tomllib.load(fh)
    return load_scene(path, device="cpu"), doc


@pytest.fixture(scope="module")
def phong_scene():
    """The scene of tests/test_oracle_phong.py: the same explicit geometry for
    the port's ``build_scene_arrays`` and for the oracle. Objects: planes
    (0-3), the Phong quad (4), the Phong ball (5), the light (6)."""
    def mat(emitted=(0, 0, 0), brdf_type=0, c_d=(0, 0, 0), c_s=(0, 0, 0), k_d=1.0, k_s=0.0, power=0.0):
        return dict(emitted=list(emitted), brdf_type=brdf_type, c_d=list(c_d), c_s=list(c_s),
                    k_d=k_d, k_s=k_s, power=power)

    materials = [mat(c_d=WALL_KD) for _ in PLANES]
    for ph in (PHONG_QUAD, PHONG_BALL):
        materials.append(mat(brdf_type=2, c_d=ph["color_d"], c_s=ph["color_s"], k_d=ph["kd"], k_s=ph["ks"],
                             power=ph["power"]))
    materials.append(mat(emitted=(50, 50, 50)))
    ball = dict(pos=[75.0, 10.0, 85.0], r=10.0)
    light = dict(pos=[50.0, 70.0, 100.0], r=4.0)
    scene = build_scene_arrays(
        "phong_oracle", np.asarray(CAM_POS), np.asarray(CAM_DIR),
        spheres=[dict(**ball, obj=5), dict(**light, obj=6)],
        planes=[dict(**p, obj=i) for i, p in enumerate(PLANES)],
        triangles=[dict(a=t[0], b=t[1], c=t[2], obj=4) for t in QUAD],
        materials=materials, device="cpu",
    )
    doc = dict(
        camera=dict(pos=CAM_POS, dir=CAM_DIR),
        objects=[
            *[dict(brdf=dict(type="diffuse", kd=WALL_KD), geometry=dict(type="plane", **p)) for p in PLANES],
            dict(brdf=dict(type="phong", **PHONG_QUAD), geometry=dict(type="triangles", tris=QUAD)),
            dict(brdf=dict(type="phong", **PHONG_BALL), geometry=dict(type="sphere", **ball)),
            dict(emitted=[50, 50, 50], brdf=dict(type="diffuse", kd=[0, 0, 0]),
                 geometry=dict(type="sphere", **light)),
        ],
    )
    return scene, doc


def _camera_basis(doc, cfg):
    w, h = float(cfg.width), float(cfg.height)
    cx = np.asarray([cfg.fov_scale * w / h, 0.0, 0.0])
    cam_dir = np.asarray(doc["camera"]["dir"], float)
    cy = np.cross(cx, cam_dir)
    return cx, cy / np.linalg.norm(cy) * cfg.fov_scale, cam_dir


def _test_rays(doc, n, seed):
    """Half camera rays over the whole frame, half rays from points inside
    the scene in random directions."""
    rng = np.random.default_rng(seed)
    cx, cy, cam_dir = _camera_basis(doc, RenderConfig())
    d_cam = cx * rng.uniform(-0.5, 0.5, (n // 2, 1)) + cy * rng.uniform(-0.5, 0.5, (n // 2, 1)) + cam_dir
    ro = np.concatenate([np.tile(np.asarray(doc["camera"]["pos"], float), (n // 2, 1)),
                         rng.uniform([10, 5, 20], [90, 60, 150], (n - n // 2, 3))])
    d = np.concatenate([d_cam, rng.normal(size=(n - n // 2, 3))])
    return ro, d / np.linalg.norm(d, axis=1, keepdims=True)


def _second_hit_gap(oracle, ro, rd, first):
    """Distance from the nearest hit to the next surface along the ray."""
    nxt = oracle.intersect(ro + (first[0] + 1e-3) * rd, rd)
    return math.inf if nxt is None else nxt[0]


@pytest.mark.parametrize("which", ["cornell", "phong"])
def test_trace_matches_the_oracles_intersect(which, cornell, phong_scene):
    scene, doc = cornell if which == "cornell" else phong_scene
    oracle = Oracle(doc, np.random.default_rng(0))
    ro, rd = _test_rays(doc, 400, 51)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    hit = trace(scene, scene_precompute(scene), f32(ro), f32(rd), EPS)
    checked = 0
    for k in range(ro.shape[0]):
        want = oracle.intersect(ro[k], rd[k])
        if want is None:
            assert not bool(hit.valid[k])
            continue
        if _second_hit_gap(oracle, ro[k], rd[k], want) < EDGE or want[0] < EDGE:
            continue  # an edge or a corner: either surface may win
        t, _, n, obj = want
        assert bool(hit.valid[k]) and int(hit.obj[k]) == obj, k
        np.testing.assert_allclose(float(hit.t[k]), t, rtol=1e-4, atol=2e-3)
        np.testing.assert_allclose(hit.n[k].numpy(), n, atol=1e-3)
        np.testing.assert_allclose(hit.pos[k].numpy(), ro[k] + t * rd[k], atol=5e-3)
        checked += 1
    assert checked > 300
    if which == "phong":  # the quad and the ball are both seen
        assert {4, 5} <= set(hit.obj[hit.valid].tolist())


def test_brdf_eval_matches_the_oracles_f_eval(phong_scene):
    scene, doc = phong_scene
    oracle = Oracle(doc, np.random.default_rng(0))
    rng = np.random.default_rng(52)
    n_s = 200

    def unit(a):
        return a / np.linalg.norm(a, axis=1, keepdims=True)

    n = unit(rng.normal(size=(n_s, 3)))
    # Both directions in the hemisphere of n, some close to the mirror pair.
    o = unit(rng.normal(size=(n_s, 3)) + 1.5 * n)
    i = unit(rng.normal(size=(n_s, 3)) + 1.5 * n)
    refl = 2.0 * (o * n).sum(1, keepdims=True) * n - o
    i[::4] = unit(refl[::4] + 0.05 * rng.normal(size=(n_s // 4, 3)))
    obj = rng.choice([0, 4, 5], n_s)  # a wall, the Phong quad, the Phong ball
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    mat = brdf.gather_mat(scene, torch.from_numpy(obj))
    got = brdf.eval_nonspecular3(mat, f32(n).unbind(1), f32(o).unbind(1), f32(i).unbind(1), has_phong=True)
    want = np.stack([oracle.f_eval(doc["objects"][ob]["brdf"], n[k], o[k], i[k]) * np.ones(3)
                     for k, ob in enumerate(obj)])
    assert want.max() > 5.0  # the lobe's peak is among them
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


def _port_pixel_means(scene, cfg, py, pxs):
    """[SEEDS, len(pxs), 3]: mean radiance of each pixel of row ``py`` over
    its 4 subpixel lanes x SAMPLES samples, once per seed."""
    pre = scene_precompute(scene)
    out = []
    for seed in range(SEEDS):
        sums, rays = render_band_regen(scene, pre, cfg, py, 1, SAMPLES, seed)
        assert int(rays) >= cfg.width * 4 * SAMPLES  # at least the camera rays
        out.append(sums[0, pxs].sum(dim=1).numpy() / (4 * SAMPLES))
    return np.stack(out)


def _oracle_pixel(doc, cfg, px, py, seed, use_mis=False):
    """(mean, sem) of ``N_ORACLE`` oracle paths through pixel (px, py)."""
    oracle = Oracle(doc, np.random.default_rng(seed), use_mis=use_mis)
    cx, cy, cam_dir = _camera_basis(doc, cfg)
    acc = np.zeros((N_ORACLE, 3))
    for k in range(N_ORACLE):
        fx = (0.5 + px + oracle.rng.uniform(-0.5, 0.5)) / cfg.width - 0.5
        fy = (0.5 + py + oracle.rng.uniform(-0.5, 0.5)) / cfg.height - 0.5
        d = cx * fx + cy * fy + cam_dir
        acc[k] = oracle.received(np.asarray(doc["camera"]["pos"], float), d / np.linalg.norm(d))
    return acc.mean(axis=0), acc.std(axis=0) / np.sqrt(N_ORACLE)


def _assert_row_matches_oracle(scene, doc, cfg, py, pxs, seed):
    ours = _port_pixel_means(scene, cfg, py, pxs)
    ours_mean = ours.mean(axis=0)
    ours_sem = ours.std(axis=0, ddof=1) / np.sqrt(SEEDS)
    for j, px in enumerate(pxs):
        o_mean, o_sem = _oracle_pixel(doc, cfg, px, py, seed, use_mis=cfg.use_mis)
        sem = np.sqrt(ours_sem[j] ** 2 + o_sem**2)
        diff = np.abs(ours_mean[j] - o_mean)
        assert (diff < 4.5 * sem + 0.02).all(), (
            f"pixel ({px},{py}): port {ours_mean[j]} vs oracle {o_mean} sem {sem}"
        )
        assert ours_mean[j].max() > 0.02  # a lit surface, not a miss


@pytest.mark.parametrize("use_mis", [False, True])
def test_cornell_row_matches_the_oracle(cornell, use_mis):
    """Back-wall and side-wall pixels of one row, NEE and MIS (the oracle's
    own balance heuristic, written from the spec)."""
    scene, doc = cornell
    cfg = RenderConfig(use_mis=use_mis, engine="regen")
    _assert_row_matches_oracle(scene, doc, cfg, 150, [120, 300, 470], seed=321 if use_mis else 123)


@pytest.mark.parametrize("py,pxs", [(150, [300]), (87, [404]), (60, [150])])
def test_phong_scene_rows_match_the_oracle(phong_scene, py, pxs):
    """The Phong quad, the Phong ball and a floor pixel of
    tests/test_oracle_phong.py. The oracle continues a Phong path by another
    estimator (cosine sampling and a (kd+ks) roulette) than the port's
    three-way lobe sampler: equal expectations through different estimators."""
    scene, doc = phong_scene
    _assert_row_matches_oracle(scene, doc, RenderConfig(engine="regen"), py, pxs, seed=321)
