"""The plain reference against the program on the CPU at tiny sizes, its
control, and the frozen work counts on a small mesh."""

import os
import shutil

import pytest
import torch

from rtbench import compare, spec, work
from rtbench.reference import bvh
from rtbench.reference import frame as F
from rtbench.reference import render as R
from rtbench.reference import scene as RS

ROOT = spec.ROOT
SEED = 2**31 + 4321


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh_scene(tmp_path_factory):
    """The cornell walls with the chair mesh (212 triangles behind the
    program's BVH), a mirror sphere and the sphere light."""
    d = tmp_path_factory.mktemp("mesh")
    os.makedirs(d / "assets")
    shutil.copy(os.path.join(ROOT, "scenes", "assets", "chair.obj"), d / "assets" / "chair.obj")
    toml = open(os.path.join(ROOT, "benchmark", "scenes", "cornell_box.toml")).read()
    toml = toml.split("# Ball 1")[0] + (
        '[[objects]]\nbrdf = { type = "diffuse", kd = [0.9, 0.9, 0.9] }\n'
        'geometry = { type = "mesh", path = "chair.obj" }\n'
        'transforms = [ { scale = 20.0 }, { translate = [30.0, 10.0, 60.0] }, { rotate_y = 0.5 } ]\n'
        "# Ball 2" + toml.split("# Ball 2")[1])
    (d / "chair_room.toml").write_text(toml)
    return str(d / "chair_room.toml")


def port_image(path, w, h, spp, seed=SEED, sharded_over=None):
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.loader import load_scene
    from raytracer_tpu_torch.render.renderer import Renderer

    scene = load_scene(path, device="cpu")
    cfg = RenderConfig(width=w, height=h, seed=seed)
    if sharded_over:
        from raytracer_tpu_torch.parallel.mesh import ShardedRenderer

        return ShardedRenderer(scene, cfg, ["cpu"] * sharded_over).render_image(spp)
    return Renderer(scene, cfg, device="cpu").render_image(spp)


def ref_rows(path, schedule, w, h, spp, rows, seed=SEED, cards=1, dtype=torch.float32):
    ds = R.DevScene(RS.load(path), R.Params(width=w, height=h), "cpu", dtype)
    return F.render_rows(ds, schedule, rows, spp, seed, cards).numpy()


def test_cornell_rows_equal_the_program():
    path = os.path.join(ROOT, "benchmark", "scenes", "cornell_box.toml")
    img = port_image(path, 24, 18, 64)
    rows = list(range(18))
    assert compare.pixels_off_pct(compare.image_rows(img, rows), ref_rows(path, "k1", 24, 18, 64, rows)) == 0.0


def test_cornell_over_four_devices_equals_the_program():
    path = os.path.join(ROOT, "benchmark", "scenes", "cornell_box.toml")
    img = port_image(path, 24, 18, 16, sharded_over=4)
    rows = list(range(0, 18, 2))
    got = compare.image_rows(img, rows)
    assert compare.pixels_off_pct(got, ref_rows(path, "k1", 24, 18, 16, rows, cards=4)) == 0.0
    # The one-card band plan seeds the rows otherwise: most pixels differ.
    assert compare.pixels_off_pct(got, ref_rows(path, "k1", 24, 18, 16, rows, cards=1)) > 50.0


def test_mesh_rows_equal_the_program(mesh_scene):
    img = port_image(mesh_scene, 24, 18, 16)
    rows = [1, 5, 9, 13, 17]
    assert compare.pixels_off_pct(compare.image_rows(img, rows), ref_rows(mesh_scene, "regen", 24, 18, 16, rows)) == 0.0


def test_the_controls_fail(mesh_scene):
    """bfloat16 in the reference (the sphere/plane cells' control) and the
    program's own bfloat16 state (the mesh cell's) move many pixels."""
    path = os.path.join(ROOT, "benchmark", "scenes", "cornell_box.toml")
    rows = list(range(0, 18, 3))
    f32 = ref_rows(path, "k1", 24, 18, 64, rows)
    bf16 = ref_rows(path, "k1", 24, 18, 64, rows, dtype=torch.bfloat16)
    assert compare.pixels_off_pct(bf16, f32) > 50.0
    os.environ["RT_STATE_BF16"] = "1"
    try:
        img = port_image(mesh_scene, 24, 18, 16)
    finally:
        del os.environ["RT_STATE_BF16"]
    rows = list(range(18))
    # At this size the program in float32 is off on no pixel (the test above).
    assert compare.pixels_off_pct(compare.image_rows(img, rows), ref_rows(mesh_scene, "regen", 24, 18, 16, rows)) > 0.0


def test_sample_counts_follow_the_program():
    assert [F.samples(s) for s in (2, 8, 16, 64, 256, 12)] == [0, 2, 4, 16, 64, 4]
    assert F.band_rows(R.Params(), 1) == 50
    assert F.band_rows(R.Params(), 4) == 38


def test_work_counts_on_a_small_mesh(mesh_scene):
    """The tree's walk finds every hit that brute force finds, and counts
    the work it did; the arithmetic of the tables."""
    sc = RS.load(mesh_scene)
    ds = R.DevScene(sc, R.Params(), "cpu")
    tree = bvh.Tree(sc.tris)
    g = torch.Generator().manual_seed(3)
    n = 4000
    c = torch.as_tensor(sc.tris.reshape(-1, 3).mean(0), dtype=torch.float32)
    ro = c + (torch.rand(n, 3, generator=g) - 0.5) * 200.0
    target = torch.as_tensor(sc.tris[torch.randint(len(sc.tris), (n,), generator=g).numpy()].mean(1),
                             dtype=torch.float32)
    rd = target - ro
    rd = rd / rd.norm(dim=1, keepdim=True)
    t_bf, i_bf = R.mesh_nearest(ds, tuple(ro.T), tuple(rd.T), torch.full((n,), R.INF))
    hit = i_bf >= 0
    assert hit.float().mean() > 0.5
    counts = bvh.walk_counts(tree, ds.tri_rows, ro, rd, None, ds.p.tri_tmin, ds.p.tri_parallel)
    assert counts["rays"] == n and counts["boxes"] > n and 0 < counts["cand"] <= counts["tris"]
    assert counts["tris"] < n * len(sc.tris) / 4
    # Any-hit below the nearest hit's distance finds nothing; just past it, something.
    cap = torch.where(hit, t_bf * 0.999, torch.ones(n))
    c_none = bvh.walk_counts(tree, ds.tri_rows, ro, rd, cap, ds.p.tri_tmin, ds.p.tri_parallel)
    assert c_none["boxes"] < counts["boxes"] * 2
    ops, nbytes = work.walk_work({"rays": 10, "boxes": 100, "tris": 40, "cand": 5}, 1000)
    assert ops == 10 * 9 + 100 * 26 + 40 * 16 + 5 * 30 and nbytes == 10 * 37 + 1000
    ops, _ = work.k1_work({"camera": 2, "bounce": 3, "shadow": 1}, 3, 6, 8, 9)
    assert ops == 2 * 46 + 3 * (75 + 126 + 130) + 1 * (75 + 126 + 60)
    assert work.least_s(67e12, 0) == pytest.approx(1.0)
