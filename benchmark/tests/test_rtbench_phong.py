"""The crewmate cell: the Phong reference (``rtbench/reference/phong.py``)
and the module that holds a frame to the configuration's own reference
module (``rtbench/offline_cfgref.py``).

On the CPU at tiny sizes: the reference equals the program's plain path on
every pixel; a whole run is ``correct``; four planted faults make it
``correct: false``: half the samples and an answer altered
(``rtbench/faults.py``), and two of the Phong material planted here, its
lobe left out of the shading (``phong_lobe_left_out``: Phong surfaces
shade with kd alone) and the upstream's local-frame lobes
(``phong_local_frame``: ``fix_phong_frame`` off); the new modules import
nothing of the program or of JAX; the new metric readers give ``None``
where there is nothing to read. On the card (``-m cuda``), at the cell's
own size: the program reads under the limit and the controls and every
fault above it.
"""

import ast
import contextlib
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import run as runmod
from rtbench import compare, faults, spec
from rtbench.reference import frame as F
from rtbench.reference import phong
from rtbench.reference import render as R

CELL = "crewmate16.offline"
SCENE = os.path.join(spec.BENCH_DIR, "scenes", "crewmate_phong.toml")
TINY = ["--device", "cpu", "--width", "24", "--height", "18"]
SEED = 2**31 + 4321
JAX = {"jax", "jaxlib", "flax", "raytracer_tpu"}


@contextlib.contextmanager
def phong_lobe_left_out():
    """Phong surfaces shade with their cosine term alone, in the light
    sample's term and in the bounce's weight."""
    from raytracer_tpu_torch.ops import brdf

    orig = brdf.eval_nonspecular3

    def kd_only(mat, n, o, i, has_phong=False, *rest, **kw):
        return orig(mat, n, o, i, False, *rest, **kw)

    brdf.eval_nonspecular3 = kd_only
    try:
        yield
    finally:
        brdf.eval_nonspecular3 = orig


@contextlib.contextmanager
def phong_local_frame():
    """The upstream's bug: the Phong lobes' directions left in the local frame."""
    from raytracer_tpu_torch.ops import brdf

    orig = brdf.sample3

    def local(mat, n, o, u1, u2, u3, fix_phong_frame=True, *rest, **kw):
        return orig(mat, n, o, u1, u2, u3, False, *rest, **kw)

    brdf.sample3 = local
    try:
        yield
    finally:
        brdf.sample3 = orig


FAULTS = {
    "half_the_samples": lambda: faults.planted("half_the_samples"),
    "answer_altered": lambda: faults.planted("answer_altered"),
    "phong_lobe_left_out": phong_lobe_left_out,
    "phong_local_frame": phong_local_frame,
}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def result(capsys, trace="0"):
    rc = runmod.main(["--workload", CELL, "--seed", str(2**31 + 99), "--seconds", "0.5", "--trace", trace, *TINY])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def test_reference_equals_the_program_on_every_pixel():
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.loader import load_scene
    from raytracer_tpu_torch.render.renderer import Renderer

    w, h = 24, 18
    scene = load_scene(SCENE, device="cpu")
    assert scene.has_phong and scene.use_bvh
    ds = phong.dev_scene(SCENE, R.Params(width=w, height=h), "cpu")
    rows = list(range(h))
    for seed in (SEED, 7):
        img = Renderer(scene, RenderConfig(width=w, height=h, seed=seed), device="cpu").render_image(16)
        counts: dict = {}
        ref = phong.render_rows(ds, "regen", rows, 16, seed, counts=counts).numpy()
        assert compare.pixels_off_pct(compare.image_rows(img, rows), ref) == 0.0
        assert counts["camera"] == w * h * 4 * F.samples(16) and counts["shadow_traced"] > 0


def test_the_loader_reads_the_phong_materials():
    sc = phong.load(SCENE)
    on = sc.brdf == phong.PHONG
    assert on.sum() == 2 and len(sc.tris) == 3412
    # The mesh (kd 0.65, ks 0.3, power 25), then the sphere, as float32.
    got = [sc.k_d[on].tolist(), sc.k_s[on].tolist(), sc.power[on].tolist()]
    assert got == [[np.float32(0.65), np.float32(0.45)], [np.float32(0.3), np.float32(0.5)], [25.0, 80.0]]
    assert (sc.power[~on] == 0).all() and (sc.k_s[~on] == 0).all()


def test_a_whole_run_is_correct(capsys):
    r = result(capsys)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"setup_s", "frame_s"}
    assert r["checks"]["pixels_off_pct"]["value"] == 0.0
    assert r["checks"]["frames_unequal"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(capsys, fault):
    with FAULTS[fault]():
        r = result(capsys)
    assert r["correct"] is False
    assert r["checks"]["pixels_off_pct"]["value"] > r["checks"]["pixels_off_pct"]["limit"]


def _top_names(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_new_modules_import_nothing_of_the_program_or_of_jax():
    rt = os.path.join(spec.BENCH_DIR, "rtbench")
    assert _top_names(os.path.join(rt, "reference", "phong.py")) <= {
        "__future__", "dataclasses", "os", "tomllib", "numpy", "torch", "rtbench"}
    for f in ("offline_cfgref.py", os.path.join("..", "metrics", "k2_roofline_pct.crewmate.py")):
        names = _top_names(os.path.join(rt, f))
        assert "raytracer_tpu_torch" not in names and not names & JAX, f
    config = spec.config(spec.load(), spec.cell(spec.load(), CELL)["config"])
    assert config["reference_module"] == "rtbench.reference.phong"
    code = ("import json, sys; sys.path[:0] = [%r, %r]; import rtbench.offline_cfgref, rtbench.reference.phong; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))" % (spec.BENCH_DIR, spec.ROOT))
    loaded = set(json.loads(subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                                           check=True, timeout=120).stdout))
    assert "raytracer_tpu_torch" not in loaded and not loaded & JAX


NEW_READERS = ("phong_hit_pct.crewmate", "glue_ms_per_frame.crewmate", "regen_graph_step_pct.crewmate",
               "k2_roofline_pct.crewmate", "device_idle_pct.crewmate")


def test_the_new_readers_find_nothing_without_counters_frames_or_kernels():
    summary = types.SimpleNamespace(kernel_us=lambda like: (0.0, 0), busy_share=lambda: 1.0)
    ctx = types.SimpleNamespace(out={"events": [], "traced_frames": [], "frame_s": 0.5}, summary=summary,
                                ref_rays=None, render_params={"height": 18}, check_rows=[0])
    for name in NEW_READERS[:-1]:
        assert spec.metric_reader(name)(ctx) is None, name
    assert spec.metric_reader(NEW_READERS[-1])(ctx) == 0.0  # the stem reader: the trace's busy share
    assert {m["name"] for m in spec.per_layer(spec.load(), CELL)} == set(NEW_READERS)


@pytest.mark.cuda
def test_on_the_card_the_limit_lies_between_the_program_and_the_faults():
    """At the cell's size: the program under the limit on two seeds; both
    controls and every fault above it on three. The readings print as JSON
    lines (``-s``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rtbench import calibrate_cfgref

    sp = spec.load()
    limit = spec.config(sp, spec.cell(sp, CELL)["config"])["check"]["pixels_off_pct"]
    r = calibrate_cfgref.readings(CELL, [7001, 7002], [7101, 7102, 7103], FAULTS)
    print(json.dumps(r))
    assert all(v <= limit for _s, v, _t in r["program"])
    for control in ("control_state_bf16", "control_reference_bf16"):
        assert all(v > limit for _s, v in r[control]), control
    assert set(r["faults"]) == set(FAULTS)
    assert all(v > limit for readings in r["faults"].values() for _s, v in readings)
