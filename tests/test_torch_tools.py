"""The port's command-line tools and observability helpers on the CPU: the
cases of ``tests/test_tools.py`` on the port (``tools.render`` with
``--mis`` and ``--profile``, ``tools.top_ops``, ``RenderStats``,
``tools.parity``), ``tools.kbench``'s refusal without a
card, and the BVH's leaf-size and cut-size hooks.
"""

import gzip
import json
import os
import time

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.loader import load_scene
from raytracer_tpu_torch.tools import top_ops
from raytracer_tpu_torch.tools.render import main as render_main
from raytracer_tpu_torch.utils.png import read_png
from raytracer_tpu_torch.utils.timing import RenderStats, device_trace
from tests.torch_cpu import one_torch_thread  # noqa: F401  (autouse)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
CORNELL = os.path.join(SCENES, "cornell_box.toml")


def test_render_cli_writes_png(tmp_path):
    out = str(tmp_path / "out.png")
    rc = render_main([CORNELL, "--spp", "8", "--out", out, "--width", "40", "--height", "30",
                      "--device", "cpu"])
    assert rc == 0
    img = read_png(out)
    assert img.shape == (30, 40, 3)
    assert img.mean() > 5  # actually rendered something


def test_render_cli_mis_flag(tmp_path):
    out = str(tmp_path / "mis.png")
    rc = render_main([CORNELL, "--spp", "8", "--out", out, "--width", "40", "--height", "30",
                      "--mis", "--max-depth", "8", "--seed", "3", "--device", "cpu"])
    assert rc == 0 and os.path.exists(out)


def test_render_cli_profile_trace(tmp_path, capsys):
    """--profile writes one Chrome trace of the render, which the analyzer
    reads and ranks, and prints the render's counters after its stats."""
    out = str(tmp_path / "prof.png")
    trace_dir = str(tmp_path / "trace")
    rc = render_main([CORNELL, "--spp", "4", "--out", out, "--width", "20", "--height", "15",
                      "--device", "cpu", "--profile", trace_dir])
    assert rc == 0
    (line,) = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("counters ")]
    assert json.loads(line[len("counters "):]) == {"host.syncs": 1}  # one K1 frame: one pull
    found = [f for f in os.listdir(trace_dir) if f.endswith(".trace.json.gz")]
    assert len(found) == 1, f"trace artifacts under {trace_dir}: {os.listdir(trace_dir)}"

    events = top_ops.load_trace_events(trace_dir)
    assert events and all(e["ph"] == "X" for e in events)
    rows, total_us = top_ops.summarize(events, top=5)
    assert rows and total_us > 0 and len(rows) <= 5
    assert rows == sorted(rows, key=lambda r: -r[1])
    name, us, count, mean = rows[0]
    assert count >= 1 and mean == pytest.approx(us / count)
    only, _ = top_ops.summarize(events, like="aten::where")
    assert [r[0] for r in only] == ["aten::where"]
    # A CPU render has host ops and no device slice.
    assert top_ops.by_category(events, top_ops.HOST_CATS)
    assert not top_ops.by_category(events, top_ops.DEVICE_CATS)
    assert top_ops.main([trace_dir, "--top", "3"]) == 0
    assert top_ops.main([str(tmp_path / "nothing_here")]) == 1


def test_device_trace_is_a_noop_without_a_directory(tmp_path):
    with device_trace(None):
        pass
    with device_trace(""):
        pass
    assert os.listdir(tmp_path) == []
    with device_trace(str(tmp_path / "t"), "cpu"):
        torch.ones(8).sum()
    (name,) = os.listdir(tmp_path / "t")
    assert name.endswith(".trace.json.gz")
    assert top_ops.load_trace_events(str(tmp_path / "t"))


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_top_ops_splits_device_and_host_and_measures_busy(tmp_path):
    """A hand-made trace in the profiler's format: two kernels on streams
    that overlap, a copy, host ops around them and a Python frame."""
    events = [
        _x("aten::add", "cpu_op", 0.0, 10.0),
        _x("aten::mul", "cpu_op", 90.0, 10.0),
        _x("bvh8_kernel(TravParams)", "kernel", 10.0, 20.0),
        _x("key_kernel<32>(KeyTable)", "kernel", 20.0, 20.0),  # overlaps the first by 10
        _x("bvh8_kernel(TravParams)", "kernel", 60.0, 5.0),
        _x("Memcpy DtoH", "gpu_memcpy", 70.0, 5.0),
        _x("cudaLaunchKernel", "cuda_runtime", 5.0, 2.0),
        _x("render.py(10): main", "python_function", 0.0, 100.0),
    ]
    trace = {"traceEvents": events + [{"ph": "M", "name": "process_name"}]}
    with gzip.open(tmp_path / "a.trace.json.gz", "wt") as fh:
        json.dump(trace, fh)
    with open(tmp_path / "b.trace.json", "w") as fh:
        json.dump({"traceEvents": [_x("aten::add", "cpu_op", 200.0, 1.0)]}, fh)
    loaded = top_ops.load_trace_events(str(tmp_path))
    assert len(loaded) == 9  # both files, complete slices only
    device = top_ops.by_category(events, top_ops.DEVICE_CATS)
    rows, total = top_ops.summarize(device)
    assert rows[0] == ("bvh8_kernel(TravParams)", 25.0, 2, 12.5) and total == 50.0
    assert [r[0] for r in top_ops.summarize(top_ops.by_category(events, top_ops.HOST_CATS))[0]] == [
        "aten::add", "aten::mul"]
    # Python frames nest and are left out unless asked for.
    assert "render.py(10): main" not in [r[0] for r in top_ops.summarize(events)[0]]
    assert "render.py(10): main" in [r[0] for r in top_ops.summarize(events, include_host_frames=True)[0]]
    busy, window = top_ops.device_busy(events)
    assert busy == 40.0  # [10, 40) + [60, 65) + [70, 75)
    assert window == 100.0  # from the first host op to the end of the last
    assert top_ops.device_busy([]) == (0.0, 0.0)
    assert top_ops.main([str(tmp_path)]) == 0


def test_render_stats_phases_and_rates():
    st = RenderStats(pixels=100, samples=4)
    with st.phase("load"):
        time.sleep(0.01)
    with st.phase("render"):
        time.sleep(0.01)
    with st.phase("render"):
        pass  # accumulates
    st.rays = 2_000_000
    s = st.summary()
    assert s["phases"]["load"] >= 0.01
    assert s["phases"]["render"] >= 0.01
    assert s["mrays_per_s"] > 0
    assert s["pixels"] == 100


@pytest.mark.parametrize("name", ["flying_unicorn", "crewmate_phong"])
def test_parity_tool_smoke(name, capsys):
    """The parity tool end to end on the CPU, where it holds the twins
    against each other; on a card the same entry holds the kernels."""
    from raytracer_tpu_torch.tools.parity import main, run

    path = os.path.join(SCENES, f"{name}.toml")
    assert run(path, n=1 << 11, device="cpu")
    assert "K4 twin vs K2 twin" in capsys.readouterr().out
    assert run(CORNELL, n=64, device="cpu")  # no mesh: nothing to compare
    assert main([path, "--n", "256", "--device", "cpu"]) == 0


def test_parity_tool_reports_a_mismatch(monkeypatch, capsys):
    from raytracer_tpu_torch.ops import bvh_binary as bb
    from raytracer_tpu_torch.tools import parity

    real = bb.bvh_binary_twin
    monkeypatch.setattr(bb, "bvh_binary_twin", lambda *a, **kw: tuple(x + 1 for x in real(*a, **kw)))
    path = os.path.join(SCENES, "crewmate_phong.toml")
    assert parity.main([path, "--n", "512", "--device", "cpu"]) == 1
    assert "MISMATCH" in capsys.readouterr().out


def test_kbench_exits_1_without_cuda(monkeypatch, capsys):
    from raytracer_tpu_torch.tools import kbench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kbench.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "cuda" in out.err.lower()
    with pytest.raises(SystemExit):
        kbench.main(["--variants", "widemxu"])


def test_leaf_and_cut_hooks(monkeypatch):
    """A non-default leaf size builds a tree that ``check_leaf_groups``
    accepts and on which K2's and K4's twins agree; RT_MAX_CUT sets the
    treetop cut; the defaults are the JAX package's."""
    from raytracer_tpu.ops import bvh as jax_bvh
    from raytracer_tpu_torch.ops import bvh, bvh_binary, bvh_traverse
    from raytracer_tpu_torch.tools.parity import parity_rays

    assert (bvh.MAX_LEAF, bvh.C_LEAF, bvh.MAX_CUT) == (jax_bvh.MAX_LEAF, jax_bvh.C_LEAF, 32) == (64, 3.0, 32)
    path = os.path.join(SCENES, "crewmate_phong.toml")
    default = load_scene(path, device="cpu")
    monkeypatch.setattr(bvh, "MAX_LEAF", 16)  # the traversals read it there
    monkeypatch.setattr(bvh, "C_LEAF", 2.0)
    monkeypatch.setenv("RT_MAX_CUT", "12")
    scene = load_scene(path, device="cpu")
    assert scene.bvh_cut_lo.shape[0] == 12 < default.bvh_cut_lo.shape[0] == 32
    assert scene.bvh_lo.shape[0] > default.bvh_lo.shape[0]  # smaller leaves, more nodes
    assert int(scene.bvh_count.max()) <= 16 and (scene.bvh_first[scene.bvh_count > 0] % 16 == 0).all()
    tree = tuple(getattr(scene, f).numpy() for f in ("bvh_lo", "bvh_hi", "bvh_skip", "bvh_first", "bvh_count"))
    _, _, w_child, w_count, _ = bvh.collapse_bvh8(tree)
    bvh.check_leaf_groups(w_child, w_count)  # at the patched leaf size
    with pytest.raises(ValueError, match="64-row group"):
        bvh.check_leaf_groups(w_child, w_count, max_leaf=64)
    cfg = RenderConfig()
    n = 2048
    ro, rd = parity_rays(scene, cfg, n, seed=5)
    inf = torch.full((n,), 3.0e38)
    none = torch.zeros(n, dtype=torch.bool)
    t2, i2 = bvh_traverse.bvh_traverse_twin(scene, ro, rd, inf, none, False, cfg.eps)
    t4, i4 = bvh_binary.bvh_binary_twin(scene, ro, rd, inf, none, False, cfg.eps)
    assert torch.equal(t2, t4) and (t2 < 1e30).sum() > n // 50
    # The same hits as the default tree's (the triangles are the same).
    monkeypatch.undo()
    t_def, _ = bvh_traverse.bvh_traverse_twin(default, ro, rd, inf, none, False, cfg.eps)
    assert ((t_def < 1e30) == (t2 < 1e30)).all()
    np.testing.assert_allclose(t2[t2 < 1e30].numpy(), t_def[t_def < 1e30].numpy(), rtol=1e-5)


def test_leaf_size_must_be_a_multiple_of_four():
    """RT_MAX_LEAF is checked when ``ops/bvh.py`` is imported: K4 loads leaf
    rows four at a time."""
    import subprocess
    import sys

    root = os.path.dirname(SCENES)
    for value, ok in (("16", True), ("6", False), ("0", False)):
        run = subprocess.run(
            [sys.executable, "-c", "from raytracer_tpu_torch.ops import bvh; print(bvh.MAX_LEAF)"],
            cwd=root, env={**os.environ, "RT_MAX_LEAF": value}, capture_output=True, text=True,
        )
        assert (run.returncode == 0) == ok, run.stderr
        if ok:
            assert run.stdout.strip() == value
        else:
            assert "multiple of 4" in run.stderr
