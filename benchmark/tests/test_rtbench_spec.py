"""BENCHMARK.json and the files it names: found by name, names and units
within the allowed characters, and a cell or a metric added by files alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from rtbench import spec

ROOT = spec.ROOT


def test_every_named_file_is_found():
    sp = spec.load()
    for w in sp["workloads"]:
        cfg = spec.config(sp, w["config"])
        assert os.path.isfile(os.path.join(ROOT, cfg["scene"]))
        tf = spec.traffic(w["traffic"])
        assert tf["kind"] in ("offline", "served")
    for m in sp["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    for c in sp["configs"]:
        assert c["file"].startswith("benchmark/configs/")


def test_names_and_units_use_the_allowed_characters():
    sp = spec.load()
    assert spec.check_names(sp) == []
    for group in ("end_to_end", "per_layer"):
        for m in sp[group]:
            assert m["better"] in ("lower", "higher")
            assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves", "workloads"}
    assert len({w["name"] for w in sp["workloads"]}) == len(sp["workloads"])


def test_contract_shape():
    sp = spec.load()
    assert set(sp) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert sp["paths"] == ["benchmark"]
    assert "setup_s" in {m["name"] for m in sp["end_to_end"]}
    assert sum(w["chips"] == 4 for w in sp["workloads"]) <= 1
    for w in sp["workloads"]:
        names = {m["name"] for m in spec.end_to_end(sp, w["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert spec.per_layer(sp, w["name"])
    for m in sp["per_layer"]:
        assert m["moves"] in {e["name"] for e in sp["end_to_end"]}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_a_cell_and_a_metric_are_added_by_files_alone(tmp_path):
    """In a copy: a new traffic file, a new metric reader and their entries
    are found with no edit to any file that was there."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "scenes"))
    sp = spec.load()
    sp["workloads"].append({"name": "cornell64.offline", "config": "cornell_600x450", "traffic": "offline64",
                            "chips": 1, "why": "a new cell"})
    sp["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                            "source": "program_span", "layer": "device", "moves": "frame_s",
                            "workloads": ["cornell64.offline"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(sp))
    (tmp_path / "benchmark" / "traffic" / "offline64.json").write_text(
        json.dumps({"kind": "offline", "spp": 64, "trace_frames": 1, "keep_every": 4}))
    (tmp_path / "benchmark" / "metrics" / "frames_traced.py").write_text(
        "def read(ctx):\n    return len(ctx.out['traced_frames'])\n")
    loaded = spec.load(str(tmp_path))
    assert spec.cell(loaded, "cornell64.offline")["traffic"] == "offline64"
    assert spec.traffic("offline64", str(tmp_path / "benchmark"))["spp"] == 64
    names = [m["name"] for m in spec.per_layer(loaded, "cornell64.offline")]
    assert "frames_traced" in names
    read = spec.metric_reader("frames_traced", str(tmp_path / "benchmark"))

    class C:
        out = {"traced_frames": [0.1, 0.2]}

    assert read(C) == 2


def test_refuses_without_a_card():
    """Without CUDA the run exits non-zero and prints no result."""
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"), "--workload",
                        "cornell256.offline", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_refuses_in_a_directory_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files
    makes the run exit non-zero with no result."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cornell256.offline", "--seed", "1",
                        "--seconds", "1", "--trace", "0", "--device", "cpu", "--width", "8", "--height", "6"],
                       capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
