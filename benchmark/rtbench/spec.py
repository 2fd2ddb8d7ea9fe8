"""The benchmark's description, and the files it names, found by name.

``BENCHMARK.json`` (at the checkout's root) lists the configurations, the
cells and the metrics. Everything that belongs to one of them lives in a
file of its own under ``benchmark/``, which the harness finds by the name
that ``BENCHMARK.json`` gives:

- a configuration: the file its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<traffic>.json``;
- a per-layer metric: ``metrics/<metric>.py``, a module with ``read(ctx)``;
  where there is none, ``metrics/<stem>.py``, the stem being the name up to
  its first dot, so that one reader serves the metric's split per cell
  (``device_idle_pct.offline``, ``device_idle_pct.mesh``, ...).

An end-to-end metric split per cell the same way (``frame_s.mesh``) takes
the value that the cell's driver reports under its stem (``frame_s``).

A later change adds a cell, a mix or a metric by adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class SpecError(ValueError):
    pass


def load(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.isfile(path):
        raise SpecError(f"no BENCHMARK.json at {root}")
    with open(path) as fh:
        return json.load(fh)


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError(f"no workload {name!r} in BENCHMARK.json")


def config(spec: dict, name: str, root: str = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as fh:
                return json.load(fh)
    raise SpecError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    path = os.path.join(bench_dir, "traffic", f"{name}.json")
    if not os.path.isfile(path):
        raise SpecError(f"no traffic file {path}")
    with open(path) as fh:
        return json.load(fh)


def end_to_end(spec: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in spec["end_to_end"] if cell_name in m.get("workloads", [cell_name])]


def per_layer(spec: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics read in the cell's traced runs: those that
    list it, and those that list no cell and move one of its end-to-end
    metrics."""
    moved = {m["name"] for m in end_to_end(spec, cell_name)}
    return [m for m in spec["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def stem(name: str) -> str:
    """A metric's name up to its first dot."""
    return name.split(".")[0]


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The ``read(ctx)`` function of ``metrics/<name>.py``, or else of
    ``metrics/<stem>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        path = os.path.join(bench_dir, "metrics", f"{stem(name)}.py")
    if not os.path.isfile(path):
        raise SpecError(f"no metric reader for {name!r} in {os.path.dirname(path)}")
    mod_name = "rtbench_metric_" + re.sub(r"\W", "_", name)
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def check_names(spec: dict) -> list[str]:
    """Names and units outside the allowed characters (empty when sound)."""
    bad = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[group]:
            if not NAME.match(e["name"]):
                bad.append(e["name"])
            if "unit" in e and not UNIT.match(e["unit"]):
                bad.append(e["unit"])
    for w in spec["workloads"]:
        for k in ("config", "traffic"):
            if not NAME.match(w[k]):
                bad.append(w[k])
    for c in spec["configs"]:
        bad += [k for k in c["reduced"] if not NAME.match(k)]
    return bad
