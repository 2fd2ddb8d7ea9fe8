"""What the benchmark's files import and open: top-level module names are
compared whole, so that ``raytracer_tpu_torch`` is not taken for
``raytracer_tpu``."""

import ast
import os

from rtbench import spec

BENCH = spec.BENCH_DIR
JAX = {"jax", "jaxlib", "flax", "raytracer_tpu"}


def py_files(sub=""):
    for d, _dirs, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_names(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    for f in py_files():
        assert not top_names(f) & JAX, f


def test_the_names_are_compared_whole():
    assert "raytracer_tpu_torch".split(".")[0] not in JAX
    assert "raytracer_tpu.models".split(".")[0] in JAX


def test_the_reference_imports_nothing_of_the_program():
    for f in py_files(os.path.join("rtbench", "reference")):
        names = top_names(f)
        assert "raytracer_tpu_torch" not in names and not names & JAX, f
        assert names <= {"__future__", "dataclasses", "math", "os", "tomllib", "numpy", "torch", "rtbench"}, (f, names)


def test_no_file_opens_a_document():
    """No string the runs' files hold names a ``.md`` file (the tests, this
    one among them, are not run by a run)."""
    for f in py_files():
        if os.sep + "tests" + os.sep in f:
            continue
        tree = ast.parse(open(f).read(), f)
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert not node.value.strip().endswith(".md"), (f, node.value)
