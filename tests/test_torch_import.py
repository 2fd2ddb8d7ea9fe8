"""The port is self-contained: it imports torch, and nothing of the JAX
package ``raytracer_tpu``, nor jax, flax or triton.

Two checks: importing every module of ``raytracer_tpu_torch`` in a fresh
interpreter leaves no ``raytracer_tpu``/``raytracer_tpu.*`` module, and no
jax, flax or triton, in ``sys.modules``; and no source file of the port,
nor any of its root scripts (``chip_smoke.py``, ``bench_torch.py``,
``__graft_entry_torch__.py``), has an import statement of those packages
anywhere (a lazy import inside a function included).
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "raytracer_tpu_torch"
FORBIDDEN = ("raytracer_tpu", "jax", "flax", "triton")


def _port_files() -> list[str]:
    out = []
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT, PKG)):
        out += [os.path.relpath(os.path.join(dirpath, f), ROOT) for f in files if f.endswith(".py")]
    return sorted(out)


def _module_name(relpath: str) -> str:
    mod = relpath[: -len(".py")].replace(os.sep, ".")
    return mod[: -len(".__init__")] if mod.endswith(".__init__") else mod


PORT_FILES = _port_files()
ROOT_SCRIPTS = ["chip_smoke.py", "bench_torch.py", "__graft_entry_torch__.py"]
MODULES = tuple(_module_name(f) for f in PORT_FILES)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_the_new_copies_are_port_modules():
    for mod in ("config", "models.obj", "server.wire", "utils.timing", "render.checkpoint",
                "parallel.mesh", "tools.top_ops", "tools.parity", "tools.kbench",
                "render.wavefront_fused", "utils.native"):
        assert f"{PKG}.{mod}" in MODULES


def test_port_imports_no_jax_flax_or_triton():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("relpath", PORT_FILES + ROOT_SCRIPTS)
def test_no_import_statement_of_the_jax_package(relpath):
    with open(os.path.join(ROOT, relpath)) as fh:
        tree = ast.parse(fh.read(), filename=relpath)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and _forbidden(node.module or ""):
            bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__",
        ):
            bad += [a.value for a in node.args if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f"{relpath} imports {bad}"


@pytest.mark.parametrize("relpath", PORT_FILES + ROOT_SCRIPTS)
def test_reads_no_document(relpath):
    """The program runs from a checkout of the program alone: no file of it
    names a ``.md`` document as a path to open."""
    with open(os.path.join(ROOT, relpath)) as fh:
        tree = ast.parse(fh.read(), filename=relpath)
    docs = [node.value for node in ast.walk(tree) if isinstance(node, ast.Constant)
            and isinstance(node.value, str) and node.value.strip().lower().endswith(".md")]
    assert not docs, f"{relpath} names {docs}"
