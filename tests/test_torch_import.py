"""The port imports torch and never jax, flax or triton."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = (
    "raytracer_tpu_torch",
    "raytracer_tpu_torch.ops.megakernel",
    "raytracer_tpu_torch.ops.bvh",
    "raytracer_tpu_torch.ops.keys",
    "raytracer_tpu_torch.ops.bvh_traverse",
    "raytracer_tpu_torch.ops.bvh_binary",
    "raytracer_tpu_torch.ops.intersect",
    "raytracer_tpu_torch.ops.brdf",
    "raytracer_tpu_torch.render.integrator",
    "raytracer_tpu_torch.render.wavefront",
    "raytracer_tpu_torch.render.renderer",
    "raytracer_tpu_torch.server.app",
    "raytracer_tpu_torch.server.main",
    "raytracer_tpu_torch.tools.render",
)


def test_port_imports_no_jax_flax_or_triton():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "print(sorted(m for m in ('jax', 'flax', 'triton') if m in sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
