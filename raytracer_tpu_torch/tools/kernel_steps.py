"""Each design step of K1 (``ops/csrc/megakernel.cu``) and K2
(``ops/csrc/bvh8.cu``) against its alternative, on one CUDA card:
``python -m raytracer_tpu_torch.tools.kernel_steps [--out FILE]``.

An alternative is built from the shipped source by replacing named parts of
it (``EDITS``), so that everything else is the shipped code; each part must
occur exactly once, or the script stops. Every variant, the shipped source
included, is compiled with the port's nvcc flags into
``build/raytracer_tpu_torch/steps/`` (one nvcc each, all at once), and its
``-Xptxas -v`` line is printed. The port's own wrappers launch each variant
(their library is swapped for the variant's), so arguments and checks are
the shipped ones. A variant is held to the shipped kernel on every lane or
ray (K1: sums and ray counts equal; K2: t and index equal) before it is
timed by CUDA events, in turns with the shipped kernel (shipped, variant,
variant, shipped).

K1, on the cornell_box and cubes 600x450 256 spp frames (one launch of the
frame's bands, 64 samples a lane):

- ``launch_bounds_1``: ``__launch_bounds__(128, 1)``, registers left to the
  compiler, against the shipped minimum of 8 blocks an SM;
- ``const_materials``: the material rows read from the constant bank, as
  the first port read the whole table, against the shipped copy in shared
  memory;
- ``smem_table``: the whole scene table staged in shared memory;
- ``one_band_launches``: the shipped kernel launched once a band.

K2, on the frame's 1,080,000 coherence-sorted bounce rays of flying_unicorn
and of crewmate_phong:

- ``shared_stack``: the stack and the insertion keys in shared memory, one
  column per thread (no local memory), against per-thread arrays in local
  memory;
- ``sort_network``: the hit children ordered by a compare-exchange network
  in registers (``NET8``) instead of the insertion into shared memory;
- ``lazy_uv``: u and v computed only for a t that can still win;
- ``padded_rows``: every leaf tests all its max_leaf rows, padding included;
- ``smem_nodes``: the node table copied into each block's shared memory,
  with a persistent grid (as many blocks as are resident at once).

Output: one line per measurement, then ``{"steps": [...]}`` (also written to
``--out``) with each variant's ptxas line, times and ratio to the shipped
kernel, and the card's name and power limit. Several helpers here
(``card``, ``event_ms``, ``ptxas_lines``, ``scene_rays``) serve
``chip_smoke.py`` too.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from raytracer_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STEPS_DIR = os.path.join(_build.BUILD_DIR, "steps")

# An optimal sorting network for 8 inputs (19 compare-exchanges, depth 6).
NET8 = (
    (0, 2), (1, 3), (4, 6), (5, 7),
    (0, 4), (1, 5), (2, 6), (3, 7),
    (0, 1), (2, 3), (4, 5), (6, 7),
    (2, 4), (3, 5),
    (1, 4), (3, 6),
    (1, 2), (3, 4), (5, 6),
)

# --- the variants: (start, end, replacement) edits of a shipped source ------
# An edit replaces the text from ``start`` through ``end`` (``end`` None:
# ``start`` alone).

_K1_STAGE = (
    "  __shared__ float mats[MEGA_PF_MAX];\n"
    "  for (int k = threadIdx.x; k < 10 * p.no; k += MEGA_BLOCK) mats[k] = pf[lay.mat + k];\n"
    "  __syncthreads();\n"
)

_K2_SLAB = """        float t0 = (a.x - ox) * ix, t1 = (a.w - ox) * ix;
        float tnear = fminf(t0, t1), tfar = fmaxf(t0, t1);
        t0 = (a.y - oy) * iy;
        t1 = (b.x - oy) * iy;
        tnear = fmaxf(tnear, fminf(t0, t1));
        tfar = fminf(tfar, fmaxf(t0, t1));
        t0 = (a.z - oz) * iz;
        t1 = (b.y - oz) * iz;
        tnear = fmaxf(tnear, fminf(t0, t1));
        tfar = fminf(tfar, fmaxf(t0, t1));
"""


def _network_code() -> str:
    """CUDA statements that order kk/vv/sl by (key descending, slot
    ascending) with the compare-exchanges of ``NET8``."""
    out = []
    for i, j in NET8:
        out.append(
            f"      {{ const bool sw = kk[{j}] > kk[{i}] || (kk[{j}] == kk[{i}] && sl[{j}] < sl[{i}]);\n"
            f"        const float k0 = kk[{i}], k1 = kk[{j}];\n"
            f"        const int v0 = vv[{i}], v1 = vv[{j}], s0 = sl[{i}], s1 = sl[{j}];\n"
            f"        kk[{i}] = sw ? k1 : k0; kk[{j}] = sw ? k0 : k1;\n"
            f"        vv[{i}] = sw ? v1 : v0; vv[{j}] = sw ? v0 : v1;\n"
            f"        sl[{i}] = sw ? s1 : s0; sl[{j}] = sw ? s0 : s1; }}\n"
        )
    return "".join(out)


EDITS: dict[str, tuple[str, list[tuple[str, str | None, str]]]] = {
    "K1_shipped": ("megakernel", []),
    "K1_launch_bounds_1": ("megakernel", [
        ("__launch_bounds__(MEGA_BLOCK, 8)", None, "__launch_bounds__(MEGA_BLOCK, 1)"),
    ]),
    "K1_const_materials": ("megakernel", [
        (_K1_STAGE, None, "  const float* mats = pf + lay.mat;\n"),
    ]),
    "K1_smem_table": ("megakernel", [
        (_K1_STAGE, None,
         "  __shared__ float tab_s[MEGA_PF_MAX];\n"
         "  for (int k = threadIdx.x; k < lay.mat + 10 * p.no; k += MEGA_BLOCK) tab_s[k] = pf[k];\n"
         "  __syncthreads();\n"
         "  pf = tab_s;\n"
         "  const float* mats = tab_s + lay.mat;\n"),
    ]),
    "K2_shipped": ("bvh8", []),
    "K2_shared_stack": ("bvh8", [
        ("// Walk ray i.\n", None,
         "// Element d of a thread's column of a [d][BVH8_BLOCK] shared array.\n"
         "template <typename T>\n"
         "struct Column {\n"
         "  T* base;\n"
         "  __device__ __forceinline__ T& operator[](int d) const { return base[d * BVH8_BLOCK]; }\n"
         "};\n\n"
         "// Walk ray i.\n"),
        ("  int stk[BVH8_MAX_STACK];", "being pushed\n",
         "  extern __shared__ int smem[];\n"
         "  const Column<int> stk{smem + threadIdx.x};\n"
         "  const Column<float> keys{reinterpret_cast<float*>(smem + p.stack_depth * BVH8_BLOCK) + threadIdx.x};\n"),
        ("bvh8_kernel<<<blocks, BVH8_BLOCK, 0, (cudaStream_t)stream>>>(", None,
         "bvh8_kernel<<<blocks, BVH8_BLOCK, ((size_t)stack_depth + 8) * BVH8_BLOCK * 4,\n"
         "                (cudaStream_t)stream>>>("),
    ]),
    "K2_sort_network": ("bvh8", [
        ("      int h = 0;  // children pushed", "      sp += h;\n",
         "      float kk[8];\n"
         "      int vv[8], sl[8];\n"
         "      int h = 0;\n"
         "#pragma unroll\n"
         "      for (int s = 0; s < 8; ++s) {\n"
         "        const float4 a = __ldg(nd + 2 * s);\n"
         "        const float4 b = __ldg(nd + 2 * s + 1);\n"
         "        const int cnt = (int)b.w;\n"
         + _K2_SLAB +
         "        const bool hit = cnt != 0 && tnear <= tfar && tfar > p.tri_tmin && tnear < t_best;\n"
         "        const int child = (int)b.z;\n"
         "        kk[s] = hit ? tnear : __int_as_float(0xff800000);  // -inf\n"
         "        vv[s] = cnt > 0 ? -(child + cnt - 1) - 1 : child;\n"
         "        sl[s] = hit ? s : 8 + s;\n"
         "        h += hit ? 1 : 0;\n"
         "      }\n"
         "      if (sp + h > p.stack_depth) __trap();\n"
         + _network_code() +
         "#pragma unroll\n"
         "      for (int q = 0; q < 8; ++q)\n"
         "        if (q < h) stk[sp + q] = vv[q];\n"
         "      sp += h;\n"),
    ]),
    "K2_lazy_uv": ("bvh8", [
        ("        const float u =\n", "          i_best = p.base + first + j;\n        }\n",
         "        if (fabsf(denom) >= p.tri_parallel && t > p.tri_tmin && t < t_best) {\n"
         "          const float u =\n"
         "              (b.x * ox + b.y * oy + b.z * oz) + t * (b.x * dx + b.y * dy + b.z * dz) - b.w;\n"
         "          const float v =\n"
         "              (c.x * ox + c.y * oy + c.z * oz) + t * (c.x * dx + c.y * dy + c.z * dz) - c.w;\n"
         "          if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f) {\n"
         "            t_best = t;\n"
         "            i_best = p.base + first + j;\n"
         "          }\n"
         "        }\n"),
    ]),
    "K2_padded_rows": ("bvh8", [
        ("      for (int j = 0; j <= last - first; ++j) {\n", None,
         "      for (int j = 0; j < p.max_leaf; ++j) {\n"),
    ]),
    "K2_smem_nodes": ("bvh8", [
        ("        const float4 a = __ldg(nd + 2 * s);\n        const float4 b = __ldg(nd + 2 * s + 1);\n",
         None, "        const float4 a = nd[2 * s];\n        const float4 b = nd[2 * s + 1];\n"),
        ("  const int i = blockIdx.x * BVH8_BLOCK + threadIdx.x;\n", "t_out, idx_out);\n}\n",
         "  extern __shared__ float4 smem_nodes[];\n"
         "  for (int k = threadIdx.x; k < p.n_nodes * 16; k += BVH8_BLOCK) smem_nodes[k] = nodes[k];\n"
         "  __syncthreads();\n"
         "  for (int i = blockIdx.x * BVH8_BLOCK + threadIdx.x; i < p.n; i += gridDim.x * BVH8_BLOCK)\n"
         "    walk(p, i, rox, roy, roz, rdx, rdy, rdz, t_init, resolved0, smem_nodes, tris, t_out, idx_out);\n"
         "}\n"),
        ("  const int blocks = (n + BVH8_BLOCK - 1) / BVH8_BLOCK;\n",
         "      (const float4*)tris, t_out, idx_out);\n",
         "  const size_t smem = (size_t)n_nodes * 256;\n"
         "  cudaError_t e = cudaFuncSetAttribute(bvh8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
         "                                       (int)smem);\n"
         "  if (e != cudaSuccess) return (int)e;\n"
         "  int dev = 0, n_sm = 0, per_sm = 0;\n"
         "  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;\n"
         "  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)\n"
         "    return (int)e;\n"
         "  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bvh8_kernel, BVH8_BLOCK,\n"
         "                                                         smem)) != cudaSuccess)\n"
         "    return (int)e;\n"
         "  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;\n"
         "  int blocks = (n + BVH8_BLOCK - 1) / BVH8_BLOCK;\n"
         "  if (blocks > per_sm * n_sm) blocks = per_sm * n_sm;\n"
         "  bvh8_kernel<<<blocks, BVH8_BLOCK, smem, (cudaStream_t)stream>>>(\n"
         "      p, rox, roy, roz, rdx, rdy, rdz, t_init, resolved0, (const float4*)nodes,\n"
         "      (const float4*)tris, t_out, idx_out);\n"),
    ]),
}


def variant_source(name: str) -> str:
    """The CUDA source of variant ``name``: its shipped source with its
    edits applied. Raises ``ValueError`` when a part to replace does not
    occur exactly once."""
    base, edits = EDITS[name]
    with open(os.path.join(_build.CSRC, f"{base}.cu")) as fh:
        src = fh.read()
    for start, end, new in edits:
        if src.count(start) != 1:
            raise ValueError(f"{name}: {start[:50]!r} occurs {src.count(start)} times in {base}.cu, not once")
        i = src.index(start)
        j = i + len(start)
        if end is not None:
            if src.count(end, j) != 1:
                raise ValueError(f"{name}: {end[:50]!r} occurs {src.count(end, j)} times after the start")
            j = src.index(end, j) + len(end)
        src = src[:i] + new + src[j:]
    return src


def build_variant(name: str) -> tuple[ctypes.CDLL, str]:
    """Compile variant ``name`` with the port's flags -> (library, ptxas
    output). Raises ``RuntimeError`` with the compiler's output on failure."""
    os.makedirs(STEPS_DIR, exist_ok=True)
    cu = os.path.join(STEPS_DIR, f"{name}.cu")
    so = os.path.join(STEPS_DIR, f"lib{name}.so")
    with open(cu, "w") as fh:
        fh.write(variant_source(name))
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) building {name}:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(so), res.stdout + res.stderr


# --- helpers shared with chip_smoke.py ----------------------------------------


def card() -> str:
    """The current card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def event_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(reps):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps


def ptxas_lines(log: str) -> list[str]:
    """One line per kernel from nvcc's ``-Xptxas -v`` output: registers,
    stack frame (local memory), spills, shared memory."""
    out, name, frame = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = demangle(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            frame = f"stack frame {m.group(1)} B, spill stores {m.group(2)} B, spill loads {m.group(3)} B"
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            out.append(f"{name}: {m.group(1)} registers, {frame}, static smem {smem.group(1) if smem else 0} B")
            name, frame = None, ""
    return out


def demangle(sym: str) -> str:
    """``_Z11mega_kernelILi8EEv...`` -> ``mega_kernel<8>`` (enough for the
    kernels of this repo)."""
    m = re.match(r"_Z(\d+)", sym)
    if not m:
        return sym
    k = m.end()
    name = sym[k : k + int(m.group(1))]
    t = re.match(r"IL[ib](\w+?)EE", sym[k + int(m.group(1)) :])
    return f"{name}<{t.group(1)}>" if t else name


def scene_rays(scene, pre, cfg, n_each: int, seed: int = 20261016):
    """The ray classes of the regen engine on a BVH scene, on the scene's
    device: every camera ray of the frame (one per lane), and, from the
    first hits of ``n_each`` of them, BSDF-bounce rays and shadow rays to
    light samples bounded at ``dist - visibility_margin``. Returns
    (camera (ro, rd), {class: (ro, rd, t_init, resolved0, any_hit)})."""
    from raytracer_tpu_torch.models import vecmath as vm
    from raytracer_tpu_torch.models.camera import camera_rays3
    from raytracer_tpu_torch.ops import brdf
    from raytracer_tpu_torch.ops.intersect import trace_soa
    from raytracer_tpu_torch.ops.megakernel import uniform
    from raytracer_tpu_torch.render.integrator import sample_light3

    dev, eps = scene.device, cfg.eps
    n = cfg.width * cfg.height * 4
    slot = torch.arange(n, device=dev)
    pix, sub = slot // 4, slot % 4
    f32 = torch.float32
    cam = camera_rays3(
        scene, cfg.width, cfg.height, cfg.fov_scale,
        (pix % cfg.width).to(f32), (pix // cfg.width).to(f32), (sub % 2).to(f32), (sub // 2).to(f32),
        uniform(seed, slot, 0, 0), uniform(seed, slot, 0, 1),
    )
    g = torch.Generator(device=dev).manual_seed(seed)
    pick = torch.randperm(n, generator=g, device=dev)[:n_each]
    ro = tuple(c[pick].contiguous() for c in cam[0])
    rd = tuple(c[pick].contiguous() for c in cam[1])
    hit = trace_soa(scene, pre, ro, rd, eps)
    mat = brdf.gather_mat(scene, hit.obj)
    u = [torch.rand(n_each, generator=g, device=dev) for _ in range(4)]
    wi, _ = brdf.sample3(mat, hit.n, vm.neg3(rd), u[0], u[1], u[2], cfg.fix_phong_frame, scene.has_phong)
    y, _, _ = sample_light3(scene, u[2], u[3], u[1])
    to_y = vm.sub3(y, hit.pos)
    dist = torch.sqrt(vm.norm2_3(to_y))
    wi_d = vm.scale3(to_y, 1.0 / torch.clamp_min(dist, 1e-20))
    bound = torch.where(hit.valid, dist - eps.visibility_margin, 0.0)
    inf = torch.full((n_each,), 3.0e38, device=dev)
    none = torch.zeros(n_each, dtype=torch.bool, device=dev)
    res0 = torch.rand(n_each, generator=g, device=dev) < 0.1
    classes = {
        "camera": (ro, rd, inf, none, False),
        "bounce": (hit.pos, wi, inf, none, False),
        "shadow": (hit.pos, wi_d, bound, none, False),
        "shadow-any-hit": (hit.pos, wi_d, bound, res0 | (bound <= 0), True),
    }
    return cam, classes


# --- measurement ----------------------------------------------------------------


@contextlib.contextmanager
def _swapped(module, attr: str, value):
    """``module.attr`` replaced by ``value`` inside the block."""
    saved = getattr(module, attr)
    setattr(module, attr, value)
    try:
        yield
    finally:
        setattr(module, attr, saved)


def _k1_launcher(lib: ctypes.CDLL):
    """The ``_launch_fn`` replacement that hands ``mega_cuda_bands`` the
    variant's ``rt_mega_launch``, typed as the shipped one."""
    from raytracer_tpu_torch.ops import megakernel as mk

    fn = lib.rt_mega_launch
    fn.argtypes, fn.restype = mk._launch_fn().argtypes, ctypes.c_int
    return lambda: fn


def _k2_library(lib: ctypes.CDLL):
    """The ``_lib`` replacement that hands ``bvh_traverse_cuda`` the
    variant's library, typed as the shipped one."""
    from raytracer_tpu_torch.ops import bvh_traverse as bt

    fn = lib.rt_bvh8_launch
    fn.argtypes, fn.restype = bt._lib().rt_bvh8_launch.argtypes, ctypes.c_int
    return lambda: lib


def _turns(shipped, variant, reps: int) -> tuple[list[float], list[float]]:
    """Event times of shipped, variant, variant, shipped."""
    a, b = [event_ms(shipped, reps)], [event_ms(variant, reps)]
    b.append(event_ms(variant, reps))
    a.append(event_ms(shipped, reps))
    return a, b


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_steps: no CUDA card", file=sys.stderr)
        return 1
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.loader import load_scene
    from raytracer_tpu_torch.ops import bvh_traverse as bt
    from raytracer_tpu_torch.ops import keys
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops.intersect import scene_precompute
    from raytracer_tpu_torch.render.renderer import Renderer

    smi = card()
    print(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(EDITS)) as pool:
        built = dict(zip(EDITS, pool.map(build_variant, EDITS)))
    print(f"[build] {len(built)} variants in {time.perf_counter() - t0:.2f} s", flush=True)
    ptx = {}
    for name, (_, log) in built.items():
        ptx[name] = "; ".join(ptxas_lines(log))
        print(f"[ptxas] {name}: {ptx[name]}", flush=True)

    steps = []
    cfg = RenderConfig()
    scenes_dir = os.path.join(REPO, "scenes")

    # K1: the 256 spp frame (64 samples a lane, all bands in one launch).
    k1_ship = _k1_launcher(built["K1_shipped"][0])
    for sname in ("cornell_box", "cubes"):
        scene = load_scene(os.path.join(scenes_dir, f"{sname}.toml"), device="cuda")
        pf, static = mk.pack_params(scene, cfg)
        rows = Renderer(scene, cfg, device="cuda").plan(256)[0]
        n_band = rows * cfg.width * 4
        bands = [(y, mk.band_seed(cfg.seed, y, 0)) for y in range(0, cfg.height, rows)]

        def frame(samples, bands=bands, pf=pf, static=static, n_band=n_band):
            return mk.mega_cuda_bands(pf, static, bands, samples, n_band, "cuda")

        def per_band(samples, bands=bands, pf=pf, static=static, n_band=n_band):
            return [mk.mega_cuda(pf, static, y, samples, n_band, sd, "cuda") for y, sd in bands]

        with _swapped(mk, "_launch_fn", k1_ship):
            ref16 = frame(16)
            one16 = per_band(16)
            ship_ms, var_ms = _turns(lambda: frame(64), lambda: per_band(64), 3)
        same = torch.equal(ref16[0], torch.cat([o[0] for o in one16])) and torch.equal(
            ref16[1], torch.cat([o[1] for o in one16]))
        steps.append(_k1_step("K1_one_band_launches", sname, len(bands), same, ship_ms, var_ms,
                              ptx["K1_shipped"], smi))
        for name in ("K1_launch_bounds_1", "K1_const_materials", "K1_smem_table"):
            var = _k1_launcher(built[name][0])
            with _swapped(mk, "_launch_fn", var):
                acc, rays = frame(16)
            same = torch.equal(acc, ref16[0]) and torch.equal(rays, ref16[1])

            def run_var(var=var):
                with _swapped(mk, "_launch_fn", var):
                    frame(64)

            def run_ship():
                with _swapped(mk, "_launch_fn", k1_ship):
                    frame(64)

            ship_ms, var_ms = _turns(run_ship, run_var, 3)
            steps.append(_k1_step(name, sname, len(bands), same, ship_ms, var_ms, ptx[name], smi))

    # K2: the frame's coherence-sorted bounce rays.
    k2_ship = _k2_library(built["K2_shipped"][0])
    n_frame = cfg.width * cfg.height * 4
    for sname in ("flying_unicorn", "crewmate_phong"):
        scene = load_scene(os.path.join(scenes_dir, f"{sname}.toml"), device="cuda")
        _, classes = scene_rays(scene, scene_precompute(scene), cfg, n_frame)
        ro, rd, t_init, res0, _ = classes["bounce"]
        order = keys.coherence_order(scene, ro, rd, cfg.eps)
        bounce = (scene, tuple(c[order] for c in ro), tuple(c[order] for c in rd), t_init[order],
                  res0[order], False, cfg.eps)
        with _swapped(bt, "_lib", k2_ship):
            t_ref, i_ref = bt.bvh_traverse_cuda(*bounce)
        t_tw, _ = bt.bvh_traverse_twin(*bounce)
        check_twin = bool(torch.equal(t_ref, t_tw))
        print(f"[twin] K2 shipped {sname}: t equal to the twin on every ray: {check_twin}", flush=True)
        if not check_twin:
            raise RuntimeError(f"the shipped K2 differs from its twin on {sname}")
        for name in ("K2_shared_stack", "K2_sort_network", "K2_lazy_uv", "K2_padded_rows", "K2_smem_nodes"):
            var = _k2_library(built[name][0])
            with _swapped(bt, "_lib", var):
                t_v, i_v = bt.bvh_traverse_cuda(*bounce)
            same = bool(torch.equal(t_v, t_ref) and torch.equal(i_v, i_ref))

            def run_var(var=var):
                with _swapped(bt, "_lib", var):
                    bt.bvh_traverse_cuda(*bounce)

            def run_ship():
                with _swapped(bt, "_lib", k2_ship):
                    bt.bvh_traverse_cuda(*bounce)

            ship_ms, var_ms = _turns(run_ship, run_var, 10)
            step = dict(kernel="K2", variant=name, scene=sname, rays=n_frame, equal=same,
                        shipped_ms=ship_ms, variant_ms=var_ms,
                        ratio=sum(var_ms) / sum(ship_ms), ptxas=ptx[name], card=smi)
            print(f"[step] {name} {sname} {n_frame} sorted bounce rays: t and index equal to the shipped "
                  f"kernel on every ray: {same}; shipped {ship_ms} ms, variant {var_ms} ms, ratio "
                  f"{step['ratio']:.4f} | {smi}", flush=True)
            steps.append(step)
    print(f"[ptxas] shipped: K1 {ptx['K1_shipped']}; K2 {ptx['K2_shipped']}", flush=True)
    result = {"steps": steps, "card": smi}
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    bad = [f"{s['variant']} {s['scene']}" for s in steps if not s["equal"]]
    if bad:
        print(f"kernel_steps: variants that differ from the shipped kernel: {bad}", file=sys.stderr)
        return 1
    return 0


def _k1_step(name, sname, n_bands, same, ship_ms, var_ms, ptx, smi) -> dict:
    step = dict(kernel="K1", variant=name, scene=sname, bands=n_bands, equal=bool(same),
                shipped_ms=ship_ms, variant_ms=var_ms, ratio=sum(var_ms) / sum(ship_ms), ptxas=ptx, card=smi)
    print(f"[step] {name} {sname} 600x450 256spp frame ({n_bands} bands): every lane equal to the shipped "
          f"kernel's: {step['equal']}; shipped {ship_ms} ms, variant {var_ms} ms, ratio {step['ratio']:.4f} "
          f"| {smi}", flush=True)
    return step


if __name__ == "__main__":
    sys.exit(main())
