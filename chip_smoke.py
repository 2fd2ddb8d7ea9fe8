"""Smoke test of the PyTorch + CUDA port on one GPU: ``python3 chip_smoke.py``.

Builds the port's four kernels from ``raytracer_tpu_torch/ops/csrc`` (one
nvcc each) and the native host library from ``native/*.cpp`` (g++), all at
once, and prints what ``-Xptxas -v`` says of each kernel (registers, stack
frame, spills). ``[native]`` holds the C++ OBJ parser against the numpy one
on every asset, times the unicorn's load with each, and measures the
native CPU baselines of ``bench_torch.py`` on this host. Holds each kernel
against its plain PyTorch twin on the card: K1 on a cornell_box and a cubes
band, and its all-bands frame launch against the bands launched one by one;
K2 and K4 at every ray class and width of the main path; K3 on every class
(and, with a shorter cut, through its run-time cut count; with 256 boxes,
through its device table). Counts, with the twins, the visits of the BVH
walks and the rays of K1 that the bounds below rest on.
Then drives the port's three main paths the way a user would:

- the megakernel path (K1): offline ``Renderer.render_image`` of
  cornell_box and cubes at the reference's 600x450 against the repo's own
  64 spp renders in ``examples/``, and the WebSocket server's ``RenderJob``
  (batch and progressive) with every wire message parsed;
- the BVH path (K2, K3, the regen engine): flying_unicorn at 600x450 16 spp
  against ``examples/flying_unicorn.png``, and served through ``RenderJob``
  with the batched transport, equal to ``render_image(16)``;
- the Phong/MIS path (K2 or K4, K3, the regen engine with Phong and MIS):
  crewmate_phong at 64 spp against ``examples/crewmate_phong.png``, at
  16 spp under the default traversal (K2) and under
  ``RT_BVH_KERNEL=binary`` (the skip-link walk K4), each also served, and
  cornell_box with MIS at 64 spp against ``examples/cornell_box_mis.png``.

Then the rest of what the port does, each at the reference's 600x450:

- ``[fused]`` the fused-trace engine (``engine="fused"``): K3, K2 and K4
  against their twins on its double-width batch (1.08M sorted bounce rays
  and 1.08M bounded shadow rays, a third parked with cap 0); flying_unicorn
  16 spp equal to the regen frame (rays, a dispatch's sums, every pixel)
  with one K3 and one K2 launch per trace, its wall beside regen's (medians
  of 3 alternated runs), and served equal to ``render_image(16)``;
  crewmate_phong under ``RT_BVH_KERNEL=binary`` (K4, no K2) equal to the
  regen K4 frame; cornell_box equal to regen (no kernel);
- ``[simple]`` the lockstep engine (``engine="simple"``) on cornell_box at
  64 spp against ``examples/cornell_box.png``, its wall beside K1's frame;
- ``[checkpoint]`` cornell_box to 256 spp with a cancel after two of the
  four chunks, a save, a load and a resume: the sums of the uninterrupted
  render on every element;
- ``[sharded]`` row bands over ``[cuda:0, cuda:0]`` (the one card twice:
  the whole multi-device path): each device band of a cornell_box band
  equal to the plain band function, and the flying_unicorn frame (and the
  crewmate_phong frame under K4) equal to the plain renderer's on every
  pixel;
- ``[trace]`` a flying_unicorn frame under ``device_trace`` into
  ``chiprun_out/trace``: ``tools.top_ops`` finds the K2 and K3 kernels by
  name as often as the wrappers counted, and prints the top device kernels,
  the top host ops and the device's busy share;
- ``[parity]`` ``tools.parity`` on flying_unicorn and crewmate_phong;
- ``[bench]`` ``bench_torch.py``'s run functions (three timed renders a
  config; cornell MIS is read once, at 64 spp, by the ``[time]`` lines), each with
  its own launch counts: a megakernel config and the progressive run must
  launch K1, a mesh config and the served run K2 and K3;
- ``[entry]`` the band step of ``__graft_entry_torch__.entry()``;
- ``[mesh-light]`` the chair room of ``tests/test_server_mesh.py:28`` lit
  by an octahedron mesh light (written to a temporary directory) instead
  of its sphere: a mesh light behind the BVH, 16 spp, seeds 0 and 1, on the
  regen and fused engines: K2 and K3 launch on both, the fused frame equals
  the regen frame on every pixel, the NEE and MIS means agree within
  ``MESH_LIGHT_MIS_BOUND``, and ``tools.parity`` holds every kernel against
  its twin on the scene's rays;
- ``[variants]`` the measurement hooks of the regen engine and of the
  traversal wrapper on flying_unicorn 16 spp, each frame's wall beside the
  default's (medians of 3 runs, every variant and the default in turn, each
  the second frame of its renderer, whose first captured its CUDA graphs),
  its K2/K3/K4 launches and its traversal and K3 kernel time: the frames of
  ``RT_PERMUTE_STATE=1`` (the lane permutation, off by default), of
  ``RT_SORT_GROUP=8`` with it and of ``RT_SHADOW_COMPACT=1`` equal to the
  default on every pixel (and on crewmate_phong under K4),
  ``RT_STATE_BF16=1`` and ``RT_SHADOW_REVERSE=1`` statistically equal,
  ``RT_DEFER_SHADOW=1`` equal on >= 99% of pixels; the glue's split by the
  probes ``RT_ABLATE=shadow`` and ``RT_ABLATE=rng``; ``RT_SHADOW_COMPACT``
  on the frame's any-hit shadow class; and K2 against its twin at
  ``RT_LEAF_TRIS`` 0 and 8, its time at 0, 8 and 64 beside the bound of
  the rows each tests.

Each path runs with every launch count set to 0 just before it and read
just after, and fails if one of its kernels was not launched. Every phase
raises on failure, so the exit code is non-zero. Without CUDA it exits
non-zero at once. ``[seconds]`` lines give each phase's time. A regen
renderer captures its loop steps as CUDA graphs in its first frame
(``render.wavefront.StepGraphs``), so a wall taken on a fresh renderer's
first frame includes those captures; the ``[variants]`` walls do not.

Last come the times: each kernel per launch at the main path's shapes and
per frame, beside its plain twin and its bound (the larger of its
operations over the card's f32 peak and its bytes over the memory rate,
from this run's inputs and counts); K2, K4 and K3 on the fused engine's
2.16M-ray batch, and the fused frames' breakdowns beside regen's.

Output: progress lines, then a ``{"kernels": [...]}`` JSON line, the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENES = ("cornell_box", "cubes")
# Bounds on the 600x450 64 spp images against the repo's 64 spp renders
# (examples/cornell_box.png mean 112.16, examples/cubes.png mean 113.79).
IMAGE_MEAN = {"cornell_box": (110.7, 113.7), "cubes": (112.3, 115.3)}
IMAGE_MAD_MAX = 16.0
# cornell_box 256 spp against the 64 spp bound: the per-subpixel clamp lets
# the mean rise with the sample count (+1.24 from 64 to 256 spp at 120x90 on
# the CPU twin).
CHECKPOINT_MEAN_RISE = 1.5
# flying_unicorn 600x450 16 spp against examples/flying_unicorn.png (a 16 spp
# render, mean 108.99): the mean within these bounds, and the MAD at most the
# MAD between two port renders at seeds 0 and 1 plus this margin.
UNICORN_MEAN = (107.5, 110.5)
UNICORN_MAD_MARGIN = 1.0
# crewmate_phong 600x450 64 spp against examples/crewmate_phong.png (a 64 spp
# render, mean 106.79): the mean within these bounds, the MAD as the
# unicorn's.
CREWMATE_MEAN = (105.29, 108.29)
# crewmate_phong 16 spp under K4 against K2, same seed: equal on this share
# of pixels (a tie or a slab rounding can send one path elsewhere; the
# draws keyed on slot and iteration keep that to the pixel).
VARIANT_PIXEL_SHARE = 0.999
# The fused batch: a third of its shadow half parked with cap 0, as lanes
# without a shadow ray are.
FUSED_PARKED_EVERY = 3
# cornell_box with MIS, 600x450 64 spp, against examples/cornell_box_mis.png
# (a 64 spp render, mean 112.50): the mean within these bounds and the MAD
# below IMAGE_MAD_MAX.
MIS_MEAN = (111.0, 114.0)
# The mesh-light scene, 600x450 16 spp: the NEE and MIS image means within
# this many u8: the 3.5 of tests/test_torch_phong_mis.py::
# test_mis_agrees_with_nee at 48x36 64 spp, scaled by the square root of
# the samples' ratio, as the mean's noise falls (3.5 / sqrt(39.06) = 0.56).
# (On the CPU at 200x150 16 spp, same seed, the two means differ by 0.03.)
MESH_LIGHT_MIS_BOUND = 3.5 * (48 * 36 * 64 / (600 * 450 * 16)) ** 0.5
# [variants] on flying_unicorn 16 spp against the default frame: a frame of
# other roundings (RT_STATE_BF16, RT_SHADOW_REVERSE) within this mean and
# at most MAD(seed 0, seed 1) + UNICORN_MAD_MARGIN from it; the deferred
# shadow frame (the same terms, resolved an iteration later) equal on this
# share of pixels and within this mean.
VARIANT_MEAN = 0.5
DEFER_PIXEL_SHARE, DEFER_MEAN = 0.99, 0.05

# Peak rates of one H100 SXM (NVIDIA's data sheet): f32 outside the tensor
# cores, counting a fused multiply-add as two operations, and HBM3. The
# kernels are built with FMA contraction off, so every add and multiply is
# an instruction of its own; PEAK_F32_INSTR is the rate at which the card
# issues them, which bounds FMA-free code instead.
PEAK_F32_FLOPS = 67e12
PEAK_F32_INSTR = 33.5e12
PEAK_BYTES = 3.35e12

# Operations per unit of work, counted from the CUDA sources (an add, sub,
# mul, division, square root, sine, cosine, min, max or float compare is
# one; the counter hash's integer work and the loads are not counted).
# K1 (megakernel.cu): one sphere/plane/triangle test in trace or occluded;
# a camera ray's regeneration; a bounce besides its trace (hit point and
# normal, emission, Russian roulette, BSDF sample, throughput); a shadow
# ray besides its trace (the light sample, the geometry terms).
K1_OPS = dict(sphere=25, plane=21, tri=47, camera=46, bounce=130, shadow=60)
# K2 (bvh8.cu) and K4 (bvh_binary.cu): per ray (the inverse direction), per
# node visited (K2: 8 slab tests of 26; K4: one of 27), per real leaf
# triangle (K2: denom, t and the tests on t; K4: all of the test) and, for
# K2, per candidate triangle (u, v and their tests, which the search needs
# only for a t that can still win: the least work, not what the kernel,
# which computes them for every real triangle, does).
K2_OPS = dict(ray=9, node=208, tri=16, cand=30)
# K4 per ray: 3 guards and 3 divisions of the inverse direction, 3 compares
# of the octant. Per node whose box is tested: 6 subtractions, 6 products, 12
# minima and maxima, 3 compares. Per real triangle of an entered leaf (the up to three padded
# rows of its last group of four are no work): denom 5, its guard 1, n.ro 5,
# t 2, u 13, v 13, the tests 8.
K4_OPS = dict(ray=9, node=27, tri=47, cand=0)
# K3 (coherence_key.cu): per ray (inverse direction 6, miss 1, octant 3,
# Morton code 3 x 7) and per treetop-cut box (a slab test of 22 and 3
# compares).
K3_OPS = dict(ray=31, cut=25)
# The breakdown's spacer: device cycles (about 0.2 ms) queued in front of a
# timed launch, so that the launch and both its events are queued before
# the device reaches them and the device never waits for the host between
# the two events.
SPACER_CYCLES = 400_000


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def bound_ms(ops: float, nbytes: float) -> tuple[float, str, float]:
    """(least time in ms, "operations" or "bytes", the operations' time at
    the FMA-free instruction rate)."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), ops / PEAK_F32_INSTR * 1e3


def k1_work(static, lanes: int, num_samples: int, rays: int, shadow_share: float):
    """(operations, bytes) of one K1 launch: ``rays`` traced in all, a
    ``shadow_share`` of them shadow rays (counted by the twin on a band of
    the same scene), ``num_samples`` camera rays a lane."""
    ns, npl, nt = static.n_spheres, static.n_planes, static.n_tris
    trace = K1_OPS["sphere"] * ns + K1_OPS["plane"] * npl + K1_OPS["tri"] * nt
    shadow = rays * shadow_share
    bounces = rays - shadow
    ops = (lanes * num_samples * K1_OPS["camera"] + bounces * (trace + K1_OPS["bounce"])
           + shadow * (trace + K1_OPS["shadow"]))
    return ops, lanes * 16 + (20 + 5 * ns + 7 * npl + 13 * nt + 10 * static.n_objects) * 4


def walk_work(table: dict, visits: dict, n: int, table_bytes: int):
    """(operations, bytes) of one K2 or K4 launch over ``n`` rays with the
    twin's counted visits: 37 bytes a ray (origin, direction, t_init,
    resolved0 in; t, index out) and the scene's tables once."""
    ops = (n * table["ray"] + visits["nodes"] * table["node"] + visits["tris"] * table["tri"]
           + visits["cand"] * table["cand"])
    return ops, n * 37 + table_bytes


def lane_diff(kernel: torch.Tensor, twin: torch.Tensor, rtol: float):
    """(max |kernel - twin|, share of lanes beyond rtol*max(1,|twin|))."""
    d = (kernel.double() - twin.double()).abs().reshape(kernel.shape[0], -1)
    tol = rtol * twin.double().abs().clamp_min(1.0).reshape(kernel.shape[0], -1)
    return d.max().item(), (d > tol).any(dim=1).double().mean().item()


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def sorted_runs(scene, classes, widths, eps):
    """Traversal arguments of each class sorted by the coherence key, as the
    wrapper sorts them, then of the sorted bounce rays cut to each width of
    the main path. Returns ([(name, args)], the full bounce args)."""
    from raytracer_tpu_torch.ops import keys

    runs = []
    for cname, (ro, rd, t_init, res0, any_hit) in classes.items():
        order = keys.coherence_order(scene, ro, rd, eps)
        args = (scene, tuple(c[order] for c in ro), tuple(c[order] for c in rd), t_init[order],
                res0[order], any_hit, eps)
        runs.append((cname, args))
        if cname == "bounce":
            bounce = args
    runs += [(f"bounce[:{m}]", (scene, tuple(c[:m] for c in bounce[1]), tuple(c[:m] for c in bounce[2]),
                                bounce[3][:m], bounce[4][:m], False, eps)) for m in widths]
    return runs, bounce


def hold_traversal(label, kernels, twin, runs):
    """Each run through its twin once and through each kernel of
    ``kernels`` ({arm name: function}): t bit-equal on at least
    ``T_EXACT_SHARE`` of all rays, indices that differ only on ties.
    Returns the max |dt| where both hit."""
    from raytracer_tpu_torch.ops import bvh_traverse as bt

    worst, total, equal = 0.0, 0, {arm: 0 for arm in kernels}
    for cname, args in runs:
        scene, ro_s, rd_s, t_init_s, _, any_hit, _ = args
        t_t, i_t = twin(*args)
        for arm, kernel in kernels.items():
            name = f"{label}[{arm}]" if arm else label
            t_k, i_k = kernel(*args)
            torch.cuda.synchronize()
            same = t_k == t_t
            idx_diff = i_k != i_t
            ties_ok = torch.equal(bt.leaf_t(scene, ro_s, rd_s, i_k)[idx_diff],
                                  bt.leaf_t(scene, ro_s, rd_s, i_t)[idx_diff])
            both = (t_k < 1e30) & (t_t < 1e30)
            err = (t_k[both] - t_t[both]).abs().max().item() if both.any() else 0.0
            hits = int((t_k < t_init_s).sum())
            print(f"[kernel-vs-twin] {name} {scene.name} {cname} rays={t_k.numel()} any_hit={any_hit}: t bit-equal "
                  f"on {same.double().mean().item():.6%}, idx differs on {int(idx_diff.sum())} (ties: {ties_ok}), "
                  f"hits below t_init {hits}, max|dt| {err:.3g}", flush=True)
            check(ties_ok, f"{name} {scene.name} {cname}: differing indices are not ties")
            check(hits > t_k.numel() // 50, f"{name} {scene.name} {cname}: only {hits} hits")
            worst = max(worst, err)
            equal[arm] += int(same.sum())
        total += t_t.numel()
    for arm, eq in equal.items():
        check(eq >= bt.T_EXACT_SHARE * total,
              f"{label}[{arm}] t bit-equal on {eq}/{total} rays, below {bt.T_EXACT_SHARE}")
    return worst


# What the redesigned kernels keep of their design steps (the kernels line's
# "redesigned"; each step and its alternatives are timed by
# ``raytracer_tpu_torch/tools/kernel_steps.py``). Stated here, not read from
# a document, so the script needs nothing of the checkout but the program.
REDESIGNED = {
    "K1": "all bands of a frame in one launch; material rows in shared memory; __launch_bounds__(128, 8)",
    "K2": "real leaf triangles only; a triangle's rows loaded together; nodes through the read-only cache",
    "K3": "cut count at compile time for the loader's 32 boxes, eight cuts a loop turn (run-time count "
          "otherwise); one ray a thread",
    "K4": "per-octant node layouts, near child first; a lane walks on to a leaf before it tests rows; 32-byte "
          "nodes; leaf rows four at a time",
}


def with_env(env: dict, fn):
    """``fn()`` with the variables ``env`` set, restored after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def with_variant(variant: str, fn):
    """``fn()`` with ``RT_BVH_KERNEL`` set to ``variant``, restored after."""
    return with_env({"RT_BVH_KERNEL": variant}, fn)


def octahedron_obj(center, radius) -> str:
    """OBJ text of a closed octahedron wound so that the reference's normal
    normalize((c-a) x (b-a)) points outward on every face: a mesh light
    without a back face (as tests/test_torch_phong_mis.py builds it)."""
    c = np.asarray(center, np.float64)
    verts = [c + s * np.eye(3)[k] * radius for k in range(3) for s in (1, -1)]  # +x -x +y -y +z -z
    faces = []
    for sx in (0, 1):
        for sy in (2, 3):
            for sz in (4, 5):
                a, b, cc = verts[sx], verts[sy], verts[sz]
                outward = np.dot(np.cross(cc - a, b - a), (a + b + cc) / 3 - c) > 0
                faces.append((sx, sy, sz) if outward else (sx, sz, sy))
    return "".join(f"v {x} {y} {z}\n" for x, y, z in verts) + "".join(
        f"f {i + 1} {j + 1} {k + 1}\n" for i, j, k in faces)


def mesh_light_toml(tmp: str) -> str:
    """The chair room of tests/test_server_mesh.py:28 (floor, back wall, the
    chair of scenes/assets/chair.obj) with its sphere light replaced by an
    octahedron mesh light of radius 5 at the sphere's centre, written to
    ``tmp``; returns the TOML's path."""
    octa = os.path.join(tmp, "octa.obj")
    with open(octa, "w") as fh:
        fh.write(octahedron_obj([50.0, 70.0, 100.0], 5.0))
    chair = os.path.join(ROOT, "scenes", "assets", "chair.obj")
    path = os.path.join(tmp, "chair_mesh_light.toml")
    with open(path, "w") as fh:
        fh.write(f"""[camera]
pos = [50.0, 52.0, 295.6]
dir = [0.0, -0.042612, -1.0]

[[objects]]
brdf = {{ type = "diffuse", kd = [0.75, 0.75, 0.75] }}
geometry = {{ type = "plane", pos = [0.0, 0.0, 0.0], n = [0.0, 1.0, 0.0] }}

[[objects]]
brdf = {{ type = "diffuse", kd = [0.75, 0.75, 0.75] }}
geometry = {{ type = "plane", pos = [0.0, 0.0, 0.0], n = [0.0, 0.0, -1.0] }}

[[objects]]
brdf = {{ type = "diffuse", kd = [0.8, 0.6, 0.4] }}
geometry = {{ type = "mesh", path = {json.dumps(chair)} }}
transforms = [{{ scale = 12.0 }}, {{ translate = [50.0, 15.0, 70.0] }}]

[[objects]]
emitted = [50.0, 50.0, 50.0]
brdf = {{ type = "diffuse", kd = [0.0, 0.0, 0.0] }}
geometry = {{ type = "mesh", path = {json.dumps(octa)} }}
""")
    return path


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.loader import load_scene
    from raytracer_tpu_torch.ops import _build
    from raytracer_tpu_torch.ops import bvh_binary as bb
    from raytracer_tpu_torch.ops import bvh_traverse as bt
    from raytracer_tpu_torch.ops import keys
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops.intersect import scene_precompute
    from raytracer_tpu_torch.parallel.mesh import ShardedRenderer
    from raytracer_tpu_torch.render.checkpoint import RenderCheckpoint, render_with_checkpoint
    from raytracer_tpu_torch.render.renderer import Renderer, finalize
    from raytracer_tpu_torch.server.app import RenderJob, Server
    from raytracer_tpu_torch.server.wire import parse_chunk, parse_chunks
    from raytracer_tpu_torch.tools.kernel_steps import SPACER_CYCLES as RUN_SPACER
    from raytracer_tpu_torch.tools import parity, top_ops
    from raytracer_tpu_torch.tools.kernel_steps import card, event_ms, ptxas_lines, scene_rays
    from raytracer_tpu_torch.utils import native
    from raytracer_tpu_torch.utils.png import read_png
    from raytracer_tpu_torch.utils.timing import device_trace
    from raytracer_tpu_torch.models import obj as objlib
    from raytracer_tpu_torch.render import wavefront_fused
    import bench_torch

    def zero_counts() -> None:
        mk.LAUNCHES = keys.LAUNCHES = bt.LAUNCHES = bb.LAUNCHES = 0

    def launch_counts() -> dict:
        return {"K1": mk.LAUNCHES, "K2": bt.LAUNCHES, "K3": keys.LAUNCHES, "K4": bb.LAUNCHES}

    clock = [time.perf_counter()]

    def lap(phase: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        print(f"[seconds] {phase}: {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    # 1) card
    smi = card()
    name = torch.cuda.get_device_name(0)
    print(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {name}", flush=True)

    # Where the time goes: one plain render for the wall (or the wall given),
    # then one with every traversal (K2 or K4) and K3 launch timed by CUDA
    # events recorded directly before and after it, behind a spacer
    # (SPACER_CYCLES): the kernels' own durations. The rest of the wall is
    # glue. The timed render steps eagerly: an event recorded in a captured
    # step would not be recorded again by its replays.
    def breakdown(scene, spp, label, engine="mega", wall=None):
        spent = {"trav": [], "K3": []}

        def timed(launch, bucket):
            def run(*a):
                torch.cuda._sleep(SPACER_CYCLES)
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                rc = launch(*a)
                e1.record()
                spent[bucket].append((e0, e1))
                return rc
            return run

        def render(graphed=True):
            r = Renderer(scene, RenderConfig(engine=engine), device="cuda")
            if not graphed:
                r.graphs = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render_image(spp)
            torch.cuda.synchronize()
            return r, (time.perf_counter() - t0) * 1e3

        if wall is None:
            r, wall = render()
        real = (bt._lib, bb._launch_fn, keys._launch_fn)
        k2_lib = types.SimpleNamespace(rt_bvh8_launch=timed(real[0]().rt_bvh8_launch, "trav"))
        k4_fn, k3_fn = timed(real[1](), "trav"), timed(real[2](), "K3")
        bt._lib, bb._launch_fn, keys._launch_fn = (lambda: k2_lib), (lambda: k4_fn), (lambda: k3_fn)
        try:
            r, _ = render(graphed=False)
        finally:
            bt._lib, bb._launch_fn, keys._launch_fn = real
        trav = sum(a.elapsed_time(b) for a, b in spent["trav"])
        k3 = sum(a.elapsed_time(b) for a, b in spent["K3"])
        rays = r.rays_traced()
        print(f"[time] {label} 600x450 {spp}spp: {wall / 1e3:.4f} s, {rays / wall / 1e3:.2f} Mrays/s; breakdown "
              f"wall {wall:.1f} ms = traversal kernels {trav:.1f} ms ({len(spent['trav'])} launches) + K3 kernels "
              f"{k3:.1f} ms ({len(spent['K3'])} launches) + glue {wall - trav - k3:.1f} ms (kernel times: events "
              f"directly around each launch of a second render) | {smi}", flush=True)
        return dict(n_trav=len(spent["trav"]), n_k3=len(spent["K3"]), trav_ms=trav, k3_ms=k3, wall_ms=wall)

    # 2) build all four sources and the native host library at once
    t0 = time.perf_counter()
    sources = ("megakernel", "bvh8", "coherence_key", "bvh_binary")
    with ThreadPoolExecutor(max_workers=len(sources) + 1) as pool:
        native_job = pool.submit(native.build)
        built = list(pool.map(_build.build, sources))
        native_lib, native_log = native_job.result()
    print(f"[build] {len(built)} libraries and the native host library in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for src, (lib, log) in zip(sources, built):
        print(f"[build] {lib}\n{log.strip()}", flush=True)
        for line in ptxas_lines(log) or ["built before this run: no ptxas output"]:
            print(f"[ptxas] {src}: {line}", flush=True)
    print(f"[native] built {native_lib} from {native.sources()} with {native.CXX_FLAGS + native.LIBS} "
          f"{native_log.strip()}", flush=True)

    lap("card and build")
    # 2b) the native host library: the OBJ parser against numpy's on every
    # asset, the unicorn's load with each parser, and the CPU baselines
    assets = sorted(f for f in os.listdir(os.path.join(ROOT, "scenes", "assets")) if f.endswith(".obj"))
    for asset in assets:
        path = os.path.join(ROOT, "scenes", "assets", asset)
        t0 = time.perf_counter()
        got = native.parse_obj_file(path)
        t_nat = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = objlib.load_obj_plain(path)
        t_np = time.perf_counter() - t0
        same = all(np.array_equal(g, w) and g.dtype == w.dtype for g, w in zip(got, want))
        print(f"[native] parse {asset}: {got[0].shape[0]} vertices, {got[2].shape[0]} faces, equal to numpy's "
              f"parse_obj: {same}; {t_nat:.4f} s native, {t_np:.4f} s numpy", flush=True)
        check(same, f"native OBJ parse of {asset} differs from parse_obj")
    uni_path = os.path.join(ROOT, "scenes", "flying_unicorn.toml")
    t0 = time.perf_counter()
    load_scene(uni_path, device="cuda")
    load_native = time.perf_counter() - t0
    plain_load, objlib.load_obj = objlib.load_obj, objlib.load_obj_plain
    try:
        t0 = time.perf_counter()
        load_scene(uni_path, device="cuda")
        load_plain = time.perf_counter() - t0
    finally:
        objlib.load_obj = plain_load
    print(f"[load] flying_unicorn: {load_native:.2f} s with the native parser, {load_plain:.2f} s with numpy's",
          flush=True)
    cpu_native = {s: bench_torch.measure_native_cpu(s) for s in ("cornell_box", "flying_unicorn", "crewmate_phong")}
    host = bench_torch.cpu_host()
    for s, m in cpu_native.items():
        check(m is not None and m["rays"] > 0 and m["seconds"] > 0, f"native baseline of {s}: {m}")
        print(f"[native] baseline {s} 600x450 rows {m['rows'][0]}-{m['rows'][1]} {m['spp']}spp seed 1: "
              f"{m['mrays_per_s']:.4f} Mrays/s, {m['rays']} rays in {m['seconds']:.4f} s, {m['threads']} "
              f"threads | host {host}", flush=True)
    lap("native")
    cfg = RenderConfig()
    w = cfg.width
    scenes = {s: load_scene(os.path.join(ROOT, "scenes", f"{s}.toml"), device="cuda") for s in SCENES}

    # 3) K1 against its twin on the card: one 50-row band, 8 samples, same
    # seed; the twin also counts the band's camera, bounce and shadow rays.
    rows, ns, seed, y0 = 50, 8, 20261016, 200
    n = rows * w * 4
    max_err = 0.0
    shadow_share = {}
    for s in SCENES:
        pf, static = mk.pack_params(scenes[s], cfg)
        acc_k, rays_k = mk.mega_cuda(pf, static, y0, ns, n, seed, "cuda")
        counts: dict = {}
        acc_t, rays_t = mk.mega_twin(pf, static, y0, ns, n, seed, "cuda", counts=counts)
        torch.cuda.synchronize()
        err, bad = lane_diff(acc_k, acc_t, mk.LANE_RTOL)
        _, bad_rays = lane_diff(rays_k, rays_t, 0.0)
        mean_k, mean_t = acc_k.mean().item(), acc_t.mean().item()
        print(
            f"[kernel-vs-twin] K1 {s} W={w} rows={rows} samples={ns}: max|d|={err:.3g} "
            f"lanes beyond {mk.LANE_RTOL:g}: {bad:.4%} (ray counts differ on {bad_rays:.4%}) "
            f"band mean kernel={mean_k:.7f} twin={mean_t:.7f} "
            f"rays kernel={int(rays_k.sum())} twin={int(rays_t.sum())}",
            flush=True,
        )
        check(torch.isfinite(acc_k).all().item(), f"{s}: kernel sums not finite")
        check(1.0 - bad >= mk.LANE_SHARE, f"{s}: {bad:.4%} of lanes beyond tolerance")
        check(1.0 - bad_rays >= mk.LANE_SHARE, f"{s}: ray counts differ on {bad_rays:.4%} of lanes")
        check(abs(mean_k - mean_t) <= mk.BAND_RTOL * abs(mean_t), f"{s}: band means differ")
        max_err = max(max_err, err)
        shadow_share[s] = counts["shadow"] / (counts["bounces"] + counts["shadow"])
        print(f"[count] K1 {s} band (twin): {counts['samples']} camera rays, {counts['bounces']} bounces, "
              f"{counts['shadow']} shadow rays (shadow share {shadow_share[s]:.4f})", flush=True)
        # The frame's bands in one launch (the main path's form) against the
        # same bands launched one by one.
        rows_f = Renderer(scenes[s], cfg, device="cuda").plan(4 * ns)[0]
        n_f = rows_f * w * 4
        bands = [(yy, mk.band_seed(cfg.seed, yy, 0)) for yy in range(0, cfg.height, rows_f)]
        acc_f, rays_f = mk.mega_cuda_bands(pf, static, bands, ns, n_f, "cuda")
        one = [mk.mega_cuda(pf, static, yy, ns, n_f, sd, "cuda") for yy, sd in bands]
        same_bands = torch.equal(acc_f, torch.cat([o[0] for o in one])) and torch.equal(
            rays_f, torch.cat([o[1] for o in one]))
        print(f"[kernel-vs-kernel] K1 {s}: one launch of {len(bands)} bands x {n_f} lanes, {ns} samples, "
              f"equal to {len(bands)} one-band launches on every lane: {same_bands}", flush=True)
        check(same_bands, f"{s}: the all-bands launch differs from the one-band launches")

    lap("K1 against its twin")
    # 4) K3 and K2 against their twins on flying_unicorn rays
    t0 = time.perf_counter()
    uni = load_scene(os.path.join(ROOT, "scenes", "flying_unicorn.toml"), device="cuda")
    uni_pre = scene_precompute(uni)
    print(f"[load] flying_unicorn: {uni.n_triangles} triangle slots, {uni.bvh8_nodes_flat.shape[0]} "
          f"wide nodes, stack {uni.bvh8_max_stack}, in {time.perf_counter() - t0:.2f} s", flush=True)
    # Every lane of the frame in each class: the sizes the main and shadow
    # traces give K2 and K3 on the first loop iteration.
    n_frame = cfg.width * cfg.height * 4
    cam, classes = scene_rays(uni, uni_pre, cfg, n_frame)
    key_err = 0
    for cname, (ro, rd) in [("camera", cam)] + [(c, v[:2]) for c, v in classes.items()]:
        k_k = keys.coherence_key_cuda(uni, ro, rd, cfg.eps)
        k_t = keys.coherence_key_twin(uni, ro, rd, cfg.eps)
        torch.cuda.synchronize()
        n_diff = int((k_k != k_t).sum())
        key_err = max(key_err, int((k_k.long() - k_t.long()).abs().max()))
        print(f"[kernel-vs-twin] K3 {cname} rays={k_k.numel()}: keys differ on {n_diff} "
              f"(misses {int((k_k >> 30).sum())})", flush=True)
        check(n_diff == 0, f"K3 differs from its twin on {n_diff} {cname} rays")
    # A tree with fewer inner nodes gets a shorter cut, which the kernel takes
    # with its cut count at run time: the unicorn's first 20 boxes.
    short = dataclasses.replace(uni, bvh_cut_lo=uni.bvh_cut_lo[:20].contiguous(),
                                bvh_cut_hi=uni.bvh_cut_hi[:20].contiguous())
    ro, rd = classes["bounce"][:2]
    n_diff = int((keys.coherence_key_cuda(short, ro, rd, cfg.eps)
                  != keys.coherence_key_twin(short, ro, rd, cfg.eps)).sum())
    print(f"[kernel-vs-twin] K3 bounce rays={ro[0].numel()}, 20 cut boxes (run-time count): keys differ on "
          f"{n_diff}", flush=True)
    check(n_diff == 0, f"K3 with 20 cut boxes differs from its twin on {n_diff} rays")
    # A cut longer than the by-value table (RT_MAX_CUT=256): the kernel reads
    # its device copy of the table.
    saved_cut = os.environ.get("RT_MAX_CUT")
    os.environ["RT_MAX_CUT"] = "256"
    try:
        long_cut = load_scene(os.path.join(ROOT, "scenes", "flying_unicorn.toml"), device="cuda")
    finally:
        if saved_cut is None:
            os.environ.pop("RT_MAX_CUT")
        else:
            os.environ["RT_MAX_CUT"] = saved_cut
    n_long = long_cut.bvh_cut_lo.shape[0]
    k_k = keys.coherence_key_cuda(long_cut, ro, rd, cfg.eps)
    k_t = keys.coherence_key_twin(long_cut, ro, rd, cfg.eps)
    n_diff = int((k_k != k_t).sum())
    n_entries = int(torch.unique((k_k >> 17) & 0x1FFF).numel())
    print(f"[kernel-vs-twin] K3 bounce rays={ro[0].numel()}, {n_long} cut boxes (RT_MAX_CUT=256, device table): "
          f"keys differ on {n_diff}; {n_entries} distinct entries", flush=True)
    check(n_long >= 256 and n_diff == 0, f"K3 with {n_long} cut boxes differs from its twin on {n_diff} rays")
    # K2 on each class at the frame's width, then on the bounce class at the
    # other widths of the main path: the tail-compaction stages of the frame,
    # and a served delivery band with its own stages.
    from raytracer_tpu_torch.render.wavefront import tail_widths

    rows_b = Renderer(uni, cfg, device="cuda").plan_delivery(16)[0]
    n_band = rows_b * cfg.width * 4
    widths = sorted(set(tail_widths(n_frame, cfg, True) + [n_band] + tail_widths(n_band, cfg, True)),
                    reverse=True)
    uni_runs, bounce_args = sorted_runs(uni, classes, widths, cfg.eps)
    k2_err = hold_traversal("K2", {"": bt.bvh_traverse_cuda}, bt.bvh_traverse_twin, uni_runs)

    # 4b) K4 against its twin on crewmate_phong and flying_unicorn rays, the
    # same classes and widths; and against K2 on the nearest-hit classes
    # (both are exact searches with the same t expression).
    t0 = time.perf_counter()
    crew = load_scene(os.path.join(ROOT, "scenes", "crewmate_phong.toml"), device="cuda")
    crew_pre = scene_precompute(crew)
    print(f"[load] crewmate_phong: {crew.n_triangles} triangle slots, {crew.bvh_binary_nodes8.shape[0]} "
          f"binary nodes ({int((crew.bvh_count > 0).sum())} leaves), {crew.bvh8_nodes_flat.shape[0]} wide "
          f"nodes, in {time.perf_counter() - t0:.2f} s", flush=True)
    _, crew_classes = scene_rays(crew, crew_pre, cfg, n_frame)
    crew_runs, crew_bounce = sorted_runs(crew, crew_classes, widths, cfg.eps)
    k2_err = max(k2_err, hold_traversal("K2", {"": bt.bvh_traverse_cuda}, bt.bvh_traverse_twin, crew_runs))
    k4_err = 0.0
    for runs in (crew_runs, uni_runs):
        k4_err = max(k4_err, hold_traversal("K4", {"": bb.bvh_binary_cuda}, bb.bvh_binary_twin, runs))
        for cname, args in runs[:3]:  # camera, bounce, shadow: nearest hits
            t4, _ = bb.bvh_binary_cuda(*args)
            t2, _ = bt.bvh_traverse_cuda(*args)
            same = (t4 == t2).double().mean().item()
            print(f"[K4-vs-K2] {args[0].name} {cname} rays={t4.numel()}: t bit-equal on {same:.6%}", flush=True)
            check(same >= bt.T_EXACT_SHARE, f"K4 and K2 differ on {args[0].name} {cname}")

    # 4c) the visits the walks need on the frame's sorted bounce rays,
    # counted by the twins (the bounds of K2 and K4 below rest on them)
    visits = {}
    for sname, args in (("flying_unicorn", bounce_args), ("crewmate_phong", crew_bounce)):
        n_r = args[1][0].numel()
        for kname, twin in (("K2", bt.bvh_traverse_twin), ("K4", bb.bvh_binary_twin)):
            v: dict = {}
            twin(*args, visits=v)
            visits[kname, sname] = v
            print(f"[visits] {kname} {sname} {n_r} sorted bounce rays (twin): per ray {v['nodes'] / n_r:.4f} "
                  f"nodes, {v['leaves'] / n_r:.4f} leaves, {v['tris'] / n_r:.3f} real leaf triangles, "
                  f"{v['cand'] / n_r:.3f} candidates (t could still win)", flush=True)

    lap("K2, K3, K4 against their twins, visits")
    # 5) the megakernel path, offline (counts from here to the end of phase 6)
    zero_counts()
    k1_per_frame = {}
    k1_render = {}
    for s in SCENES:
        before = mk.LAUNCHES
        r = Renderer(scenes[s], RenderConfig(), device="cuda")
        check(r.engine == "mega", f"{s}: select_band_engine gave {r.engine!r}")
        t0 = time.perf_counter()
        img = r.render_image(64)
        wall = time.perf_counter() - t0
        ref = read_png(os.path.join(ROOT, "examples", f"{s}.png")).astype(np.float64)
        mean = float(img.mean())
        mad = float(np.abs(img.astype(np.float64) - ref).mean())
        rays = r.rays_traced()
        print(
            f"[render] {s} 600x450 64spp engine={r.engine} launches={mk.LAUNCHES - before} "
            f"mean={mean:.3f} (ref {ref.mean():.3f}) MAD={mad:.3f} wall={wall:.4f} s "
            f"rays={rays} {rays / wall / 1e6:.1f} Mrays/s | {smi}",
            flush=True,
        )
        lo, hi = IMAGE_MEAN[s]
        check(img.shape == (450, 600, 3) and img.dtype == np.uint8, f"{s}: image {img.shape}")
        k1_per_frame[s] = mk.LAUNCHES - before
        k1_render[s] = (wall, rays)
        check(k1_per_frame[s] == 1, f"{s}: the frame took {k1_per_frame[s]} K1 launches, not one")
        check(lo <= mean <= hi, f"{s}: image mean {mean:.3f} outside [{lo}, {hi}]")
        check(mad < IMAGE_MAD_MAX, f"{s}: MAD {mad:.3f} >= {IMAGE_MAD_MAX}")

    # 6) the megakernel path, served: RenderJob.run with a capturing send
    server = Server(scenes, device="cuda")
    for s, progressive in (("cornell_box", False), ("cornell_box", True), ("cubes", False)):
        msgs: list = []
        first = []

        async def send(m, msgs=msgs, first=first) -> None:
            if not first:
                first.append(time.perf_counter())
            msgs.append(m)

        job = RenderJob(send=send)
        renderer = server.renderer_for(s, server.width, server.height)
        job.mark_running()
        t0 = time.perf_counter()
        stopped = asyncio.run(job.run(renderer, 16, progressive=progressive))
        wall = time.perf_counter() - t0
        check(not stopped, f"{s}: served render stopped early")
        chunks = [parse_chunk(m) for m in msgs]
        check(len(chunks) > 0 and len(chunks) % 4500 == 0, f"{s}: {len(chunks)} chunks, not whole frames")
        frames = len(chunks) // 4500
        last = np.zeros((450, 600, 3), np.uint8)
        for f in range(frames):
            seen = np.zeros((450, 600), np.int32)
            for mtype, x, y, rgb in chunks[f * 4500 : (f + 1) * 4500]:
                check(mtype == 0 and rgb.shape == (60, 3) and x % 60 == 0, f"{s}: bad chunk at {x},{y}")
                seen[y, x : x + 60] += 1
                last[y, x : x + 60] = rgb
            check((seen == 1).all(), f"{s}: frame {f} does not cover every pixel exactly once")
        if not progressive:
            same = Renderer(scenes[s], RenderConfig(), device="cuda").render_image(16)
            check(np.array_equal(last, same), f"{s}: served frame differs from render_image(16)")
        print(
            f"[serve] {s} 600x450 16spp progressive={progressive}: {frames} frame(s) x 4500 "
            f"chunks, first chunk {first[0] - t0:.4f} s, total {wall:.4f} s, "
            f"{wall / frames:.4f} s/pass, rays={job.stats.rays}, image mean {last.mean():.3f} | {smi}",
            flush=True,
        )
    launches = {"K1": mk.LAUNCHES, "K2": bt.LAUNCHES, "K3": keys.LAUNCHES}
    print(f"[launches] megakernel path: {launches}", flush=True)
    check(launches["K1"] > 0, "the megakernel path did not launch K1")

    lap("megakernel path")
    # 7) the BVH path, offline: flying_unicorn 600x450 16 spp, seeds 0 and 1
    zero_counts()
    ref = read_png(os.path.join(ROOT, "examples", "flying_unicorn.png")).astype(np.float64)
    imgs, rays_by_seed = {}, {}
    for sd in (0, 1):
        r = Renderer(uni, RenderConfig(seed=sd), device="cuda")
        check(r.engine == "regen", f"flying_unicorn: select_band_engine gave {r.engine!r}")
        check(r.plan(16) == (450, 1, 4), f"flying_unicorn: plan {r.plan(16)}")
        t0 = time.perf_counter()
        imgs[sd] = img = r.render_image(16)
        wall = time.perf_counter() - t0
        rays_by_seed[sd] = rays = r.rays_traced()
        mean = float(img.mean())
        mad = float(np.abs(img.astype(np.float64) - ref).mean())
        print(
            f"[render] flying_unicorn 600x450 16spp seed={sd} engine={r.engine} "
            f"K2 launches={bt.LAUNCHES} K3 launches={keys.LAUNCHES} mean={mean:.3f} "
            f"(ref {ref.mean():.3f}) MAD={mad:.3f} wall={wall:.4f} s rays={rays} "
            f"{rays / wall / 1e6:.2f} Mrays/s | {smi}",
            flush=True,
        )
        check(img.shape == (450, 600, 3) and np.isfinite(img).all(), "flying_unicorn: bad image")
    unicorn_wall, unicorn_rays_n = wall, rays
    unicorn_frame, unicorn_rays0 = imgs[0], rays_by_seed[0]
    mean0 = float(imgs[0].mean())
    mad0 = float(np.abs(imgs[0].astype(np.float64) - ref).mean())
    mad01 = uni_mad01 = float(np.abs(imgs[0].astype(np.float64) - imgs[1].astype(np.float64)).mean())
    print(f"[render] flying_unicorn MAD(seed 0, seed 1) = {mad01:.3f}; MAD(seed 0, ref) = {mad0:.3f}", flush=True)
    check(UNICORN_MEAN[0] <= mean0 <= UNICORN_MEAN[1], f"flying_unicorn mean {mean0:.3f} outside {UNICORN_MEAN}")
    check(mad0 <= mad01 + UNICORN_MAD_MARGIN, f"flying_unicorn MAD {mad0:.3f} > {mad01:.3f} + {UNICORN_MAD_MARGIN}")

    # 8) the BVH path, served: batched transport, 16 spp, whole frame once
    msgs, first = [], []

    async def send_u(m) -> None:
        if not first:
            first.append(time.perf_counter())
        msgs.append(m)

    userver = Server({"flying_unicorn": uni}, device="cuda")
    renderer = userver.renderer_for("flying_unicorn", 600, 450)
    rows_b = renderer.plan_delivery(16)[0]
    job = RenderJob(send=send_u)
    job.mark_running()
    t0 = time.perf_counter()
    stopped = asyncio.run(job.run(renderer, 16, batch=True))
    wall = time.perf_counter() - t0
    check(not stopped, "flying_unicorn: served render stopped early")
    served = np.zeros((450, 600, 3), np.uint8)
    seen = np.zeros((450, 600), np.int32)
    n_chunks = 0
    for m in msgs:
        for mtype, x, y, rgb in parse_chunks(m):
            check(mtype == 0 and rgb.shape == (60, 3), f"flying_unicorn: bad chunk at {x},{y}")
            seen[y, x : x + 60] += 1
            served[y, x : x + 60] = rgb
            n_chunks += 1
    check(n_chunks == 4500 and (seen == 1).all(), "flying_unicorn: served frame not whole")
    check(450 // rows_b >= 4 and len(msgs) >= 4, f"flying_unicorn: {len(msgs)} deliveries of {rows_b} rows")
    check(np.array_equal(served, imgs[0]), "flying_unicorn: served frame differs from render_image(16)")
    print(
        f"[serve] flying_unicorn 600x450 16spp batch: {len(msgs)} messages, {450 // rows_b} bands of "
        f"{rows_b} rows, 4500 chunks, first chunk {first[0] - t0:.4f} s, total {wall:.4f} s/pass, "
        f"rays={job.stats.rays}, equal to render_image(16) | {smi}",
        flush=True,
    )
    launches.update(K2=bt.LAUNCHES, K3=keys.LAUNCHES)
    print(f"[launches] BVH path: K2={launches['K2']} K3={launches['K3']}", flush=True)
    check(launches["K2"] > 0 and launches["K3"] > 0, "the BVH path did not launch K2 and K3")

    lap("BVH path")
    # 9) the Phong/MIS path: crewmate_phong offline at 64 spp (default
    # traversal), at 16 spp under each traversal variant, offline and
    # served, then cornell_box with MIS (counts from here to the end of 9)
    zero_counts()
    ref = read_png(os.path.join(ROOT, "examples", "crewmate_phong.png")).astype(np.float64)
    imgs = {}
    for sd in (0, 1):
        r = Renderer(crew, RenderConfig(seed=sd), device="cuda")
        check(r.engine == "regen", f"crewmate_phong: select_band_engine gave {r.engine!r}")
        t0 = time.perf_counter()
        imgs[sd] = img = r.render_image(64)
        wall = time.perf_counter() - t0
        rays = r.rays_traced()
        print(f"[render] crewmate_phong 600x450 64spp seed={sd} engine={r.engine} mean={img.mean():.3f} "
              f"(ref {ref.mean():.3f}) MAD={np.abs(img - ref).mean():.3f} wall={wall:.4f} s rays={rays} "
              f"{rays / wall / 1e6:.2f} Mrays/s | {smi}", flush=True)
        check(img.shape == (450, 600, 3), "crewmate_phong: bad image")
    mean0 = float(imgs[0].mean())
    mad0 = float(np.abs(imgs[0] - ref).mean())
    mad01 = float(np.abs(imgs[0].astype(np.float64) - imgs[1]).mean())
    print(f"[render] crewmate_phong MAD(seed 0, seed 1) = {mad01:.3f}; MAD(seed 0, ref) = {mad0:.3f}", flush=True)
    check(CREWMATE_MEAN[0] <= mean0 <= CREWMATE_MEAN[1], f"crewmate_phong mean {mean0:.3f} outside {CREWMATE_MEAN}")
    check(mad0 <= mad01 + UNICORN_MAD_MARGIN, f"crewmate_phong MAD {mad0:.3f} > {mad01:.3f} + {UNICORN_MAD_MARGIN}")

    # Under each variant: render_image(16), then the same frame served with
    # the batched transport, which must equal it.
    cserver = Server({"crewmate_phong": crew}, device="cuda")

    def render_and_serve():
        t0 = time.perf_counter()
        img = Renderer(crew, RenderConfig(), device="cuda").render_image(16)
        wall = time.perf_counter() - t0
        msgs = []

        async def send_c(m) -> None:
            msgs.append(m)

        job = RenderJob(send=send_c)
        job.mark_running()
        t0 = time.perf_counter()
        stopped = asyncio.run(job.run(cserver.renderer_for("crewmate_phong", 600, 450), 16, batch=True))
        check(not stopped, "crewmate_phong: served render stopped early")
        return img, wall, msgs, time.perf_counter() - t0

    variant_imgs, variant_launches = {}, {}
    for variant in ("widesmem", "binary"):
        k2_0, k4_0 = bt.LAUNCHES, bb.LAUNCHES
        img, wall, msgs, served_wall = with_variant(variant, render_and_serve)
        variant_launches[variant] = (bt.LAUNCHES - k2_0, bb.LAUNCHES - k4_0)
        variant_imgs[variant] = img
        served = np.zeros((450, 600, 3), np.uint8)
        seen = np.zeros((450, 600), np.int32)
        for m in msgs:
            for mtype, x, y, rgb in parse_chunks(m):
                check(mtype == 0 and rgb.shape == (60, 3), f"crewmate_phong: bad chunk at {x},{y}")
                seen[y, x : x + 60] += 1
                served[y, x : x + 60] = rgb
        check((seen == 1).all(), f"crewmate_phong {variant}: served frame not whole")
        check(np.array_equal(served, img), f"crewmate_phong {variant}: served frame differs from render_image(16)")
        print(f"[render] crewmate_phong 600x450 16spp RT_BVH_KERNEL={variant}: mean={img.mean():.3f} "
              f"wall={wall:.4f} s; served {len(msgs)} messages, {served_wall:.4f} s/pass, equal to "
              f"render_image(16); launches K2={variant_launches[variant][0]} K4={variant_launches[variant][1]} "
              f"| {smi}", flush=True)
    k2_n, k4_n = variant_launches["binary"]
    check(k4_n > 0 and k2_n == 0, f"RT_BVH_KERNEL=binary launched K2 {k2_n} and K4 {k4_n} times")
    k2_n, k4_n = variant_launches["widesmem"]
    check(k2_n > 0 and k4_n == 0, f"the default variant launched K2 {k2_n} and K4 {k4_n} times")
    same_px = float((variant_imgs["widesmem"] == variant_imgs["binary"]).all(axis=2).mean())
    print(f"[render] crewmate_phong 16spp: the K4 image equals the K2 image on {same_px:.6%} of pixels", flush=True)
    check(same_px >= VARIANT_PIXEL_SHARE, f"K4 and K2 images equal on {same_px:.4%} of pixels only")

    ref = read_png(os.path.join(ROOT, "examples", "cornell_box_mis.png")).astype(np.float64)
    r = Renderer(scenes["cornell_box"], RenderConfig(use_mis=True), device="cuda")
    check(r.engine == "regen", f"cornell_box MIS: select_band_engine gave {r.engine!r}")
    t0 = time.perf_counter()
    img = r.render_image(64)
    wall = mis_wall = time.perf_counter() - t0
    mis_rays = r.rays_traced()
    mean, mad = float(img.mean()), float(np.abs(img - ref).mean())
    print(f"[render] cornell_box MIS 600x450 64spp engine={r.engine} mean={mean:.3f} (ref {ref.mean():.3f}) "
          f"MAD={mad:.3f} wall={wall:.4f} s | {smi}", flush=True)
    check(img.shape == (450, 600, 3), "cornell_box MIS: bad image")
    check(MIS_MEAN[0] <= mean <= MIS_MEAN[1], f"cornell_box MIS mean {mean:.3f} outside {MIS_MEAN}")
    check(mad < IMAGE_MAD_MAX, f"cornell_box MIS MAD {mad:.3f} >= {IMAGE_MAD_MAX}")
    path3 = {"K2": bt.LAUNCHES, "K3": keys.LAUNCHES, "K4": bb.LAUNCHES}
    print(f"[launches] Phong/MIS path: {path3}", flush=True)
    check(min(path3.values()) > 0, "the Phong/MIS path did not launch K2, K3 and K4")
    launches["K4"] = path3["K4"]
    lap("Phong/MIS path")

    # 9-) the mesh-light path: a mesh light behind the BVH (draw 8 and the
    # mesh-light sample), on the regen and the fused engine, 16 spp, seeds 0
    # and 1; NEE against MIS; every kernel against its twin on its rays
    from raytracer_tpu_torch.models.scene import LIGHT_MESH

    path_launches_ml = {}
    with tempfile.TemporaryDirectory() as tmp:
        ml_path = mesh_light_toml(tmp)
        ml = load_scene(ml_path, device="cuda")
        check(ml.light_type == LIGHT_MESH and ml.use_bvh,
              f"mesh light: light type {ml.light_type}, BVH {ml.use_bvh}: not a mesh light behind a BVH")
        ml_imgs = {}
        for eng in ("regen", "fused"):
            zero_counts()
            for sd in (0, 1):
                r = Renderer(ml, RenderConfig(seed=sd, engine=eng), device="cuda")
                check(r.engine == eng, f"mesh light: engine {r.engine!r}, asked for {eng!r}")
                t0 = time.perf_counter()
                ml_imgs[eng, sd] = img = r.render_image(16)
                wall = time.perf_counter() - t0
                check(img.shape == (450, 600, 3) and img.mean() > 5.0, f"mesh light {eng}: bad image")
                print(f"[mesh-light] chair room, octahedron mesh light, 600x450 16spp engine={eng} seed={sd}: mean "
                      f"{img.mean():.3f}, wall {wall:.4f} s, rays {r.rays_traced()} | {smi}", flush=True)
            counts = path_launches_ml[f"mesh light {eng}"] = launch_counts()
            print(f"[launches] mesh light {eng}: {counts}", flush=True)
            check(counts["K2"] > 0 and counts["K3"] > 0, f"mesh light {eng}: launches {counts}")
        for sd in (0, 1):
            check(np.array_equal(ml_imgs["fused", sd], ml_imgs["regen", sd]),
                  f"mesh light seed {sd}: the fused frame differs from the regen frame")
        r = Renderer(ml, RenderConfig(use_mis=True), device="cuda")
        mis_img = r.render_image(16)
        nee_mean, mis_mean = float(ml_imgs["regen", 0].mean()), float(mis_img.mean())
        ml_mad01 = float(np.abs(ml_imgs["regen", 0].astype(np.float64) - ml_imgs["regen", 1]).mean())
        print(f"[mesh-light] fused = regen on every pixel (seeds 0 and 1); NEE mean {nee_mean:.3f}, MIS mean "
              f"{mis_mean:.3f} (|d| {abs(nee_mean - mis_mean):.3f}, bound {MESH_LIGHT_MIS_BOUND:.3f}); MAD(seed 0, "
              f"seed 1) = {ml_mad01:.3f} | {smi}", flush=True)
        check(abs(nee_mean - mis_mean) <= MESH_LIGHT_MIS_BOUND,
              f"mesh light: NEE mean {nee_mean:.3f} and MIS mean {mis_mean:.3f} differ by more than "
              f"{MESH_LIGHT_MIS_BOUND:.3f}")
        zero_counts()
        check(parity.run(ml_path, device="cuda"), "parity: the mesh-light scene's kernels disagree with their twins")
        path_launches_ml["parity mesh light"] = launch_counts()
    lap("mesh light")

    # 9a) the fused engine. First K3, K2 and K4 against their twins on its
    # double-width batch: the frame's unicorn bounce rays, then its bounded
    # shadow rays with a third parked at cap 0, sorted by the key as
    # bvh_intersect sorts them.
    from raytracer_tpu_torch.models import vecmath as vm
    from raytracer_tpu_torch.render.wavefront import PARK_RD, PARK_RO

    b_ro, b_rd, b_init = classes["bounce"][:3]
    s_ro, s_rd, s_cap = classes["shadow"][:3]
    parked = torch.arange(n_frame, device="cuda") % FUSED_PARKED_EVERY == 0
    f_ro = tuple(torch.cat([a, b]) for a, b in zip(b_ro, vm.where3(parked, PARK_RO, s_ro)))
    f_rd = tuple(torch.cat([a, b]) for a, b in zip(b_rd, vm.where3(parked, PARK_RD, s_rd)))
    f_init = torch.cat([b_init, torch.where(parked, 0.0, s_cap)])
    k_k = keys.coherence_key_cuda(uni, f_ro, f_rd, cfg.eps)
    k_t = keys.coherence_key_twin(uni, f_ro, f_rd, cfg.eps)
    n_diff = int((k_k != k_t).sum())
    print(f"[fused] K3 on the fused batch, {k_k.numel()} rays ({int(parked.sum())} parked): keys differ on "
          f"{n_diff}; parked rays in the miss group: {bool((k_k[n_frame:][parked] >> 30 == 1).all())}", flush=True)
    check(n_diff == 0, f"K3 differs from its twin on {n_diff} rays of the fused batch")
    check(bool((k_k[n_frame:][parked] >> 30 == 1).all()), "a parked shadow ray is not in K3's miss group")
    order = torch.argsort(k_k, stable=True)
    fused_args = (uni, tuple(c[order] for c in f_ro), tuple(c[order] for c in f_rd), f_init[order],
                  torch.zeros(2 * n_frame, dtype=torch.bool, device="cuda"), False, cfg.eps)
    fused_runs = [("fused batch", fused_args)]
    k2_err = max(k2_err, hold_traversal("K2", {"": bt.bvh_traverse_cuda}, bt.bvh_traverse_twin, fused_runs))
    k4_err = max(k4_err, hold_traversal("K4", {"": bb.bvh_binary_cuda}, bb.bvh_binary_twin, fused_runs))
    t_park = bt.bvh_traverse_cuda(*fused_args)[0][torch.cat([torch.zeros_like(parked), parked])[order]]
    check(bool((t_park == 0.0).all()), "a parked shadow ray did not end at its cap 0")

    # The unicorn frame on the fused engine: one K3 and one K2 launch a
    # trace, the regen frame's rays, sums and pixels, and its wall beside
    # regen's (medians of three alternated runs).
    traces = [0]
    real_trace = wavefront_fused.trace_soa

    def counted_trace(*a, **kw):
        traces[0] += 1
        return real_trace(*a, **kw)

    fused_cfg = RenderConfig(engine="fused")
    rf = Renderer(uni, fused_cfg, device="cuda")
    check(rf.engine == "fused" and rf.plan(16) == (450, 1, 4), f"fused: engine {rf.engine!r}, plan {rf.plan(16)}")
    zero_counts()
    wavefront_fused.trace_soa = counted_trace
    try:
        t0 = time.perf_counter()
        fused_img = rf.render_image(16)
        fused_first = time.perf_counter() - t0
    finally:
        wavefront_fused.trace_soa = real_trace
    path_launches_fused = {"fused flying_unicorn": launch_counts()}
    fc = path_launches_fused["fused flying_unicorn"]
    fused_rays = rf.rays_traced()
    same = bool(np.array_equal(fused_img, unicorn_frame))
    mean_f = float(fused_img.mean())
    print(f"[fused] flying_unicorn 600x450 16spp engine=fused: {traces[0]} traces of 2 x 1,080,000 rays, launches "
          f"{fc}; rays {fused_rays} (regen {unicorn_rays0}); equal to the regen frame on every pixel: {same}; "
          f"mean {mean_f:.3f}; first render {fused_first:.4f} s | {smi}", flush=True)
    check(fc["K3"] == fc["K2"] == traces[0] > 0 and fc["K1"] == fc["K4"] == 0,
          f"fused: {traces[0]} traces but launches {fc}")
    check(fused_rays == unicorn_rays0, f"fused: {fused_rays} rays, regen {unicorn_rays0}")
    check(same, "fused: the unicorn frame differs from the regen frame")
    check(UNICORN_MEAN[0] <= mean_f <= UNICORN_MEAN[1], f"fused: unicorn mean {mean_f:.3f} outside {UNICORN_MEAN}")
    rg = Renderer(uni, RenderConfig(), device="cuda")
    sums_f, rays_f = rf.render_band_sums(0, 450, 1, 1, salt=0, return_rays=True)
    sums_g, rays_g = rg.render_band_sums(0, 450, 1, 1, salt=0, return_rays=True)
    same_sums = bool(torch.equal(sums_f, sums_g)) and int(rays_f) == int(rays_g)
    print(f"[fused] flying_unicorn one dispatch (450 rows, 1 sample): sums equal to regen's on every element and "
          f"rays equal ({int(rays_f)}): {same_sums}", flush=True)
    check(same_sums, "fused: a dispatch's sums differ from regen's")

    def alternated(scene, n_runs=3):
        walls = {"regen": [], "fused": []}
        for _ in range(n_runs):
            for eng in ("regen", "fused"):
                r = Renderer(scene, RenderConfig(engine=eng), device="cuda")
                t0 = time.perf_counter()
                r.render_image(16)
                walls[eng].append(time.perf_counter() - t0)
        return {eng: (sorted(v)[len(v) // 2], v) for eng, v in walls.items()}

    fused_walls = {"flying_unicorn": alternated(uni)}
    w_f, w_g = fused_walls["flying_unicorn"]["fused"], fused_walls["flying_unicorn"]["regen"]
    print(f"[fused] flying_unicorn 600x450 16spp wall, median of 3 alternated runs: fused {w_f[0]:.4f} s "
          f"{[round(x, 4) for x in w_f[1]]}, regen {w_g[0]:.4f} s {[round(x, 4) for x in w_g[1]]}; "
          f"fused/regen {w_f[0] / w_g[0]:.3f} | {smi}", flush=True)

    # crewmate_phong under RT_BVH_KERNEL=binary: K4 and not K2, equal to the
    # regen K4 frame; then its walls.
    def crew_fused():
        zero_counts()
        img = Renderer(crew, fused_cfg, device="cuda").render_image(16)
        return img, launch_counts()

    crew_img, cc = with_variant("binary", crew_fused)
    path_launches_fused["fused crewmate_phong binary"] = cc
    share = float((crew_img == variant_imgs["binary"]).all(axis=2).mean())
    print(f"[fused] crewmate_phong 600x450 16spp RT_BVH_KERNEL=binary engine=fused: launches {cc}; equal to the "
          f"regen K4 frame on {share:.6%} of pixels", flush=True)
    check(cc["K4"] > 0 and cc["K2"] == 0 and cc["K3"] == cc["K4"], f"fused crewmate binary: launches {cc}")
    check(share >= VARIANT_PIXEL_SHARE, f"fused crewmate: equal to regen on {share:.4%} of pixels only")
    fused_walls["crewmate_phong"] = with_variant("binary", lambda: alternated(crew))
    w_f, w_g = fused_walls["crewmate_phong"]["fused"], fused_walls["crewmate_phong"]["regen"]
    print(f"[fused] crewmate_phong 600x450 16spp RT_BVH_KERNEL=binary wall, median of 3 alternated runs: fused "
          f"{w_f[0]:.4f} s {[round(x, 4) for x in w_f[1]]}, regen {w_g[0]:.4f} s {[round(x, 4) for x in w_g[1]]}; "
          f"fused/regen {w_f[0] / w_g[0]:.3f} | {smi}", flush=True)

    # cornell_box: no BVH, so no kernel runs on either engine
    zero_counts()
    t0 = time.perf_counter()
    img_f = Renderer(scenes["cornell_box"], fused_cfg, device="cuda").render_image(16)
    wall_f = time.perf_counter() - t0
    cn = path_launches_fused["fused cornell_box"] = launch_counts()
    t0 = time.perf_counter()
    img_g = Renderer(scenes["cornell_box"], RenderConfig(engine="regen"), device="cuda").render_image(16)
    wall_g = time.perf_counter() - t0
    same = bool(np.array_equal(img_f, img_g))
    print(f"[fused] cornell_box 600x450 16spp engine=fused: no BVH, so no kernel runs (launches {cn}); equal to the "
          f"regen frame on every pixel: {same}; wall {wall_f:.4f} s (regen {wall_g:.4f} s) | {smi}", flush=True)
    check(same and not any(cn.values()), f"fused cornell: equal {same}, launches {cn}")

    # the fused unicorn served with the batched transport
    fserver = Server({"flying_unicorn": uni}, cfg=fused_cfg, device="cuda")
    fr = fserver.renderer_for("flying_unicorn", 600, 450)
    msgs = []

    async def send_f(m) -> None:
        msgs.append(m)

    zero_counts()
    job = RenderJob(send=send_f)
    job.mark_running()
    t0 = time.perf_counter()
    stopped = asyncio.run(job.run(fr, 16, batch=True))
    wall = time.perf_counter() - t0
    path_launches_fused["fused flying_unicorn served"] = sc = launch_counts()
    served = np.zeros((450, 600, 3), np.uint8)
    for m in msgs:
        for _t, x, y, rgb in parse_chunks(m):
            served[y, x : x + rgb.shape[0]] = rgb
    same = bool(np.array_equal(served, fused_img))
    print(f"[fused] flying_unicorn served (batched, engine=fused): {len(msgs)} messages in {wall:.4f} s, launches "
          f"{sc}, equal to render_image(16): {same} | {smi}", flush=True)
    check(fr.engine == "fused" and not stopped and same, "fused: the served unicorn differs from render_image(16)")
    check(sc["K2"] > 0 and sc["K3"] > 0, f"fused served: launches {sc}")
    lap("fused")

    # 9b) the lockstep engine: cornell_box 600x450 64 spp with engine="simple"
    # (plain PyTorch on the card; twice, the first render loads its ops)
    ref = read_png(os.path.join(ROOT, "examples", "cornell_box.png")).astype(np.float64)
    r = Renderer(scenes["cornell_box"], RenderConfig(engine="simple"), device="cuda")
    check(r.engine == "simple" and r.plan(64) == (50, 16, 1), f"simple: engine {r.engine!r}, plan {r.plan(64)}")
    walls = []
    for _ in range(2):
        r.ray_counts.clear()
        t0 = time.perf_counter()
        img = r.render_image(64)
        walls.append(time.perf_counter() - t0)
    rays = r.rays_traced()
    mean, mad = float(img.mean()), float(np.abs(img - ref).mean())
    k1_wall, k1_rays = k1_render["cornell_box"]
    print(f"[simple] cornell_box 600x450 64spp engine=simple: 9 bands of 1.92M lanes, mean={mean:.3f} "
          f"(ref {ref.mean():.3f}) MAD={mad:.3f} wall={walls[1]:.4f} s (first render {walls[0]:.4f} s) rays={rays} "
          f"{rays / walls[1] / 1e6:.1f} Mrays/s; K1's frame: {k1_wall:.4f} s, {k1_rays / k1_wall / 1e6:.1f} Mrays/s "
          f"({walls[1] / k1_wall:.1f}x) | {smi}", flush=True)
    lo, hi = IMAGE_MEAN["cornell_box"]
    check(img.shape == (450, 600, 3), f"simple: image {img.shape}")
    check(lo <= mean <= hi, f"simple: image mean {mean:.3f} outside [{lo}, {hi}]")
    check(mad < IMAGE_MAD_MAX, f"simple: MAD {mad:.3f} >= {IMAGE_MAD_MAX}")
    lap("simple")

    # 9c) checkpoint and resume: cornell_box to 256 spp, four chunks of 16
    # samples over 9 bands; a chunk asks cancelled() ten times.
    zero_counts()
    r = Renderer(scenes["cornell_box"], RenderConfig(), device="cuda")
    check(r.plan(256) == (50, 16, 4), f"checkpoint: plan {r.plan(256)}")
    t0 = time.perf_counter()
    whole = render_with_checkpoint(r, "cornell_box", 256)
    whole_s = time.perf_counter() - t0
    asked = [0]

    def after_two_chunks() -> bool:
        asked[0] += 1
        return asked[0] > 20

    part = render_with_checkpoint(r, "cornell_box", 256, cancelled=after_two_chunks)
    check(part.num_samples == 32, f"checkpoint: cancelled at {part.num_samples} samples, not 32")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cornell.npz")
        part.save(path)
        size = os.path.getsize(path)
        loaded = RenderCheckpoint.load(path, "cornell_box", r.cfg)
    t0 = time.perf_counter()
    done = render_with_checkpoint(r, "cornell_box", 256, checkpoint=loaded)
    resume_s = time.perf_counter() - t0
    same = bool(np.array_equal(done.sums, whole.sums))
    mean = float(done.image().mean())
    path_launches = dict(path_launches_fused, **path_launches_ml, checkpoint=launch_counts())
    plain_mean = float(r.render_image(256).mean())
    print(f"[checkpoint] cornell_box 600x450 256spp: uninterrupted {whole_s:.4f} s; cancelled after 2 of 4 chunks "
          f"({part.num_samples} samples), saved ({size} bytes), loaded, resumed in {resume_s:.4f} s to "
          f"{done.num_samples} samples; sums equal on every element: {same}; image mean {mean:.3f} "
          f"(render_image(256): {plain_mean:.3f}); K1 launches {path_launches['checkpoint']['K1']} | {smi}", flush=True)
    check(done.num_samples == 64 and same, "checkpoint: the resumed sums differ from the uninterrupted render's")
    check(np.array_equal(done.image(), finalize(whole.sums, 64)[::-1]), "checkpoint: image() is not finalize of the sums")
    # The subpixels are clamped before they are averaged, so the mean rises
    # with the sample count: IMAGE_MEAN is the 64 spp bound, widened upward by
    # CHECKPOINT_MEAN_RISE for 256 spp, and the plain 256 spp frame is the
    # closer yardstick (other salts, the same estimator).
    check(lo <= mean <= hi + CHECKPOINT_MEAN_RISE,
          f"checkpoint: image mean {mean:.3f} outside [{lo}, {hi + CHECKPOINT_MEAN_RISE}]")
    check(abs(mean - plain_mean) < 0.5, f"checkpoint: image mean {mean:.3f} against render_image(256)'s {plain_mean:.3f}")
    check(path_launches["checkpoint"]["K1"] == 72,
          f"checkpoint: {path_launches['checkpoint']['K1']} K1 launches, not 36 + 18 + 18")
    lap("checkpoint")

    # 9d) row bands over [cuda:0, cuda:0]: the multi-device path on one card
    dev0 = torch.device("cuda", 0)
    pair = [dev0, dev0]
    sr = ShardedRenderer(scenes["cornell_box"], RenderConfig(), pair)
    rows_s, k_s, passes_s = sr.plan(64)
    half = rows_s // 2
    sums, n_rays = sr.render_band_sums(90, rows_s, k_s, passes_s, return_rays=True)
    total = 0
    for d in range(2):
        y0_d = 90 + d * half
        want, n_d = mk.render_band_mega(scenes["cornell_box"], sr.cfg, y0_d, half, k_s * passes_s,
                                        mk.band_seed(sr.cfg.seed, y0_d, 0))
        check(torch.equal(sums[d * half : (d + 1) * half], want),
              f"sharded: device band {d} differs from the plain band function")
        total += int(n_d)
    check(int(n_rays) == total, "sharded: the ray counts do not add up")
    zero_counts()
    t0 = time.perf_counter()
    img = sr.render_image(64)
    wall = time.perf_counter() - t0
    mean = float(img.mean())
    n_k1 = mk.LAUNCHES
    print(f"[sharded] cornell_box 600x450 64spp over [cuda:0, cuda:0]: bands of 2 x {half} rows, both device bands "
          f"equal to the plain band function; frame {wall:.4f} s in {n_k1} K1 launches (plain, one launch: "
          f"{k1_wall:.4f} s), mean={mean:.3f} | {smi}", flush=True)
    check(lo <= mean <= hi, f"sharded: image mean {mean:.3f} outside [{lo}, {hi}]")
    check(n_k1 == 2 * len(list(sr.iter_bands(64))), f"sharded: {n_k1} K1 launches")
    su = ShardedRenderer(uni, RenderConfig(), pair)
    k2_0, k3_0 = bt.LAUNCHES, keys.LAUNCHES
    t0 = time.perf_counter()
    img = su.render_image(16)
    wall = time.perf_counter() - t0
    equal = bool(np.array_equal(img, unicorn_frame))
    print(f"[sharded] flying_unicorn 600x450 16spp over [cuda:0, cuda:0]: plan {su.plan(16)}, {wall:.4f} s "
          f"(plain {unicorn_wall:.4f} s), K2 launches {bt.LAUNCHES - k2_0}, K3 launches "
          f"{keys.LAUNCHES - k3_0}, equal to the plain frame on every pixel: {equal} | {smi}", flush=True)
    check(equal, "sharded: the flying_unicorn frame differs from the plain renderer's")
    check(su.rays_traced() == unicorn_rays0, "sharded: the flying_unicorn ray count differs")
    img = with_variant("binary", lambda: ShardedRenderer(crew, RenderConfig(), pair).render_image(16))
    equal = bool(np.array_equal(img, variant_imgs["binary"]))
    print(f"[sharded] crewmate_phong 600x450 16spp RT_BVH_KERNEL=binary over [cuda:0, cuda:0]: K4 launches "
          f"{bb.LAUNCHES}, equal to the plain K4 frame on every pixel: {equal}", flush=True)
    check(equal, "sharded: the crewmate_phong K4 frame differs from the plain renderer's")
    path_launches["sharded"] = launch_counts()
    check(min(path_launches["sharded"].values()) > 0,
          f"the sharded path did not launch every kernel: {path_launches['sharded']}")
    lap("sharded")

    # 9e) a traced flying_unicorn frame, summarized by tools.top_ops
    trace_dir = os.path.join(ROOT, "chiprun_out", "trace")
    os.makedirs(trace_dir, exist_ok=True)
    for old in os.listdir(trace_dir):
        if ".trace.json" in old:
            os.remove(os.path.join(trace_dir, old))
    zero_counts()
    r = Renderer(uni, RenderConfig(), device="cuda")
    t0 = time.perf_counter()
    with device_trace(trace_dir, "cuda"):
        img = r.render_image(16)
    wall = time.perf_counter() - t0
    traced = path_launches["trace"] = launch_counts()
    check(np.array_equal(img, unicorn_frame), "trace: the traced frame differs from the plain one")
    events = top_ops.load_trace_events(trace_dir)
    device_events = top_ops.by_category(events, top_ops.DEVICE_CATS)
    check(len(device_events) > 0, "trace: the profiler recorded no device slice")
    for kname, kernel in (("K2", "bvh8_kernel"), ("K3", "key_kernel")):
        found, found_us = top_ops.summarize(device_events, like=kernel)
        n_found = sum(row[2] for row in found)
        print(f"[trace] {kname} {kernel}: {n_found} slices, {found_us / 1e3:.2f} ms in the trace; the wrapper "
              f"counted {traced[kname]} launches", flush=True)
        check(n_found == traced[kname] > 0, f"trace: {n_found} {kernel} slices for {traced[kname]} launches")
    busy_us, window_us = top_ops.device_busy(events)
    files = os.listdir(trace_dir)
    print(f"[trace] flying_unicorn 600x450 16spp under device_trace: {wall:.4f} s with the export (untraced "
          f"{unicorn_wall:.4f} s), {len(events)} slices ({len(device_events)} on the device) in {files}, "
          f"{sum(os.path.getsize(os.path.join(trace_dir, f)) for f in files)} bytes", flush=True)
    print(f"[trace] device busy {busy_us / 1e3:.1f} ms of a {window_us / 1e3:.1f} ms window: "
          f"{busy_us / window_us:.2%} busy, {1 - busy_us / window_us:.2%} idle | {smi}", flush=True)
    for what, cats in (("device kernels", top_ops.DEVICE_CATS), ("host ops", top_ops.HOST_CATS)):
        top, total_us = top_ops.summarize(top_ops.by_category(events, cats), top=10)
        for line in top_ops.format_rows(top, total_us, f"all {what}"):
            print(f"[trace] {what}: {line}", flush=True)
    lap("trace")

    # 9f) tools.parity on the card: every kernel against its twin
    zero_counts()
    for sname in ("flying_unicorn", "crewmate_phong"):
        check(parity.run(os.path.join(ROOT, "scenes", f"{sname}.toml"), device="cuda"),
              f"parity: {sname} kernels disagree with their twins")
    path_launches["parity"] = launch_counts()
    check(min(path_launches["parity"][kname] for kname in ("K2", "K3", "K4")) > 0,
          f"parity launched no kernel: {path_launches['parity']}")
    lap("parity")

    # 9g) bench_torch's run functions in this process, three timed renders a
    # config (cornell MIS: the single 64 spp render of the [time] lines)
    bench = {}

    def bench_run(key, kernels, run):
        # One run function with the counts set to 0 just before it and read
        # just after: it must launch each of ``kernels`` itself.
        zero_counts()
        bench[key] = run()
        path_launches[f"bench {key}"] = counts = launch_counts()
        check(min(counts[kname] for kname in kernels) > 0, f"bench: {key} launched no {kernels}: {counts}")

    for key, sname, spp, mis in bench_torch.CONFIGS:
        if not mis:
            bench_run(key, ("K1",) if sname in ("cornell_box", "cubes") else ("K2", "K3"),
                      lambda: bench_torch.run_config(sname, spp, mis, "cuda", repeats=3))
    bench_run("unicorn_16_serving", ("K2", "K3"), lambda: bench_torch.run_mesh_serving("cuda"))
    bench_run("progressive_1080p", ("K1",), lambda: bench_torch.run_progressive("cuda"))
    print("[bench] " + json.dumps({"card": smi, "transport": "in_process", "configs": bench}), flush=True)
    check(all(np.isfinite(v["wall_s"]) and v["rays"] > 0 for k, v in bench.items() if "rays" in v),
          "bench: a config without rays or wall")
    check(bench["progressive_1080p"]["passes_measured"] == 3, "bench: the progressive run measured no three sweeps")
    lap("bench")

    # 9h) the band step of __graft_entry_torch__.entry()
    import __graft_entry_torch__ as graft

    step, step_args = graft.entry()
    sums, n_rays = step(*step_args)
    torch.cuda.synchronize()
    print(f"[entry] __graft_entry_torch__.entry(): sums {tuple(sums.shape)} on {sums.device}, mean "
          f"{sums.mean().item():.4f}, rays {int(n_rays)}", flush=True)
    check(sums.shape == (8, 64, 4, 3) and sums.is_cuda and torch.isfinite(sums).all().item(),
          "entry: the band step's sums are not finite [8, 64, 4, 3] on the card")
    check(int(n_rays) > 0, "entry: no rays counted")
    for path, counts in path_launches.items():
        print(f"[launches] {path}: {counts}", flush=True)
    lap("entry")

    # 9i) [variants]: the measurement hooks on flying_unicorn 600x450 16 spp.
    # The default and every variant render in turn, three rounds: walls are
    # medians of 3, launches and images the last round's (each render is
    # deterministic). Then each variant's traversal and K3 kernel time.
    variants = (
        ("RT_PERMUTE_STATE=1", "equal"), ("RT_PERMUTE_STATE=1 RT_SORT_GROUP=8", "equal"),
        ("RT_SHADOW_COMPACT=1", "equal"),
        ("RT_STATE_BF16=1", "rounded"), ("RT_SHADOW_REVERSE=1", "rounded"), ("RT_DEFER_SHADOW=1", "regrouped"),
        ("RT_ABLATE=shadow", "probe"), ("RT_ABLATE=rng", "probe"),
    )

    def env_of(label: str) -> dict:
        return dict(kv.split("=") for kv in label.split()) if label != "default" else {}

    def variant_frame(scene):
        r = Renderer(scene, RenderConfig(), device="cuda")
        r.render_image(16)
        r.ray_counts.clear()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = r.render_image(16)
        return img, time.perf_counter() - t0, launch_counts(), r.rays_traced()

    v_walls = {label: [] for label in ["default"] + [v for v, _ in variants]}
    v_out = {}
    for _ in range(3):
        for label in v_walls:
            v_out[label] = with_env(env_of(label), lambda: variant_frame(uni))
            v_walls[label].append(v_out[label][1])
    med = {label: sorted(w)[1] for label, w in v_walls.items()}
    base, _, base_counts, base_rays = v_out["default"]
    check(np.array_equal(base, unicorn_frame), "variants: the default frame differs from the BVH path's")
    path_launches["variants default"] = base_counts
    print(f"[variants] flying_unicorn 600x450 16spp default: wall {med['default']:.4f} s "
          f"{[round(x, 4) for x in v_walls['default']]}, launches a frame {base_counts}, rays {base_rays} | {smi}",
          flush=True)
    for label, kind in variants:
        img8, _, counts, rays = v_out[label]
        img = img8.astype(np.float64)
        same = float((img8 == base).all(axis=2).mean())
        d_mean, mad = img.mean() - base.mean(), float(np.abs(img - base).mean())
        path_launches[f"variant {label}"] = counts
        bd = with_env(env_of(label), lambda: breakdown(uni, 16, f"flying_unicorn {label} (K2)", "regen",
                                                       wall=med[label] * 1e3))
        print(f"[variants] flying_unicorn 600x450 16spp {label}: wall {med[label]:.4f} s "
              f"{[round(x, 4) for x in v_walls[label]]} against the default's {med['default']:.4f} s "
              f"(x{med[label] / med['default']:.3f}); launches a frame K2 {counts['K2']} K3 {counts['K3']} K4 "
              f"{counts['K4']}; traversal {bd['trav_ms']:.1f} ms, K3 {bd['k3_ms']:.1f} ms; rays {rays} "
              f"({rays / base_rays:.4f} of the default's); equal to the default on {same:.6%} of pixels, mean "
              f"{img.mean():.3f} ({d_mean:+.4f}), MAD {mad:.4f} | {smi}", flush=True)
        check(np.isfinite(img).all() and counts["K2"] > 0 and counts["K3"] > 0 and counts["K4"] == 0,
              f"variants {label}: launches {counts}")
        if kind == "equal":
            check(same == 1.0 and rays == base_rays, f"variants {label}: equal on {same:.4%} of pixels, rays {rays}")
        elif kind == "rounded":
            check(abs(d_mean) <= VARIANT_MEAN and mad <= uni_mad01 + UNICORN_MAD_MARGIN,
                  f"variants {label}: mean {d_mean:+.4f}, MAD {mad:.4f} (seeds {uni_mad01:.4f})")
        elif kind == "regrouped":
            check(same >= DEFER_PIXEL_SHARE and abs(d_mean) <= DEFER_MEAN,
                  f"variants {label}: equal on {same:.4%} of pixels, mean {d_mean:+.4f}")
    # The shadow chain leaves with RT_ABLATE=shadow (one K2 and one K3 a
    # main trace), and with RT_SHADOW_REVERSE / RT_DEFER_SHADOW its K3.
    sh = v_out["RT_ABLATE=shadow"][2]
    check(sh["K2"] == sh["K3"] == base_counts["K3"] // 2, f"RT_ABLATE=shadow: launches {sh}")
    for label in ("RT_SHADOW_REVERSE=1", "RT_DEFER_SHADOW=1"):
        c = v_out[label][2]
        check(c["K2"] == 2 * c["K3"] and c["K3"] < base_counts["K3"], f"{label}: launches {c}")
    d_sh, d_rng = med["default"] - med["RT_ABLATE=shadow"], med["default"] - med["RT_ABLATE=rng"]
    rays_rng = v_out["RT_ABLATE=rng"][3]
    print(f"[variants] the glue's split, flying_unicorn 600x450 16spp: default {med['default']:.4f} s; "
          f"RT_ABLATE=shadow {med['RT_ABLATE=shadow']:.4f} s, so the shadow chain (its K3, sort, gathers, K2, "
          f"unsort, visibility) costs {d_sh:.4f} s ({d_sh / med['default']:.2%}); RT_ABLATE=rng "
          f"{med['RT_ABLATE=rng']:.4f} s, so the counter hash of the shading draws costs {d_rng:.4f} s "
          f"({d_rng / med['default']:.2%}), with {rays_rng} rays against {base_rays} (constant draws change "
          f"the paths: per ray {med['RT_ABLATE=rng'] / rays_rng * 1e9:.2f} ns against "
          f"{med['default'] / base_rays * 1e9:.2f} ns) | {smi}", flush=True)

    # Rows 1-3 on crewmate_phong under K4: frames equal to its K4 frame.
    for label, _ in variants[:3]:
        img, _, counts, _ = with_env({"RT_BVH_KERNEL": "binary", **env_of(label)}, lambda: variant_frame(crew))
        path_launches[f"variant {label} crewmate K4"] = counts
        same = bool(np.array_equal(img, variant_imgs["binary"]))
        print(f"[variants] crewmate_phong 600x450 16spp RT_BVH_KERNEL=binary {label}: launches {counts}, equal to "
              f"the K4 frame on every pixel: {same}", flush=True)
        check(same and counts["K4"] > 0 and counts["K2"] == 0, f"variants crewmate K4 {label}: {same}, {counts}")

    # RT_SHADOW_COMPACT on the frame's any-hit shadow class (the regen
    # engine issues no any-hit query), as drawn and with every second ray
    # resolved (as culled and parked lanes are): "1" equal to the plain
    # wrapper, "force" at half width; wrapper walls, medians of 3.
    s_ro, s_rd, s_bound, s_res0, _ = classes["shadow-any-hit"]
    n_half = (-(-n_frame // bt.PACKET) + 1) // 2 * bt.PACKET
    for cname, res0 in (("as drawn", s_res0), ("half resolved", s_res0 | (torch.arange(n_frame, device="cuda") % 2 == 0))):
        key = keys.coherence_key_cuda(uni, s_ro, s_rd, cfg.eps) | (res0.to(torch.int32) << 30)
        n_live = int(((key >> 30) == 0).sum())
        outs, ms_c = {}, {}
        for mode in ("0", "1", "force"):
            def any_hit_trace():
                return bt.bvh_intersect(uni, s_ro, s_rd, cfg.eps, t_init=s_bound, any_hit=True, resolved0=res0)

            outs[mode] = with_env({"RT_SHADOW_COMPACT": mode}, any_hit_trace)
            ms_c[mode] = sorted(with_env({"RT_SHADOW_COMPACT": mode}, lambda: wall_ms(any_hit_trace))
                                for _ in range(3))[1]
        same = torch.equal(outs["1"][0], outs["0"][0]) and torch.equal(outs["1"][1], outs["0"][1])
        occ = {m: int((o[0] < s_bound).sum()) for m, o in outs.items()}
        print(f"[variants] RT_SHADOW_COMPACT on {n_frame} unicorn any-hit shadow rays ({cname}): {n_live} live "
              f"(half width {n_half}); wrapper ms 0 / 1 / force: {ms_c['0']:.3f} / {ms_c['1']:.3f} / "
              f"{ms_c['force']:.3f}; \"1\" equal to \"0\" on every ray: {same}; occluded 0 / 1 / force: "
              f"{occ['0']} / {occ['1']} / {occ['force']} | {smi}", flush=True)
        check(same, f"RT_SHADOW_COMPACT=1 changed a result ({cname})")

    # RT_LEAF_TRIS: K2 against its twin with 0 and 8 rows a leaf, and K2's
    # time with 0, 8 and 64 on the sorted bounce rays, each beside the bound
    # of the work the twin counts with that many rows.
    leaf_ms, leaf_bound = {}, {}
    k2_tables = uni.bvh8_nodes_flat.numel() * 4 + uni.bvh_leaf_tris.numel() * 4
    for k in (0, 8, 64):
        v: dict = {}
        t_t, i_t = bt.bvh_traverse_twin(*bounce_args, visits=v, leaf_tris=k)
        t_k, i_k = bt.bvh_traverse_cuda(*bounce_args, leaf_tris=k)
        torch.cuda.synchronize()
        same = (t_k == t_t).double().mean().item()
        diff = i_k != i_t
        ties = torch.equal(bt.leaf_t(uni, bounce_args[1], bounce_args[2], i_k)[diff],
                           bt.leaf_t(uni, bounce_args[1], bounce_args[2], i_t)[diff])
        check(same >= bt.T_EXACT_SHARE and ties, f"K2 with leaf_tris={k}: t equal on {same:.6%}, ties {ties}")
        leaf_ms[k] = event_ms(lambda: bt.bvh_traverse_cuda(*bounce_args, leaf_tris=k), 10)
        leaf_bound[k] = bound_ms(*walk_work(K2_OPS, v, n_frame, k2_tables))[0]
        print(f"[variants] K2 RT_LEAF_TRIS={k} on {n_frame} sorted unicorn bounce rays: t bit-equal to the twin on "
              f"{same:.6%} (differing indices ties: {ties}); per ray {v['nodes'] / n_frame:.4f} nodes, "
              f"{v['leaves'] / n_frame:.4f} leaves, {v['tris'] / n_frame:.3f} triangles tested; kernel "
              f"{leaf_ms[k]:.4f} ms, bound {leaf_bound[k]:.4f} ms | {smi}", flush=True)
    print(f"[variants] K2 split: {leaf_ms[0]:.4f} ms the walk without leaf tests, {leaf_ms[64] - leaf_ms[0]:.4f} ms "
          f"the leaf tests ({(leaf_ms[64] - leaf_ms[0]) / leaf_ms[64]:.2%}); 8 rows a leaf {leaf_ms[8]:.4f} ms "
          f"(the walk then prunes less: each time is a bound of its part) | {smi}", flush=True)
    for path in [p for p in path_launches if p.startswith("variant")]:
        print(f"[launches] {path}: {path_launches[path]}", flush=True)
    lap("variants")

    # 10) times. K1: the main path's launch (a whole 600x450 frame, 1.08M
    # lanes) at 64 spp beside its twin, and at 256 spp (the headline frame);
    # a 50-row band at 16 samples (the launch of the served path) beside its
    # twin.
    pf, static = mk.pack_params(scenes["cornell_box"], cfg)
    band_ms = event_ms(lambda: mk.mega_cuda(pf, static, y0, 16, n, seed, "cuda"), 20)
    band_twin_ms = wall_ms(lambda: mk.mega_twin(pf, static, y0, 16, n, seed, "cuda"))
    print(f"[time] K1 cornell band 600x50 16 samples: kernel {band_ms:.4f} ms, twin {band_twin_ms:.1f} ms | {smi}")
    r = Renderer(scenes["cornell_box"], cfg, device="cuda")
    rows_f = r.plan(256)[0]
    n_f = rows_f * w * 4
    bands = [(yy, mk.band_seed(cfg.seed, yy, 0)) for yy in range(0, cfg.height, rows_f)]
    lanes_f = len(bands) * n_f

    def k1_frame(samples):
        return mk.mega_cuda_bands(pf, static, bands, samples, n_f, "cuda")

    kernel_ms = event_ms(lambda: k1_frame(16), 5)
    twin_ms = wall_ms(lambda: [mk.mega_twin(pf, static, yy, 16, n_f, sd, "cuda") for yy, sd in bands])
    k1_rays = int(k1_frame(16)[1].sum())
    k1_ops, k1_bytes = k1_work(static, lanes_f, 16, k1_rays, shadow_share["cornell_box"])
    k1_bound, k1_by, k1_instr = bound_ms(k1_ops, k1_bytes)
    print(f"[time] K1 cornell_box 64spp frame (one launch: {len(bands)} bands, {lanes_f} lanes, 16 samples): kernel "
          f"{kernel_ms:.4f} ms, twin {twin_ms:.1f} ms; {k1_rays} rays, {k1_ops:.4g} operations, {k1_bytes} bytes: "
          f"bound {k1_bound:.4f} ms ({k1_by}; {k1_instr:.4f} ms at the FMA-free instruction rate), "
          f"{k1_bound / kernel_ms:.2%} of it reached | {smi}", flush=True)
    t256 = event_ms(lambda: k1_frame(64), 3)
    k1_256_rays = int(k1_frame(64)[1].sum())
    ops256, bytes256 = k1_work(static, lanes_f, 64, k1_256_rays, shadow_share["cornell_box"])
    b256, by256, instr256 = bound_ms(ops256, bytes256)
    print(f"[time] K1 cornell_box 256spp frame (one launch, 64 samples): kernel {t256:.4f} ms; {k1_256_rays} "
          f"rays, bound {b256:.4f} ms ({by256}; {instr256:.4f} ms at the FMA-free instruction rate), "
          f"{b256 / t256:.2%} of it reached | {smi}", flush=True)
    # K3 on the frame's camera rays, K2 on its coherence-sorted bounce rays.
    # A K3 launch is shorter than its wrapper's host time, so its 20 launches
    # are queued behind a spacer: the events time the kernel, not the host.
    k3_ms = event_ms(lambda: keys.coherence_key_cuda(uni, cam[0], cam[1], cfg.eps), 20, RUN_SPACER)
    k3_twin_ms = wall_ms(lambda: keys.coherence_key_twin(uni, cam[0], cam[1], cfg.eps))
    n_cam = cam[0][0].numel()
    n_cut = uni.bvh_cut_lo.shape[0]
    k3_bound, k3_by, _ = bound_ms(n_cam * (K3_OPS["ray"] + n_cut * K3_OPS["cut"]), n_cam * 28 + (n_cut + 1) * 24)
    print(f"[time] K3 {n_cam} camera rays: kernel {k3_ms:.4f} ms (queued behind a spacer), twin {k3_twin_ms:.2f} ms; per 1M rays "
          f"{k3_ms * 1e6 / n_cam:.4f} / {k3_twin_ms * 1e6 / n_cam:.2f} ms; bound {k3_bound:.4f} ms ({k3_by}), "
          f"{k3_bound / k3_ms:.2%} of it reached | {smi}", flush=True)
    k2_ms = event_ms(lambda: bt.bvh_traverse_cuda(*bounce_args), 10)
    k2_twin_ms = wall_ms(lambda: bt.bvh_traverse_twin(*bounce_args))
    table_bytes = lambda sc, nodes: nodes.numel() * 4 + sc.bvh_leaf_tris.numel() * 4  # noqa: E731
    k2_ops, k2_bytes = walk_work(K2_OPS, visits["K2", "flying_unicorn"], n_frame,
                                 table_bytes(uni, uni.bvh8_nodes_flat))
    k2_bound, k2_by, k2_instr = bound_ms(k2_ops, k2_bytes)
    print(f"[time] K2 {n_frame} sorted unicorn bounce rays: kernel {k2_ms:.4f} ms, twin {k2_twin_ms:.2f} ms; per 1M "
          f"rays {k2_ms * 1e6 / n_frame:.4f} / {k2_twin_ms * 1e6 / n_frame:.2f} ms; {k2_ops:.4g} operations, "
          f"{k2_bytes} bytes: bound {k2_bound:.4f} ms ({k2_by}; {k2_instr:.4f} ms at the FMA-free instruction rate), "
          f"{k2_bound / k2_ms:.2%} of it reached | {smi}", flush=True)
    # K4 on the frame's sorted crewmate bounce rays beside K2 on the same
    # rays, and on the unicorn's.
    k4_ms = event_ms(lambda: bb.bvh_binary_cuda(*crew_bounce), 10)
    k4_twin_ms = wall_ms(lambda: bb.bvh_binary_twin(*crew_bounce))
    k2_crew_ms = event_ms(lambda: bt.bvh_traverse_cuda(*crew_bounce), 10)
    k4_uni_ms = event_ms(lambda: bb.bvh_binary_cuda(*bounce_args), 10)
    k4_ops, k4_bytes = walk_work(K4_OPS, visits["K4", "crewmate_phong"], n_frame,
                                 table_bytes(crew, crew.bvh_octant_nodes))
    k4_bound, k4_by, k4_instr = bound_ms(k4_ops, k4_bytes)
    k2c_bound = bound_ms(*walk_work(K2_OPS, visits["K2", "crewmate_phong"], n_frame,
                                    table_bytes(crew, crew.bvh8_nodes_flat)))[0]
    k4u_bound = bound_ms(*walk_work(K4_OPS, visits["K4", "flying_unicorn"], n_frame,
                                    table_bytes(uni, uni.bvh_octant_nodes)))[0]
    print(f"[time] K4 {n_frame} sorted crewmate bounce rays: kernel {k4_ms:.4f} ms, twin {k4_twin_ms:.2f} ms, "
          f"K2 {k2_crew_ms:.4f} ms; per 1M rays {k4_ms * 1e6 / n_frame:.4f} / {k4_twin_ms * 1e6 / n_frame:.2f} / "
          f"{k2_crew_ms * 1e6 / n_frame:.4f} ms; bound K4 {k4_bound:.4f} ms ({k4_by}; {k4_instr:.4f} ms FMA-free), "
          f"K2 {k2c_bound:.4f} ms | {smi}", flush=True)
    print(f"[time] K4 {n_frame} sorted unicorn bounce rays: kernel {k4_uni_ms:.4f} ms, K2 {k2_ms:.4f} ms; per 1M "
          f"rays {k4_uni_ms * 1e6 / n_frame:.4f} / {k2_ms * 1e6 / n_frame:.4f} ms; bound K4 {k4u_bound:.4f} ms "
          f"| {smi}", flush=True)
    for s in SCENES:
        r = Renderer(scenes[s], RenderConfig(), device="cuda")
        for spp in (64, 256):
            r.ray_counts.clear()
            t0 = time.perf_counter()
            r.render_image(spp)
            wall = time.perf_counter() - t0
            rays = r.rays_traced()
            print(f"[time] {s} 600x450 {spp}spp: {wall:.4f} s, {rays / wall / 1e6:.1f} Mrays/s | {smi}",
                  flush=True)
    per_frame = {"K1": k1_per_frame["cornell_box"]}
    bd = breakdown(uni, 16, "flying_unicorn (K2)")
    per_frame["K2"], per_frame["K3"] = bd["n_trav"], bd["n_k3"]
    print(f"[time] flying_unicorn 600x450 16spp: {unicorn_wall:.4f} s, "
          f"{unicorn_rays_n / unicorn_wall / 1e6:.2f} Mrays/s | {smi}", flush=True)
    for variant, label in (("widesmem", "K2"), ("binary", "K4")):
        n_trav = with_variant(variant, lambda: breakdown(crew, 16, f"crewmate_phong ({label})"))["n_trav"]
    per_frame["K4"] = n_trav
    # The fused engine: K2, K4 and K3 on its double-width batch (2.16M rays
    # sorted by the key, a sixth parked), then its frames' breakdowns.
    k2_fused_ms = event_ms(lambda: bt.bvh_traverse_cuda(*fused_args), 10)
    k4_fused_ms = event_ms(lambda: bb.bvh_binary_cuda(*fused_args), 10)
    k3_fused_ms = event_ms(lambda: keys.coherence_key_cuda(uni, f_ro, f_rd, cfg.eps), 20, RUN_SPACER)
    print(f"[time] fused batch, {2 * n_frame} unicorn rays (bounce + bounded shadow, a sixth parked): K2 "
          f"{k2_fused_ms:.4f} ms, K4 {k4_fused_ms:.4f} ms (sorted), K3 {k3_fused_ms:.4f} ms (behind a spacer) "
          f"| {smi}", flush=True)
    breakdown(uni, 16, "flying_unicorn fused (K2)", "fused")
    with_variant("binary", lambda: breakdown(crew, 16, "crewmate_phong fused (K4)", "fused"))
    # cornell MIS: the 64 spp render of the Phong/MIS path (its 256 spp
    # render, ~95 s, left the script when [variants] came).
    print(f"[time] cornell_box MIS 600x450 64spp (regen): {mis_wall:.4f} s, {mis_rays / mis_wall / 1e6:.1f} Mrays/s "
          f"| {smi}", flush=True)

    lap("times")
    none = "no single PyTorch call computes this function"
    print(json.dumps({"kernels": [
        {
            "name": "mega_kernel", "route": "cuda",
            "source": "raytracer_tpu_torch/ops/csrc/megakernel.cu",
            "replaces": "raytracer_tpu/ops/pallas/megakernel.py:96",
            "launches": launches["K1"], "max_abs_err": max_err,
            "ms": kernel_ms, "plain_ms": twin_ms, "bound_ms": k1_bound, "bound_by": k1_by,
            "library_ms": None, "library": none, "launches_per_frame": per_frame["K1"],
            "launches_per_fused_frame": 0,
            "redesigned": REDESIGNED["K1"], "launches_by_path": {path: counts["K1"] for path, counts in path_launches.items()},
        },
        {
            "name": "bvh8_kernel", "route": "cuda",
            "source": "raytracer_tpu_torch/ops/csrc/bvh8.cu",
            "replaces": "raytracer_tpu/ops/pallas/bvh_kernel.py:159",
            "launches": launches["K2"], "max_abs_err": k2_err,
            "ms": k2_ms, "plain_ms": k2_twin_ms, "bound_ms": k2_bound, "bound_by": k2_by,
            "library_ms": None, "library": none, "launches_per_frame": per_frame["K2"],
            "launches_per_fused_frame": fc["K2"],
            "leaf_tris_ms": {str(k): t for k, t in leaf_ms.items()},
            "leaf_tris_bound_ms": {str(k): t for k, t in leaf_bound.items()},
            "redesigned": REDESIGNED["K2"], "launches_by_path": {path: counts["K2"] for path, counts in path_launches.items()},
        },
        {
            "name": "key_kernel", "route": "cuda",
            "source": "raytracer_tpu_torch/ops/csrc/coherence_key.cu",
            "replaces": "raytracer_tpu/ops/pallas/key_kernel.py:41",
            "launches": launches["K3"], "max_abs_err": key_err,
            "ms": k3_ms, "plain_ms": k3_twin_ms, "bound_ms": k3_bound, "bound_by": k3_by,
            "library_ms": None, "library": none, "launches_per_frame": per_frame["K3"],
            "launches_per_fused_frame": fc["K3"],
            "redesigned": REDESIGNED["K3"], "launches_by_path": {path: counts["K3"] for path, counts in path_launches.items()},
        },
        {
            "name": "bvh_binary_kernel", "route": "cuda",
            "source": "raytracer_tpu_torch/ops/csrc/bvh_binary.cu",
            "replaces": "raytracer_tpu/ops/pallas/bvh_kernel.py:48",
            "launches": launches["K4"], "max_abs_err": k4_err,
            "ms": k4_ms, "plain_ms": k4_twin_ms, "bound_ms": k4_bound, "bound_by": k4_by,
            "library_ms": None, "library": none, "launches_per_frame": per_frame["K4"],
            "launches_per_fused_frame": cc["K4"],
            "redesigned": REDESIGNED["K4"], "launches_by_path": {path: counts["K4"] for path, counts in path_launches.items()},
        },
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
