"""Each design step of K1 (``ops/csrc/megakernel.cu``), K2
(``ops/csrc/bvh8.cu``), K3 (``ops/csrc/coherence_key.cu``) and K4
(``ops/csrc/bvh_binary.cu``) against its alternative, on one CUDA card:
``python -m raytracer_tpu_torch.tools.kernel_steps [--out FILE] [--only K3,K4]
[--sass DIR]`` (``--sass``: each variant's ``cuobjdump -sass`` listing).

An alternative is built from the shipped source by replacing named parts of
it (``EDITS``), so that everything else is the shipped code; each part must
occur exactly once, or the script stops. Every variant, the shipped source
included, is compiled with the port's nvcc flags into
``build/raytracer_tpu_torch/steps/`` (one nvcc each, all at once), and its
``-Xptxas -v`` line is printed. The port's own wrappers launch each variant
(their library is swapped for the variant's), so arguments and checks are
the shipped ones. A variant is held to the shipped kernel on every lane or
ray (K1: sums and ray counts equal; K2 and K4: t and index equal; K3: keys
equal) before it is timed by CUDA events, in turns with the shipped kernel
(shipped, variant, variant, shipped; twice for K3 and K4). A K3 launch is
shorter than its wrapper's host time, so its launches are queued behind a
device-side spacer (``SPACER_CYCLES``).

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

K3, on the frame's 1,080,000 camera rays of flying_unicorn and of
crewmate_phong (keys held equal on the camera and the bounce rays):

- ``runtime_loop``: the cut count at run time (``key_kernel<0>``, which
  serves every count but 32, and the first port's form), against the count
  at compile time;
- ``full_unroll``: the loop over the 32 boxes unrolled in full, every table
  value an immediate constant operand, against eight boxes at a time;
- ``two_rays`` and ``four_rays``: rays a thread, their loads started before
  the first slab test, against the shipped one;
- ``octant_scan``: a warp whose rays all share the signs of their inverse
  directions takes a scan specialised for those signs, in which an axis'
  near and far plane are known and need no minimum and maximum (eight
  instantiations beside the general scan), against the general scan for
  every warp;
- ``sign_select``: an axis' near and far plane picked by the sign of the
  inverse direction, per ray and cut, instead of the minimum and maximum of
  the two products.

Each K3 variant is timed twice: on the camera rays (every warp of one
octant) and on the bounce rays in lane order (random octants in a warp).

K4, on the rays K2 is timed on:

- ``node12``: the first port's 48-byte node, three float4s with ``first``
  in the third, loaded in front of a leaf's rows, against 32 bytes a node;
- ``one_node_a_turn``: one node a turn of the loop, a leaf's rows tested in
  the turn that enters it (the first port's loop), against walking on until
  a leaf is entered;
- ``fetch_ahead``: node i + 1 loaded while node i's slab test runs (the next
  node after every hit and every leaf), against a node loaded only once the
  walk knows it is next;
- ``leaf_loop_rolled`` and ``leaf_unroll_2``: a leaf's rows one or two at a
  time, against four;
- ``fixed_order``: every ray walks the tree's own pre-order, against the
  layout of its direction octant, near child first (t equal on every ray;
  an index may differ where two triangles tie in t).

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
import dataclasses
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


# K3's octant_scan variant: the scan as a function specialised for the signs
# of the inverse direction, and the warp's vote that picks it.
_K3_OCTANT_SCAN = '''// The cut box each of a thread's rays enters first, into best_t and best_i.
// OCT >= 0: the signs of the rays' inverse directions (bit k: negative along
// axis k), the same for every ray, so which of an axis' two planes is the
// near one is known here; OCT < 0: any signs, the near and far plane by the
// minimum and maximum of the two products (the same two products, so the
// same bits either way: a box has lo <= hi and rounding is monotone).
template <int NC, int OCT, class Table>
__device__ __forceinline__ void nearest_cut(const Table& tab, int n_cut,
                                            const float (&ro)[KEY_RAYS][3],
                                            const float (&inv)[KEY_RAYS][3], float tri_tmin,
                                            float (&best_t)[KEY_RAYS], int (&best_i)[KEY_RAYS]) {
#pragma unroll 8
  for (int c = 0; c < n_cut; ++c) {
#pragma unroll
    for (int r = 0; r < KEY_RAYS; ++r) {
      float tnear = 0.0f, tfar = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float lo, hi;
        if (OCT < 0) {
          const float t0 = (tab.box[c][k] - ro[r][k]) * inv[r][k];
          const float t1 = (tab.box[c][3 + k] - ro[r][k]) * inv[r][k];
          lo = fminf(t0, t1);
          hi = fmaxf(t0, t1);
        } else {
          const bool back = (OCT >> k) & 1;
          lo = (tab.box[c][back ? 3 + k : k] - ro[r][k]) * inv[r][k];
          hi = (tab.box[c][back ? k : 3 + k] - ro[r][k]) * inv[r][k];
        }
        tnear = k == 0 ? lo : fmaxf(tnear, lo);
        tfar = k == 0 ? hi : fminf(tfar, hi);
      }
      // A box the ray misses enters at infinity; strict <: ties keep the
      // lower cut index.
      if (tnear <= tfar && tfar > tri_tmin && tnear < best_t[r]) {
        best_t[r] = tnear;
        best_i[r] = c;
      }
    }
  }
}

'''

_K3_OCTANT_DISPATCH = '''  // Where every ray of the warp shares its inverse direction's signs (camera
  // rays, shadow rays towards one light, sorted rays), the warp takes the
  // scan written for those signs, which needs no minimum or maximum to tell
  // an axis' near plane from its far one. No thread has left: all 32 vote.
  int signs = 0;
  bool same = true;
#pragma unroll
  for (int r = 0; r < KEY_RAYS; ++r) {
    const int sr = (inv[r][0] < 0.0f ? 1 : 0) + (inv[r][1] < 0.0f ? 2 : 0) + (inv[r][2] < 0.0f ? 4 : 0);
    if (r == 0) signs = sr;
    same = same && sr == signs;
  }
  const int warp_signs = __shfl_sync(0xffffffffu, signs, 0);
  const bool uniform = __all_sync(0xffffffffu, same && signs == warp_signs);
  if (uniform) {
    switch (warp_signs) {
      case 0: nearest_cut<NC, 0>(tab, n_cut, ro, inv, tri_tmin, best_t, best_i); break;
      case 1: nearest_cut<NC, 1>(tab, n_cut, ro, inv, tri_tmin, best_t, best_i); break;
      case 2: nearest_cut<NC, 2>(tab, n_cut, ro, inv, tri_tmin, best_t, best_i); break;
      case 3: nearest_cut<NC, 3>(tab, n_cut, ro, inv, tri_tmin, best_t, best_i); break;
      case 4: nearest_cut<NC, 4>(tab, n_cut, ro, inv, tri_tmin, best_t, best_i); break;
      case 5: nearest_cut<NC, 5>(tab, n_cut, ro, inv, tri_tmin, best_t, best_i); break;
      case 6: nearest_cut<NC, 6>(tab, n_cut, ro, inv, tri_tmin, best_t, best_i); break;
      default: nearest_cut<NC, 7>(tab, n_cut, ro, inv, tri_tmin, best_t, best_i); break;
    }
  } else {
    nearest_cut<NC, -1>(tab, n_cut, ro, inv, tri_tmin, best_t, best_i);
  }
'''


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
        ("      for (int j = 0; j < n_rows; ++j) {\n", None,
         "      for (int j = 0; j < p.max_leaf; ++j) {\n"),
    ]),
    "K3_shipped": ("coherence_key", []),
    "K3_runtime_loop": ("coherence_key", [
        ("n_cut == KEY_STATIC_CUT ? key_kernel<KEY_STATIC_CUT> : key_kernel<0>", None, "key_kernel<0>"),
    ]),
    "K3_two_rays": ("coherence_key", [("#define KEY_RAYS 1\n", None, "#define KEY_RAYS 2\n")]),
    "K3_four_rays": ("coherence_key", [("#define KEY_RAYS 1\n", None, "#define KEY_RAYS 4\n")]),
    "K3_full_unroll": ("coherence_key", [
        ("#pragma unroll 8\n  for (int c = 0; c < n_cut; ++c) {\n", None,
         "#pragma unroll\n  for (int c = 0; c < n_cut; ++c) {\n"),
    ]),
    "K3_octant_scan": ("coherence_key", [
        ("#pragma unroll 8\n  for (int c = 0; c < n_cut; ++c) {\n", "        best_i[r] = c;\n      }\n    }\n  }\n",
         _K3_OCTANT_DISPATCH),
        ("// NC > 0: the cut count at compile time", None,
         _K3_OCTANT_SCAN + "// NC > 0: the cut count at compile time"),
    ]),
    "K3_sign_select": ("coherence_key", [
        ("        const float lo = fminf(t0, t1), hi = fmaxf(t0, t1);\n", None,
         "        const bool back = inv[r][k] < 0.0f;\n"
         "        const float lo = back ? t1 : t0, hi = back ? t0 : t1;\n"),
    ]),
    "K4_shipped": ("bvh_binary", []),
    "K4_node12": ("bvh_binary", [
        ("#define NODE_F4 2 ", None, "#define NODE_F4 3 "),
        ("          first = link;\n", None,
         "          first = (int)__ldg(nd + NODE_F4 * (node - 1) + 2).x;\n"),
    ]),
    "K4_fetch_ahead": ("bvh_binary", [
        ("  int node = (p.any_hit && resolved0[i] != 0) ? p.n_nodes : 0;\n", None,
         "  int node = (p.any_hit && resolved0[i] != 0) ? p.n_nodes : 0;\n"
         "  const int last = p.n_nodes - 1;\n"
         "  float4 a = __ldg(nd), b = __ldg(nd + 1);\n"),
        ("      const float4 a = __ldg(nd + NODE_F4 * node);      // lo.xyz link\n"
         "      const float4 b = __ldg(nd + NODE_F4 * node + 1);  // hi.xyz count\n", None,
         "      const int ahead = min(node + 1, last);  // the next node in pre-order\n"
         "      const float4 na = __ldg(nd + NODE_F4 * ahead), nb = __ldg(nd + NODE_F4 * ahead + 1);\n"),
        ("        node += 1;\n        if (hit && rows > 0) {\n", None,
         "        node += 1;\n        a = na;\n        b = nb;\n        if (hit && rows > 0) {\n"),
        ("        node = link;\n      }\n", None,
         "        node = link;\n"
         "        if (node <= last) {\n"
         "          a = __ldg(nd + NODE_F4 * node);\n"
         "          b = __ldg(nd + NODE_F4 * node + 1);\n"
         "        }\n"
         "      }\n"),
    ]),
    "K4_one_node_a_turn": ("bvh_binary", [
        ("    while (node < p.n_nodes) {  // walk on\n", None, "    do {\n"),
        ("    }  // a leaf entered, or the walk over\n", None, "    } while (false);\n"),
    ]),
    "K4_leaf_loop_rolled": ("bvh_binary", [("#define LEAF_UNROLL 4\n", None, "#define LEAF_UNROLL 1\n")]),
    "K4_leaf_unroll_2": ("bvh_binary", [("#define LEAF_UNROLL 4\n", None, "#define LEAF_UNROLL 2\n")]),
    "K4_fixed_order": ("bvh_binary", [
        ("  const int octant = (dx < 0.0f ? 1 : 0) + (dy < 0.0f ? 2 : 0) + (dz < 0.0f ? 4 : 0);\n", None,
         "  const int octant = 0;  // the harness puts the tree's own order there\n"),
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


# Device cycles (a few milliseconds) queued in front of a timed run of short
# launches, so that the host has queued them all before the device starts
# the first: the events then time the kernels, not the host's launch rate.
SPACER_CYCLES = 10_000_000


def event_ms(fn, reps: int, spacer_cycles: int = 0) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events,
    behind a device-side spacer of ``spacer_cycles`` when given (for a
    kernel shorter than its wrapper's host time)."""
    fn()
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if spacer_cycles:
        torch.cuda._sleep(spacer_cycles)
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
    # The camera's origin comes as a stride-0 view: materialise it once, or
    # every timed launch's wrapper would.
    cam = tuple(tuple(c.contiguous() for c in v) for v in cam)
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


def _launcher(lib: ctypes.CDLL, symbol: str, module):
    """The ``_launch_fn`` replacement that hands ``module``'s wrapper (K3's
    or K4's) the variant's launch function, typed as the shipped one."""
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = module._launch_fn().argtypes, ctypes.c_int
    return lambda: fn


def nodes12_from_nodes8(tables: torch.Tensor) -> torch.Tensor:
    """[8, Nn, 12] tables of the first port's node, (lo.xyz, skip),
    (hi.xyz, count), (first, 0, 0, 0), in the order of the [8, Nn, 8]
    ``tables``: a leaf's skip link is the next node, its ``first`` its link."""
    n = tables.shape[1]
    leaf = tables[..., 7] > 0
    out = torch.zeros((8, n, 12), dtype=tables.dtype, device=tables.device)
    out[..., 0:8] = tables
    nxt = torch.arange(1, n + 1, dtype=tables.dtype, device=tables.device).expand(8, n)
    out[..., 3] = torch.where(leaf, nxt, tables[..., 3])
    out[..., 8] = torch.where(leaf, tables[..., 3], 0.0)
    return out.contiguous()


def _turns(shipped, variant, reps: int, spacer_cycles: int = 0, rounds: int = 1) -> tuple[list[float], list[float]]:
    """Event times of shipped, variant, variant, shipped, ``rounds`` times."""
    a, b = [], []
    for _ in range(rounds):
        a.append(event_ms(shipped, reps, spacer_cycles))
        b.append(event_ms(variant, reps, spacer_cycles))
        b.append(event_ms(variant, reps, spacer_cycles))
        a.append(event_ms(shipped, reps, spacer_cycles))
    return a, b


def _steps_of(kernel, sname, what, n_rays, shipped, variants, same_as, ptx, smi, reps,
              spacer_cycles: int = 0, rounds: int = 1) -> list[dict]:
    """Hold each variant of ``variants`` ({name: run}) to ``shipped`` (a
    ``run() -> outputs``) by ``same_as(variant outputs, shipped outputs)``,
    then time the two in turns."""
    ref = shipped()
    steps = []
    for name, run in variants.items():
        same = bool(same_as(run(), ref))
        ship_ms, var_ms = _turns(shipped, run, reps, spacer_cycles, rounds)
        step = dict(kernel=kernel, variant=name, scene=sname, rays=n_rays, what=what, equal=same,
                    shipped_ms=ship_ms, variant_ms=var_ms, ratio=sum(var_ms) / sum(ship_ms),
                    ptxas=ptx[name], card=smi)
        print(f"[step] {name} {sname} {n_rays} {what}: equal to the shipped kernel on every ray: {same}; "
              f"shipped {ship_ms} ms, variant {var_ms} ms, ratio {step['ratio']:.4f} | {smi}", flush=True)
        steps.append(step)
    return steps


def _under(swaps, fn):
    """``fn`` run with every (module, attr, value) of ``swaps`` in place."""
    def run():
        with contextlib.ExitStack() as stack:
            for module, attr, value in swaps:
                stack.enter_context(_swapped(module, attr, value))
            return fn()
    return run


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON result to this file")
    ap.add_argument("--only", default="K1,K2,K3,K4", help="kernels to take, e.g. K3,K4 (default: all)")
    ap.add_argument("--sass", help="also write each variant's cuobjdump -sass listing into this directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_steps: no CUDA card", file=sys.stderr)
        return 1
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.loader import load_scene
    from raytracer_tpu_torch.ops import bvh_binary as bb
    from raytracer_tpu_torch.ops import bvh_traverse as bt
    from raytracer_tpu_torch.ops import keys
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops.intersect import scene_precompute
    from raytracer_tpu_torch.render.renderer import Renderer

    only = set(args.only.split(","))
    names = [n for n in EDITS if n[:2] in only]
    smi = card()
    print(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        built = dict(zip(names, pool.map(build_variant, names)))
    print(f"[build] {len(built)} variants in {time.perf_counter() - t0:.2f} s", flush=True)
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
        for name in names:
            with open(os.path.join(args.sass, f"{name}.sass"), "w") as fh:
                subprocess.run([cuobjdump, "-sass", os.path.join(STEPS_DIR, f"lib{name}.so")], stdout=fh, check=True)
    ptx = {}
    for name, (_, log) in built.items():
        ptx[name] = "; ".join(ptxas_lines(log))
        print(f"[ptxas] {name}: {ptx[name]}", flush=True)

    steps = []
    cfg = RenderConfig()
    scenes_dir = os.path.join(REPO, "scenes")

    # K1: the 256 spp frame (64 samples a lane, all bands in one launch).
    for sname in ("cornell_box", "cubes") if "K1" in only else ():
        k1_ship = _k1_launcher(built["K1_shipped"][0])
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

    # K2 and K4: the frame's coherence-sorted bounce rays. K3: its camera
    # rays (keys held equal on the bounce rays too).
    n_frame = cfg.width * cfg.height * 4

    def same_hits(out, ref):
        return torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])

    for sname in ("flying_unicorn", "crewmate_phong") if only & {"K2", "K3", "K4"} else ():
        scene = load_scene(os.path.join(scenes_dir, f"{sname}.toml"), device="cuda")
        cam, classes = scene_rays(scene, scene_precompute(scene), cfg, n_frame)
        ro, rd, t_init, res0, _ = classes["bounce"]
        order = keys.coherence_order(scene, ro, rd, cfg.eps)
        bounce = (tuple(c[order] for c in ro), tuple(c[order] for c in rd), t_init[order], res0[order],
                  False, cfg.eps)

        if "K2" in only:
            def k2(name, bounce=bounce, scene=scene):
                return _under([(bt, "_lib", _k2_library(built[name][0]))],
                              lambda: bt.bvh_traverse_cuda(scene, *bounce))

            check_twin = bool(torch.equal(k2("K2_shipped")()[0], bt.bvh_traverse_twin(scene, *bounce)[0]))
            print(f"[twin] K2 shipped {sname}: t equal to the twin on every ray: {check_twin}", flush=True)
            if not check_twin:
                raise RuntimeError(f"the shipped K2 differs from its twin on {sname}")
            steps += _steps_of(
                "K2", sname, "sorted bounce rays (t and index)", n_frame, k2("K2_shipped"),
                {n: k2(n) for n in names if n.startswith("K2_") and n != "K2_shipped"},
                same_hits, ptx, smi, 10)

        if "K3" in only:
            def k3(name, rays, scene=scene):
                return _under([(keys, "_launch_fn", _launcher(built[name][0], "rt_key_launch", keys))],
                              lambda: keys.coherence_key_cuda(scene, rays[0], rays[1], cfg.eps))

            both = (tuple(torch.cat([a, b]) for a, b in zip(cam[0], ro)),
                    tuple(torch.cat([a, b]) for a, b in zip(cam[1], rd)))
            check_twin = bool(torch.equal(k3("K3_shipped", both)(),
                                          keys.coherence_key_twin(scene, both[0], both[1], cfg.eps)))
            print(f"[twin] K3 shipped {sname}: keys equal to the twin on every camera and bounce ray: "
                  f"{check_twin}", flush=True)
            if not check_twin:
                raise RuntimeError(f"the shipped K3 differs from its twin on {sname}")
            k3_names = [n for n in names if n.startswith("K3_") and n != "K3_shipped"]
            bad = [n for n in k3_names if not torch.equal(k3(n, both)(), k3("K3_shipped", both)())]
            k3_steps = _steps_of(
                "K3", sname, "camera rays (keys)", n_frame, k3("K3_shipped", cam),
                {n: k3(n, cam) for n in k3_names}, torch.equal, ptx, smi, 20, SPACER_CYCLES, rounds=2)
            k3_steps += _steps_of(
                "K3", sname, "bounce rays in lane order (keys)", n_frame, k3("K3_shipped", (ro, rd)),
                {n: k3(n, (ro, rd)) for n in k3_names}, torch.equal, ptx, smi, 20, SPACER_CYCLES, rounds=2)
            for step in k3_steps:  # equal on the camera and bounce rays together too
                step["equal"] = step["equal"] and step["variant"] not in bad
            steps += k3_steps

        if "K4" in only:
            def k4(name, scene_v, floats=bb.NODE_FLOATS, bounce=bounce):
                swaps = [(bb, "_launch_fn", _launcher(built[name][0], "rt_bvh_binary_launch", bb)),
                         (bb, "NODE_FLOATS", floats)]
                return _under(swaps, lambda: bb.bvh_binary_cuda(scene_v, *bounce))

            t_tw, i_tw = bb.bvh_binary_twin(scene, *bounce)
            t_k4, i_k4 = k4("K4_shipped", scene)()
            check_twin = bool(torch.equal(t_k4, t_tw))
            print(f"[twin] K4 shipped {sname}: t equal to the twin on every ray: {check_twin}; index differs on "
                  f"{int((i_k4 != i_tw).sum())}", flush=True)
            if not check_twin:
                raise RuntimeError(f"the shipped K4 differs from its twin on {sname}")
            tables = scene.bvh_octant_nodes
            own = dataclasses.replace(
                scene, bvh_octant_nodes=torch.cat([scene.bvh_binary_nodes8[None], tables[1:]]).contiguous())
            wide = dataclasses.replace(scene, bvh_octant_nodes=nodes12_from_nodes8(tables))
            variants = {n: k4(n, scene) for n in names if n.startswith("K4_") and n != "K4_shipped"}
            variants["K4_fixed_order"] = k4("K4_fixed_order", own)
            variants["K4_node12"] = k4("K4_node12", wide, 12)

            def same_or_ties(out, ref, bounce=bounce, scene=scene):
                diff = out[1] != ref[1]
                return torch.equal(out[0], ref[0]) and torch.equal(
                    bt.leaf_t(scene, bounce[0], bounce[1], out[1])[diff],
                    bt.leaf_t(scene, bounce[0], bounce[1], ref[1])[diff])

            k4_steps = _steps_of("K4", sname, "sorted bounce rays (t and index)", n_frame, k4("K4_shipped", scene),
                                 {n: v for n, v in variants.items() if n != "K4_fixed_order"},
                                 same_hits, ptx, smi, 20, rounds=2)
            k4_steps += _steps_of("K4", sname, "sorted bounce rays (t; index but for ties)", n_frame,
                                  k4("K4_shipped", scene), {"K4_fixed_order": variants["K4_fixed_order"]},
                                  same_or_ties, ptx, smi, 20, rounds=2)
            steps += k4_steps
    print("[ptxas] shipped: " + "; ".join(f"{k} {ptx[k + '_shipped']}" for k in sorted(only) if k + "_shipped" in ptx),
          flush=True)
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
