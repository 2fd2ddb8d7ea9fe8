// 8-wide BVH traversal for Hopper (sm_90a): nearest (or any) triangle hit
// per ray.
//
// Replaces raytracer_tpu/ops/pallas/bvh_kernel.py::_traverse8_kernel (K2),
// with the contract of its wrapper bvh_intersect_pallas: for each ray
// (ro, rd, t_init, resolved0) the smallest t of a leaf triangle with
// |denom| >= tri_parallel, t > tri_tmin and t < the running bound (which
// starts at t_init), and that triangle's global index base + first + slot;
// a ray that finds nothing keeps t_init and index 0. In any-hit mode a ray
// stops as soon as it is resolved (resolved0, or some hit below t_init).
//
// The Pallas kernel walks the tree with a 1024-ray packet and one shared
// stack, because Mosaic has no per-lane gathers. On this card one thread
// walks one ray, over two tables in device memory:
//   nodes [Nw, 64] f32: child slot s at fields 8s..8s+7 =
//                       (lo.xyz, hi.xyz, child, count), read as float4s;
//   tris  [F', 12] f32: per leaf-ordered triangle (n_unit.xyz, n_d,
//                       q1.xyz, q1_a, q2.xyz, q2_a), 3 float4s.
// A visited node pushes its hit children ordered by the ray's own entry
// distance, farthest first, so the nearest child is popped first and earlier
// hits prune farther subtrees; ties keep slot order (the later slot is
// popped first).
//
// Cost: the tables fit in L2 (flying_unicorn: 58 KB of nodes, 2.1 MB of
// leaf rows) and a ray moves 37 bytes, so device memory does not bound it.
// The walk is a chain of dependent loads per thread, so the latency of
// those loads, and how many warps the SM holds to hide it, bound it; so
// does divergence (a warp runs until its longest walk ends). The design,
// each step timed on the card against its alternative:
// - The stack and the children's insertion keys are per-thread arrays,
//   indexed at run time, so they live in local memory, which L1 caches. A
//   hit child is inserted into the node's run of stack entries by its entry
//   distance (stable), so the walk, t and index equal the twin's. (Keeping
//   them in shared memory instead, one column per thread, removes the local
//   traffic but reserves 19 KB a block of the SM's memory that L1 would use
//   for the leaf rows; a fixed sorting network over the eight children in
//   registers orders them the same way but keeps 24 more values live.)
// - A leaf tests its real triangles only. The stack entry of a leaf is
//   -(first + count - 1) - 1, its last row; each leaf starts its own
//   max_leaf-aligned group (checked on the host), so the group is
//   last / max_leaf and the count last % max_leaf + 1. Padded rows never
//   hit, so skipping them changes nothing.
// - A triangle's three rows are loaded together and u, v computed for every
//   real triangle, the hit test predicated (computing them only for a t
//   that could still win branches the warp).
// - The node table is read from device memory through the read-only cache.
//   (A copy in each block's shared memory takes the carve-out from L1, and
//   on the unicorn, 58 KB a block, cuts the resident blocks.)
// - leaf_tris (RT_LEAF_TRIS, bvh_kernel.py:300-303) bounds the rows a leaf
//   tests: max_leaf (all) on every path but that timing probe, which sets
//   0 to time the walk without its leaf tests, or k to time a part of them.
// raytracer_tpu_torch/tools/kernel_steps.py builds each alternative named
// in brackets and times it against this kernel on the card.
//
// Numerics: the leaf and slab expressions are the Pallas kernel's
// (bvh_kernel.py:308-341, :369-374), evaluated left to right without FMA
// contraction (-fmad=false) and with IEEE division, exactly as the plain
// PyTorch twin (ops/bvh_traverse.py::bvh_traverse_twin) evaluates them.

#include <cuda_runtime.h>
#include <stdint.h>

// Largest stack bound a launch accepts; the wrapper raises when a scene's
// bvh8_max_stack exceeds it.
#define BVH8_MAX_STACK 64
#define BVH8_BLOCK 128

struct TravParams {
  int n, n_nodes, n_groups, base, max_leaf, any_hit, stack_depth, leaf_tris;
  float tri_tmin, tri_parallel;
};

// Walk ray i.
__device__ __forceinline__ void walk(
    const TravParams& p, int i, const float* __restrict__ rox, const float* __restrict__ roy,
    const float* __restrict__ roz, const float* __restrict__ rdx, const float* __restrict__ rdy,
    const float* __restrict__ rdz, const float* __restrict__ t_init,
    const uint8_t* __restrict__ resolved0, const float4* __restrict__ nodes,
    const float4* __restrict__ tris, float* __restrict__ t_out, int32_t* __restrict__ idx_out) {
  const float ox = rox[i], oy = roy[i], oz = roz[i];
  const float dx = rdx[i], dy = rdy[i], dz = rdz[i];
  const float ix = 1.0f / (fabsf(dx) < 1e-12f ? 1e-12f : dx);
  const float iy = 1.0f / (fabsf(dy) < 1e-12f ? 1e-12f : dy);
  const float iz = 1.0f / (fabsf(dz) < 1e-12f ? 1e-12f : dz);
  const float tinit = t_init[i];
  const bool res0 = resolved0[i] != 0;

  int stk[BVH8_MAX_STACK];  // the stack, top at sp - 1
  float keys[8];            // entry distances of the children being pushed
  float t_best = tinit;
  int i_best = 0;
  stk[0] = 0;  // the root wide node
  int sp = 1;
  while (sp > 0) {
    if (p.any_hit && (res0 || t_best < tinit)) break;
    const int x = stk[--sp];
    if (x < 0) {
      // Leaf: rows first .. last of group last / max_leaf.
      const int last = -x - 1;
      const int g = last / p.max_leaf;
      if (g >= p.n_groups) continue;
      const int first = g * p.max_leaf;
      const float4* tri = tris + (size_t)first * 3;
      const int n_rows = min(last - first + 1, p.leaf_tris);
      for (int j = 0; j < n_rows; ++j) {
        const float4 a = __ldg(tri + 3 * j), b = __ldg(tri + 3 * j + 1),
                     c = __ldg(tri + 3 * j + 2);
        const float denom = a.x * dx + a.y * dy + a.z * dz;
        const float n_ro = a.x * ox + a.y * oy + a.z * oz;
        const float t = (a.w - n_ro) / denom;
        const float u =
            (b.x * ox + b.y * oy + b.z * oz) + t * (b.x * dx + b.y * dy + b.z * dz) - b.w;
        const float v =
            (c.x * ox + c.y * oy + c.z * oz) + t * (c.x * dx + c.y * dy + c.z * dz) - c.w;
        if (fabsf(denom) >= p.tri_parallel && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
            t > p.tri_tmin && t < t_best) {
          t_best = t;
          i_best = p.base + first + j;
        }
      }
    } else {
      if (x >= p.n_nodes) continue;
      const float4* nd = nodes + (size_t)x * 16;
      int h = 0;  // children pushed: stk[sp] .. stk[sp + h - 1], keys descending
#pragma unroll 1
      for (int s = 0; s < 8; ++s) {
        // lo.xyz hi.x | hi.yz child count
        const float4 a = __ldg(nd + 2 * s);
        const float4 b = __ldg(nd + 2 * s + 1);
        const int cnt = (int)b.w;
        float t0 = (a.x - ox) * ix, t1 = (a.w - ox) * ix;
        float tnear = fminf(t0, t1), tfar = fmaxf(t0, t1);
        t0 = (a.y - oy) * iy;
        t1 = (b.x - oy) * iy;
        tnear = fmaxf(tnear, fminf(t0, t1));
        tfar = fminf(tfar, fmaxf(t0, t1));
        t0 = (a.z - oz) * iz;
        t1 = (b.y - oz) * iz;
        tnear = fmaxf(tnear, fminf(t0, t1));
        tfar = fminf(tfar, fmaxf(t0, t1));
        if (!(cnt != 0 && tnear <= tfar && tfar > p.tri_tmin && tnear < t_best)) continue;
        // The wrapper sizes the stack by the scene's bvh8_max_stack
        // (7 * depth + 1, which bounds this walk). A walk past it means
        // that bound is wrong: fail the launch rather than drop children.
        if (sp + h >= p.stack_depth) __trap();
        const int child = (int)b.z;
        // Insert after the entries of a larger or equal key (stable).
        int q = h++;
        while (q > 0 && keys[q - 1] < tnear) {
          keys[q] = keys[q - 1];
          stk[sp + q] = stk[sp + q - 1];
          --q;
        }
        keys[q] = tnear;
        stk[sp + q] = cnt > 0 ? -(child + cnt - 1) - 1 : child;
      }
      sp += h;
    }
  }
  t_out[i] = t_best;
  idx_out[i] = i_best;
}

// One thread walks one ray.
__global__ void __launch_bounds__(BVH8_BLOCK, 1) bvh8_kernel(
    const __grid_constant__ TravParams p, const float* __restrict__ rox,
    const float* __restrict__ roy, const float* __restrict__ roz, const float* __restrict__ rdx,
    const float* __restrict__ rdy, const float* __restrict__ rdz,
    const float* __restrict__ t_init, const uint8_t* __restrict__ resolved0,
    const float4* __restrict__ nodes, const float4* __restrict__ tris, float* __restrict__ t_out,
    int32_t* __restrict__ idx_out) {
  const int i = blockIdx.x * BVH8_BLOCK + threadIdx.x;
  if (i < p.n) walk(p, i, rox, roy, roz, rdx, rdy, rdz, t_init, resolved0, nodes, tris, t_out, idx_out);
}

extern "C" int rt_bvh8_max_stack() { return BVH8_MAX_STACK; }

// All pointers are device pointers; resolved0 is one byte per ray (0 or 1).
// stack_depth is the scene's stack bound (<= BVH8_MAX_STACK); leaf_tris the
// rows a leaf tests at most (max_leaf: all).
extern "C" int rt_bvh8_launch(const float* rox, const float* roy, const float* roz,
                              const float* rdx, const float* rdy, const float* rdz,
                              const float* t_init, const uint8_t* resolved0, const float* nodes,
                              int n_nodes, const float* tris, int n_tri_rows, int n, int base,
                              int max_leaf, int any_hit, int stack_depth, int leaf_tris,
                              float tri_tmin,
                              float tri_parallel, float* t_out, int32_t* idx_out, void* stream) {
  if (n < 0 || max_leaf <= 0 || n_tri_rows % max_leaf != 0 || stack_depth < 1 ||
      stack_depth > BVH8_MAX_STACK || leaf_tris < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  TravParams p;
  p.n = n;
  p.n_nodes = n_nodes;
  p.n_groups = n_tri_rows / max_leaf;
  p.base = base;
  p.max_leaf = max_leaf;
  p.any_hit = any_hit;
  p.stack_depth = stack_depth;
  p.leaf_tris = leaf_tris;
  p.tri_tmin = tri_tmin;
  p.tri_parallel = tri_parallel;
  const int blocks = (n + BVH8_BLOCK - 1) / BVH8_BLOCK;
  bvh8_kernel<<<blocks, BVH8_BLOCK, 0, (cudaStream_t)stream>>>(
      p, rox, roy, roz, rdx, rdy, rdz, t_init, resolved0, (const float4*)nodes,
      (const float4*)tris, t_out, idx_out);
  return (int)cudaGetLastError();
}
