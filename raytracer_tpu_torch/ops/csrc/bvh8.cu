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
// stack, because Mosaic has no per-lane gathers. On this card per-thread
// traversal is the idiom: one thread per ray, each with its own stack in
// local memory (L1-cached), over two tables in device memory:
//   nodes [Nw, 64] f32: child slot s at fields 8s..8s+7 =
//                       (lo.xyz, hi.xyz, child, count), read as float4s;
//   tris  [F', 12] f32: per leaf-ordered triangle (n_unit.xyz, n_d,
//                       q1.xyz, q1_a, q2.xyz, q2_a), 3 float4s.
// Stack entries are a wide-node id (>= 0) or a leaf -(group) - 1. A visited
// node pushes its hit children ordered by the ray's own entry distance,
// farthest first, so the nearest child is popped first and earlier hits
// prune farther subtrees (the Pallas sorting network orders by the packet
// minimum, which is a packet artefact). Ties keep slot order: the later slot
// is popped first. Padded leaf slots are all-zero rows: denom = 0 fails the
// |denom| cutoff, so they never hit.
//
// Cost: both tables fit in L2 (flying_unicorn: 58 KB of nodes, 2.1 MB of
// leaf rows), so the kernel is bound by the per-thread FP32 work of the leaf
// tests (64 triangles x ~25 flops per leaf visit) and by divergence: a warp's
// threads walk different paths and the warp runs until its longest walk
// ends. This first version is simple on purpose: no ray sorting inside the
// kernel, no shared-memory node cache, no wgmma.
//
// Numerics: the leaf and slab expressions are the Pallas kernel's
// (bvh_kernel.py:308-341, :369-374), evaluated left to right without FMA
// contraction (-fmad=false) and with IEEE division, exactly as the plain
// PyTorch twin (ops/bvh_traverse.py::bvh_traverse_twin) evaluates them.

#include <cuda_runtime.h>
#include <stdint.h>

// Stack bound compiled into the kernel; the wrapper raises when a scene's
// bvh8_max_stack exceeds it (flying_unicorn needs 29).
#define BVH8_MAX_STACK 64

struct TravParams {
  int n, n_nodes, n_groups, base, max_leaf, any_hit;
  float tri_tmin, tri_parallel;
};

__global__ void __launch_bounds__(128) bvh8_kernel(
    const __grid_constant__ TravParams p, const float* __restrict__ rox,
    const float* __restrict__ roy, const float* __restrict__ roz, const float* __restrict__ rdx,
    const float* __restrict__ rdy, const float* __restrict__ rdz,
    const float* __restrict__ t_init, const uint8_t* __restrict__ resolved0,
    const float4* __restrict__ nodes, const float4* __restrict__ tris, float* __restrict__ t_out,
    int32_t* __restrict__ idx_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const float ox = rox[i], oy = roy[i], oz = roz[i];
  const float dx = rdx[i], dy = rdy[i], dz = rdz[i];
  const float ix = 1.0f / (fabsf(dx) < 1e-12f ? 1e-12f : dx);
  const float iy = 1.0f / (fabsf(dy) < 1e-12f ? 1e-12f : dy);
  const float iz = 1.0f / (fabsf(dz) < 1e-12f ? 1e-12f : dz);
  const float tinit = t_init[i];
  const bool res0 = resolved0[i] != 0;

  float t_best = tinit;
  int i_best = 0;
  int stack[BVH8_MAX_STACK];
  int sp = 0;
  stack[sp++] = 0;  // the root wide node
  while (sp > 0) {
    if (p.any_hit && (res0 || t_best < tinit)) break;
    const int x = stack[--sp];
    if (x < 0) {
      // Leaf group g: max_leaf triangle rows.
      const int g = -x - 1;
      if (g >= p.n_groups) continue;
      const int first = g * p.max_leaf;
      const float4* tri = tris + (size_t)first * 3;
      for (int j = 0; j < p.max_leaf; ++j) {
        const float4 a = tri[3 * j], b = tri[3 * j + 1], c = tri[3 * j + 2];
        const float denom = a.x * dx + a.y * dy + a.z * dz;
        const float n_ro = a.x * ox + a.y * oy + a.z * oz;
        const float t = (a.w - n_ro) / denom;
        const float u = (b.x * ox + b.y * oy + b.z * oz) + t * (b.x * dx + b.y * dy + b.z * dz) - b.w;
        const float v = (c.x * ox + c.y * oy + c.z * oz) + t * (c.x * dx + c.y * dy + c.z * dz) - c.w;
        if (fabsf(denom) >= p.tri_parallel && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
            t > p.tri_tmin && t < t_best) {
          t_best = t;
          i_best = p.base + first + j;
        }
      }
    } else {
      if (x >= p.n_nodes) continue;
      const float4* nd = nodes + (size_t)x * 16;
      float key[8];
      int val[8];
      int h = 0;
      for (int s = 0; s < 8; ++s) {
        const float4 a = nd[2 * s], b = nd[2 * s + 1];  // lo.xyz hi.x | hi.yz child count
        const int cnt = (int)b.w;
        if (cnt == 0) continue;  // empty slot
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
        if (!(tnear <= tfar && tfar > p.tri_tmin && tnear < t_best)) continue;
        const int child = (int)b.z;
        const int pv = cnt > 0 ? -(child / p.max_leaf) - 1 : child;
        // Insert into the list kept in descending entry distance; an equal
        // key goes after the ones already there (stable).
        int q = h++;
        while (q > 0 && key[q - 1] < tnear) {
          key[q] = key[q - 1];
          val[q] = val[q - 1];
          --q;
        }
        key[q] = tnear;
        val[q] = pv;
      }
      // The wrapper only launches scenes with bvh8_max_stack (7 * depth + 1,
      // which bounds this walk) <= BVH8_MAX_STACK. A walk past it means that
      // bound is wrong: fail the launch rather than drop children.
      if (sp + h > BVH8_MAX_STACK) __trap();
      for (int q = 0; q < h; ++q) stack[sp++] = val[q];
    }
  }
  t_out[i] = t_best;
  idx_out[i] = i_best;
}

extern "C" int rt_bvh8_max_stack() { return BVH8_MAX_STACK; }

// All pointers are device pointers; resolved0 is one byte per ray (0 or 1).
extern "C" int rt_bvh8_launch(const float* rox, const float* roy, const float* roz,
                              const float* rdx, const float* rdy, const float* rdz,
                              const float* t_init, const uint8_t* resolved0, const float* nodes,
                              int n_nodes, const float* tris, int n_tri_rows, int n, int base,
                              int max_leaf, int any_hit, float tri_tmin, float tri_parallel,
                              float* t_out, int32_t* idx_out, void* stream) {
  if (n < 0 || max_leaf <= 0 || n_tri_rows % max_leaf != 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  TravParams p;
  p.n = n;
  p.n_nodes = n_nodes;
  p.n_groups = n_tri_rows / max_leaf;
  p.base = base;
  p.max_leaf = max_leaf;
  p.any_hit = any_hit;
  p.tri_tmin = tri_tmin;
  p.tri_parallel = tri_parallel;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  bvh8_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      p, rox, roy, roz, rdx, rdy, rdz, t_init, resolved0, (const float4*)nodes,
      (const float4*)tris, t_out, idx_out);
  return (int)cudaGetLastError();
}
