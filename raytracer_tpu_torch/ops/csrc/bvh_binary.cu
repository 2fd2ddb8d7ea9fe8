// Binary BVH traversal for Hopper (sm_90a): nearest (or any) triangle hit
// per ray by a stackless skip-link walk.
//
// Replaces raytracer_tpu/ops/pallas/bvh_kernel.py::_traverse_kernel (K4),
// with the contract of its wrapper bvh_intersect_pallas: for each ray
// (ro, rd, t_init, resolved0) the smallest t of a leaf triangle with
// |denom| >= tri_parallel, barycentrics inside, t > tri_tmin and t < the
// running bound (which starts at t_init), and that triangle's global index
// base + first + j; a ray that finds nothing keeps t_init and index 0. In
// any-hit mode a ray stops as soon as it is resolved (resolved0, or some hit
// below t_init).
//
// The Pallas kernel walks the tree with a 1024-ray packet sharing one node
// pointer (it descends where ANY ray of the packet hits the box), fetches a
// node or a leaf by a masked lane reduction and, in any-hit mode, all-reduces
// the packet's resolved flags: all three exist because Mosaic has no
// per-lane gathers. Here one thread walks one ray by itself over two tables
// in device memory:
//   nodes [Nn, 12] f32: per binary node (lo.xyz, skip), (hi.xyz, count),
//                       (first, 0, 0, 0), read as float4s;
//   tris  [F', 12] f32: per leaf-ordered triangle (n_unit.xyz, n_d,
//                       q1.xyz, q1_a, q2.xyz, q2_a), 3 float4s (the table
//                       K2 reads).
// The nodes are in DFS pre-order with skip links (skip[i] = first node past
// i's subtree), so the walk needs no stack: if the ray's own slab test hits
// node i it goes on to i + 1 (after testing the leaf's count rows, if i is a
// leaf), else it jumps to skip[i]; it ends when the pointer passes the last
// node.
//
// Cost: both tables fit in L2 (flying_unicorn: 66 KB of nodes, 2.1 MB of
// leaf rows), so the kernel is bound by per-thread FP32 work (up to 64
// triangles x ~25 flops per leaf hit) and by warp divergence (a warp runs
// until its longest walk ends). The walk visits the nodes in DFS order, not
// nearest child first as K2 does, so a near hit found late prunes less and
// the walk tests more leaves than K2's. This first version is simple on
// purpose: no shared-memory node cache, no ray reordering inside the kernel.
//
// Numerics: the slab and leaf expressions are the Pallas kernel's
// (bvh_kernel.py:65-67, :86-94, :102-132: safe_denom, the u <= 1 test,
// j < count), evaluated left to right without FMA contraction (-fmad=false)
// and with IEEE division, exactly as the plain PyTorch twin
// (ops/bvh_binary.py::bvh_binary_twin) evaluates them.

#include <cuda_runtime.h>
#include <stdint.h>

struct WalkParams {
  int n, n_nodes, n_rows, base, any_hit;
  float tri_tmin, tri_parallel;
};

__global__ void __launch_bounds__(128) bvh_binary_kernel(
    const __grid_constant__ WalkParams p, const float* __restrict__ rox,
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

  float t_best = tinit;
  int i_best = 0;
  int node = (p.any_hit && resolved0[i] != 0) ? p.n_nodes : 0;
  while (node < p.n_nodes) {
    if (p.any_hit && t_best < tinit) break;
    const float4 a = nodes[3 * node], b = nodes[3 * node + 1];  // lo.xyz skip | hi.xyz count
    float tnear = -3.0e38f, tfar = 3.0e38f;
    float t0 = (a.x - ox) * ix, t1 = (b.x - ox) * ix;
    tnear = fmaxf(tnear, fminf(t0, t1));
    tfar = fminf(tfar, fmaxf(t0, t1));
    t0 = (a.y - oy) * iy;
    t1 = (b.y - oy) * iy;
    tnear = fmaxf(tnear, fminf(t0, t1));
    tfar = fminf(tfar, fmaxf(t0, t1));
    t0 = (a.z - oz) * iz;
    t1 = (b.z - oz) * iz;
    tnear = fmaxf(tnear, fminf(t0, t1));
    tfar = fminf(tfar, fmaxf(t0, t1));
    if (!(tnear <= tfar && tfar > p.tri_tmin && tnear < t_best)) {
      const int skip = (int)a.w;
      // The host packer checks skip > node; a table that breaks it would
      // loop forever, so fail the launch instead.
      if (skip <= node) __trap();
      node = skip;
      continue;
    }
    const int count = (int)b.w;
    if (count > 0) {
      const int first = (int)nodes[3 * node + 2].x;
      if (first < 0 || first + count > p.n_rows) __trap();
      const float4* tri = tris + (size_t)first * 3;
      for (int j = 0; j < count; ++j) {
        const float4 e = tri[3 * j], f = tri[3 * j + 1], g = tri[3 * j + 2];
        const float denom = e.x * dx + e.y * dy + e.z * dz;
        const float safe_denom = fabsf(denom) < 1e-30f ? 1e-30f : denom;
        const float n_ro = e.x * ox + e.y * oy + e.z * oz;
        const float t = (e.w - n_ro) / safe_denom;
        const float u = (f.x * ox + f.y * oy + f.z * oz) + t * (f.x * dx + f.y * dy + f.z * dz) - f.w;
        const float v = (g.x * ox + g.y * oy + g.z * oz) + t * (g.x * dx + g.y * dy + g.z * dz) - g.w;
        if (fabsf(denom) >= p.tri_parallel && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
            u + v <= 1.0f && t > p.tri_tmin && t < t_best) {
          t_best = t;
          i_best = p.base + first + j;
        }
      }
    }
    node += 1;
  }
  t_out[i] = t_best;
  idx_out[i] = i_best;
}

// All pointers are device pointers; resolved0 is one byte per ray (0 or 1).
extern "C" int rt_bvh_binary_launch(const float* rox, const float* roy, const float* roz,
                                    const float* rdx, const float* rdy, const float* rdz,
                                    const float* t_init, const uint8_t* resolved0,
                                    const float* nodes, int n_nodes, const float* tris,
                                    int n_tri_rows, int n, int base, int any_hit, float tri_tmin,
                                    float tri_parallel, float* t_out, int32_t* idx_out,
                                    void* stream) {
  if (n < 0 || n_nodes < 0 || n_tri_rows < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  WalkParams p;
  p.n = n;
  p.n_nodes = n_nodes;
  p.n_rows = n_tri_rows;
  p.base = base;
  p.any_hit = any_hit;
  p.tri_tmin = tri_tmin;
  p.tri_parallel = tri_parallel;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  bvh_binary_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      p, rox, roy, roz, rdx, rdy, rdz, t_init, resolved0, (const float4*)nodes,
      (const float4*)tris, t_out, idx_out);
  return (int)cudaGetLastError();
}
