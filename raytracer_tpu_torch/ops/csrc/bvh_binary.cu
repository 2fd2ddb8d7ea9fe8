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
//   nodes [8, Nn, 8] f32: per direction octant and binary node
//                         (lo.xyz, link), (hi.xyz, count), two float4s;
//   tris  [F', 12] f32:   per leaf-ordered triangle (n_unit.xyz, n_d,
//                         q1.xyz, q1_a, q2.xyz, q2_a), 3 float4s (the table
//                         K2 reads).
// Each octant's nodes are one DFS pre-order of the same tree, so the walk
// needs no stack: if the ray's own slab test hits node i it goes on to i + 1
// (after testing the leaf's count rows, if i is a leaf); if it misses an
// inner node it jumps to link, the first node past i's subtree; past a
// missed leaf it goes on to i + 1, a leaf's subtree being itself (so a
// leaf's link holds its first triangle row instead). It ends when the
// pointer passes the last node.
//
// What bounds it on this card: the tables fit in L2 (flying_unicorn: 354 KB
// of nodes, 2.1 MB of leaf rows), so not bytes but the chain of dependent
// loads (a node is known only after the slab test of the one before) and the
// warp's longest walk. The design, each step timed against its alternative
// by tools/kernel_steps.py:
//   - a node is 32 bytes, one sector and two loads, with no third load in
//     front of a leaf's rows (fetching node i + 1 while node i is tested
//     measured slower and is not done);
//   - a lane walks on from node to node until it enters a leaf, and only
//     then tests rows: the lanes of a warp then run the (long) row loop
//     together instead of some idling through it at inner nodes;
//   - the leaf loop takes four rows at a time, their twelve loads started
//     before the arithmetic; rows in order with a strict <, so the first
//     row of the smallest t still wins;
//   - near child first: in the layout of the ray's direction octant every
//     inner node's near child comes first (ops/bvh.py::octant_orders), so a
//     near hit found early prunes the far subtrees by tnear < t_best. The
//     rays arrive sorted by a key that holds the octant, so a warp mostly
//     shares one layout. The nearest t is the minimum over the same
//     triangles whatever the order; the index may differ where two
//     triangles tie in t.
//
// Numerics: the slab and leaf expressions are the Pallas kernel's
// (bvh_kernel.py:65-67, :86-94, :102-132: safe_denom, the u <= 1 test,
// j < count), evaluated left to right without FMA contraction (-fmad=false)
// and with IEEE division, exactly as the plain PyTorch twin
// (ops/bvh_binary.py::bvh_binary_twin) evaluates them.

#include <cuda_runtime.h>
#include <stdint.h>

#define WALK_BLOCK 128
#define NODE_F4 2  // float4s a node
#define LEAF_UNROLL 4

struct WalkParams {
  int n, n_nodes, n_rows, base, any_hit;
  float tri_tmin, tri_parallel;
};

__global__ void __launch_bounds__(WALK_BLOCK) bvh_binary_kernel(
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
  const int octant = (dx < 0.0f ? 1 : 0) + (dy < 0.0f ? 2 : 0) + (dz < 0.0f ? 4 : 0);
  const float4* nd = nodes + (size_t)octant * p.n_nodes * NODE_F4;

  float t_best = tinit;
  int i_best = 0;
  int node = (p.any_hit && resolved0[i] != 0) ? p.n_nodes : 0;
  while (node < p.n_nodes) {
    if (p.any_hit && t_best < tinit) break;
    // Walk on until a leaf is entered, so that the lanes of a warp test
    // their leaves' rows together.
    int first = 0, count = 0;
    while (node < p.n_nodes) {  // walk on
      const float4 a = __ldg(nd + NODE_F4 * node);      // lo.xyz link
      const float4 b = __ldg(nd + NODE_F4 * node + 1);  // hi.xyz count
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
      const bool hit = tnear <= tfar && tfar > p.tri_tmin && tnear < t_best;
      const int rows = (int)b.w;
      const int link = (int)a.w;
      if (hit || rows > 0) {
        node += 1;
        if (hit && rows > 0) {
          first = link;
          count = rows;
          break;
        }
      } else {
        // The host packer checks link > node; a table that breaks it would
        // loop forever, so fail the launch instead.
        if (link <= node) __trap();
        node = link;
      }
    }  // a leaf entered, or the walk over
    if (first < 0 || first + ((count + LEAF_UNROLL - 1) & -LEAF_UNROLL) > p.n_rows) __trap();
    const float4* tri = tris + (size_t)first * 3;
    for (int j0 = 0; j0 < count; j0 += LEAF_UNROLL) {
      float4 e[LEAF_UNROLL], f[LEAF_UNROLL], g[LEAF_UNROLL];
#pragma unroll
      for (int q = 0; q < LEAF_UNROLL; ++q) {
        e[q] = __ldg(tri + 3 * (j0 + q));
        f[q] = __ldg(tri + 3 * (j0 + q) + 1);
        g[q] = __ldg(tri + 3 * (j0 + q) + 2);
      }
#pragma unroll
      for (int q = 0; q < LEAF_UNROLL; ++q) {
        const float denom = e[q].x * dx + e[q].y * dy + e[q].z * dz;
        const float safe_denom = fabsf(denom) < 1e-30f ? 1e-30f : denom;
        const float n_ro = e[q].x * ox + e[q].y * oy + e[q].z * oz;
        const float t = (e[q].w - n_ro) / safe_denom;
        const float u = (f[q].x * ox + f[q].y * oy + f[q].z * oz) +
                        t * (f[q].x * dx + f[q].y * dy + f[q].z * dz) - f[q].w;
        const float v = (g[q].x * ox + g[q].y * oy + g[q].z * oz) +
                        t * (g[q].x * dx + g[q].y * dy + g[q].z * dz) - g[q].w;
        if (j0 + q < count && fabsf(denom) >= p.tri_parallel && u >= 0.0f && u <= 1.0f &&
            v >= 0.0f && u + v <= 1.0f && t > p.tri_tmin && t < t_best) {
          t_best = t;
          i_best = p.base + first + j0 + q;
        }
      }
    }
  }
  t_out[i] = t_best;
  idx_out[i] = i_best;
}

// All pointers are device pointers; resolved0 is one byte per ray (0 or 1);
// nodes holds the eight octant layouts, n_nodes rows each.
extern "C" int rt_bvh_binary_launch(const float* rox, const float* roy, const float* roz,
                                    const float* rdx, const float* rdy, const float* rdz,
                                    const float* t_init, const uint8_t* resolved0,
                                    const float* nodes, int n_nodes, const float* tris,
                                    int n_tri_rows, int n, int base, int any_hit, float tri_tmin,
                                    float tri_parallel, float* t_out, int32_t* idx_out,
                                    void* stream) {
  if (n < 0 || n_nodes < 1 || n_tri_rows < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  WalkParams p;
  p.n = n;
  p.n_nodes = n_nodes;
  p.n_rows = n_tri_rows;
  p.base = base;
  p.any_hit = any_hit;
  p.tri_tmin = tri_tmin;
  p.tri_parallel = tri_parallel;
  const int blocks = (n + WALK_BLOCK - 1) / WALK_BLOCK;
  bvh_binary_kernel<<<blocks, WALK_BLOCK, 0, (cudaStream_t)stream>>>(
      p, rox, roy, roz, rdx, rdy, rdz, t_init, resolved0, (const float4*)nodes,
      (const float4*)tris, t_out, idx_out);
  return (int)cudaGetLastError();
}
