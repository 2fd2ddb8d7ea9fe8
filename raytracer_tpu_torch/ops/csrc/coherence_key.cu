// Traversal-coherence sort key for Hopper (sm_90a).
//
// Replaces raytracer_tpu/ops/pallas/key_kernel.py::_key_kernel (K3), whose
// output is bit-identical to raytracer_tpu/ops/bvh.py::_coherence_key. Per ray
// it writes the i32 key
//     miss << 30 | entry << 17 | octant << 13 | morton12
// where entry is the treetop-cut box the ray enters first (nearest slab
// entry, ties to the lower cut index) and miss says it enters none.
//
// The (C+1) x 6 table of cut boxes plus the root box is a by-value
// __grid_constant__ argument (198 floats at C = 32), so it lies in the
// constant bank, for up to KEY_MAX_CUT boxes. A longer cut (up to the entry
// field's 8191, KEY_CUT_LIMIT) is read from a device copy of the table
// through the read-only cache instead (KeyTableDev): every thread of a warp
// reads the same row, so each load is one broadcast. The rays come in as six f32 columns (coalesced 4-byte
// loads) and the key goes out as one i32: 28 bytes of device memory per ray
// (1M rays move 28 MB, ~9 us at 3.35 TB/s). That is not what bounds it: a
// ray costs C slab tests of 25 FMA-free operations, of which the 10 minima
// and maxima, the 3 compares and the 2 selects run at half the rate of the
// 12 adds and multiplies, so the instruction rate sets the time.
//
// What the design does about it, each step timed against its alternative by
// tools/kernel_steps.py:
//   - the kernel is a template on the cut count. For KEY_STATIC_CUT (32, the
//     count ops/bvh.py::treetop_cut gives every tree with enough inner
//     nodes) the cut loop has a constant trip count and is unrolled eight
//     cuts at a time, each cut's six table values fetched as three 64-bit
//     uniform loads and used as operands of the subtracts. Unrolled in full
//     it measured 17-20% slower, with the count at run time 6-7%. Any other
//     count 1..KEY_MAX_CUT runs the same source with the count at run time
//     (key_kernel<0>), and KEY_MAX_CUT+1..KEY_CUT_LIMIT the same source again
//     over the device table (key_kernel<0, KeyTableDev>);
//   - one ray a thread (KEY_RAYS; a block takes KEY_RAYS tiles of KEY_BLOCK
//     consecutive rays, so that every load stays coalesced): with the count
//     at compile time the unrolled cuts give the scheduler enough
//     independent work, and two rays a thread measured no faster, four
//     7-10% slower.
// Tried and not kept (tools/kernel_steps.py times each): a scan specialised for the signs
// of the inverse direction, taken by a warp whose rays all share them (6 of
// a slab test's 10 minima and maxima go), was 11% faster on camera rays and
// 7% slower on bounce rays in lane order, and the engine sends as many
// launches of the one kind as of the other; picking the near and far plane
// by that sign per ray and cut made no difference.
//
// Numerics, held bit for bit against the plain PyTorch twin
// (ops/keys.py::coherence_key_twin): built without fast math and with FMA
// contraction off (-fmad=false, ops/_build.py); 1/d is an IEEE division of the
// guarded direction where(|d| < 1e-12, 1e-12, d); the Morton quantisation is a
// true division (ro - lo) / max(hi - lo, 1e-6) * 15, never a reciprocal
// multiply; the f32 -> i32 cast after the clip truncates.

#include <cuda_runtime.h>
#include <stdint.h>

#define KEY_MAX_CUT 64
#define KEY_CUT_LIMIT 8191
#define KEY_STATIC_CUT 32
#define KEY_BLOCK 256
#define KEY_RAYS 1

struct KeyTable {
  float box[KEY_MAX_CUT + 1][6];  // rows 0..C-1: cut boxes; row C: the root box
};

// The same rows in device memory: tab.box[c][k] loads row c's value k
// through the read-only cache.
struct KeyRowsDev {
  const float* rows;
  struct Row {
    const float* p;
    __device__ __forceinline__ float operator[](int k) const { return __ldg(p + k); }
  };
  __device__ __forceinline__ Row operator[](int c) const { return Row{rows + 6 * c}; }
};
struct KeyTableDev {
  KeyRowsDev box;
};

// NC > 0: the cut count at compile time; NC == 0: n_cut_rt at run time.
// Table: KeyTable (by value) or KeyTableDev (a device pointer).
template <int NC, class Table = KeyTable>
__global__ void __launch_bounds__(KEY_BLOCK) key_kernel(const __grid_constant__ Table tab,
                                                        int n_cut_rt,
                                                        const float* __restrict__ rox,
                                                        const float* __restrict__ roy,
                                                        const float* __restrict__ roz,
                                                        const float* __restrict__ rdx,
                                                        const float* __restrict__ rdy,
                                                        const float* __restrict__ rdz, int n,
                                                        float tri_tmin, int32_t* __restrict__ key) {
  const int n_cut = NC > 0 ? NC : n_cut_rt;
  const int i0 = blockIdx.x * (KEY_BLOCK * KEY_RAYS) + threadIdx.x;
  float ro[KEY_RAYS][3], rd[KEY_RAYS][3], inv[KEY_RAYS][3];
#pragma unroll
  for (int r = 0; r < KEY_RAYS; ++r) {
    // A slot past the end reads the last ray and stores nothing.
    const int i = min(i0 + r * KEY_BLOCK, n - 1);
    ro[r][0] = rox[i];
    ro[r][1] = roy[i];
    ro[r][2] = roz[i];
    rd[r][0] = rdx[i];
    rd[r][1] = rdy[i];
    rd[r][2] = rdz[i];
  }
#pragma unroll
  for (int r = 0; r < KEY_RAYS; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      inv[r][k] = 1.0f / (fabsf(rd[r][k]) < 1e-12f ? 1e-12f : rd[r][k]);

  const float inf = __int_as_float(0x7f800000);
  float best_t[KEY_RAYS];
  int best_i[KEY_RAYS];
#pragma unroll
  for (int r = 0; r < KEY_RAYS; ++r) {
    best_t[r] = inf;
    best_i[r] = 0;
  }
#pragma unroll 8
  for (int c = 0; c < n_cut; ++c) {
#pragma unroll
    for (int r = 0; r < KEY_RAYS; ++r) {
      float tnear = 0.0f, tfar = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float t0 = (tab.box[c][k] - ro[r][k]) * inv[r][k];
        const float t1 = (tab.box[c][3 + k] - ro[r][k]) * inv[r][k];
        const float lo = fminf(t0, t1), hi = fmaxf(t0, t1);
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
#pragma unroll
  for (int r = 0; r < KEY_RAYS; ++r) {
    const int i = i0 + r * KEY_BLOCK;
    if (i >= n) continue;
    const int miss = best_t[r] == inf ? 1 : 0;
    const int octant = (rd[r][0] < 0.0f ? 1 : 0) + 2 * (rd[r][1] < 0.0f ? 1 : 0) +
                       4 * (rd[r][2] < 0.0f ? 1 : 0);
    int morton = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float lo = tab.box[n_cut][k], hi = tab.box[n_cut][3 + k];
      const float span = fmaxf(hi - lo, 1e-6f);
      float v = (ro[r][k] - lo) / span * 15.0f;
      v = fminf(fmaxf(v, 0.0f), 15.0f);
      int q = (int)v;
      q = (q | (q << 4)) & 0x0C3;
      q = (q | (q << 2)) & 0x249;
      morton |= q << k;
    }
    key[i] = (miss << 30) | (best_i[r] << 17) | (octant << 13) | morton;
  }
}

// table is a HOST pointer to (n_cut + 1) * 6 floats, copied into the launch's
// argument buffer when n_cut <= KEY_MAX_CUT; dev_table is the same table in
// device memory, read when n_cut > KEY_MAX_CUT (it may be null otherwise).
extern "C" int rt_key_launch(const float* table, const float* dev_table, int n_cut,
                             const float* rox, const float* roy, const float* roz,
                             const float* rdx, const float* rdy, const float* rdz, int n,
                             float tri_tmin, int32_t* key, void* stream) {
  if (n_cut < 1 || n_cut > KEY_CUT_LIMIT || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int per_block = KEY_BLOCK * KEY_RAYS;
  const int blocks = (n + per_block - 1) / per_block;
  if (n_cut > KEY_MAX_CUT) {
    if (dev_table == nullptr) return (int)cudaErrorInvalidValue;
    const KeyTableDev dtab = {{dev_table}};
    key_kernel<0, KeyTableDev><<<blocks, KEY_BLOCK, 0, (cudaStream_t)stream>>>(
        dtab, n_cut, rox, roy, roz, rdx, rdy, rdz, n, tri_tmin, key);
    return (int)cudaGetLastError();
  }
  KeyTable tab = {};
  for (int r = 0; r <= n_cut; ++r)
    for (int k = 0; k < 6; ++k) tab.box[r][k] = table[6 * r + k];
  auto kernel = n_cut == KEY_STATIC_CUT ? key_kernel<KEY_STATIC_CUT> : key_kernel<0>;
  kernel<<<blocks, KEY_BLOCK, 0, (cudaStream_t)stream>>>(tab, n_cut, rox, roy, roz, rdx, rdy, rdz,
                                                         n, tri_tmin, key);
  return (int)cudaGetLastError();
}
