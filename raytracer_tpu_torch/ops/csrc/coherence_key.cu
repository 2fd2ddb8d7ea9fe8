// Traversal-coherence sort key for Hopper (sm_90a).
//
// Replaces raytracer_tpu/ops/pallas/key_kernel.py::_key_kernel (K3), whose
// output is bit-identical to raytracer_tpu/ops/bvh.py::_coherence_key. Per ray
// it writes the i32 key
//     miss << 30 | entry << 17 | octant << 13 | morton12
// where entry is the treetop-cut box the ray enters first (nearest slab
// entry, ties to the lower cut index) and miss says it enters none.
//
// One thread per ray. The (C+1) x 6 table of cut boxes plus the root box is a
// by-value __grid_constant__ argument (198 floats at C = 32), so every thread
// reads it through the constant cache with warp-uniform broadcasts. The rays
// come in as six f32 columns (coalesced 4-byte loads) and the key goes out as
// one i32: 28 bytes of device memory per ray, so the kernel is bound by
// device-memory bandwidth (1M rays move 28 MB, ~10 us at 3.35 TB/s) plus ~32
// slab tests of FP32 work per ray.
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

struct KeyTable {
  float box[KEY_MAX_CUT + 1][6];  // rows 0..C-1: cut boxes; row C: the root box
};

__global__ void __launch_bounds__(256) key_kernel(const __grid_constant__ KeyTable tab, int n_cut,
                                                  const float* __restrict__ rox,
                                                  const float* __restrict__ roy,
                                                  const float* __restrict__ roz,
                                                  const float* __restrict__ rdx,
                                                  const float* __restrict__ rdy,
                                                  const float* __restrict__ rdz, int n,
                                                  float tri_tmin, int32_t* __restrict__ key) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ro[3] = {rox[i], roy[i], roz[i]};
  const float rd[3] = {rdx[i], rdy[i], rdz[i]};
  float inv[3];
  for (int k = 0; k < 3; ++k) inv[k] = 1.0f / (fabsf(rd[k]) < 1e-12f ? 1e-12f : rd[k]);

  const float inf = __int_as_float(0x7f800000);
  float best_t = inf;
  int best_i = 0;
  for (int c = 0; c < n_cut; ++c) {
    float tnear = 0.0f, tfar = 0.0f;
    for (int k = 0; k < 3; ++k) {
      float t0 = (tab.box[c][k] - ro[k]) * inv[k];
      float t1 = (tab.box[c][3 + k] - ro[k]) * inv[k];
      float lo = fminf(t0, t1), hi = fmaxf(t0, t1);
      tnear = k == 0 ? lo : fmaxf(tnear, lo);
      tfar = k == 0 ? hi : fminf(tfar, hi);
    }
    float tn = (tnear <= tfar && tfar > tri_tmin) ? tnear : inf;
    if (tn < best_t) {  // strict: ties keep the lower cut index
      best_t = tn;
      best_i = c;
    }
  }
  const int miss = best_t == inf ? 1 : 0;
  const int octant = (rd[0] < 0.0f ? 1 : 0) + 2 * (rd[1] < 0.0f ? 1 : 0) + 4 * (rd[2] < 0.0f ? 1 : 0);
  int morton = 0;
  for (int k = 0; k < 3; ++k) {
    float lo = tab.box[n_cut][k], hi = tab.box[n_cut][3 + k];
    float span = fmaxf(hi - lo, 1e-6f);
    float v = (ro[k] - lo) / span * 15.0f;
    v = fminf(fmaxf(v, 0.0f), 15.0f);
    int q = (int)v;
    q = (q | (q << 4)) & 0x0C3;
    q = (q | (q << 2)) & 0x249;
    morton |= q << k;
  }
  key[i] = (miss << 30) | (best_i << 17) | (octant << 13) | morton;
}

// table is a HOST pointer to (n_cut + 1) * 6 floats, copied into the launch's
// argument buffer.
extern "C" int rt_key_launch(const float* table, int n_cut, const float* rox, const float* roy,
                             const float* roz, const float* rdx, const float* rdy,
                             const float* rdz, int n, float tri_tmin, int32_t* key,
                             void* stream) {
  if (n_cut < 1 || n_cut > KEY_MAX_CUT || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  KeyTable tab = {};
  for (int r = 0; r <= n_cut; ++r)
    for (int k = 0; k < 6; ++k) tab.box[r][k] = table[6 * r + k];
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  key_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(tab, n_cut, rox, roy, roz, rdx, rdy,
                                                            rdz, n, tri_tmin, key);
  return (int)cudaGetLastError();
}
