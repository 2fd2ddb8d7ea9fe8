// Bounce megakernel for Hopper (sm_90a): the whole per-lane path-trace loop
// of one or several row bands in one kernel.
//
// Replaces raytracer_tpu/ops/pallas/megakernel.py::_mega_kernel (K1). It
// computes what that kernel computes, lane for lane, and not its layout:
//
// - One thread per lane, slot = pixel*4 + sub. Each thread runs its own loop
//   it = 0, 1, ... until it has no live path and no samples left, or until
//   hard_cap = num_samples*(max_depth+2)+64. The Pallas kernel loops per
//   [rows,128] block with a block-wide "work remains" reduction and an i32
//   active mask; those are workarounds for the TPU compiler, not the spec. A
//   lane without work changes no state there, so a lane sees the same
//   iteration numbers, and the same random draws, in both.
// - Random numbers: the counter hash over (lane ^ seed, it, draw), draws 0-6
//   as in the JAX kernel's interpret mode (the TPU build uses the TPU's
//   hardware generator, which this card does not have).
// - The scene table pf (a few hundred f32: camera, light, spheres, planes,
//   <=32 triangles, materials) is a by-value __grid_constant__ argument, so
//   it lives in the constant bank. The primitive loops read it there: their
//   index is the same in every lane of a warp, so each read is a broadcast
//   and an operand of the arithmetic instruction itself, with no load. The
//   material rows are the one divergent read (the lanes of a warp hit
//   different objects), which the constant cache serves once per distinct
//   address; each block copies them into shared memory at its start, which
//   serves a warp in one access (a bank conflict at worst). Staging the
//   whole table in shared memory instead makes every uniform read a load:
//   slower on cornell_box, faster on cubes (raytracer_tpu_torch/tools/
//   kernel_steps.py times this and each choice below against its
//   alternative on the card).
// - Several bands in one launch: lane g belongs to band g / n_band, whose
//   (y0, seed) the band table gives, and keeps its slot g % n_band, so
//   every draw and every pixel equals the one-band launch's. A 600x450
//   frame is 1.08M lanes in one launch instead of nine 120,000-lane ones
//   (938 blocks, less than one wave of the card's 132 SMs).
//
// Cost: the kernel reads a few hundred scalars and writes 16 bytes per lane,
// so device memory does not bound it. Per-thread FP32 and SFU work (sqrt,
// division, sin/cos) bounds it, and so does divergence: the threads of a
// warp run until the warp's longest path ends, and Russian roulette makes
// path lengths vary. No sorting or compaction of lanes.
//
// Numerics: no fast math; sqrtf, division, sinf and cosf are the accurate
// IEEE forms, and normalization multiplies by 1/sqrtf (not rsqrtf). The
// library is built with FMA contraction OFF (-fmad=false, ops/_build.py), so
// every expression rounds after each operation exactly as the plain PyTorch
// twin (ops/megakernel.py::mega_twin) does on the card. The stated lane
// tolerance (ops/megakernel.py LANE_RTOL, LANE_SHARE): |kernel - twin| <=
// 1e-4 * max(1, |twin|) on >= 99% of lanes, band means within 1e-3; on an
// H100 the two agree bit for bit on every lane.

#include <cuda_runtime.h>
#include <stdint.h>

#define INF_F 3.0e38f
#define INV_PI_F 0.318309886183790671538f
#define TWO_PI_F 6.28318530717958647692f

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 mk(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 add3(V3 a, V3 b) { return mk(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub3(V3 a, V3 b) { return mk(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 mul3(V3 a, V3 b) { return mk(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 scale3(V3 a, float s) { return mk(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
// max(a, b) that keeps a NaN in a, like jnp.maximum / torch.clamp_min.
__device__ __forceinline__ float maxn(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ V3 normalize3(V3 v) { return scale3(v, 1.0f / sqrtf(dot3(v, v))); }
__device__ __forceinline__ V3 ld3(const float* p) { return mk(p[0], p[1], p[2]); }

__device__ __forceinline__ uint32_t hash3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t h = (a * 0xCC9E2D51u) ^ (b * 0x1B873593u) ^ (c * 0x85EBCA6Bu);
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float uniform(uint32_t lane_seed, uint32_t it, uint32_t draw) {
  return (float)(hash3(lane_seed, it, draw) >> 8) * (1.0f / 16777216.0f);
}

// Capacity of the by-value scene table: with Params and the pointers it
// stays under the classic 4 KB kernel-argument limit. cornell_box needs 167
// floats, cubes 469.
#define MEGA_PF_MAX 960

struct SceneTable {
  float v[MEGA_PF_MAX];
};

struct Params {
  int ns, np, nt, no, width, height, num_samples, n_band, n_valid;
  int rr_start_depth;
  float rr_survival;
  int max_depth;
  float sphere_tmin, plane_parallel, hit_offset, visibility_margin, tri_tmin, tri_parallel;
};

// Offsets of the primitive groups in the table (same order as the JAX pf).
struct Layout {
  int sph, pln, tri, mat;
};

__device__ __forceinline__ float sphere_t(const float* s, V3 ro, V3 rd, float tmin, float* det_out) {
  V3 oc = sub3(ld3(s), ro);
  float b = dot3(oc, rd);
  float r = s[3];
  float det = b * b - dot3(oc, oc) + r * r;
  float sq = sqrtf(maxn(det, 0.0f));
  float t_near = b - sq;
  float t_far = b + sq;
  *det_out = det;
  return t_near > tmin ? t_near : (t_far > tmin ? t_far : INF_F);
}

__device__ __forceinline__ bool plane_t(const float* s, V3 ro, V3 rd, float parallel, float* t_out) {
  V3 n = ld3(s + 3);
  float d_n = dot3(n, rd);
  float t = (dot3(n, ld3(s)) - dot3(n, ro)) / d_n;
  *t_out = t;
  return fabsf(d_n) >= parallel && t >= 0.0f;
}

__device__ __forceinline__ bool tri_t(const float* s, V3 ro, V3 rd, float parallel, float tmin,
                                      float* t_out) {
  V3 n = ld3(s);
  float denom = dot3(n, rd);
  float t = (s[3] - dot3(n, ro)) / denom;
  V3 q1 = ld3(s + 4), q2 = ld3(s + 8);
  float u = dot3(q1, ro) + t * dot3(q1, rd) - s[7];
  float v = dot3(q2, ro) + t * dot3(q2, rd) - s[11];
  *t_out = t;
  return fabsf(denom) >= parallel && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
         t > tmin;
}

// Nearest hit: returns false on a miss; else the object, the two-sided
// normal and the hit position (offset along the normal for non-spheres).
// Ties go to the earlier primitive, spheres before planes before triangles.
__device__ __forceinline__ bool trace(const float* pf, const Layout& lay, const Params& p, V3 ro, V3 rd,
                      int* obj, V3* n_out, V3* pos_out) {
  float t_best = INF_F;
  V3 v = mk(0.f, 0.f, 0.f);
  bool is_sph = false;
  float objf = 0.f;
  for (int s = 0; s < p.ns; ++s) {
    const float* q = pf + lay.sph + 5 * s;
    float det;
    float t = sphere_t(q, ro, rd, p.sphere_tmin, &det);
    t = det >= 0.0f ? t : INF_F;
    if (t < t_best) {
      t_best = t;
      v = ld3(q);
      is_sph = true;
      objf = q[4];
    }
  }
  for (int s = 0; s < p.np; ++s) {
    const float* q = pf + lay.pln + 7 * s;
    float t;
    bool ok = plane_t(q, ro, rd, p.plane_parallel, &t);
    t = ok ? t : INF_F;
    if (t < t_best) {
      t_best = t;
      v = ld3(q + 3);
      is_sph = false;
      objf = q[6];
    }
  }
  for (int s = 0; s < p.nt; ++s) {
    const float* q = pf + lay.tri + 13 * s;
    float t;
    bool ok = tri_t(q, ro, rd, p.tri_parallel, p.tri_tmin, &t);
    t = ok ? t : INF_F;
    if (t < t_best) {
      t_best = t;
      v = ld3(q);
      is_sph = false;
      objf = q[12];
    }
  }
  if (!(t_best < INF_F)) return false;
  V3 pos = add3(ro, scale3(rd, t_best));
  V3 n;
  if (is_sph) {
    V3 d = sub3(pos, v);
    n = scale3(d, 1.0f / sqrtf(maxn(dot3(d, d), 1e-20f)));
  } else {
    n = v;
  }
  if (dot3(n, rd) > 0.0f) n = scale3(n, -1.0f);
  float off = is_sph ? 0.0f : p.hit_offset;
  *pos_out = add3(pos, scale3(n, off));
  *n_out = n;
  *obj = (int)objf;
  return true;
}

// Any hit strictly below `bound` (the result is an OR, so stop at the first).
__device__ __forceinline__ bool occluded(const float* pf, const Layout& lay, const Params& p, V3 ro, V3 rd,
                         float bound) {
  for (int s = 0; s < p.ns; ++s) {
    float det;
    float t = sphere_t(pf + lay.sph + 5 * s, ro, rd, p.sphere_tmin, &det);
    if (det >= 0.0f && t < bound) return true;
  }
  for (int s = 0; s < p.np; ++s) {
    float t;
    if (plane_t(pf + lay.pln + 7 * s, ro, rd, p.plane_parallel, &t) && t < bound) return true;
  }
  for (int s = 0; s < p.nt; ++s) {
    float t;
    if (tri_t(pf + lay.tri + 13 * s, ro, rd, p.tri_parallel, p.tri_tmin, &t) && t < bound)
      return true;
  }
  return false;
}

#define MEGA_BLOCK 128

// At least 8 resident blocks per SM caps the registers at 64 a thread (half
// the card's thread slots resident), which ptxas meets without spills and
// which runs the cornell_box frame faster than the compiler's own choice of
// 69. (The 32-byte stack frame ptxas reports is sinf/cosf's scratch for
// arguments past 1e5, which these never reach.)
__global__ void __launch_bounds__(MEGA_BLOCK, 8)
    mega_kernel(const __grid_constant__ SceneTable tab, const __grid_constant__ Params p,
                const int2* __restrict__ bands, float* __restrict__ acc_out,
                int* __restrict__ rays_out) {
  const float* pf = tab.v;
  Layout lay;
  lay.sph = 20;
  lay.pln = lay.sph + 5 * p.ns;
  lay.tri = lay.pln + 7 * p.np;
  lay.mat = lay.tri + 13 * p.nt;
  __shared__ float mats[MEGA_PF_MAX];
  for (int k = threadIdx.x; k < 10 * p.no; k += MEGA_BLOCK) mats[k] = pf[lay.mat + k];
  __syncthreads();
  const int g = blockIdx.x * MEGA_BLOCK + threadIdx.x;
  if (g >= p.n_valid) return;
  const int band = g / p.n_band;
  const int slot = g - band * p.n_band;
  const int2 bd = bands[band];  // (y0, seed)

  const V3 cam_pos = ld3(pf + 0), cam_dir = ld3(pf + 3), cx = ld3(pf + 6), cy = ld3(pf + 9);
  const V3 light_pos = ld3(pf + 12), light_e = ld3(pf + 16);
  const float light_r = pf[15], light_area = pf[19];

  const uint32_t lane_seed = (uint32_t)slot ^ (uint32_t)bd.y;
  const int pix = slot / 4, sub = slot % 4;
  const float px = (float)(pix % p.width);
  const float py = (float)(bd.x + pix / p.width);
  const float sx = (float)(sub % 2), sy = (float)(sub / 2);
  const float fw = (float)p.width, fh = (float)p.height;
  const int hard_cap = p.num_samples * (p.max_depth + 2) + 64;

  int rays = 0, j = 0, depth = 0;
  bool active = false;
  V3 ro = mk(0.f, 0.f, 0.f), rd = ro, L = ro, beta = ro, emis = ro, acc = ro;

  for (int it = 0; it < hard_cap; ++it) {
    const uint32_t itu = (uint32_t)it;
    // 1) regenerate: an idle lane starts its next sample
    if (!active && j < p.num_samples) {
      float r1 = 2.0f * uniform(lane_seed, itu, 0);
      float dx = r1 < 1.0f ? sqrtf(r1) - 1.0f : 1.0f - sqrtf(maxn(2.0f - r1, 0.0f));
      float r2 = 2.0f * uniform(lane_seed, itu, 1);
      float dy = r2 < 1.0f ? sqrtf(r2) - 1.0f : 1.0f - sqrtf(maxn(2.0f - r2, 0.0f));
      float fx = ((sx + 0.5f + dx) / 2.0f + px) / fw - 0.5f;
      float fy = ((sy + 0.5f + dy) / 2.0f + py) / fh - 0.5f;
      ro = cam_pos;
      rd = normalize3(add3(add3(scale3(cx, fx), scale3(cy, fy)), cam_dir));
      depth = 0;
      L = mk(0.f, 0.f, 0.f);
      beta = mk(1.f, 1.f, 1.f);
      emis = beta;
      j += 1;
      active = true;
    }
    if (!active) break;  // no live path and no samples left

    // 2) main trace
    rays += 1;
    int obj;
    V3 nrm, x;
    bool valid = trace(pf, lay, p, ro, rd, &obj, &nrm, &x);
    depth += 1;
    bool live = false;
    if (valid) {
      const float* m = mats + 10 * obj;  // is_spec, f_d[3], c_s[3], em[3]
      // 3) arrival emission
      L = add3(L, mul3(emis, ld3(m + 7)));
      V3 o = scale3(rd, -1.0f);
      bool is_spec = m[0] > 0.5f;
      V3 f_d = ld3(m + 1), c_s = ld3(m + 4);

      // 4) NEE: uniform sphere-light sample + shadow test
      if (!is_spec) {
        float zl = 2.0f * uniform(lane_seed, itu, 2) - 1.0f;
        float rl = sqrtf(maxn(1.0f - zl * zl, 0.0f));
        float phil = TWO_PI_F * uniform(lane_seed, itu, 3);
        V3 ny = mk(rl * cosf(phil), rl * sinf(phil), zl);
        V3 to_y = sub3(add3(light_pos, scale3(ny, light_r)), x);
        float dist = sqrtf(maxn(dot3(to_y, to_y), 1e-20f));
        V3 wi_d = scale3(to_y, 1.0f / dist);
        float r2l = maxn(dist * dist, 1e-20f);
        rays += 1;
        bool occ = occluded(pf, lay, p, x, wi_d, dist - p.visibility_margin);
        float cos_x = dot3(nrm, wi_d);
        float cos_y = dot3(ny, scale3(wi_d, -1.0f));
        float scale = (occ ? 0.0f : 1.0f) * cos_x * cos_y * (light_area / r2l);
        V3 direct = mk(light_e.x * f_d.x * scale, light_e.y * f_d.y * scale,
                       light_e.z * f_d.z * scale);
        L = add3(L, mul3(beta, direct));
      }

      // 5) Russian roulette + BSDF sample
      float p_rr = depth <= p.rr_start_depth ? 1.0f : p.rr_survival;
      bool cont = uniform(lane_seed, itu, 4) < p_rr && depth < p.max_depth;
      float inv_p = 1.0f / p_rr;
      V3 wi, weight;
      if (is_spec) {
        wi = sub3(scale3(nrm, 2.0f * dot3(o, nrm)), o);
        weight = scale3(c_s, inv_p);
      } else {
        float zc = sqrtf(uniform(lane_seed, itu, 5));
        float rc = sqrtf(maxn(1.0f - zc * zc, 0.0f));
        float phic = TWO_PI_F * uniform(lane_seed, itu, 6);
        bool use_y = fabsf(nrm.x) > 0.1f;
        V3 helper = mk(use_y ? 0.0f : 1.0f, use_y ? 1.0f : 0.0f, 0.0f);
        V3 ub = normalize3(cross3(helper, nrm));
        V3 vb = cross3(nrm, ub);
        wi = add3(add3(scale3(ub, rc * cosf(phic)), scale3(vb, rc * sinf(phic))),
                  scale3(nrm, zc));
        float cos_c = dot3(nrm, wi);
        float pdf_b = maxn(cos_c, 0.0f) * INV_PI_F;
        float pdf_floor = maxn(pdf_b, 1e-12f);
        bool pos_pdf = pdf_b > 1e-12f;
        V3 w = mk(pos_pdf ? f_d.x * cos_c / pdf_floor : 0.0f,
                  pos_pdf ? f_d.y * cos_c / pdf_floor : 0.0f,
                  pos_pdf ? f_d.z * cos_c / pdf_floor : 0.0f);
        weight = scale3(w, inv_p);
      }
      V3 beta_next = mul3(beta, weight);
      live = cont && (beta_next.x > 0.0f || beta_next.y > 0.0f || beta_next.z > 0.0f);
      // A mirror bounce collects the next hit's emission at beta/p; a
      // diffuse one collects none (NEE already counted the light).
      emis = is_spec ? scale3(beta, inv_p) : mk(0.f, 0.f, 0.f);
      beta = beta_next;
      if (live) {
        ro = x;
        rd = wi;
      }
    }
    // 6) completion: bank the finished path
    if (!live) acc = add3(acc, L);
    active = live;
    if (!live && j >= p.num_samples) break;
  }
  acc_out[3 * g + 0] = acc.x;
  acc_out[3 * g + 1] = acc.y;
  acc_out[3 * g + 2] = acc.z;
  rays_out[g] = rays;
}

// pf is a HOST pointer to n_pf floats; it is copied into the launch's
// argument buffer, so the caller may free it as soon as this returns. bands
// is a DEVICE array of n_bands (y0, seed) pairs; lane g of the launch is
// slot g % n_band of band g / n_band, and acc/rays hold n_bands * n_band
// lanes.
extern "C" int rt_mega_launch(const float* pf, int n_pf, int ns, int np, int nt, int no, int width,
                              int height, const int* bands, int n_bands, int n_band,
                              int num_samples, int rr_start_depth, float rr_survival,
                              int max_depth, float sphere_tmin, float plane_parallel,
                              float hit_offset, float visibility_margin, float tri_tmin,
                              float tri_parallel, float* acc, int* rays, void* stream) {
  if (n_pf < 0 || n_pf > MEGA_PF_MAX || n_pf != 20 + 5 * ns + 7 * np + 13 * nt + 10 * no ||
      n_bands < 0 || n_band < 0 ||
      (long)n_bands * n_band > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  SceneTable tab = {};
  for (int i = 0; i < n_pf; ++i) tab.v[i] = pf[i];
  Params p;
  p.ns = ns;
  p.np = np;
  p.nt = nt;
  p.no = no;
  p.width = width;
  p.height = height;
  p.num_samples = num_samples;
  p.n_band = n_band;
  p.n_valid = n_bands * n_band;
  p.rr_start_depth = rr_start_depth;
  p.rr_survival = rr_survival;
  p.max_depth = max_depth;
  p.sphere_tmin = sphere_tmin;
  p.plane_parallel = plane_parallel;
  p.hit_offset = hit_offset;
  p.visibility_margin = visibility_margin;
  p.tri_tmin = tri_tmin;
  p.tri_parallel = tri_parallel;
  if (p.n_valid == 0) return 0;
  const int blocks = (p.n_valid + MEGA_BLOCK - 1) / MEGA_BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  mega_kernel<<<blocks, MEGA_BLOCK, 0, s>>>(tab, p, (const int2*)bands, acc, rays);
  return (int)cudaGetLastError();
}
