// Kernel 2: one binned wavefront bounce -- worklist trace, hit attributes,
// shading.
//
// Replaces the TPU kernel pathtracerap_tpu/pallas/megakernel.py::_bounce_kernel
// (launched by _bounce_call) with its device helpers _trace_inkernel (sub
// mode), _accept_chain, select_attrs and _shade_inkernel_t.  Same contract:
// a tile whose rays are all dead passes its state through; otherwise each
// ray finds the nearest accepted triangle over its tile's worklist (exact-t
// ties to the lowest global index), reads the winner's attribute rows and
// is shaded with this bounce's 4 uniforms into a new 10-column state
// [orig, dir, color, remaining].  Dead rays keep their state.  The hit
// triangle's index (-1: miss, or a tile with no live ray) is written too.
//
// What bounds it on the H100: as kernel 1, FP32 FMA issue in the sweep --
// about 50 flops per (ray, triangle) against 88 bytes of shared operands;
// the shading is a few hundred flops per ray, once.  The design: one thread
// block per 256-ray tile, one thread per ray; the worklist holds
// 128-triangle sub-block ids (or whole blocks above 64 blocks), sorted by
// the tile's entry distance; for each entry the threads stage its 22
// operand rows (11 KB) in shared memory and sweep it.  The TPU's groups of
// four sub-blocks, its one-hot attribute matmul and its lane-major shading
// layout are TPU devices and are not carried over: the winner's attributes
// are read directly from the (16, T) attribute rows.
//
// The shading mirrors render/shade.py::shade with the rsqrt normalization
// operation by operation (fmaf where the plain version fuses: dot and cross
// products), so that the kernel and its plain version round alike.

#include "common.cuh"

namespace {

constexpr float kTwoPi = 6.2831853071795864769f;
constexpr float kSqrt13 = 0.5773502691896257645f;
constexpr float kInvPhong = 1.0f / 31.0f;  // 1 / (METAL_PHONG_EXPONENT + 1)
constexpr float kSpawn = 0.1f;             // SPAWN_OFFSET
constexpr float kMiss = 0.01f;             // MISS_ATTENUATION
// MaterialType
constexpr float kDiffuse = 0.f, kSpecular = 1.f, kReflective = 2.f, kRefractive = 3.f,
                kEmissive = 4.f, kCoat = 5.f, kMetal = 6.f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 pick(bool c, V3 a, V3 b) { return c ? a : b; }
// torch.clamp(x, min=lo): NaN stays NaN (fmaxf would drop it)
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x));
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {fmaf(a.y, b.z, -(a.z * b.y)), fmaf(a.z, b.x, -(a.x * b.z)),
          fmaf(a.x, b.y, -(a.y * b.x))};
}

// v * rsqrt(max(|v|^2, 1e-30)): finite at v == 0
__device__ __forceinline__ V3 norm(V3 v) {
  return scale(rsqrtf(clamp_min(dot(v, v), 1e-30f)), v);
}

// parity: the reference's n - 2 (i . n) n (utility.h:64-69); else i - 2 (i . n) n
__device__ __forceinline__ V3 reflect(V3 i, V3 n, bool parity) {
  const V3 k = scale(2.0f * dot(i, n), n);
  return sub(parity ? n : i, k);
}

__device__ V3 cosine_hemisphere(V3 n, float u0, float u1) {
  const float up = sqrtf(clamp_min(u0, 0.0f));
  const float over = sqrtf(clamp_min(1.0f - up * up, 0.0f));
  const float around = u1 * kTwoPi;
  const V3 seed = fabsf(n.x) < kSqrt13   ? V3{1.f, 0.f, 0.f}
                  : fabsf(n.y) < kSqrt13 ? V3{0.f, 1.f, 0.f}
                                         : V3{0.f, 0.f, 1.f};
  const V3 t1 = norm(cross(n, seed));
  const V3 t2 = norm(cross(n, t1));
  return add(add(scale(up, n), scale(cosf(around) * over, t1)), scale(sinf(around) * over, t2));
}

__device__ V3 metal_scatter(V3 n, V3 d, float u2, float u3) {
  const float phi = kTwoPi * u2;
  const float cos_t = powf(clamp_min(1.0f - u3, 0.0f), kInvPhong);
  const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
  const V3 w = norm(sub(d, scale(2.0f * dot(n, d), n)));
  const V3 seed = fabsf(w.x) > 0.1f ? V3{0.f, 1.f, 0.f} : V3{1.f, 0.f, 0.f};
  const V3 u = norm(cross(seed, w));
  const V3 v = cross(w, u);
  return add(add(scale(cosf(phi) * sin_t, u), scale(sinf(phi) * sin_t, v)), scale(cos_t, w));
}

// Fresnel-roulette dielectric (quality mode); orient is the spawn side
__device__ V3 refract_scatter(V3 n, V3 d, float ri, float u3, float& orient) {
  const bool entering = dot(d, n) < 0.0f;
  const V3 n_eff = entering ? n : neg(n);
  float cos_i = -dot(d, n_eff);
  cos_i = cos_i < 0.0f ? 0.0f : (cos_i > 1.0f ? 1.0f : cos_i);
  const float eta = entering ? 1.0f / ri : ri;
  const float k = 1.0f - eta * eta * (1.0f - cos_i * cos_i);
  const bool tir = k < 0.0f;
  const float cos_t = sqrtf(clamp_min(k, 0.0f));
  const V3 refr = norm(add(scale(eta, d), scale(eta * cos_i - cos_t, n_eff)));
  const float q = (ri - 1.0f) / (ri + 1.0f);
  const float r0 = q * q;
  const float cos_x = entering ? cos_i : cos_t;
  const float fres = r0 + (1.0f - r0) * powf(1.0f - cos_x, 5.0f);
  const bool take_refl = tir || (u3 < fres);
  orient = (take_refl ? 1.0f : -1.0f) * (entering ? 1.0f : -1.0f);
  return take_refl ? reflect(d, n_eff, false) : refr;
}

struct Attrs {
  V3 n, rgb, gn;
  float mt, ri;
};

// One shading step of one ray (render/shade.py::shade; Renderer.cpp:411-479).
__device__ void shade(float* s, float t, const Attrs& a, const float* u, bool parity) {
  const V3 orig = {s[0], s[1], s[2]}, dir = {s[3], s[4], s[5]};
  const V3 color = {s[6], s[7], s[8]};
  const float remaining = s[9];
  const bool alive = remaining > 0.0f;
  const bool hit = t < PTT_F_MAX;
  const V3 unit_z = {0.f, 0.f, 1.f};
  const V3 n = hit ? a.n : unit_z;

  const V3 d = norm(dir);
  const V3 pt = add(orig, scale(t, d));
  V3 spawn = add(pt, scale(kSpawn, n));

  const float mt = a.mt;
  const bool is_diffuse = mt == kDiffuse, is_metal = mt == kMetal, is_coat = mt == kCoat;
  const bool is_emissive = mt == kEmissive, is_reflective = mt == kReflective;

  const V3 dir_diffuse = cosine_hemisphere(n, u[0], u[1]);
  const V3 dir_refl = reflect(d, n, parity);
  bool scatters = is_diffuse || is_metal || is_coat || is_reflective;
  V3 new_dir;
  if (is_diffuse) {
    new_dir = dir_diffuse;
  } else if (is_metal) {
    new_dir = metal_scatter(n, d, u[2], u[3]);
  } else if (is_coat) {
    new_dir = pick(u[0] < 0.5f, dir_refl, cosine_hemisphere(n, u[1], u[2]));
  } else {
    new_dir = dir_refl;
  }
  if (!parity) {
    const bool is_specular = mt == kSpecular, is_refractive = mt == kRefractive;
    scatters = scatters || is_specular || is_refractive;
    if (is_refractive) {
      float orient;
      new_dir = refract_scatter(n, d, a.ri, u[3], orient);
      spawn = add(pt, scale(kSpawn * orient, n));
    } else if (is_specular) {
      new_dir = dir_refl;
    }
  }
  const bool shaded = alive && hit;
  const bool upd_dir = shaded && scatters;
  const bool upd_col = shaded && (scatters || is_emissive);

  V3 mat_c = a.rgb;
  if (!parity) {
    // cosine throughput factor against the geometric normal
    const float cosf_ = dot(dir_diffuse, hit ? a.gn : unit_z);
    const float f = is_diffuse ? clamp_min(cosf_, 0.0f) : 1.0f;
    mat_c = {mat_c.x * f, mat_c.y * f, mat_c.z * f};
  }
  V3 col = upd_col ? V3{color.x * mat_c.x, color.y * mat_c.y, color.z * mat_c.z} : color;
  const bool missed = alive && !hit;
  if (missed) col = scale(kMiss, col);
  const bool kill = missed || (shaded && is_emissive);

  const V3 o2 = upd_dir ? spawn : orig;
  const V3 d2 = upd_dir ? new_dir : dir;
  s[0] = o2.x; s[1] = o2.y; s[2] = o2.z;
  s[3] = d2.x; s[4] = d2.y; s[5] = d2.z;
  s[6] = col.x; s[7] = col.y; s[8] = col.z;
  s[9] = kill ? 0.0f : (alive ? remaining - 1.0f : remaining);
}

}  // namespace

__global__ void bounce_kernel(const float* __restrict__ state,  // (N, 10)
                              const float* __restrict__ uni,    // (N, 4)
                              const int* __restrict__ lists,    // (nt, list_w)
                              int list_w, int unit,
                              const float* __restrict__ ops,    // (16, 4 * attr_cols)
                              const float* __restrict__ attr,   // (16, attr_cols)
                              int attr_cols, int tri_block, int parity,
                              float* __restrict__ out,          // (N, 10)
                              int* __restrict__ idx_out) {      // (N,) hit or -1
  extern __shared__ float sm[];
  const int tile = blockIdx.x;
  const size_t ray = (size_t)tile * blockDim.x + threadIdx.x;
  float s[10];
  for (int k = 0; k < 10; ++k) s[k] = state[ray * 10 + k];
  if (!__syncthreads_or(s[9] > 0.0f)) {  // no live ray in the tile
    for (int k = 0; k < 10; ++k) out[ray * 10 + k] = s[k];
    idx_out[ray] = -1;
    return;
  }
  const RayVec r = state_ray(s);

  float best = PTT_F_MAX;
  int best_idx = -1;
  const int* row = lists + (size_t)tile * list_w;
  for (int j = 0; j < list_w; ++j) {
    const int id = row[j];
    if (id < 0) break;  // -1 padding is a suffix of the row
    __syncthreads();
    stage_ops(sm, ops, 4 * attr_cols, id * unit, unit, tri_block);
    __syncthreads();
    sweep(sm, unit, id * unit, r, best, best_idx);
  }

  Attrs a = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, 0.f, 0.f};
  if (best_idx >= 0) {
    const float* c = attr + best_idx;
    const size_t ld = attr_cols;
    a.n = {c[0 * ld], c[1 * ld], c[2 * ld]};
    a.mt = c[3 * ld];
    a.rgb = {c[4 * ld], c[5 * ld], c[6 * ld]};
    a.gn = {c[7 * ld], c[8 * ld], c[9 * ld]};
    a.ri = c[11 * ld];
  }
  shade(s, best, a, uni + ray * 4, parity != 0);
  for (int k = 0; k < 10; ++k) out[ray * 10 + k] = s[k];
  idx_out[ray] = best_idx;
}

extern "C" int ptt_bounce(const float* state, const float* uni, const int* lists, int nt,
                          int list_w, int unit, int ray_tile, const float* ops,
                          const float* attr, int attr_cols, int tri_block, int parity,
                          float* out, int* idx_out, void* stream) {
  if (nt == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)PTT_ROWS * unit * sizeof(float);
  cudaError_t err = set_smem(bounce_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  bounce_kernel<<<nt, ray_tile, smem, (cudaStream_t)stream>>>(
      state, uni, lists, list_w, unit, ops, attr, attr_cols, tri_block, parity, out, idx_out);
  return (int)cudaGetLastError();
}
