// Shading device code shared by kernels 2, 4 and S1 (bounce.cu,
// megakernel.cu, defer_shade.cu).
//
// One shading step of one ray, render/shade.py::shade, operation by
// operation: fmaf where the plain version fuses (dot and cross products),
// so that the kernels and their plain versions round alike.  The
// normalization is a template parameter, fixed by the shading a kernel
// replaces: kernels 2 and 4 take the rsqrt form (Exact false; the TPU
// kernels' _shade_inkernel, ops/math.py normalize_rsqrt), S1 the exact one
// (Exact true; ops/math.py normalize, the XLA shading of the JAX package's
// deferred bounce).  The material constants mirror constants.py and
// scene/types.py::MaterialType.
//
// Everything here sits in an anonymous namespace: each kernel source gets
// its own copy, and nothing is linked across sources.
#pragma once

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

// Exact: v / sqrt(|v|^2), with IEEE sqrtf and division; else v * rsqrt(max(
// |v|^2, 1e-30)), finite at v == 0
template <bool Exact>
__device__ __forceinline__ V3 norm(V3 v) {
  if (Exact) {
    const float len = sqrtf(dot(v, v));
    return {v.x / len, v.y / len, v.z / len};
  }
  return scale(rsqrtf(clamp_min(dot(v, v), 1e-30f)), v);
}

// parity: the reference's n - 2 (i . n) n (utility.h:64-69); else i - 2 (i . n) n
__device__ __forceinline__ V3 reflect(V3 i, V3 n, bool parity) {
  const V3 k = scale(2.0f * dot(i, n), n);
  return sub(parity ? n : i, k);
}

template <bool Exact>
__device__ V3 cosine_hemisphere(V3 n, float u0, float u1) {
  const float up = sqrtf(clamp_min(u0, 0.0f));
  const float over = sqrtf(clamp_min(1.0f - up * up, 0.0f));
  const float around = u1 * kTwoPi;
  const V3 seed = fabsf(n.x) < kSqrt13   ? V3{1.f, 0.f, 0.f}
                  : fabsf(n.y) < kSqrt13 ? V3{0.f, 1.f, 0.f}
                                         : V3{0.f, 0.f, 1.f};
  const V3 t1 = norm<Exact>(cross(n, seed));
  const V3 t2 = norm<Exact>(cross(n, t1));
  return add(add(scale(up, n), scale(cosf(around) * over, t1)), scale(sinf(around) * over, t2));
}

template <bool Exact>
__device__ V3 metal_scatter(V3 n, V3 d, float u2, float u3) {
  const float phi = kTwoPi * u2;
  const float cos_t = powf(clamp_min(1.0f - u3, 0.0f), kInvPhong);
  const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
  const V3 w = norm<Exact>(sub(d, scale(2.0f * dot(n, d), n)));
  const V3 seed = fabsf(w.x) > 0.1f ? V3{0.f, 1.f, 0.f} : V3{1.f, 0.f, 0.f};
  const V3 u = norm<Exact>(cross(seed, w));
  const V3 v = cross(w, u);
  return add(add(scale(cosf(phi) * sin_t, u), scale(sinf(phi) * sin_t, v)), scale(cos_t, w));
}

// Fresnel-roulette dielectric (quality mode); orient is the spawn side
template <bool Exact>
__device__ V3 refract_scatter(V3 n, V3 d, float ri, float u3, float& orient) {
  const bool entering = dot(d, n) < 0.0f;
  const V3 n_eff = entering ? n : neg(n);
  float cos_i = -dot(d, n_eff);
  cos_i = cos_i < 0.0f ? 0.0f : (cos_i > 1.0f ? 1.0f : cos_i);
  const float eta = entering ? 1.0f / ri : ri;
  const float k = 1.0f - eta * eta * (1.0f - cos_i * cos_i);
  const bool tir = k < 0.0f;
  const float cos_t = sqrtf(clamp_min(k, 0.0f));
  const V3 refr = norm<Exact>(add(scale(eta, d), scale(eta * cos_i - cos_t, n_eff)));
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

// The winner's attribute rows [shade_n, mat_type, rgb, geom_n, idx+1, ri]
// (WorldTriangles.attr_rows, (16, attr_cols) row-major).
__device__ __forceinline__ Attrs read_attrs(const float* __restrict__ attr, int attr_cols,
                                            int idx) {
  const float* c = attr + idx;
  const size_t ld = attr_cols;
  Attrs a;
  a.n = {c[0 * ld], c[1 * ld], c[2 * ld]};
  a.mt = c[3 * ld];
  a.rgb = {c[4 * ld], c[5 * ld], c[6 * ld]};
  a.gn = {c[7 * ld], c[8 * ld], c[9 * ld]};
  a.ri = c[11 * ld];
  return a;
}

// One shading step of one ray (render/shade.py::shade; Renderer.cpp:411-479).
template <bool Exact>
__device__ void shade(float* s, float t, const Attrs& a, const float* u, bool parity) {
  const V3 orig = {s[0], s[1], s[2]}, dir = {s[3], s[4], s[5]};
  const V3 color = {s[6], s[7], s[8]};
  const float remaining = s[9];
  const bool alive = remaining > 0.0f;
  const bool hit = t < PTT_F_MAX;
  const V3 unit_z = {0.f, 0.f, 1.f};
  const V3 n = hit ? a.n : unit_z;

  const V3 d = norm<Exact>(dir);
  const V3 pt = add(orig, scale(t, d));
  V3 spawn = add(pt, scale(kSpawn, n));

  const float mt = a.mt;
  const bool is_diffuse = mt == kDiffuse, is_metal = mt == kMetal, is_coat = mt == kCoat;
  const bool is_emissive = mt == kEmissive, is_reflective = mt == kReflective;

  const V3 dir_diffuse = cosine_hemisphere<Exact>(n, u[0], u[1]);
  const V3 dir_refl = reflect(d, n, parity);
  bool scatters = is_diffuse || is_metal || is_coat || is_reflective;
  V3 new_dir;
  if (is_diffuse) {
    new_dir = dir_diffuse;
  } else if (is_metal) {
    new_dir = metal_scatter<Exact>(n, d, u[2], u[3]);
  } else if (is_coat) {
    new_dir = pick(u[0] < 0.5f, dir_refl, cosine_hemisphere<Exact>(n, u[1], u[2]));
  } else {
    new_dir = dir_refl;
  }
  if (!parity) {
    const bool is_specular = mt == kSpecular, is_refractive = mt == kRefractive;
    scatters = scatters || is_specular || is_refractive;
    if (is_refractive) {
      float orient;
      new_dir = refract_scatter<Exact>(n, d, a.ri, u[3], orient);
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
