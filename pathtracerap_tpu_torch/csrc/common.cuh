// Shared device code of the traversal kernels (trace_list.cu, bounce.cu,
// bounce_trace.cu, megakernel.cu, nearest_hit.cu).
//
// The fused operand pack `ops` is (16, 4*T) row-major: per block of TB
// triangles its columns are [s_ab | s_bc | s_ca | plane], so triangle g's
// quadrant-q column is (g / TB) * 4 * TB + q * TB + g % TB.  Edge columns
// hold [p x q, q - p] in rows 0-5, the plane column [-n, -d] in rows 6-9;
// every other entry is zero.  A ray's vector is [dir, orig x dir, orig, -1].
//
// Rules shared with the JAX reference (ops/plucker.py, pallas/trace.py):
//  * the accept chain is the five explicit comparisons below.  fminf/fmaxf
//    must not be used for it: fminf(NaN, x) returns x, whereas the
//    reference's min/max propagate NaN, and det == 0 lanes (NaN or inf
//    u, v, t) must be rejected;
//  * an entry replaces the best only on a strictly smaller t, or on an
//    equal finite t with a lower global triangle index;
//  * the side and plane sums are fused multiply-add chains in row order,
//    the rounding of the plain versions' f32 matrix product.
#pragma once

#include <cuda_runtime.h>

#define PTT_F_MAX 9999999.0f
#define PTT_NEG_EPS (-0.005f)
#define PTT_ONE_EPS 1.005f
// rows staged per triangle: 6 edge rows x 3 quadrants + 4 plane rows
#define PTT_ROWS 22

struct RayVec {
  float d0, d1, d2, m0, m1, m2, o0, o1, o2;
};

// The ray vector of a 10-column state row [orig, dir, color, remaining]:
// d = dir * rsqrt(max(|dir|^2, 1e-30)), m = orig x d, the plain versions'
// normalize_rsqrt and cross3 operation by operation.
__device__ __forceinline__ RayVec state_ray(const float* s) {
  const float o0 = s[0], o1 = s[1], o2 = s[2];
  const float dd = fmaf(s[5], s[5], fmaf(s[4], s[4], s[3] * s[3]));
  const float k = rsqrtf(dd < 1e-30f ? 1e-30f : dd);
  const float d0 = k * s[3], d1 = k * s[4], d2 = k * s[5];
  return {d0, d1, d2,
          fmaf(o1, d2, -(o2 * d1)), fmaf(o2, d0, -(o0 * d2)), fmaf(o0, d1, -(o1 * d0)),
          o0, o1, o2};
}

// Stage the PTT_ROWS non-zero operand rows of triangles [g0, g0 + width)
// into sm[PTT_ROWS][width].  width divides tri_block and g0 is a multiple
// of width, so the run lies inside one block.
__device__ __forceinline__ void stage_ops(float* sm, const float* __restrict__ ops,
                                          int ops_cols, int g0, int width, int tri_block) {
  const int base = (g0 / tri_block) * 4 * tri_block + g0 % tri_block;
  for (int i = threadIdx.x; i < PTT_ROWS * width; i += blockDim.x) {
    const int r = i / width;
    const int c = i - r * width;
    const int q = r < 18 ? r / 6 : 3;
    const int row = r < 18 ? r % 6 : r - 12;
    sm[i] = __ldg(ops + (size_t)row * ops_cols + base + q * tri_block + c);
  }
}

// Pluecker side value of edge quadrant q (0..2) of staged triangle c.
__device__ __forceinline__ float side(const float* sm, int q, int c, int width, const RayVec& r) {
  const float* e = sm + q * 6 * width + c;
  float acc = r.d0 * e[0];
  acc = fmaf(r.d1, e[width], acc);
  acc = fmaf(r.d2, e[2 * width], acc);
  acc = fmaf(r.m0, e[3 * width], acc);
  acc = fmaf(r.m1, e[4 * width], acc);
  return fmaf(r.m2, e[5 * width], acc);
}

// t * det of staged triangle c: orig . (-n) + (-1) * (-d).
__device__ __forceinline__ float plane(const float* sm, int c, int width, const RayVec& r) {
  const float* p = sm + 18 * width + c;
  float acc = r.o0 * p[0];
  acc = fmaf(r.o1, p[width], acc);
  acc = fmaf(r.o2, p[2 * width], acc);
  return fmaf(-1.0f, p[3 * width], acc);
}

// Epsilon-guarded Moeller-Trumbore accept (Renderer.cpp:188-201); returns
// t if accepted, PTT_F_MAX otherwise.  Debug is the explicit-mask form of
// PTAP_DEBUG=1 (pallas/megakernel.py:608-633): det == 0 is masked and the
// reciprocal guarded, where the fast form lets IEEE inf/NaN fail the range
// tests.  Both forms accept the same triangles; Debug = false compiles to
// the fast form alone.
template <bool Debug = false>
__device__ __forceinline__ float accept_t(float s_ab, float s_bc, float s_ca, float num) {
  const float det = s_ab + s_bc + s_ca;
  const bool parallel = Debug && det == 0.0f;
  const float inv_det = 1.0f / (parallel ? 1.0f : det);
  const float t = num * inv_det;
  const float u = s_ca * inv_det;
  const float v = s_ab * inv_det;
  const bool ok = !parallel && (u >= PTT_NEG_EPS) && (v >= PTT_NEG_EPS) && (t >= PTT_NEG_EPS) &&
                  (u <= PTT_ONE_EPS) && (u + v <= PTT_ONE_EPS);
  return ok ? t : PTT_F_MAX;
}

// Sweep `width` staged triangles whose global indices start at g0,
// keeping the lexicographic (t, index) best.
template <bool Debug = false>
__device__ __forceinline__ void sweep(const float* sm, int width, int g0, const RayVec& r,
                                      float& best, int& best_idx) {
  for (int c = 0; c < width; ++c) {
    const float t = accept_t<Debug>(side(sm, 0, c, width, r), side(sm, 1, c, width, r),
                                    side(sm, 2, c, width, r), plane(sm, c, width, r));
    const int g = g0 + c;
    if (t < best || (t == best && t < PTT_F_MAX && g < best_idx)) {
      best = t;
      best_idx = g;
    }
  }
}

// Launch helper: opt in to more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
