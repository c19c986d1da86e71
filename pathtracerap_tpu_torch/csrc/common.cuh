// Shared device code of the traversal kernels (trace_list.cu, bounce.cu,
// bounce_trace.cu, megakernel.cu, nearest_hit.cu).
//
// The fused operand pack `ops` is (16, 4*T) row-major: per block of TB
// triangles its columns are [s_ab | s_bc | s_ca | plane], so triangle g's
// quadrant-q column is (g / TB) * 4 * TB + q * TB + g % TB.  Edge columns
// hold [p x q, q - p] in rows 0-5, the plane column [-n, -d] in rows 6-9;
// every other entry is zero.  A ray's vector is [dir, orig x dir, orig, -1].
//
// The triangle-major pack `ops_tri` (T, 24) holds, per triangle, the same
// 22 non-zero entries (s_ab rows 0-5, s_bc rows 0-5, s_ca rows 0-5, plane
// rows 6-9) and two zero pads: 96 bytes, so a run of triangles is one
// contiguous, 16-byte aligned span that 16-byte cp.async copies stage, and
// six 16-byte shared loads bring a triangle's operands into registers.
// Kernel 5's packless world has no ops_tri: it writes its runs into shared
// memory in the same order from the dense operands.
//
// What bounds a sweep on the H100.  Every kernel sweeps through
// `sweep_rays`: a triangle is loaded once as six 16-byte broadcasts for
// the thread's R rays (22 scalar shared loads a pair would bind the sweep
// to the SM's shared-memory load pipe, about one warp-wide load a clock),
// and the division and the accept chain run only for pairs that a
// division-free test cannot reject (may_accept); a pair then costs its 22
// FMAs, the determinant and the test, about 40 instructions, and the
// instruction issue bounds it.
//
// Rules shared with the JAX reference (ops/plucker.py, pallas/trace.py):
//  * the accept chain is the five explicit comparisons below.  fminf/fmaxf
//    must not be used for it: fminf(NaN, x) returns x, whereas the
//    reference's min/max propagate NaN, and det == 0 lanes (NaN or inf
//    u, v, t) must be rejected (may_accept's fminf only decides whether
//    the chain runs);
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
// floats per triangle of the triangle-major pack (22 rows and 2 zero pads)
#define PTT_TRI_FLOATS 24

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

// Whether accept_t can accept a pair, decided without its division: a
// conservative test that never rejects a pair the chain (either form)
// accepts.  Let a = |det|.  Below 2^-128 the reciprocal overflows and the
// chain accepts nothing.  Above it the reciprocal and the products u, v, t
// are within a relative 2^-20 of s_ca / det, s_ab / det and num / det (or
// below 2^-126 in magnitude), so an accepted pair has u, v, t >= -0.005
// and u + v <= 1.005, hence s_bc / det >= -0.0051 (an accepted pair has
// |s_ab|, |s_ca| <= 1.011 a, so det's rounding is negligible): each of
// s_ab, s_bc, s_ca and num, times the sign of det, is at least -0.006 a,
// a bound whose rounding the 20 % margin covers down to a = 2^-140.  An
// infinite det passes, a NaN one fails, as in the chain.  The test costs
// five multiplies on the FMA pipe and five compares; bitwise & and | keep
// it free of branches, which would split the R rays of sweep_rays into
// basic blocks the scheduler cannot interleave.
__device__ __forceinline__ bool may_accept(float s_ab, float s_bc, float s_ca, float num) {
  const float det = s_ab + s_bc + s_ca;
  const float sgn = __int_as_float(0x3f800000 | (__float_as_int(det) & 0x80000000));
  const float bound = -0.006f * fabsf(det);
  const float lo = fminf(fminf(s_ab * sgn, s_bc * sgn), fminf(s_ca * sgn, num * sgn));
  return lo >= bound;
}

// A (ray, triangle) pair's side values and t * det: fmaf chains in row
// order (the rounding of the plain versions' f32 matrix products), on a
// triangle-major row q.
struct PairSums {
  float ab, bc, ca, pl;
};

__device__ __forceinline__ PairSums pair_sums(const float4 (&q)[6], const RayVec& v) {
  float ab = v.d0 * q[0].x;
  ab = fmaf(v.d1, q[0].y, ab);
  ab = fmaf(v.d2, q[0].z, ab);
  ab = fmaf(v.m0, q[0].w, ab);
  ab = fmaf(v.m1, q[1].x, ab);
  ab = fmaf(v.m2, q[1].y, ab);
  float bc = v.d0 * q[1].z;
  bc = fmaf(v.d1, q[1].w, bc);
  bc = fmaf(v.d2, q[2].x, bc);
  bc = fmaf(v.m0, q[2].y, bc);
  bc = fmaf(v.m1, q[2].z, bc);
  bc = fmaf(v.m2, q[2].w, bc);
  float ca = v.d0 * q[3].x;
  ca = fmaf(v.d1, q[3].y, ca);
  ca = fmaf(v.d2, q[3].z, ca);
  ca = fmaf(v.m0, q[3].w, ca);
  ca = fmaf(v.m1, q[4].x, ca);
  ca = fmaf(v.m2, q[4].y, ca);
  float pl = v.o0 * q[4].z;
  pl = fmaf(v.o1, q[4].w, pl);
  pl = fmaf(v.o2, q[5].x, pl);
  pl = fmaf(-1.0f, q[5].y, pl);
  return {ab, bc, ca, pl};
}

// Sweep R rays at once over `width` triangles staged
// triangle-major (`width` x 6 float4): six 16-byte loads a triangle serve
// the thread's R rays.  Only where some ray may be accepted (may_accept)
// does the thread run accept_t and the lexicographic improve: each ray's
// (best, best_idx) is bit for bit that of a one-ray sweep that runs the
// chain on every pair, and the hot loop holds no division, whose
// special-case branch would serialize the R rays.
template <int R, bool Debug = false>
__device__ __forceinline__ void sweep_rays(const float4* sm, int width, int g0, const RayVec (&r)[R],
                                           float (&best)[R], int (&best_idx)[R]) {
  for (int c = 0; c < width; ++c) {
    const float4* p = sm + 6 * c;
    const float4 q[6] = {p[0], p[1], p[2], p[3], p[4], p[5]};
    PairSums ps[R];
    bool any = false;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      ps[k] = pair_sums(q, r[k]);
      any |= may_accept(ps[k].ab, ps[k].bc, ps[k].ca, ps[k].pl);
    }
    if (__builtin_expect(any, 0)) {
      const int g = g0 + c;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float t = accept_t<Debug>(ps[k].ab, ps[k].bc, ps[k].ca, ps[k].pl);
        if (t < best[k] || (t == best[k] && t < PTT_F_MAX && g < best_idx[k])) {
          best[k] = t;
          best_idx[k] = g;
        }
      }
    }
  }
}

// The merge key of a hit (t, g), t in [-0.005, FLOAT_MAX), for kernels
// that split a tile's worklist over thread blocks (trace_list.cu,
// bounce.cu): t's order (-0.0 as +0.0) above the index above a flag for
// -0.0, all inverted, so that the best hit is the largest key (atomicMax)
// and a slot no chunk wrote (zero) is a miss.  The one-pass sweep keeps
// the lexicographic minimum of (t, index), -0.0 equal to +0.0, so chunks
// merged in any order give its bits.
__device__ __forceinline__ unsigned long long merge_key(float t, int g) {
  const unsigned b = __float_as_uint(t);
  const unsigned ord = (b << 1) == 0u ? 0x80000000u : (b >> 31 ? ~b : b | 0x80000000u);
  const unsigned long long key = ((unsigned long long)ord << 32) |
                                 ((unsigned long long)(unsigned)g << 1) | (b == 0x80000000u);
  return ~key;
}

__device__ __forceinline__ void merged_hit(unsigned long long v, float& t, int& g) {
  if (v == 0ull) {
    t = PTT_F_MAX;
    g = -1;
    return;
  }
  const unsigned long long key = ~v;
  const unsigned ord = (unsigned)(key >> 32);
  const unsigned b = (key & 1ull) ? 0x80000000u : (ord >> 31 ? ord & 0x7fffffffu : ~ord);
  t = __uint_as_float(b);
  g = (int)((unsigned)(key & 0xffffffffull) >> 1);
}

// 16-byte asynchronous global -> shared copies (cp.async, Ampere and
// later), committed as one group per staged run.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start staging triangles [g0, g0 + width) of the (T, 24) triangle-major
// pack into sm (width x 6 float4): every thread of the block issues its
// share of the 16-byte copies, as one commit group.  The copies land
// behind the caller's work; cp_async_wait_all() then a block barrier
// make them visible to every thread.
__device__ __forceinline__ void stage_tri_async(float4* sm, const float* __restrict__ ops_tri,
                                                int g0, int width) {
  const float4* src = reinterpret_cast<const float4*>(ops_tri) + (size_t)g0 * 6;
  for (int i = threadIdx.x; i < width * 6; i += blockDim.x) cp_async16(sm + i, src + i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The Run-triangle runs of a worklist row in sweep order (kernels 1, 2
// and 3): entry j's `unit / Run` runs in ascending order, entries until the
// first -1 or the row's end, runs from the last real triangle on dropped.
template <int Run>
struct RunCursor {
  const int* row;
  int list_w, unit, n_tris, j, off, id;

  __device__ void start() {
    j = 0;
    off = 0;
    id = list_w > 0 ? row[0] : -1;
    skip();
  }
  __device__ bool done() const { return id < 0; }
  __device__ int g0() const { return id * unit + off; }
  __device__ void skip() {
    while (id >= 0 && id * unit + off >= n_tris) {
      ++j;
      off = 0;
      id = j < list_w ? row[j] : -1;
    }
  }
  __device__ void next() {
    off += Run;
    if (off >= unit) {
      ++j;
      off = 0;
      id = j < list_w ? row[j] : -1;
    }
    skip();
  }
};

// Launch helper: opt in to more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
