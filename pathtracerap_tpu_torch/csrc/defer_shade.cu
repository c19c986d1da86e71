// Kernel S1: the shading of the train step's index forward, one launch a
// wavefront bounce.
//
// Replaces no Pallas kernel: the JAX package shades these bounces in XLA
// (pathtracerap_tpu/pallas/megakernel.py _defer_shade_apply and the bounce
// 0 of its binned loops).  The port shaded them with render/shade.py::shade
// as about 250 elementwise torch ops a call, each a launch over the whole
// wavefront, and the host's time to enqueue them set the pace of the step.
// Two forms, one thread a ray, the state in registers:
//  * deferred (kernels/megakernel.py defer_shade_apply): the sorted (N, 10)
//    state pack [orig, dir, color, remaining] and kernel 3's winner
//    (t, column + 1; 0 a miss) in, the next pack out.  A live ray that hit
//    reads the winner's column of the (16, attr_cols) attribute rows; a
//    dead ray's column is unspecified (kernel 3 skips it) and the ray
//    passes through unread.  The 4 uniforms of ray i are row pix[i] (i
//    without pix) of the (rows, ucols) stream, columns ucol .. ucol + 3;
//  * bounce 0 (first_wavefront): ns samples of the n_pad primary rays as
//    one wavefront, row i from primary ray i % n_pad (its kernel 1 hit
//    record's fields and its ray) and uniform row i, columns 0 .. 3; the
//    primary state (colour 1, remaining max_bounces) is built in registers.
// The math is shade.cuh's exact form (v / sqrt(v . v), IEEE sqrtf and
// division: the build has no --use_fast_math), which equals the torch body
// (ops/math.py normalize) bit for bit; the index streams the replay
// rebuilds the colour from depend on it.
//
// What bounds it on the H100: memory.  A ray moves about 180 bytes (the
// pack in and out, t and column, the winner's 16 attribute floats, 4
// uniforms and pix) against a few hundred flops of shading.

#include "shade.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    defer_shade_kernel(const float* __restrict__ state, const float* __restrict__ t,
                       const int* __restrict__ col1, const float* __restrict__ attr, int attr_cols,
                       const float* __restrict__ uni, int ucols, int ucol,
                       const long long* __restrict__ pix, int n, int parity,
                       float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const size_t ray = i;
  float s[10];
  for (int c = 0; c < 10; ++c) s[c] = state[ray * 10 + c];
  const int c1 = col1[ray];
  const bool hit = c1 > 0;
  // a miss: zero attributes, ri 1.5 (ops/plucker.py hit_record)
  Attrs a = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, 0.f, 1.5f};
  if (s[9] > 0.0f && hit) a = read_attrs(attr, attr_cols, c1 - 1);
  const size_t row = pix != nullptr ? (size_t)pix[ray] : ray;
  shade<true>(s, hit ? t[ray] : PTT_F_MAX, a, uni + row * ucols + ucol, parity != 0);
  for (int c = 0; c < 10; ++c) out[ray * 10 + c] = s[c];
}

__global__ void __launch_bounds__(kThreads)
    primary_shade_kernel(const float* __restrict__ t, const float* __restrict__ normal,
                         const int* __restrict__ mat_type, const float* __restrict__ rgb,
                         const float* __restrict__ gn, const float* __restrict__ ri,
                         const float* __restrict__ ro, int ro_ld, const float* __restrict__ rd,
                         int rd_ld, int n_pad, int rows, const float* __restrict__ uni,
                         int ucols, int max_bounces, int parity, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows) return;
  const size_t r = i % n_pad;
  const float* o = ro + r * ro_ld;
  const float* d = rd + r * rd_ld;
  float s[10] = {o[0], o[1], o[2], d[0], d[1], d[2], 1.0f, 1.0f, 1.0f, (float)max_bounces};
  Attrs a;
  a.n = {normal[r * 3], normal[r * 3 + 1], normal[r * 3 + 2]};
  a.mt = (float)mat_type[r];
  a.rgb = {rgb[r * 3], rgb[r * 3 + 1], rgb[r * 3 + 2]};
  a.gn = {gn[r * 3], gn[r * 3 + 1], gn[r * 3 + 2]};
  a.ri = ri[r];
  shade<true>(s, t[r], a, uni + (size_t)i * ucols, parity != 0);
  for (int c = 0; c < 10; ++c) out[(size_t)i * 10 + c] = s[c];
}

}  // namespace

// state, out: (n, 10) f32; t (n,) f32, col1 (n,) i32: kernel 3's winner;
// attr: (16, attr_cols) f32; uni: (rows, ucols) f32, read at row pix[i]
// (pix: (n,) int64, or null for row i) and columns ucol .. ucol + 3.
extern "C" int ptt_defer_shade(const float* state, const float* t, const int* col1,
                               const float* attr, int attr_cols, const float* uni, int ucols,
                               int ucol, const long long* pix, int n, int parity, float* out,
                               void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (n < 0 || ucol < 0 || ucol + 4 > ucols) return (int)cudaErrorInvalidValue;
  defer_shade_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      state, t, col1, attr, attr_cols, uni, ucols, ucol, pix, n, parity, out);
  return (int)cudaGetLastError();
}

// t, mat_type, ri: (n_pad,); normal, rgb, gn: (n_pad, 3), the primary
// hit record; ro, rd: the (n_pad, 3) primary rays, rows ro_ld and rd_ld
// floats apart (0: a camera's one eye); uni: (rows, ucols) f32, rows = ns
// * n_pad; out: (rows, 10) f32.
extern "C" int ptt_defer_shade_primary(const float* t, const float* normal, const int* mat_type,
                                       const float* rgb, const float* gn, const float* ri,
                                       const float* ro, int ro_ld, const float* rd, int rd_ld,
                                       int n_pad, int rows, const float* uni, int ucols,
                                       int max_bounces, int parity, float* out, void* stream) {
  if (rows == 0) return (int)cudaSuccess;
  if (n_pad < 1 || rows < 0 || rows % n_pad || ucols < 4 || ro_ld < 0 || rd_ld < 0)
    return (int)cudaErrorInvalidValue;
  primary_shade_kernel<<<(rows + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      t, normal, mat_type, rgb, gn, ri, ro, ro_ld, rd, rd_ld, n_pad, rows, uni, ucols, max_bounces,
      parity, out);
  return (int)cudaGetLastError();
}
