// Profiling kernels P1, P2 and P4: one block visit of the traversal kernels,
// taken apart so that each part can be timed alone.
//
// Replaces the TPU kernels
//   scripts/prof_kernel_parts.py::make_kernel   (P1: the product in bf16,
//       bf16x3 or f32, then the accept chain, the argmin, the attribute
//       select),
//   scripts/prof_kernel_parts2.py::make_kernel  (P2: the single-pass bf16
//       product at K = 16, 32 and 128, looped or unrolled, and `empty`),
//   scripts/prof_mega_sweep.py::empty_variant   (P4: out = w[:, 0], with or
//       without an operand the kernel never reads).
// Same contract, quirks included.  Per ray (one row of w, K values) and per
// visit blk of nb, the 4 * tb columns [blk * 4 * tb, (blk + 1) * 4 * tb) of
// ops (K, 4 * tb * nb) give s = w . ops[:, col]:
//   mm_*    best = min(best, min_col s);
//   accept  s's quadrants [s_ab | s_bc | s_ca | t * det] through the
//           explicit-mask accept chain (common.cuh's accept_t<true>), then
//           best = min(best, min over the visit's tb triangles);
//   argmin  + the first index `arg` of that minimum; on a strictly smaller
//           minimum best takes it and attrs += float(arg);
//   select  + on a strictly smaller minimum attrs = the sum of the 7
//           attribute rows of column blk * tb + arg, otherwise attrs = the
//           sum of 7 copies of attrs (the TPU kernel's where broadcasts its
//           (R, 1) carry over 7 columns); then attrs += attrs * 0.
// The output is best + attrs.  Every variant but mm_bf16 and mm_f32 takes
// the bf16x3 product: a_hi = bf16(a), a_lo = bf16(a - a_hi), the same for
// b, s = dot(a_lo, b_hi) + dot(a_hi, b_lo) + dot(a_hi, b_hi), each dot
// accumulated in f32 (bf16 rounding to nearest even).
//
// What bounds it on the H100: the issue of its shared-memory loads, one
// broadcast load per FMA (the bf16x3 split does three FMAs per two loads
// and takes twice, not three times, as long as one pass).  The product is
// K FMAs per (ray, column) (3K for bf16x3): 4.2e11 flops a pass at K = 16
// over 800,256 rays x 16,384 columns, against 51 MB of w.  The design keeps
// w's row in registers (split to hi/lo once), one thread per ray in blocks
// of 128, and stages the visit's columns in shared memory in runs of 32 KB
// (already rounded, and split where bf16x3 needs it), read as broadcasts.
// It runs the products on the CUDA cores, summed in k order; a tensor-core
// (mma.sync m16n8k16 bf16) form of the
// bf16 variants is the question these kernels were written to measure and
// is left to the PRs that redesign kernels 1 to 4.  The TPU grid of 512-ray
// tiles becomes the copy kernel's thread blocks (P4 measures a grid step).

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

enum Variant : int {
  kMmBf16 = 0, kMmBf16x3 = 1, kMmF32 = 2, kAccept = 3, kArgmin = 4, kSelect = 5, kEmpty = 6
};

constexpr int kThreads = 128;       // rays per thread block of the parts kernel
constexpr int kStageFloats = 8192;  // 32 KB of staged operands per run
constexpr int kSelectRows = 7;      // attribute rows the select variant sums

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int K, int V>
struct Cfg {
  static constexpr bool kF32 = V == kMmF32;
  static constexpr bool kSplit = V != kMmF32 && V != kMmBf16;  // bf16x3: hi and lo copies
  static constexpr int kCopies = kSplit ? 2 : 1;
  static constexpr int kRun = kStageFloats / (4 * K * kCopies);  // triangles per staged run
};

// sum_k a[k] * b[k * stride], accumulated in f32 in k order
template <int K>
__device__ __forceinline__ float dot_k(const float* a, const float* b, int stride) {
  float acc = a[0] * b[0];
#pragma unroll
  for (int k = 1; k < K; ++k) acc = fmaf(a[k], b[k * stride], acc);
  return acc;
}

template <int K, int V, bool Unroll>
__global__ void __launch_bounds__(kThreads)
parts_kernel(const float* __restrict__ w,     // (N, K)
             const float* __restrict__ ops,   // (K, ops_cols)
             int ops_cols,
             const float* __restrict__ attr,  // (16, attr_cols); read by select
             int attr_cols, int tb, int nb,
             float* __restrict__ out) {       // (N,)
  using C = Cfg<K, V>;
  constexpr int kRun = C::kRun;
  constexpr int kPlane = 4 * K * kRun;  // floats of one staged copy
  __shared__ float sm[kStageFloats];    // [copy][quadrant][k][kRun]
  const size_t ray = (size_t)blockIdx.x * kThreads + threadIdx.x;

  float a_hi[K];
  float a_lo[C::kSplit ? K : 1];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float x = w[ray * K + k];
    a_hi[k] = C::kF32 ? x : bf16_round(x);
    if (C::kSplit) a_lo[k] = bf16_round(x - a_hi[k]);
  }

  float best = PTT_F_MAX, attrs = 0.0f;
  auto visit = [&](int blk) {
    float vmin = INFINITY;  // min of s (mm_*) or of the accepted t (the rest)
    int arg = 0;            // first index of that minimum among the visit's tb triangles
    for (int r0 = 0; r0 < tb; r0 += kRun) {
      __syncthreads();  // the previous run's operands are no longer read
      for (int i = threadIdx.x; i < kPlane; i += kThreads) {
        const int q = i / (K * kRun);
        const int rem = i - q * K * kRun;
        const int k = rem / kRun;
        const int c = rem - k * kRun;
        const float x = __ldg(ops + (size_t)k * ops_cols + (size_t)blk * 4 * tb + q * tb + r0 + c);
        const float hi = C::kF32 ? x : bf16_round(x);
        sm[i] = hi;
        if (C::kSplit) sm[kPlane + i] = bf16_round(x - hi);
      }
      __syncthreads();
      for (int c = 0; c < kRun; ++c) {
        float s[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* b = sm + q * K * kRun + c;
          if (C::kSplit) {
            const float mix = dot_k<K>(a_lo, b, kRun) + dot_k<K>(a_hi, b + kPlane, kRun);
            s[q] = mix + dot_k<K>(a_hi, b, kRun);
          } else {
            s[q] = dot_k<K>(a_hi, b, kRun);
          }
        }
        if (V <= kMmF32) {
          vmin = fminf(vmin, fminf(fminf(s[0], s[1]), fminf(s[2], s[3])));
        } else {
          const float t = accept_t<true>(s[0], s[1], s[2], s[3]);
          if (t < vmin) {
            vmin = t;
            arg = r0 + c;
          }
        }
      }
    }
    const bool improve = vmin < best;
    if (V == kArgmin && improve) attrs = (float)arg + attrs;
    if (V == kSelect) {
      float sum;
      if (improve) {
        const float* col = attr + (size_t)blk * tb + arg;
        sum = col[0];
        for (int k = 1; k < kSelectRows; ++k) sum = sum + col[(size_t)k * attr_cols];
      } else {
        sum = attrs;
        for (int k = 1; k < kSelectRows; ++k) sum = sum + attrs;
      }
      attrs = sum + attrs * 0.0f;
    }
    if (improve) best = vmin;
  };
  if (Unroll) {
#pragma unroll 8
    for (int blk = 0; blk < nb; ++blk) visit(blk);
  } else {
#pragma unroll 1
    for (int blk = 0; blk < nb; ++blk) visit(blk);
  }
  out[ray] = best + attrs;
}

// P4 and P2's `empty`: out = w[:, 0], one thread per row, one thread block
// per tile of rows.  `ops` is bound and never read, as the TPU kernel's
// unused operand.
__global__ void empty_kernel(const float* __restrict__ w, int k, const float* __restrict__ ops,
                             float* __restrict__ out) {
  const size_t row = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  out[row] = w[row * k];
}

template <int K, int V, bool U>
cudaError_t launch_parts(const float* w, int n, const float* ops, int ops_cols, const float* attr,
                         int attr_cols, int tb, int nb, float* out, cudaStream_t stream) {
  if (tb % Cfg<K, V>::kRun || n % kThreads) return cudaErrorInvalidValue;
  parts_kernel<K, V, U><<<n / kThreads, kThreads, 0, stream>>>(w, ops, ops_cols, attr, attr_cols,
                                                                 tb, nb, out);
  return cudaGetLastError();
}

}  // namespace

// variant: Variant above.  k: the product's depth (16, 32 or 128; 16 for
// every variant but mm_bf16).  unroll: P2's unrolled visit loop (mm_bf16).
// rows: the empty kernel's tile of rows (threads per block).
extern "C" int ptt_prof_parts(const float* w, int n, int k, int rows, const float* ops,
                              int ops_cols, const float* attr, int attr_cols, int tb, int nb,
                              int variant, int unroll, float* out, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (variant == kEmpty) {
    if (rows < 32 || rows > 1024 || n % rows) return (int)cudaErrorInvalidValue;
    empty_kernel<<<n / rows, rows, 0, st>>>(w, k, ops, out);
    return (int)cudaGetLastError();
  }
  const auto run = [&](auto launch) {
    return (int)launch(w, n, ops, ops_cols, attr, attr_cols, tb, nb, out, st);
  };
  if (k == 16 && !unroll) {
    switch (variant) {
      case kMmBf16: return run(launch_parts<16, kMmBf16, false>);
      case kMmBf16x3: return run(launch_parts<16, kMmBf16x3, false>);
      case kMmF32: return run(launch_parts<16, kMmF32, false>);
      case kAccept: return run(launch_parts<16, kAccept, false>);
      case kArgmin: return run(launch_parts<16, kArgmin, false>);
      case kSelect: return run(launch_parts<16, kSelect, false>);
    }
  }
  if (variant == kMmBf16) {
    if (k == 16 && unroll) return run(launch_parts<16, kMmBf16, true>);
    if (k == 32 && !unroll) return run(launch_parts<32, kMmBf16, false>);
    if (k == 128) {
      return unroll ? run(launch_parts<128, kMmBf16, true>)
                    : run(launch_parts<128, kMmBf16, false>);
    }
  }
  return (int)cudaErrorInvalidValue;
}
