// Profiling kernel P3: integer arithmetic on a row argmin.
//
// Replaces the TPU kernel scripts/prof_r5_shade.py::k, which checked that
// Mosaic lowers integer math on an in-kernel argmin and a scalar-prefetched
// table.  Same contract: per row of x (rows, cols) f32, am = the first
// index of the row's minimum (a NaN counts as the minimum, as jnp.argmin
// has it), g = am / 128, local = am % 128, and
// out = bases[min(g, 3)] * 128 + local in int32 (the TPU kernel's where
// chain sends every g >= 3 to bases[3]).
//
// What bounds it on the H100: at 512 x 512 nothing but the launch -- 1 MB
// read once.  The design: one warp per row, each lane scanning a strided
// share of the columns, then a shuffle reduction that keeps the lower index
// on equal values.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;  // 8 rows per thread block

// Whether (v, i) comes before (bv, bi) in jnp.argmin's order.
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  if (isnan(v)) return !isnan(bv) || i < bi;
  if (isnan(bv)) return false;
  return v < bv || (v == bv && i < bi);
}

__global__ void argmin_int_kernel(const float* __restrict__ x, int rows, int cols,
                                  const int* __restrict__ bases, int* __restrict__ out) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const float* r = x + (size_t)row * cols;
  float bv = INFINITY;
  int bi = INT_MAX;
  for (int j = lane; j < cols; j += 32) {
    const float v = r[j];
    if (before(v, j, bv, bi)) {
      bv = v;
      bi = j;
    }
  }
  for (int off = 16; off > 0; off /= 2) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (before(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    const int g = bi / 128;
    const int local = bi % 128;
    const int base = g == 0 ? bases[0] : g == 1 ? bases[1] : g == 2 ? bases[2] : bases[3];
    out[row] = base * 128 + local;
  }
}

}  // namespace

extern "C" int ptt_prof_argmin(const float* x, int rows, int cols, const int* bases, int* out,
                               void* stream) {
  if (rows == 0) return (int)cudaSuccess;
  if (cols <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (rows * 32 + kThreads - 1) / kThreads;
  argmin_int_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, rows, cols, bases, out);
  return (int)cudaGetLastError();
}
