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
// What bounds it on the H100: the bytes, 4 a column read once; at the
// scripts' 512 x 512 (1 MB, 0.3 us at 3.35 TB/s) a launch and one memory
// round trip cost more than that.  The design: one warp a row and a
// thread block (fastest of 1, 2, 4 and 8 rows a block on the card at
// both of the script's shapes), so that 512 rows spread over the 132 SMs;
// the four bases loaded first, so
// their latency hides under the row's; for 512 columns on a 16-byte
// aligned row (the wrapper decides) every lane issues its four float4
// loads before its first compare, then reduces lane-locally and across
// the warp by shuffles, in the plain version's (value, index, NaN first)
// order.  Other widths take a strided loop of scalar loads.

#include <cuda_runtime.h>

#include <climits>

namespace {

// Whether (v, i) comes before (bv, bi) in jnp.argmin's order.
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  if (isnan(v)) return !isnan(bv) || i < bi;
  if (isnan(bv)) return false;
  return v < bv || (v == bv && i < bi);
}

__device__ __forceinline__ void take(float v, int i, float& bv, int& bi) {
  if (before(v, i, bv, bi)) {
    bv = v;
    bi = i;
  }
}

template <bool Vec512>
__global__ void __launch_bounds__(32) argmin_int_kernel(const float* __restrict__ x, int cols,
                                                        const int* __restrict__ bases,
                                                        int* __restrict__ out) {
  const int b0 = __ldg(bases), b1 = __ldg(bases + 1), b2 = __ldg(bases + 2), b3 = __ldg(bases + 3);
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  float bv = INFINITY;
  int bi = INT_MAX;
  if (Vec512) {
    // lane l holds columns 4 (l + 32 q) .. + 3 for q = 0..3: each of the
    // four loads is 512 contiguous bytes across the warp
    const float4* r = reinterpret_cast<const float4*>(x + (size_t)row * 512);
    float4 v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = __ldg(r + lane + 32 * q);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = 4 * (lane + 32 * q);
      take(v[q].x, c, bv, bi);
      take(v[q].y, c + 1, bv, bi);
      take(v[q].z, c + 2, bv, bi);
      take(v[q].w, c + 3, bv, bi);
    }
  } else {
    const float* r = x + (size_t)row * cols;
    for (int j = lane; j < cols; j += 32) take(__ldg(r + j), j, bv, bi);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    take(ov, oi, bv, bi);
  }
  if (lane == 0) {
    const int g = bi / 128;
    const int base = g == 0 ? b0 : g == 1 ? b1 : g == 2 ? b2 : b3;
    out[row] = base * 128 + bi % 128;
  }
}

__global__ void noop_kernel() {}

}  // namespace

// vec: the 512-column float4 path (cols == 512, x 16-byte aligned).  One
// thread block of one warp a row.
extern "C" int ptt_prof_argmin(const float* x, int rows, int cols, const int* bases, int* out,
                               int vec, void* stream) {
  if (rows == 0) return (int)cudaSuccess;
  if (cols <= 0) return (int)cudaErrorInvalidValue;
  if (vec && (cols != 512 || reinterpret_cast<size_t>(x) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    argmin_int_kernel<true><<<rows, 32, 0, s>>>(x, cols, bases, out);
  } else {
    argmin_int_kernel<false><<<rows, 32, 0, s>>>(x, cols, bases, out);
  }
  return (int)cudaGetLastError();
}

// An empty kernel on `blocks` thread blocks of `threads`: the launch floor
// that chip_smoke reads beside P3.
extern "C" int ptt_noop(int blocks, int threads, void* stream) {
  noop_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
