// Kernel 3: the trace half of a deferred binned bounce -- worklist nearest
// hit, no attributes, no shading.
//
// Replaces the TPU kernel pathtracerap_tpu/pallas/megakernel.py::_bounce_trace_kernel
// (launched by _bounce_trace_call) with its device helper _trace_inkernel in
// emit_gcol mode.  Same contract: a tile whose rays are all dead writes
// (FLOAT_MAX, 0); otherwise each ray finds the nearest accepted triangle
// over its tile's sub-block worklist, exact-t ties to the lowest baked
// index, and writes its t (FLOAT_MAX on a miss) and the triangle's baked
// index + 1 (0 on a miss).  The differentiable forward (diff/fast.py)
// records that index stream and shades in torch.
//
// What bounds it on the H100: as kernels 1 and 2, FP32 FMA throughput in the
// sweep -- about 50 flops per (ray, triangle) against 88 bytes of shared
// operands.  The design is kernel 2's without its shading: one thread
// block per 256-ray tile, one thread per ray; the tile's worklist holds
// 128-triangle sub-block ids sorted by entry distance, and for each entry
// the threads stage its 22 operand rows (11 KB) in shared memory and
// sweep it.  The TPU kernel groups the sub-blocks by four into 512-wide
// MXU slabs and selects the winner's column with a one-hot argmin; here
// each thread keeps its (t, index) best in registers, so neither is needed.

#include "common.cuh"

__global__ void bounce_trace_kernel(const float* __restrict__ state,  // (N, 10)
                                    const int* __restrict__ lists,    // (nt, list_w)
                                    int list_w, int unit,
                                    const float* __restrict__ ops,    // (16, ops_cols)
                                    int ops_cols, int tri_block,
                                    float* __restrict__ t_out,        // (N,)
                                    int* __restrict__ col_out) {      // (N,) index + 1, 0: miss
  extern __shared__ float sm[];
  const int tile = blockIdx.x;
  const size_t ray = (size_t)tile * blockDim.x + threadIdx.x;
  const float* s = state + ray * 10;
  if (!__syncthreads_or(s[9] > 0.0f)) {  // no live ray in the tile
    t_out[ray] = PTT_F_MAX;
    col_out[ray] = 0;
    return;
  }
  const RayVec r = state_ray(s);
  float best = PTT_F_MAX;
  int best_idx = -1;
  const int* row = lists + (size_t)tile * list_w;
  for (int j = 0; j < list_w; ++j) {
    const int id = row[j];
    if (id < 0) break;  // -1 padding is a suffix of the row
    __syncthreads();    // the previous entry's rows are no longer read
    stage_ops(sm, ops, ops_cols, id * unit, unit, tri_block);
    __syncthreads();
    sweep(sm, unit, id * unit, r, best, best_idx);
  }
  t_out[ray] = best;
  col_out[ray] = best_idx + 1;  // best_idx is -1 exactly when best is FLOAT_MAX
}

extern "C" int ptt_bounce_trace(const float* state, const int* lists, int nt, int list_w,
                                int unit, int ray_tile, const float* ops, int ops_cols,
                                int tri_block, float* t_out, int* col_out, void* stream) {
  if (nt == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)PTT_ROWS * unit * sizeof(float);
  cudaError_t err = set_smem(bounce_trace_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  bounce_trace_kernel<<<nt, ray_tile, smem, (cudaStream_t)stream>>>(
      state, lists, list_w, unit, ops, ops_cols, tri_block, t_out, col_out);
  return (int)cudaGetLastError();
}
