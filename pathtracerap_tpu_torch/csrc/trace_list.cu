// Kernel 1: worklist nearest-hit trace of the primary rays.
//
// Replaces the TPU kernel pathtracerap_tpu/pallas/trace.py::_fused_list_kernel
// (launched by nearest_hit_fused).  Same contract: per ray tile, visit the
// blocks of that tile's tmin-sorted, -1-padded worklist; per ray return the
// nearest accepted triangle (t, global index), exact-t ties to the lowest
// index, (FLOAT_MAX, -1) on a miss.
//
// What bounds it on the H100: FP32 FMA issue.  Each (ray, triangle) pair
// costs 22 fused multiply-adds for the three side values and t * det, a
// division and the accept chain -- about 50 flops -- against 88 bytes of
// operands that every ray of the tile reuses.  The design keeps those
// operands in shared memory: one thread block per ray tile, one thread per
// ray; for each listed block the threads stage its 22 non-zero operand rows
// (512 triangles: 45 KB) and then every thread sweeps every triangle,
// reading the rows as broadcasts.  Nothing goes to device memory but the
// result.  The TPU tiling (512-ray tiles on the MXU, bf16x3 splits, SMEM
// worklist chunking, streamed DMA above 313 blocks) is not carried over:
// the pack is read from global memory at any scene size.

#include "common.cuh"

__global__ void trace_list_kernel(const float* __restrict__ w,      // (N, 16)
                                  const float* __restrict__ ops,    // (16, ops_cols)
                                  int ops_cols,
                                  const int* __restrict__ lists,    // (nt, list_w)
                                  int list_w, int tri_block,
                                  float* __restrict__ t_out,        // (N,)
                                  int* __restrict__ idx_out) {      // (N,)
  extern __shared__ float sm[];
  const int tile = blockIdx.x;
  const size_t ray = (size_t)tile * blockDim.x + threadIdx.x;
  const float* wr = w + ray * 16;
  const RayVec r = {wr[0], wr[1], wr[2], wr[3], wr[4], wr[5], wr[6], wr[7], wr[8]};
  float best = PTT_F_MAX;
  int best_idx = -1;
  const int* row = lists + (size_t)tile * list_w;
  for (int j = 0; j < list_w; ++j) {
    const int blk = row[j];
    if (blk < 0) break;  // -1 padding is a suffix of the row
    __syncthreads();     // the previous block's rows are no longer read
    stage_ops(sm, ops, ops_cols, blk * tri_block, tri_block, tri_block);
    __syncthreads();
    sweep(sm, tri_block, blk * tri_block, r, best, best_idx);
  }
  t_out[ray] = best;
  idx_out[ray] = best_idx;
}

extern "C" int ptt_trace_list(const float* w, const float* ops, int ops_cols, const int* lists,
                              int nt, int list_w, int ray_tile, int tri_block, float* t_out,
                              int* idx_out, void* stream) {
  if (nt == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)PTT_ROWS * tri_block * sizeof(float);
  cudaError_t err = set_smem(trace_list_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  trace_list_kernel<<<nt, ray_tile, smem, (cudaStream_t)stream>>>(
      w, ops, ops_cols, lists, list_w, tri_block, t_out, idx_out);
  return (int)cudaGetLastError();
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
