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
// The shading is csrc/shade.cuh's, which kernel 4 shares.

#include "shade.cuh"

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
