// Kernel 3: the trace half of a deferred binned bounce -- worklist nearest
// hit, no attributes, no shading.
//
// Replaces the TPU kernel pathtracerap_tpu/pallas/megakernel.py::_bounce_trace_kernel
// (launched by _bounce_trace_call) with its device helper _trace_inkernel in
// emit_gcol mode.  Same contract: a tile whose rays are all dead writes
// (FLOAT_MAX, 0); otherwise each ray finds the nearest accepted triangle
// over its tile's sub-block worklist, exact-t ties to the lowest baked
// index, and writes its t (FLOAT_MAX on a miss) and the triangle's baked
// index + 1 (0 on a miss).  A dead ray of a live tile gets an unspecified
// result.  The differentiable forward (diff/fast.py) records that index
// stream and shades in torch.
//
// What bounds it on the H100: as kernels 1 and 2, the sweep's instruction
// issue, about 40 instructions per (ray, triangle) pair (common.cuh
// sweep_rays).  The first port (one thread per ray, two barriers and a
// synchronous staging of the column-major pack per worklist entry, then
// 22 scalar shared loads and a division per pair) was bound by the SM's
// shared-memory load pipe.  The design is kernel 2's sweep without its
// shading: one thread block per ray tile of `ray_tile / R` threads, R =
// kRays; each thread owns R rays of the sorted tile, strided by
// `ray_tile / R` so that the state loads and the stores stay coalesced,
// and sweeps them together (six 16-byte shared loads a triangle for R
// rays, the division only where a ray may be accepted).  The wavefront is
// sorted with dead rays last, so the live rays of a tile are a prefix and
// a thread with no live ray skips the sweep.  The worklist's 128-triangle
// runs of the triangle-major pack ops_tri are staged by 16-byte cp.async
// into two shared buffers, run j + 1 landing while run j is swept, one
// barrier a run, and the sweep stops at the last real triangle (padding
// is never accepted).  Kernel 1's split of a list over several thread
// blocks is not needed: the reference scene's lists hold at most 24
// sub-blocks.  The TPU kernel groups the sub-blocks by four into 512-wide
// MXU slabs and selects the winner's column with a one-hot argmin; here
// each thread keeps its (t, index) bests in registers, so neither is
// needed.

#include "common.cuh"

namespace {

constexpr int kSweepRun = 128;  // triangles staged per shared-memory run
// rays a thread carries through the sweep (R): chosen on the card, PERF.md
// (kernels/megakernel.py BOUNCE_TRACE_RAYS_PER_THREAD mirrors it)
constexpr int kRays = 2;

}  // namespace

__global__ void bounce_trace_kernel(const float* __restrict__ state,    // (N, 10)
                                    const int* __restrict__ lists,      // (nt, list_w)
                                    int list_w, int unit,
                                    const float* __restrict__ ops_tri,  // (T, 24) triangle-major pack
                                    int n_tris,                         // real triangles
                                    float* __restrict__ t_out,          // (N,)
                                    int* __restrict__ col_out) {        // (N,) index + 1, 0: miss
  __shared__ float4 run[2][kSweepRun * 6];
  const int tile = blockIdx.x;
  // this thread's rays: base + k * stride, k < kRays
  const int stride = blockDim.x;
  const size_t base = (size_t)tile * stride * kRays + threadIdx.x;

  RayVec r[kRays];
  float best[kRays];
  int best_idx[kRays];
  bool live = false;  // whether any of this thread's rays is live
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const float* sk = state + (base + (size_t)k * stride) * 10;
    float s[10];
    for (int c = 0; c < 10; ++c) s[c] = sk[c];
    live = live || s[9] > 0.0f;
    r[k] = state_ray(s);
    best[k] = PTT_F_MAX;
    best_idx[k] = -1;
  }
  if (__syncthreads_or(live)) {  // else no live ray in the tile: every ray misses
    RunCursor<kSweepRun> cur = {lists + (size_t)tile * list_w, list_w, unit, n_tris, 0, 0, -1};
    cur.start();
    if (!cur.done()) stage_tri_async(run[0], ops_tri, cur.g0(), min(kSweepRun, n_tris - cur.g0()));
    for (int buf = 0; !cur.done(); buf ^= 1) {
      const int g0 = cur.g0();
      const int width = min(kSweepRun, n_tris - g0);
      cur.next();
      cp_async_wait_all();
      __syncthreads();  // run `buf` is in for every thread; run buf ^ 1 is no longer read
      if (!cur.done()) {
        stage_tri_async(run[buf ^ 1], ops_tri, cur.g0(), min(kSweepRun, n_tris - cur.g0()));
      }
      if (live) sweep_rays<kRays>(run[buf], width, g0, r, best, best_idx);
    }
  }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const size_t ray = base + (size_t)k * stride;
    t_out[ray] = best[k];
    col_out[ray] = best_idx[k] + 1;  // best_idx is -1 exactly when best is FLOAT_MAX
  }
}

extern "C" int ptt_bounce_trace(const float* state, const int* lists, int nt, int list_w,
                                int unit, int ray_tile, const float* ops_tri, int n_tris,
                                float* t_out, int* col_out, void* stream) {
  if (nt == 0) return (int)cudaSuccess;
  if (ray_tile % (32 * kRays)) return (int)cudaErrorInvalidValue;
  bounce_trace_kernel<<<nt, ray_tile / kRays, 0, (cudaStream_t)stream>>>(
      state, lists, list_w, unit, ops_tri, n_tris, t_out, col_out);
  return (int)cudaGetLastError();
}
