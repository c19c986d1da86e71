// Kernel 4: the whole-sample fused path tracer -- every bounce of a sample
// (trace, hit attributes, shading) in one launch, the ray state in
// registers across the bounce loop.
//
// Replaces the TPU kernel pathtracerap_tpu/pallas/megakernel.py::_megakernel
// (launched by _sample_pallas_call, per sample and with emit_idx, and by
// _sample_pallas_call_batched, over a batch of samples) with its sweep-mode
// _trace_inkernel, select_attrs and _shade_inkernel(_t).  Same contract:
// per ray, bounce 0 shades from the cached primary-hit row (use_primary)
// or traces the ray; every later bounce sweeps every real block in
// ascending index order, keeps the nearest accepted triangle (exact-t ties
// to the lowest index), reads its attribute rows and shades with this
// bounce's 4 uniforms (column block 4b).  The output is the contribution
// sqrt(max(color, 0)), summed in sample order over a batch of samples;
// with emit_idx also each bounce's triangle index + 1 (0 on a miss, and 0
// where the ray was already dead), the frozen hit topology of the
// differentiable replay.
//
// What bounds it on the H100: FP32 FMA issue in the sweep, as kernels 1-3 --
// about 50 flops per (ray, triangle) against 88 bytes of shared operands,
// and here every live ray meets every real triangle slot at every bounce
// (no worklists: the ray state never leaves the kernel to be sorted).  The
// shading is a few hundred flops per ray and bounce.  The design: one
// thread block per 256-ray tile, one thread per ray, its 10-word state
// [orig, dir, color, remaining] in registers for the whole sample.  Every
// ray of a tile sweeps the same triangles in the same order, so the tile
// stages each 128-triangle run's 22 operand rows (11 KB) in shared memory
// once and every live thread sweeps it; dead rays help with the staging
// and skip the sweep, and a tile with no live ray skips the bounce's
// trace.  Above 8 blocks (GATE_BLOCKS, kernels/megakernel.py) the tile
// skips a block that no live ray's slab test reaches within the current
// best (the TPU kernel's gate, per tile with __syncthreads_or; it never
// changes a hit).  A sample batch
// is a loop over samples that sums in registers, where the TPU carried the
// sum across a sequential grid dimension in VMEM.  The TPU kernel's
// bf16x3 MXU products, one-hot attribute matmul and lane-major shading
// layout are TPU devices and are not carried over.

#include "shade.cuh"

namespace {

constexpr int kFusedTile = 256;  // rays per thread block
constexpr int kSweepRun = 128;   // triangles staged per shared-memory run

// The winner's attribute rows [shade_n, mat_type, rgb, geom_n, idx+1, ri]
// (WorldTriangles.attr_rows, (16, attr_cols) row-major).
__device__ __forceinline__ Attrs read_attrs(const float* __restrict__ attr, int attr_cols,
                                            int idx) {
  const float* c = attr + idx;
  const size_t ld = attr_cols;
  Attrs a;
  a.n = {c[0 * ld], c[1 * ld], c[2 * ld]};
  a.mt = c[3 * ld];
  a.rgb = {c[4 * ld], c[5 * ld], c[6 * ld]};
  a.gn = {c[7 * ld], c[8 * ld], c[9 * ld]};
  a.ri = c[11 * ld];
  return a;
}

// The TPU kernel's per-block gate (megakernel.py:1139-1162): the slab test
// of block blk's AABB, margin-inflated, against this ray's current best.
__device__ __forceinline__ bool box_reaches(const float* __restrict__ box, const RayVec& r,
                                            const float inv[3], float margin, float best) {
  const float o[3] = {r.o0, r.o1, r.o2};
  float near[3], far[3];
  for (int k = 0; k < 3; ++k) {
    const float lo = (box[k] - o[k]) * inv[k];
    const float hi = (box[3 + k] - o[k]) * inv[k];
    near[k] = fminf(lo, hi);
    far[k] = fmaxf(lo, hi);
  }
  const float tmin = fmaxf(fmaxf(near[0], near[1]), near[2]);
  const float tmax = fminf(fminf(far[0], far[1]), far[2]);
  return tmax >= -margin && tmin <= tmax + margin && tmin - margin <= best;
}

}  // namespace

__global__ void __launch_bounds__(kFusedTile)
sample_fused_kernel(const float* __restrict__ w16,    // (N, 16) [dir, o x dir, orig, -1, 1, 0...]
                    const float* __restrict__ prim,   // (N, 16) [t, n, mt, rgb, gn, idx+1, ri, 0..]
                    const float* __restrict__ uni,    // (ns, N, 4 * max_bounces)
                    int n, int ns, int max_bounces,
                    const float* __restrict__ ops,    // (16, ops_cols)
                    int ops_cols,
                    const float* __restrict__ attr,   // (16, attr_cols)
                    int attr_cols,
                    const float* __restrict__ aabb,   // (n_blocks, 8)
                    const float* __restrict__ margin, // (1,)
                    int n_blocks, int tri_block, int parity, int use_primary, int gated,
                    float* __restrict__ out,          // (N, 3)
                    int* __restrict__ idx_out) {      // (N, max_bounces) or null
  extern __shared__ float sm[];
  const size_t ray = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float* wr = w16 + ray * 16;
  const float* pr = prim + ray * 16;
  const int ucols = 4 * max_bounces;
  const float slack = gated ? margin[0] : 0.0f;
  float acc[3] = {0.0f, 0.0f, 0.0f};

  for (int smp = 0; smp < ns; ++smp) {
    float s[10] = {wr[6], wr[7], wr[8], wr[0], wr[1], wr[2], 1.0f, 1.0f, 1.0f,
                   (float)max_bounces};
    const float* u = uni + ((size_t)smp * n + ray) * ucols;
    for (int b = 0; b < max_bounces; ++b) {
      const bool alive = s[9] > 0.0f;
      float t = PTT_F_MAX;
      int idx1 = 0;
      Attrs a = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, 0.f, 0.f};
      if (b == 0 && use_primary) {
        t = pr[0];
        a.n = {pr[1], pr[2], pr[3]};
        a.mt = pr[4];
        a.rgb = {pr[5], pr[6], pr[7]};
        a.gn = {pr[8], pr[9], pr[10]};
        idx1 = (int)pr[11];
        a.ri = pr[12];
      } else if (__syncthreads_or(alive)) {  // the tile has a live ray
        const RayVec r = state_ray(s);
        float inv[3] = {0.0f, 0.0f, 0.0f};
        if (gated) {
          const float d[3] = {r.d0, r.d1, r.d2};
          for (int k = 0; k < 3; ++k) {
            const float dk = fabsf(d[k]) < 1e-12f ? (d[k] < 0.0f ? -1e-12f : 1e-12f) : d[k];
            inv[k] = 1.0f / dk;
          }
        }
        int best_idx = -1;
        for (int blk = 0; blk < n_blocks; ++blk) {
          if (gated &&
              !__syncthreads_or(alive && box_reaches(aabb + (size_t)blk * 8, r, inv, slack, t))) {
            continue;
          }
          for (int run = 0; run < tri_block; run += kSweepRun) {
            const int g0 = blk * tri_block + run;
            __syncthreads();  // the previous run's rows are no longer read
            stage_ops(sm, ops, ops_cols, g0, kSweepRun, tri_block);
            __syncthreads();
            if (alive) sweep(sm, kSweepRun, g0, r, t, best_idx);
          }
        }
        if (best_idx >= 0) a = read_attrs(attr, attr_cols, best_idx);
        idx1 = best_idx + 1;  // best_idx is -1 exactly when t is FLOAT_MAX
      }
      if (idx_out) idx_out[ray * max_bounces + b] = alive ? idx1 : 0;
      shade(s, t, a, u + 4 * b, parity != 0);  // a dead ray passes through
    }
    for (int k = 0; k < 3; ++k) {
      const float c = sqrtf(clamp_min(s[6 + k], 0.0f));
      acc[k] = smp == 0 ? c : acc[k] + c;
    }
  }
  for (int k = 0; k < 3; ++k) out[ray * 3 + k] = acc[k];
}

extern "C" int ptt_sample_fused(const float* w16, const float* prim, const float* uni, int n,
                                int ns, int max_bounces, const float* ops, int ops_cols,
                                const float* attr, int attr_cols, const float* aabb,
                                const float* margin, int n_blocks, int tri_block, int parity,
                                int use_primary, int gated, float* out, int* idx_out,
                                void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)PTT_ROWS * kSweepRun * sizeof(float);
  sample_fused_kernel<<<n / kFusedTile, kFusedTile, smem, (cudaStream_t)stream>>>(
      w16, prim, uni, n, ns, max_bounces, ops, ops_cols, attr, attr_cols, aabb, margin,
      n_blocks, tri_block, parity, use_primary, gated, out, idx_out);
  return (int)cudaGetLastError();
}
