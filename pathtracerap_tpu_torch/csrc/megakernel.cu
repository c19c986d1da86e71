// Kernel 4: the whole-sample fused path tracer -- every bounce of a sample
// (trace, hit attributes, shading) in one launch, the ray state in
// registers across the bounce loop.
//
// Replaces the TPU kernel pathtracerap_tpu/pallas/megakernel.py::_megakernel
// (launched by _sample_pallas_call, per sample and with emit_idx, and by
// _sample_pallas_call_batched, over a batch of samples) with its sweep-mode
// _trace_inkernel, select_attrs and _shade_inkernel(_t).  Same contract:
// per ray, bounce 0 shades from the cached primary-hit row (use_primary)
// or traces the ray; every later bounce sweeps every real triangle in
// ascending index order, keeps the nearest accepted triangle (exact-t ties
// to the lowest index), reads its attribute rows and shades with this
// bounce's 4 uniforms (column block 4b).  The output is the contribution
// sqrt(max(color, 0)), summed in sample order over a batch of samples;
// with emit_idx also each bounce's triangle index + 1 (0 on a miss, and 0
// where the ray was already dead), the frozen hit topology of the
// differentiable replay.
//
// What bounds it on the H100: the sweep, every live ray against every real
// triangle at every traced bounce (no worklists: the ray state never
// leaves the kernel to be sorted); the shading is a few hundred flops per
// ray and bounce.  The first port (one thread per ray, 22 scalar shared
// loads and a division per pair, every lane of a warp with one live lane
// sweeping, the padding of the last block swept too) was bound by the SM's
// shared-memory load pipe.  The design now:
//  * one thread block per 256-ray tile, one thread per ray: its 10-word
//    state [orig, dir, color, remaining] stays in registers for the whole
//    sample, and the thread reads the attributes and shades it (uniforms
//    and idx_out in the original ray order);
//  * live-ray compaction at each traced bounce: every live ray writes its
//    ray vector to a compacted slot in shared memory (warp ballots plus a
//    block prefix), and the first `live` threads sweep one compacted ray
//    each (common.cuh sweep_rays: six 16-byte loads a triangle, the
//    division only where may_accept cannot reject the pair), then hand
//    (t, index) back through shared memory to the owner.  Which thread
//    sweeps a ray changes no bit of its result; no dead lane sweeps, only
//    the last sweeping warp's surplus lanes idle;
//  * the sweep stops at the last real triangle (n_tris): padding columns are
//    zero, det = 0 gives t = NaN, which the accept chain rejects in both
//    forms, so the cut is exact;
//  * 128-triangle runs of the triangle-major pack are staged by 16-byte
//    cp.async into two shared buffers: run j + 1 lands while run j is swept,
//    with one block barrier a run (cp.async rather than the bulk TMA copy:
//    a run is 12 KB that every thread issues in three 16-byte copies, and
//    the barrier that frees the other buffer is needed anyway, so an
//    mbarrier's phase tracking would buy nothing);
//  * above 8 blocks (GATE_BLOCKS, kernels/megakernel.py) the tile skips a
//    block that no live ray's slab test reaches within its current best
//    (the TPU kernel's gate), evaluated by the sweeping threads on their
//    rays with __syncthreads_or; it never changes a hit.
// On the card the sweep then issues about 40 instructions a pair (22 FMAs,
// the determinant, may_accept) at about 2 warp-instructions per SM clock:
// the loads no longer bound it.  Several rays a thread (one triangle's
// loads serving 2 or 4 rays) measured no faster on the quality slab and
// slower on the Cornell batch (PERF.md), so a thread sweeps one ray.
// `pairs`, when given, receives each tile's count of the (ray, triangle)
// pairs its sweeping warps issued (every lane of a warp that sweeps) and
// of those of live rays: what the compaction and the gate left to sweep.
// A sample batch is a loop over samples that sums in registers, where the
// TPU carried the sum across a sequential grid dimension in VMEM.  The TPU
// kernel's bf16x3 MXU products, one-hot attribute matmul and lane-major
// shading layout are TPU devices and are not carried over.

#include "shade.cuh"

namespace {

constexpr int kFusedTile = 256;  // rays per thread block
constexpr int kSweepRun = 128;   // triangles staged per shared-memory run
constexpr int kWarps = kFusedTile / 32;

struct FusedSmem {
  float4 run[2][kSweepRun * 6];  // two staged runs of the triangle-major pack
  float ray[9][kFusedTile];      // compacted ray vectors [d, o x d, o], by slot
  float res_t[kFusedTile];       // (t, index) of each compacted slot
  int res_i[kFusedTile];
  int warp_live[2][kWarps];      // live rays per warp, alternating by traced bounce
};

__device__ __forceinline__ void ray_inv(const RayVec& r, float inv[3]) {
  const float d[3] = {r.d0, r.d1, r.d2};
  for (int k = 0; k < 3; ++k) {
    const float dk = fabsf(d[k]) < 1e-12f ? (d[k] < 0.0f ? -1e-12f : 1e-12f) : d[k];
    inv[k] = 1.0f / dk;
  }
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

// Whether any live ray of the tile reaches block blk: each sweeping thread
// tests its compacted ray; every thread of the block must call it.
__device__ __forceinline__ bool tile_reaches(const float* __restrict__ aabb, int blk,
                                             const RayVec& r, float best, bool sweeper,
                                             float margin) {
  bool any = false;
  if (sweeper) {
    float inv[3];
    ray_inv(r, inv);
    any = box_reaches(aabb + (size_t)blk * 8, r, inv, margin, best);
  }
  return __syncthreads_or(any);
}

// The nearest hit of the tile's n_live compacted rays (sm.ray): the first
// n_live threads sweep one ray each (slot tid) over the real triangles
// [0, n_tris), block by block; the results land in sm.res_t / sm.res_i by
// slot.  Returns the triangles swept (gated blocks skipped).  Every thread
// of the block must call it.
template <bool Debug>
__device__ __forceinline__ int trace_compacted(FusedSmem& sm, int n_live,
                                               const float* __restrict__ ops_tri, int n_tris,
                                               const float* __restrict__ aabb, int n_blocks,
                                               int tri_block, int gated, float margin) {
  const int tid = threadIdx.x;
  const bool sweeper = tid < n_live;
  const int slot = min(tid, n_live - 1);  // surplus lanes read a live ray and sweep none
  // sweep_rays' one-ray form
  RayVec r[1] = {{sm.ray[0][slot], sm.ray[1][slot], sm.ray[2][slot], sm.ray[3][slot],
                  sm.ray[4][slot], sm.ray[5][slot], sm.ray[6][slot], sm.ray[7][slot],
                  sm.ray[8][slot]}};
  float best[1] = {PTT_F_MAX};
  int best_idx[1] = {-1};
  int swept = 0;

  int blk = 0;
  while (gated && blk < n_blocks && !tile_reaches(aabb, blk, r[0], best[0], sweeper, margin)) {
    ++blk;
  }
  int run = 0, buf = 0;
  if (blk < n_blocks) {
    stage_tri_async(sm.run[0], ops_tri, blk * tri_block, min(kSweepRun, n_tris - blk * tri_block));
  }
  while (blk < n_blocks) {
    const int g0 = blk * tri_block + run;
    const int width = min(kSweepRun, n_tris - g0);
    int next_blk = blk, next_run = run + kSweepRun;
    const bool block_ends = next_run >= tri_block || g0 + kSweepRun >= n_tris;
    if (block_ends) {
      next_blk = blk + 1;
      next_run = 0;
    }
    cp_async_wait_all();
    __syncthreads();  // run `buf` is in for every thread; run buf ^ 1 is no longer read
    // the next run is known now unless a gated block ends: its gate needs this run's best
    if (!(block_ends && gated) && next_blk < n_blocks) {
      const int g1 = next_blk * tri_block + next_run;
      stage_tri_async(sm.run[buf ^ 1], ops_tri, g1, min(kSweepRun, n_tris - g1));
    }
    if (sweeper) sweep_rays<1, Debug>(sm.run[buf], width, g0, r, best, best_idx);
    swept += width;
    if (block_ends && gated) {
      while (next_blk < n_blocks &&
             !tile_reaches(aabb, next_blk, r[0], best[0], sweeper, margin)) {
        ++next_blk;
      }
      if (next_blk < n_blocks) {
        stage_tri_async(sm.run[buf ^ 1], ops_tri, next_blk * tri_block,
                        min(kSweepRun, n_tris - next_blk * tri_block));
      }
    }
    blk = next_blk;
    run = next_run;
    buf ^= 1;
  }

  if (sweeper) {
    sm.res_t[tid] = best[0];
    sm.res_i[tid] = best_idx[0];
  }
  __syncthreads();
  return swept;
}

}  // namespace

// Debug: the explicit-mask accept chain of PTAP_DEBUG=1 (common.cuh).
template <bool Debug>
__global__ void __launch_bounds__(kFusedTile)
sample_fused_kernel(const float* __restrict__ w16,      // (N, 16) [dir, o x dir, orig, -1, 1, 0...]
                    const float* __restrict__ prim,     // (N, 16) [t, n, mt, rgb, gn, idx+1, ri, 0..]
                    const float* __restrict__ uni,      // (ns, N, 4 * max_bounces)
                    int n, int ns, int max_bounces,
                    const float* __restrict__ ops_tri,  // (T, 24) triangle-major pack
                    int n_tris,                         // real triangles: the sweep stops here
                    const float* __restrict__ attr,     // (16, attr_cols)
                    int attr_cols,
                    const float* __restrict__ aabb,     // (n_blocks, 8)
                    const float* __restrict__ margin,   // (1,)
                    int n_blocks, int tri_block, int parity, int use_primary, int gated,
                    float* __restrict__ out,            // (N, 3)
                    int* __restrict__ idx_out,          // (N, max_bounces) or null
                    unsigned long long* __restrict__ pairs) {  // (N / kFusedTile, 2) or null
  __shared__ FusedSmem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t ray = (size_t)blockIdx.x * kFusedTile + threadIdx.x;
  const int ucols = 4 * max_bounces;
  const float slack = gated ? margin[0] : 0.0f;
  float acc[3];
  float s[10];
  int pass = 0;  // traced bounces so far: picks the warp_live buffer
  // (ray, triangle) pairs of the sweeping warps' lanes, and of live rays
  unsigned long long issued = 0, live_pairs = 0;

  for (int smp = 0; smp < ns; ++smp) {
    const float* wr = w16 + ray * 16;
    const float init[10] = {wr[6], wr[7], wr[8], wr[0], wr[1], wr[2], 1.0f, 1.0f, 1.0f,
                            (float)max_bounces};
    for (int c = 0; c < 10; ++c) s[c] = init[c];
    for (int b = 0; b < max_bounces; ++b) {
      const bool traced = !(b == 0 && use_primary);
      const bool alive = s[9] > 0.0f;
      int n_live = 0, slot = 0;
      if (traced) {
        // compaction: this ray's slot among the tile's live rays, in (warp, lane) order
        int* wl = sm.warp_live[pass & 1];
        ++pass;
        const unsigned live = __ballot_sync(0xffffffffu, alive);
        if (lane == 0) wl[warp] = __popc(live);
        slot = __popc(live & ((1u << lane) - 1u));
        __syncthreads();
        for (int e = 0; e < kWarps; ++e) {
          const int c = wl[e];
          n_live += c;
          slot += e < warp ? c : 0;
        }
        if (n_live > 0) {  // the tile has a live ray
          if (alive) {
            const RayVec r = state_ray(s);
            const float v[9] = {r.d0, r.d1, r.d2, r.m0, r.m1, r.m2, r.o0, r.o1, r.o2};
            for (int j = 0; j < 9; ++j) sm.ray[j][slot] = v[j];
          }
          __syncthreads();
          const int swept = trace_compacted<Debug>(sm, n_live, ops_tri, n_tris, aabb, n_blocks,
                                                   tri_block, gated, slack);
          issued += (unsigned long long)swept * (unsigned)((n_live + 31) & ~31);
          live_pairs += (unsigned long long)swept * (unsigned)n_live;
        }
      }
      float t = PTT_F_MAX;
      int idx1 = 0;
      Attrs a = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, 0.f, 0.f};
      if (!traced) {
        const float* pr = prim + ray * 16;
        t = pr[0];
        a.n = {pr[1], pr[2], pr[3]};
        a.mt = pr[4];
        a.rgb = {pr[5], pr[6], pr[7]};
        a.gn = {pr[8], pr[9], pr[10]};
        idx1 = (int)pr[11];
        a.ri = pr[12];
      } else if (alive && n_live > 0) {
        t = sm.res_t[slot];
        const int best_idx = sm.res_i[slot];
        if (best_idx >= 0) a = read_attrs(attr, attr_cols, best_idx);
        idx1 = best_idx + 1;  // best_idx is -1 exactly when t is FLOAT_MAX
      }
      if (idx_out) idx_out[ray * max_bounces + b] = alive ? idx1 : 0;
      const float* u = uni + ((size_t)smp * n + ray) * ucols;
      shade<false>(s, t, a, u + 4 * b, parity != 0);  // a dead ray passes through
    }
    for (int c = 0; c < 3; ++c) {
      const float v = sqrtf(clamp_min(s[6 + c], 0.0f));
      acc[c] = smp == 0 ? v : acc[c] + v;
    }
  }
  for (int c = 0; c < 3; ++c) out[ray * 3 + c] = acc[c];
  if (pairs != nullptr && threadIdx.x == 0) {
    pairs[2 * blockIdx.x] = issued;
    pairs[2 * blockIdx.x + 1] = live_pairs;
  }
}

extern "C" int ptt_sample_fused(const float* w16, const float* prim, const float* uni, int n,
                                int ns, int max_bounces, const float* ops_tri, int n_tris,
                                const float* attr, int attr_cols, const float* aabb,
                                const float* margin, int n_blocks, int tri_block, int parity,
                                int use_primary, int gated, float* out, int* idx_out,
                                unsigned long long* pairs, int debug, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  void* kernel = debug ? (void*)sample_fused_kernel<true> : (void*)sample_fused_kernel<false>;
  void* args[] = {&w16,    &prim,   &uni,  &n,        &ns,          &max_bounces, &ops_tri,
                  &n_tris, &attr,   &attr_cols, &aabb, &margin,     &n_blocks,    &tri_block,
                  &parity, &use_primary, &gated, &out, &idx_out, &pairs};
  return (int)cudaLaunchKernel(kernel, dim3(n / kFusedTile), dim3(kFusedTile), args, 0,
                               (cudaStream_t)stream);
}
