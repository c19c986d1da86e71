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
// triangle's index (-1: miss, or a dead ray) is written too.
//
// What bounds it on the H100: the sweep -- about 40 instructions per
// (ray, triangle) pair over the tile's worklist (22 FMAs, the determinant,
// may_accept), issued at about 2 warp-instructions per SM clock; the
// shading is a few hundred flops per ray, once.  The first port (one
// thread per ray, 22 scalar shared loads and a division per pair, two
// barriers and a synchronous staging per worklist entry) was bound by the
// SM's shared-memory load pipe.  The design now: thread blocks of
// `ray_tile / R` threads, R = 2 (kRays), one a ray tile and chunk of its
// worklist (below); each thread owns R rays of the sorted tile, strided
// by `ray_tile / R` so that the state loads and stores stay coalesced,
// keeps their ray vectors and bests in registers and sweeps them
// together (common.cuh sweep_rays: six 16-byte shared loads a triangle
// for R rays, the division only where a ray may be accepted).  The
// wavefront is sorted with dead rays last, so the live rays of a tile are
// a prefix: in a tile with fewer live rays than threads (the megascene's
// tail) the threads and warps past them own no live ray and skip the
// sweep.  The worklist holds 128-triangle
// sub-block ids (or whole blocks above 64 blocks, four runs an entry),
// sorted by the tile's entry distance; its 128-triangle runs of the
// triangle-major pack are staged by 16-byte cp.async into two shared
// buffers, run j + 1 landing while run j is swept, one barrier a run, and
// the sweep stops at the last real triangle (padding is never accepted).
// Then each thread re-reads its rays' states and shades them one by one.
// R = 2 measured as fast as R = 1 within the spread of runs, and R = 4
// slower (PERF.md).
//
// Worklists split over thread blocks.  On a dense mesh the block lists of
// incoherent bounces keep most of the scene's blocks, and the wavefront's
// live tiles (a prefix of the sorted slab) can be fewer than the 132 SMs:
// one thread block a tile then left SMs idle for the whole sweep of the
// longest list.  So, as kernel 1 does, a tile's list is cut into chunks of
// C entries (the wrapper picks C from the shapes), each swept by its own
// thread block (grid: tiles x ceil(list width / C); a chunk past the
// list's end returns at once).  A tile whose list fits one chunk sweeps,
// shades and writes in one thread block, with no atomics; a tile with no
// live ray is passed through by its chunk 0.  Otherwise each chunk folds
// its rays' bests into a per-ray 64-bit key (common.cuh merge_key) with
// atomicMax, and the tile's last chunk to finish (a per-tile counter,
// after a __threadfence) reads the merged hits at L2, re-reads the states
// and shades them: the key keeps the one-pass sweep's lexicographic
// minimum of (t, index), so the output is the same bits for any C.
//
// The TPU's groups of four sub-blocks, its one-hot attribute matmul and
// its lane-major shading layout are TPU devices and are not carried over:
// the winner's attributes are read directly from the (16, T) attribute
// rows.
//
// The shading is csrc/shade.cuh's, which kernel 4 shares.

#include "shade.cuh"

namespace {

constexpr int kSweepRun = 128;  // triangles staged per shared-memory run
// rays a thread carries through the sweep (R): chosen on the card, PERF.md
// (kernels/megakernel.py BOUNCE_RAYS_PER_THREAD mirrors it)
constexpr int kRays = 2;

}  // namespace

// Debug: the explicit-mask accept chain of PTAP_DEBUG=1 (common.cuh).
template <bool Debug>
__global__ void bounce_kernel(const float* __restrict__ state,    // (N, 10)
                              const float* __restrict__ uni,      // (N, 4)
                              const int* __restrict__ lists,      // (nt, list_w)
                              int list_w, int unit,
                              int chunk,                          // entries a thread block sweeps
                              const float* __restrict__ ops_tri,  // (T, 24) triangle-major pack
                              int n_tris,                         // real triangles
                              const float* __restrict__ attr,     // (16, attr_cols)
                              int attr_cols, int parity,
                              float* __restrict__ out,            // (N, 10)
                              int* __restrict__ idx_out,          // (N,) hit or -1
                              unsigned long long* merge) {        // (N + nt) zeros, or null
  __shared__ float4 run[2][kSweepRun * 6];
  __shared__ int last;
  const int tile = blockIdx.x;
  const int* row = lists + (size_t)tile * list_w;
  const int j0 = blockIdx.y * chunk;
  if (j0 > 0 && row[j0] < 0) return;  // a chunk past the list's end
  const bool whole = list_w <= chunk || row[chunk] < 0;  // the list fits chunk 0
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
  if (!__syncthreads_or(live)) {  // no live ray in the tile: chunk 0 passes it through
    if (j0 > 0) return;
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const size_t ray = base + (size_t)k * stride;
      for (int c = 0; c < 10; ++c) out[ray * 10 + c] = state[ray * 10 + c];
      idx_out[ray] = -1;
    }
    return;
  }

  RunCursor<kSweepRun> cur = {row + j0, min(chunk, list_w - j0), unit, n_tris, 0, 0, -1};
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
    if (live) sweep_rays<kRays, Debug>(run[buf], width, g0, r, best, best_idx);
  }

  if (!whole) {
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const size_t ray = base + (size_t)k * stride;
      if (best_idx[k] >= 0) atomicMax(merge + ray, merge_key(best[k], best_idx[k]));
    }
    __threadfence();  // this chunk's keys are visible before its count
    __syncthreads();
    if (threadIdx.x == 0) {
      // the list's length (its entries are a prefix of the row, > chunk here)
      int lo = chunk + 1, hi = list_w;
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (row[mid - 1] >= 0) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      const unsigned long long chunks = (lo + chunk - 1) / chunk;
      unsigned long long* count = merge + (size_t)gridDim.x * stride * kRays + tile;
      last = atomicAdd(count, 1ull) == chunks - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      // read at L2, where the atomics landed
      merged_hit(atomicAdd(merge + base + (size_t)k * stride, 0ull), best[k], best_idx[k]);
    }
  }

#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const size_t ray = base + (size_t)k * stride;
    float s[10];
    for (int c = 0; c < 10; ++c) s[c] = state[ray * 10 + c];
    const bool alive = s[9] > 0.0f;
    Attrs a = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, 0.f, 0.f};
    if (alive && best_idx[k] >= 0) a = read_attrs(attr, attr_cols, best_idx[k]);
    shade(s, best[k], a, uni + ray * 4, parity != 0);  // a dead ray passes through
    for (int c = 0; c < 10; ++c) out[ray * 10 + c] = s[c];
    idx_out[ray] = alive ? best_idx[k] : -1;
  }
}

// chunk: worklist entries a thread block sweeps (>= 1); merge: (N + nt)
// zeroed 64-bit words when a list spans chunks (the per-ray keys, then the
// per-tile counts), else unused.
extern "C" int ptt_bounce(const float* state, const float* uni, const int* lists, int nt,
                          int list_w, int unit, int ray_tile, int chunk, const float* ops_tri,
                          int n_tris, const float* attr, int attr_cols, int parity, float* out,
                          int* idx_out, unsigned long long* merge, int debug, void* stream) {
  if (nt == 0) return (int)cudaSuccess;
  if (ray_tile % (32 * kRays) || chunk < 1) return (int)cudaErrorInvalidValue;
  const int chunks = list_w > 0 ? (list_w + chunk - 1) / chunk : 1;
  if (chunks > 65535 || (chunks > 1 && merge == nullptr)) return (int)cudaErrorInvalidValue;
  void* kernel = debug ? (void*)bounce_kernel<true> : (void*)bounce_kernel<false>;
  void* args[] = {&state, &uni,      &lists,     &list_w, &unit, &chunk,   &ops_tri,
                  &n_tris, &attr, &attr_cols, &parity, &out,  &idx_out, &merge};
  return (int)cudaLaunchKernel(kernel, dim3(nt, chunks), dim3(ray_tile / kRays), args, 0,
                               (cudaStream_t)stream);
}
