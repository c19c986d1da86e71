// Kernel 1: worklist nearest-hit trace (the primary rays, and every bounce
// of the per-bounce pallas engine).
//
// Replaces the TPU kernel pathtracerap_tpu/pallas/trace.py::_fused_list_kernel
// (launched by nearest_hit_fused), its streamed mode above 313 blocks
// included.  Same contract: per ray tile, visit the blocks of that tile's
// tmin-sorted, -1-padded worklist; per ray return the nearest accepted
// triangle (t, global index), exact-t ties to the lowest index,
// (FLOAT_MAX, -1) on a miss.  Every ray of a tile is traced, live or not.
//
// What bounds it on the H100: the sweep's instruction issue, about 40
// instructions per (ray, triangle) pair (common.cuh sweep_rays), and how
// evenly the pairs spread over the 132 SMs: list lengths vary from tile
// to tile (the megascene's primaries: median 1 block, at most 298), and
// one thread block per tile left the longest list on one SM.  The design:
//  * operands: the bake's triangle-major pack ops_tri, staged in runs of
//    128 triangles by 16-byte cp.async into two shared buffers, run j + 1
//    landing while run j is swept, one barrier a run; each thread sweeps
//    R rays of the tile (strided, so that the ray loads stay coalesced)
//    with six 16-byte shared loads a triangle; the sweep stops at the last
//    real triangle (padding is never accepted);
//  * worklists split over thread blocks: a tile's list is cut into chunks
//    of C entries, each swept by its own thread block (grid: tiles x
//    ceil(list width / C); a chunk past the list's end returns at once).
//    A tile whose list fits one chunk writes its (t, index) directly.
//    Otherwise each chunk folds its rays' bests into a per-ray 64-bit key
//    with atomicMax, and the tile's last chunk to finish (a per-tile
//    counter, after a __threadfence) writes the result.  The one-pass
//    sweep keeps the lexicographic minimum of (t, index), -0.0 equal to
//    +0.0, so any order of chunks gives the same bits as long as the key
//    orders that way: t first, -0.0 taken as +0.0, then the index, and a
//    flag bit that gives a -0.0 back.
// The TPU tiling (512-ray tiles on the MXU, bf16x3 splits, SMEM worklist
// chunking, streamed DMA above 313 blocks) is not carried over.

#include "common.cuh"

namespace {

constexpr int kSweepRun = 128;  // triangles staged per shared-memory run
// rays a thread sweeps (R) and worklist entries a thread block sweeps (C):
// chosen on the card, PERF.md (kernels/trace.py TRACE_LIST_RAYS and
// TRACE_LIST_CHUNK mirror them)
constexpr int kRays = 2;
constexpr int kChunk = 1;

// The merge key of a hit (t, g), t in [-0.005, FLOAT_MAX): t's order
// (-0.0 as +0.0) above the index above a flag for -0.0, all inverted, so
// that the best hit is the largest key and a slot no chunk wrote (zero)
// is a miss.
__device__ __forceinline__ unsigned long long merge_key(float t, int g) {
  const unsigned b = __float_as_uint(t);
  const unsigned ord = (b << 1) == 0u ? 0x80000000u : (b >> 31 ? ~b : b | 0x80000000u);
  const unsigned long long key = ((unsigned long long)ord << 32) |
                                 ((unsigned long long)(unsigned)g << 1) | (b == 0x80000000u);
  return ~key;
}

__device__ __forceinline__ void merged_hit(unsigned long long v, float& t, int& g) {
  if (v == 0ull) {
    t = PTT_F_MAX;
    g = -1;
    return;
  }
  const unsigned long long key = ~v;
  const unsigned ord = (unsigned)(key >> 32);
  const unsigned b = (key & 1ull) ? 0x80000000u : (ord >> 31 ? ord & 0x7fffffffu : ~ord);
  t = __uint_as_float(b);
  g = (int)((unsigned)(key & 0xffffffffull) >> 1);
}

}  // namespace

// Debug: the explicit-mask accept chain of PTAP_DEBUG=1 (common.cuh).
template <bool Debug>
__global__ void trace_list_kernel(const float* __restrict__ w,        // (N, 16) ray vectors
                                  const int* __restrict__ lists,      // (nt, list_w)
                                  int list_w, int unit,
                                  const float* __restrict__ ops_tri,  // (T, 24) triangle-major pack
                                  int n_tris,                         // real triangles
                                  float* __restrict__ t_out,          // (N,)
                                  int* __restrict__ idx_out,          // (N,)
                                  unsigned long long* merge) {        // (N + nt) zeros, or null
  __shared__ float4 run[2][kSweepRun * 6];
  __shared__ int last;
  const int tile = blockIdx.x;
  const int* row = lists + (size_t)tile * list_w;
  const int j0 = blockIdx.y * kChunk;
  if (j0 > 0 && row[j0] < 0) return;  // a chunk past the list's end
  const bool whole = list_w <= kChunk || row[kChunk] < 0;  // the list fits chunk 0
  // this thread's rays: base + k * stride, k < kRays
  const int stride = blockDim.x;
  const size_t base = (size_t)tile * stride * kRays + threadIdx.x;

  RayVec r[kRays];
  float best[kRays];
  int best_idx[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const float4* wr = reinterpret_cast<const float4*>(w + (base + (size_t)k * stride) * 16);
    const float4 a = wr[0], b = wr[1], c = wr[2];
    r[k] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
    best[k] = PTT_F_MAX;
    best_idx[k] = -1;
  }

  RunCursor<kSweepRun> cur = {row + j0, min(kChunk, list_w - j0), unit, n_tris, 0, 0, -1};
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
    sweep_rays<kRays, Debug>(run[buf], width, g0, r, best, best_idx);
  }

  if (whole) {
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const size_t ray = base + (size_t)k * stride;
      t_out[ray] = best[k];
      idx_out[ray] = best_idx[k];
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const size_t ray = base + (size_t)k * stride;
    if (best_idx[k] >= 0) atomicMax(merge + ray, merge_key(best[k], best_idx[k]));
  }
  __threadfence();  // this chunk's keys are visible before its count
  __syncthreads();
  if (threadIdx.x == 0) {
    // the list's length (its entries are a prefix of the row, > kChunk here)
    int lo = kChunk + 1, hi = list_w;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (row[mid - 1] >= 0) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const unsigned long long chunks = (lo + kChunk - 1) / kChunk;
    unsigned long long* count = merge + (size_t)gridDim.x * stride * kRays + tile;
    last = atomicAdd(count, 1ull) == chunks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const size_t ray = base + (size_t)k * stride;
    float t;
    int g;
    merged_hit(atomicAdd(merge + ray, 0ull), t, g);  // read at L2, where the atomics landed
    t_out[ray] = t;
    idx_out[ray] = g;
  }
}

// merge: (N + nt) zeroed 64-bit words when list_w > kChunk (the per-ray
// keys, then the per-tile counts), else unused.
extern "C" int ptt_trace_list(const float* w, const int* lists, int nt, int list_w, int unit,
                              int ray_tile, const float* ops_tri, int n_tris, float* t_out,
                              int* idx_out, unsigned long long* merge, int debug, void* stream) {
  if (nt == 0) return (int)cudaSuccess;
  if (unit % kSweepRun || ray_tile % (32 * kRays) || ray_tile / kRays > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  if (list_w > kChunk && merge == nullptr) return (int)cudaErrorInvalidValue;
  const int chunks = list_w > 0 ? (list_w + kChunk - 1) / kChunk : 1;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  void* kernel = debug ? (void*)trace_list_kernel<true> : (void*)trace_list_kernel<false>;
  void* args[] = {&w, &lists, &list_w, &unit, &ops_tri, &n_tris, &t_out, &idx_out, &merge};
  return (int)cudaLaunchKernel(kernel, dim3(nt, chunks), dim3(ray_tile / kRays), args, 0,
                               (cudaStream_t)stream);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
