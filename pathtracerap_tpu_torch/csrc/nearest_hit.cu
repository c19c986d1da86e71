// Kernel 5: dense nearest-hit trace of a world without a fused pack.
//
// Replaces the TPU kernel pathtracerap_tpu/pallas/trace.py::_nearest_hit_kernel
// (launched by nearest_hit).  Same contract: per ray the nearest accepted
// triangle over every real triangle (t, index), exact-t ties to the lowest
// index, (FLOAT_MAX, -1) on a miss; with `cull`, a triangle run is skipped
// when no live ray's slab test against its box can reach it with a better t.
// A dead ray's result is unspecified.
//
// Operands are JAX's dense layout: edge_mat (3, 8, T) holds per triangle the
// three Pluecker edge columns [p x q, q - p, 0, 0], plane_mat (8, T) holds
// [n, d_plane, 0...], cluster_aabb (8, T / 128) each 128-triangle cluster's
// inflated box [min, max, 0, 0], group_aabb (8, groups) the union box of
// each kGroup consecutive real clusters (ops/plucker.py cluster_group_aabb,
// made once by the bake).  The ray is w = [dir, orig x dir, 0, 0] and
// wo = [orig, -1, alive, 0, 0, 0].
//
// What bounds it on the H100: at 2.16 M triangles, the gate.  A bounce ray's
// slab test admits a few hundred of the 16,907 clusters, or none (the room
// camera's rays leave the scene), so a gate that tests every cluster box
// with one block barrier a cluster took most of the time; from inside the
// room the sweep of the admitted runs is real work too.  The design: one
// thread block per 256-ray tile of 256 / R threads, R = kRays rays a thread
// (strided, so that loads and stores stay coalesced), walking the real
// triangles in index order in 128-triangle runs (one run = one cluster of
// the bake):
//  * a tile with no live ray leaves at once and writes misses;
//  * two-level gate: the group box of kGroup clusters is tested first, one
//    block vote (__syncthreads_or) a group; only inside a group that some
//    live ray's test admits are the member clusters tested, one vote each,
//    and an admitted cluster's run swept.  Boxes are staged kBoxChunk
//    clusters (and their groups) at a time in shared memory;
//  * the admitted run's operands are written into shared memory in the
//    order of the bake's triangle-major pack ops_tri (s_ab rows 0-5, s_bc
//    rows 0-5, s_ca rows 0-5, -n, -d, two zero pads: 24 floats a triangle;
//    the plane negated, so that the fmaf chains compute the TPU kernel's
//    -num, bit for bit) and swept by common.cuh's sweep_rays.  The stage is
//    synchronous: the next run to sweep is known only after the vote that
//    follows this sweep, and the SM's other resident blocks hide its loads.
//
// Why the two-level gate sweeps exactly the runs the per-cluster gate
// sweeps.  A group box contains each member's box (min of mins, max of
// maxes; a group with an inverted or NaN member box, which every ray
// reaches, has an infinite box, which every ray with a finite origin
// reaches too).  The slab test's operations are monotone in f32: (b - o) *
// inv is non-decreasing in b for inv > 0 and non-increasing for inv < 0, so
// per axis the group's min(lo, hi) is at most the member's and its max(lo,
// hi) at least, and so are tmin and tmax after the max / min over the axes;
// then tmax >= -margin, tmin <= tmax + margin and tmin - margin <= best
// hold for the group whenever they hold for the member, at the same best.
// The group is tested with each ray's best at the group's start, which is
// never smaller than its best when any member is tested (a best only
// falls).  So whenever a live ray's test admits a member, the same ray's
// test admits its group: a group that no ray's test admits holds no
// cluster the per-cluster gate would admit, and nothing is swept there in
// either gate, so the bests, and by induction the sets of swept runs, are
// the same.  Ties already go to the lower index, which comes first.

#include "common.cuh"

namespace {

constexpr int kTile = 256;  // rays a thread block (kernels/trace.py DENSE_TILE)
constexpr int kRun = 128;   // triangles a run == the bake's cluster width (DENSE_RUN)
// rays a thread sweeps (R) and clusters a group box unites (G): chosen on
// the card, PERF.md (kernels/trace.py DENSE_RAYS, ops/plucker.py
// CLUSTER_GROUP mirror them)
constexpr int kRays = 2;
constexpr int kGroup = 64;
constexpr int kBoxChunk = 256;  // cluster boxes staged at once, a multiple of kGroup
constexpr int kThreads = kTile / kRays;
static_assert(kBoxChunk % kGroup == 0, "a chunk of boxes holds whole groups");

// A ray's slab-test operands: its origin and the reciprocal of its
// direction, magnitude clamped away from 0 (no 0 * inf).
struct Slab {
  float o[3], inv[3];
};

__device__ __forceinline__ Slab slab_of(const RayVec& r) {
  Slab s = {{r.o0, r.o1, r.o2}, {0.0f, 0.0f, 0.0f}};
  const float d[3] = {r.d0, r.d1, r.d2};
  for (int a = 0; a < 3; ++a) {
    const float da = fabsf(d[a]) < 1e-12f ? (d[a] < 0.0f ? -1e-12f : 1e-12f) : d[a];
    s.inv[a] = 1.0f / da;
  }
  return s;
}

// Whether the ray reaches box k of a staged [6][N] table with a t that can
// beat `best` (kernels/trace.py slab_reaches mirrors it op for op).
template <int N>
__device__ __forceinline__ bool reaches(const float (&box)[6][N], int k, const Slab& s,
                                        float margin, float best) {
  float tmin = 0.0f, tmax = 0.0f;
  for (int a = 0; a < 3; ++a) {
    const float lo = (box[a][k] - s.o[a]) * s.inv[a];
    const float hi = (box[3 + a][k] - s.o[a]) * s.inv[a];
    tmin = a == 0 ? fminf(lo, hi) : fmaxf(tmin, fminf(lo, hi));
    tmax = a == 0 ? fmaxf(lo, hi) : fminf(tmax, fmaxf(lo, hi));
  }
  return (tmax >= -margin) && (tmin <= tmax + margin) && (tmin - margin <= best);
}

// Write run [g0, g0 + kRun) of the dense operands into sm (kRun x 24
// floats) in ops_tri's order, the plane rows negated; the pads are left as
// they are.  Loads are coalesced along the triangles.
__device__ __forceinline__ void stage_dense(float* sm, const float* __restrict__ edge_mat,
                                            const float* __restrict__ plane_mat, int tris,
                                            int g0) {
  for (int i = threadIdx.x; i < PTT_ROWS * kRun; i += kThreads) {
    const int row = i / kRun;
    const int c = i - row * kRun;
    // rows 0-17: edge q = row / 6, component row % 6; rows 18-21: -n, -d
    sm[c * PTT_TRI_FLOATS + row] =
        row < 18 ? __ldg(edge_mat + (size_t)((row / 6) * 8 + row % 6) * tris + g0 + c)
                 : -__ldg(plane_mat + (size_t)(row - 18) * tris + g0 + c);
  }
}

}  // namespace

__global__ void __launch_bounds__(kThreads)
nearest_hit_kernel(const float* __restrict__ w,           // (N, 8)
                   const float* __restrict__ wo,          // (N, 8)
                   const float* __restrict__ edge_mat,    // (3, 8, tris)
                   const float* __restrict__ plane_mat,   // (8, tris)
                   int tris,
                   const float* __restrict__ aabb,        // (8, tris / kRun)
                   const float* __restrict__ group_aabb,  // (8, ceil(runs / kGroup))
                   const float* __restrict__ margin_p,    // (1,)
                   int runs, int cull,
                   float* __restrict__ t_out,             // (N,)
                   int* __restrict__ idx_out,             // (N,)
                   int* __restrict__ swept,               // (N / kTile,) or null
                   int* __restrict__ tests) {             // (N / kTile, 2) or null
  __shared__ float4 run[kRun * 6];
  __shared__ float box[6][kBoxChunk];
  __shared__ float gbox[6][kBoxChunk / kGroup];
  const int tid = threadIdx.x;
  // this thread's rays: base + k * kThreads, k < kRays
  const size_t base = (size_t)blockIdx.x * kTile + tid;

  RayVec r[kRays];
  Slab sl[kRays];
  bool alive[kRays];
  float best[kRays];
  int best_idx[kRays];
  bool live = false;  // whether any of this thread's rays is live
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const size_t ray = base + (size_t)k * kThreads;
    const float* wr = w + ray * 8;
    const float* wor = wo + ray * 8;
    r[k] = {wr[0], wr[1], wr[2], wr[3], wr[4], wr[5], wor[0], wor[1], wor[2]};
    sl[k] = slab_of(r[k]);
    alive[k] = wor[4] > 0.0f;
    live = live || alive[k];
    best[k] = PTT_F_MAX;
    best_idx[k] = -1;
  }
  float* runf = reinterpret_cast<float*>(run);
  for (int c = tid; c < kRun; c += kThreads) {  // the pads, which no stage writes
    runf[c * PTT_TRI_FLOATS + 22] = 0.0f;
    runf[c * PTT_TRI_FLOATS + 23] = 0.0f;
  }
  int n_swept = 0, n_group_tests = 0, n_cluster_tests = 0;
  if (__syncthreads_or(live)) {  // else no live ray in the tile: every ray misses
    if (cull) {
      const float margin = *margin_p;
      const int clusters = tris / kRun;
      const int groups = (runs + kGroup - 1) / kGroup;
      for (int gi = 0; gi < groups; ++gi) {
        const int c0 = gi * kGroup;
        const int kc = c0 % kBoxChunk;
        if (kc == 0) {
          // every thread is past the last vote, so no box of the chunk
          // before is read any more
          for (int i = tid; i < 6 * kBoxChunk; i += kThreads) {
            const int a = i / kBoxChunk, j = i - a * kBoxChunk;
            if (c0 + j < runs) box[a][j] = __ldg(aabb + (size_t)a * clusters + c0 + j);
          }
          for (int i = tid; i < 6 * (kBoxChunk / kGroup); i += kThreads) {
            const int a = i / (kBoxChunk / kGroup), j = i - a * (kBoxChunk / kGroup);
            if (gi + j < groups) gbox[a][j] = __ldg(group_aabb + (size_t)a * groups + gi + j);
          }
          __syncthreads();
        }
        bool pass = false;
#pragma unroll
        for (int k = 0; k < kRays; ++k)
          pass = pass || (alive[k] && reaches(gbox, kc / kGroup, sl[k], margin, best[k]));
        ++n_group_tests;
        if (!__syncthreads_or(pass)) continue;
        const int c1 = min(c0 + kGroup, runs);
        for (int c = c0; c < c1; ++c) {
          bool hit = false;
#pragma unroll
          for (int k = 0; k < kRays; ++k)
            hit = hit || (alive[k] && reaches(box, c % kBoxChunk, sl[k], margin, best[k]));
          ++n_cluster_tests;
          // also the barrier after which the previous run is no longer read
          if (!__syncthreads_or(hit)) continue;
          stage_dense(runf, edge_mat, plane_mat, tris, c * kRun);
          __syncthreads();
          if (live) sweep_rays<kRays>(run, kRun, c * kRun, r, best, best_idx);
          ++n_swept;
        }
      }
    } else {
      for (int c = 0; c < runs; ++c) {
        __syncthreads();  // the previous run is no longer read
        stage_dense(runf, edge_mat, plane_mat, tris, c * kRun);
        __syncthreads();
        if (live) sweep_rays<kRays>(run, kRun, c * kRun, r, best, best_idx);
        ++n_swept;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const size_t ray = base + (size_t)k * kThreads;
    t_out[ray] = best[k];
    idx_out[ray] = best_idx[k];
  }
  if (tid == 0) {
    if (swept != nullptr) swept[blockIdx.x] = n_swept;
    if (tests != nullptr) {
      tests[2 * blockIdx.x] = n_group_tests;
      tests[2 * blockIdx.x + 1] = n_cluster_tests;
    }
  }
}

extern "C" int ptt_nearest_hit(const float* w, const float* wo, const float* edge_mat,
                               const float* plane_mat, int tris, const float* aabb,
                               const float* group_aabb, const float* margin, int runs,
                               int n_tiles, int cull, float* t_out, int* idx_out, int* swept,
                               int* tests, void* stream) {
  if (n_tiles == 0) return (int)cudaSuccess;
  nearest_hit_kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      w, wo, edge_mat, plane_mat, tris, aabb, group_aabb, margin, runs, cull, t_out, idx_out,
      swept, tests);
  return (int)cudaGetLastError();
}
