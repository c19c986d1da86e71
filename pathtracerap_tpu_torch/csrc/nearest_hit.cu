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
// inflated box [min, max, 0, 0].  The ray is w = [dir, orig x dir, 0, 0] and
// wo = [orig, -1, alive, 0, 0, 0].
//
// What bounds it on the H100: at 2.16 M triangles the sweep itself is small
// (a bounce ray's slab test admits a few hundred of the 16,907 clusters), so
// the gate loop does: every thread block tests every cluster box against
// each of its rays, one barrier a cluster.  The design: one thread block per
// 256-ray tile, one thread per ray, walking the real triangles in index order
// in 128-triangle runs (one run = one cluster of the bake).  Boxes are staged
// 256 at a time in shared memory with coalesced loads; a run that some live
// ray's test admits (__syncthreads_or) has its 22 non-zero operand rows staged
// in shared memory (11 KB, the plane row negated, so kernel 1's `sweep` in
// common.cuh computes -(o . n - d) as the TPU kernel's -num, bit for bit) and
// every thread sweeps it.  Gating each 128-triangle cluster is finer than the
// TPU kernel's gate on the union box of a 1024-triangle block, and as
// conservative: a skipped run holds no triangle that could beat the running
// best, and ties already go to the lower index, which comes first.

#include "common.cuh"

#define NH_TILE 256  // rays a thread block; also the cluster boxes staged at once
#define NH_RUN 128   // triangles a run == the bake's cluster width

__global__ void __launch_bounds__(NH_TILE)
nearest_hit_kernel(const float* __restrict__ w,          // (N, 8)
                   const float* __restrict__ wo,         // (N, 8)
                   const float* __restrict__ edge_mat,   // (3, 8, tris)
                   const float* __restrict__ plane_mat,  // (8, tris)
                   int tris,
                   const float* __restrict__ aabb,       // (8, tris / NH_RUN)
                   const float* __restrict__ margin_p,   // (1,)
                   int runs, int cull,
                   float* __restrict__ t_out,            // (N,)
                   int* __restrict__ idx_out,            // (N,)
                   int* __restrict__ swept) {            // (N / NH_TILE,) or null
  __shared__ float sm[PTT_ROWS * NH_RUN];
  __shared__ float box[6][NH_TILE];
  const int tid = threadIdx.x;
  const size_t ray = (size_t)blockIdx.x * NH_TILE + tid;
  const float* wr = w + ray * 8;
  const float* wor = wo + ray * 8;
  const RayVec r = {wr[0], wr[1], wr[2], wr[3], wr[4], wr[5], wor[0], wor[1], wor[2]};
  const bool alive = wor[4] > 0.0f;
  const int clusters = tris / NH_RUN;
  // the slab test's reciprocal, magnitude clamped away from 0 (no 0 * inf)
  float inv[3];
  const float d[3] = {r.d0, r.d1, r.d2};
  for (int a = 0; a < 3; ++a) {
    const float da = fabsf(d[a]) < 1e-12f ? (d[a] < 0.0f ? -1e-12f : 1e-12f) : d[a];
    inv[a] = 1.0f / da;
  }
  const float o[3] = {r.o0, r.o1, r.o2};
  const float margin = *margin_p;
  float best = PTT_F_MAX;
  int best_idx = -1;
  int n_swept = 0;
  for (int c = 0; c < runs; ++c) {
    if (cull) {
      const int k = c % NH_TILE;
      if (k == 0) {
        __syncthreads();  // every thread has read the previous chunk of boxes
        if (c + tid < runs)
          for (int a = 0; a < 6; ++a) box[a][tid] = __ldg(aabb + (size_t)a * clusters + c + tid);
        __syncthreads();
      }
      bool pass = false;
      if (alive) {
        float tmin = 0.0f, tmax = 0.0f;
        for (int a = 0; a < 3; ++a) {
          const float lo = (box[a][k] - o[a]) * inv[a];
          const float hi = (box[3 + a][k] - o[a]) * inv[a];
          tmin = a == 0 ? fminf(lo, hi) : fmaxf(tmin, fminf(lo, hi));
          tmax = a == 0 ? fmaxf(lo, hi) : fminf(tmax, fmaxf(lo, hi));
        }
        pass = (tmax >= -margin) && (tmin <= tmax + margin) && (tmin - margin <= best);
      }
      // also the barrier after which the previous run's rows are no longer read
      if (!__syncthreads_or(pass)) continue;
    } else {
      __syncthreads();
    }
    const int g0 = c * NH_RUN;
    for (int i = tid; i < PTT_ROWS * NH_RUN; i += NH_TILE) {
      const int row = i / NH_RUN;
      const int col = g0 + i - row * NH_RUN;
      // rows 0-17: edge q = row / 6, component row % 6; rows 18-21: -n, -d
      sm[i] = row < 18 ? __ldg(edge_mat + (size_t)((row / 6) * 8 + row % 6) * tris + col)
                       : -__ldg(plane_mat + (size_t)(row - 18) * tris + col);
    }
    __syncthreads();
    sweep(sm, NH_RUN, g0, r, best, best_idx);
    ++n_swept;
  }
  t_out[ray] = best;
  idx_out[ray] = best_idx;
  if (swept != nullptr && tid == 0) swept[blockIdx.x] = n_swept;
}

extern "C" int ptt_nearest_hit(const float* w, const float* wo, const float* edge_mat,
                               const float* plane_mat, int tris, const float* aabb,
                               const float* margin, int runs, int n_tiles, int cull,
                               float* t_out, int* idx_out, int* swept, void* stream) {
  if (n_tiles == 0) return (int)cudaSuccess;
  nearest_hit_kernel<<<n_tiles, NH_TILE, 0, (cudaStream_t)stream>>>(
      w, wo, edge_mat, plane_mat, tris, aabb, margin, runs, cull, t_out, idx_out, swept);
  return (int)cudaGetLastError();
}
