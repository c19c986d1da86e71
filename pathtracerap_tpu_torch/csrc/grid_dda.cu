// Kernel G1: the parity engine's uniform-grid trace, one thread a ray.
//
// Replaces pathtracerap_tpu/ops/intersect.py::trace_parity (its per-model
// march _dda_one_model, :131, and the merge over models, :276), which JAX
// runs as XLA, not Pallas: a lax.while_loop over voxel steps in which the
// whole wavefront gathers (N, K) triangle rows each step, inside a scan
// over models.  Here, as in the reference's
// computeRaySceneIntersectionKernel (Renderer.cpp:363-409), each thread
// walks one ray through the models in index order: the world -> model
// transform and normalisation, the slab test and entry voxel
// (Renderer.cpp:252-270), the DDA with the strict axis choice
// (Renderer.cpp:331-357), and in each voxel its CSR bucket
// (voxel_tri_start / voxel_tri_count, the ELL row's order) through
// Moeller-Trumbore (Renderer.cpp:174-215); then the early exit
// (Renderer.cpp:326-329) and the merge on a strictly smaller world
// distance.
//
// The plain version is ops/intersect.py::trace_parity; this kernel repeats
// its arithmetic operation by operation (fmaf where it calls addcmul or
// dot3/cross3's fused chains, IEEE division and sqrt, no fast math: the
// range tests rely on det == 0 giving inf or NaN), and its argmin rule in
// a voxel: the first strictly smaller t wins, a NaN t counting as the
// smallest, so an accepted NaN blocks that voxel's update.
//
// What bounds it on the H100: operations and divergence, not bytes.  A
// ray's work is data dependent (voxels stepped, triangles tested: the
// kernel's own counters); the scene's tables (a few hundred KB for the
// reference scene) stay in L1 and L2.  This first form is the simple one:
// no sorting of rays by direction, no shared-memory staging.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr float kFMax = 9999999.0f;
constexpr float kFMin = -9999990.0f;
constexpr float kEps = 0.005f;
constexpr int kThreads = 128;

struct GridScene {
  const float* w2m;         // (I, 4, 4)
  const float* m2w;         // (I, 4, 4)
  const float* nmat;        // (I, 3, 3) inverse-transposes of m2w's 3x3
  const int* model_mesh;    // (I,)
  const int* model_grid;    // (I,)
  const float* bb_min;      // (M, 3)
  const float* bb_max;      // (M, 3)
  const float* voxel_w;     // (G, 3)
  const int* voxel_start;   // (G,)
  const int* vt_start;      // (NV,)
  const int* vt_count;      // (NV,)
  const int* vt_tris;       // (P,)
  const int* tri_vidx;      // (T, 3)
  const float* vpos;        // (V, 3)
  const float* vnrm;        // (V, 3)
  const int* mat_type;      // (I,)
  const float* mat_color;   // (I, 3)
  const float* mat_ri;      // (I,)
  int n_models, gx, gy, gz;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 ld3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }

// ops/math.py: dot3 = fma chain from x, cross3 = fma(a, b, -(c * d))
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x));
}
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {fmaf(a.y, b.z, -(a.z * b.y)), fmaf(a.z, b.x, -(a.x * b.z)),
          fmaf(a.x, b.y, -(a.y * b.x))};
}

// intersect.py mat3_apply: m[:3, :3] @ v, products fused in column order;
// m is row-major with row stride `ld`
__device__ __forceinline__ V3 mat3(const float* m, int ld, V3 v) {
  return {fmaf(v.z, m[2], fmaf(v.y, m[1], v.x * m[0])),
          fmaf(v.z, m[ld + 2], fmaf(v.y, m[ld + 1], v.x * m[ld])),
          fmaf(v.z, m[2 * ld + 2], fmaf(v.y, m[2 * ld + 1], v.x * m[2 * ld]))};
}

__device__ __forceinline__ V3 normalize(V3 v) {
  const float len = sqrtf(dot3(v, v));
  return {v.x / len, v.y / len, v.z / len};
}

// torch.minimum / torch.maximum: NaN propagates
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : (b < a ? b : a);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : (b > a ? b : a);
}

// the slab's near and far t on one axis (Renderer.cpp:150-170)
__device__ __forceinline__ void slab_axis(float o, float d, float inv, float lo, float hi,
                                          float& near, float& far) {
  const bool zero = d == 0.0f;
  const float t_lo = zero ? kFMin : (lo - o) * inv;
  const float t_hi = zero ? kFMax : (hi - o) * inv;
  near = nan_min(t_lo, t_hi);
  far = nan_max(t_lo, t_hi);
}

// Moeller-Trumbore with the reference's epsilon rules (intersect.py
// moller_trumbore); returns whether it accepts, t in t_out
__device__ __forceinline__ bool moller_trumbore(V3 ro, V3 rd, V3 v0, V3 v1, V3 v2, float& t_out) {
  const V3 e1 = sub(v1, v0);
  const V3 e2 = sub(v2, v0);
  const V3 pvec = cross3(rd, e2);
  const float det = dot3(e1, pvec);
  const float inv_det = 1.0f / det;
  const V3 tvec = sub(ro, v0);
  const float u = dot3(tvec, pvec) * inv_det;
  const V3 qvec = cross3(tvec, e1);
  const float v = dot3(rd, qvec) * inv_det;
  const float t = dot3(e2, qvec) * inv_det;
  t_out = t;
  return fabsf(det) >= kEps && !(u < -kEps) && !(u > 1.0f + kEps) && !(v < -kEps) &&
         !(u + v > 1.0f + kEps) && !(t < -kEps);
}

__device__ __forceinline__ int axis_of(const int (&a)[3], int k) { return k == 0 ? a[0] : k == 1 ? a[1] : a[2]; }

__global__ void __launch_bounds__(kThreads) grid_dda_kernel(
    const float* __restrict__ ro_w, const float* __restrict__ rd_w, int n, GridScene s,
    float* __restrict__ t_out, float* __restrict__ n_out, int* __restrict__ mt_out,
    float* __restrict__ col_out, float* __restrict__ ri_out, int* __restrict__ steps_out,
    int* __restrict__ tests_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const V3 row = ld3(ro_w + 3 * i);
  const V3 rdw = ld3(rd_w + 3 * i);
  const int dims[3] = {s.gx, s.gy, s.gz};

  float best_t = kFMax;
  V3 best_nrm = {0.0f, 0.0f, 0.0f};
  V3 best_col = {0.0f, 0.0f, 0.0f};
  int best_mt = 0;
  float best_ri = 1.5f;
  int total_steps = 0, total_tests = 0;

  for (int m = 0; m < s.n_models; ++m) {
    const float* w2m = s.w2m + 16 * m;
    const int mesh = s.model_mesh[m];
    const int grid = s.model_grid[m];
    const V3 bmin = ld3(s.bb_min + 3 * mesh);
    const V3 bmax = ld3(s.bb_max + 3 * mesh);
    const float vw[3] = {s.voxel_w[3 * grid], s.voxel_w[3 * grid + 1], s.voxel_w[3 * grid + 2]};
    const int vbase = s.voxel_start[grid];

    // world -> model: position with the translation, the direction
    // normalised; 1 / rd is taken as |v| / v (intersect.py)
    V3 ro = mat3(w2m, 4, row);
    ro = {ro.x + w2m[3], ro.y + w2m[7], ro.z + w2m[11]};
    const V3 v = mat3(w2m, 4, rdw);
    const float len = sqrtf(dot3(v, v));
    const V3 rd = {v.x / len, v.y / len, v.z / len};
    const float o[3] = {ro.x, ro.y, ro.z};
    const float d[3] = {rd.x, rd.y, rd.z};
    const float inv[3] = {len / v.x, len / v.y, len / v.z};
    const float lo[3] = {bmin.x, bmin.y, bmin.z};
    const float hi[3] = {bmax.x, bmax.y, bmax.z};

    float nr[3], fr[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) slab_axis(o[a], d[a], inv[a], lo[a], hi[a], nr[a], fr[a]);
    const float tmin = nan_max(nan_max(nr[0], nr[1]), nr[2]);
    const float tmax_box = nan_min(nan_min(fr[0], fr[1]), fr[2]);
    bool active = !((tmax_box < 0.0f) | (tmin > tmax_box));

    int ivox[3], step[3], out[3];
    float entry[3], tmax[3], delta[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      entry[a] = fmaf(d[a], tmin, o[a]);
      active = active && ((entry[a] - lo[a]) >= -kEps);
      int iv = (int)(fabsf((entry[a] - lo[a]) + kEps) / vw[a]);
      iv = iv < 0 ? 0 : iv;
      ivox[a] = iv < dims[a] - 1 ? iv : dims[a] - 1;
      const bool pos = d[a] > 0.0f;
      step[a] = pos ? 1 : -1;
      out[a] = pos ? dims[a] : -1;
      const float pos_next = fmaf((float)(pos ? ivox[a] + 1 : ivox[a]), vw[a], lo[a]);
      const bool nonzero = d[a] != 0.0f;
      delta[a] = nonzero ? fabsf(vw[a] * inv[a]) : kFMax;
      tmax[a] = nonzero ? (pos_next - entry[a]) * inv[a] : kFMax;
    }

    float mt = kFMax;  // the model's best t
    int mt_tri = -1;
    bool is_int = false;
    int cache[3] = {ivox[0], ivox[1], ivox[2]};
    while (active) {
      const int flat = vbase + ivox[0] + ivox[1] * s.gx + ivox[2] * (s.gx * s.gy);
      const int start = s.vt_start[flat];
      const int count = s.vt_count[flat];
      total_tests += count;
      // the voxel's first argmin over accepted t (rejected: +inf)
      float vt = INFINITY;
      int vtri = -1;
      bool any = false;
      for (int k = 0; k < count; ++k) {
        const int tri = s.vt_tris[start + k];
        const int* vi = s.tri_vidx + 3 * tri;
        float t;
        const bool acc = moller_trumbore(ro, rd, ld3(s.vpos + 3 * vi[0]), ld3(s.vpos + 3 * vi[1]),
                                         ld3(s.vpos + 3 * vi[2]), t);
        any |= acc;
        const float tm = acc ? t : INFINITY;
        if (k == 0 || (!isnan(vt) && (isnan(tm) || tm < vt))) {
          vt = tm;
          vtri = tri;
        }
      }
      if (vt < mt) {
        mt = vt;
        mt_tri = vtri;
      }
      if (any) {
        is_int = true;
        cache[0] = ivox[0];
        cache[1] = ivox[1];
        cache[2] = ivox[2];
      }
      const bool early = is_int && (abs(cache[0] - ivox[0]) > 2 || abs(cache[1] - ivox[1]) > 2 ||
                                    abs(cache[2] - ivox[2]) > 2);
      const bool take_x = (tmax[0] < tmax[1]) & (tmax[0] < tmax[2]);
      const bool take_y = !take_x & (tmax[1] < tmax[2]);
      const int a = take_x ? 0 : take_y ? 1 : 2;
      const int next = axis_of(ivox, a) + (a == 0 ? step[0] : a == 1 ? step[1] : step[2]);
      const bool stepped_out = next == (a == 0 ? out[0] : a == 1 ? out[1] : out[2]);
      const float t_axis = a == 0 ? tmax[0] : a == 1 ? tmax[1] : tmax[2];
      if (a == 0) {
        ivox[0] = next;
        tmax[0] = tmax[0] + delta[0];
      } else if (a == 1) {
        ivox[1] = next;
        tmax[1] = tmax[1] + delta[1];
      } else {
        ivox[2] = next;
        tmax[2] = tmax[2] + delta[2];
      }
      ++total_steps;
      active = !early && !stepped_out && !(t_axis >= kFMax);
    }

    // the averaged (not barycentric) vertex normal of the model's winner
    // (Renderer.cpp:203); zero where no voxel improved
    V3 n_model = {0.0f, 0.0f, 0.0f};
    if (mt_tri >= 0) {
      const int* vi = s.tri_vidx + 3 * mt_tri;
      const V3 a = ld3(s.vnrm + 3 * vi[0]), b = ld3(s.vnrm + 3 * vi[1]), c = ld3(s.vnrm + 3 * vi[2]);
      const float third = 1.0f / 3.0f;
      n_model = normalize({((a.x + b.x) + c.x) * third, ((a.y + b.y) + c.y) * third,
                           ((a.z + b.z) + c.z) * third});
    }

    // the world distance and merge (Renderer.cpp:384-399)
    const float* m2w = s.m2w + 16 * m;
    V3 wp = mat3(m2w, 4, {fmaf(rd.x, mt, ro.x), fmaf(rd.y, mt, ro.y), fmaf(rd.z, mt, ro.z)});
    wp = {wp.x + m2w[3], wp.y + m2w[7], wp.z + m2w[11]};
    const V3 dd = sub(wp, row);
    const float world_d = sqrtf(dot3(dd, dd));
    if (is_int && best_t > world_d) {
      best_t = world_d;
      best_nrm = normalize(mat3(s.nmat + 9 * m, 3, n_model));
      best_mt = s.mat_type[m];
      best_col = ld3(s.mat_color + 3 * m);
      best_ri = s.mat_ri[m];
    }
  }

  t_out[i] = best_t;
  n_out[3 * i] = best_nrm.x;
  n_out[3 * i + 1] = best_nrm.y;
  n_out[3 * i + 2] = best_nrm.z;
  mt_out[i] = best_mt;
  col_out[3 * i] = best_col.x;
  col_out[3 * i + 1] = best_col.y;
  col_out[3 * i + 2] = best_col.z;
  ri_out[i] = best_ri;
  if (steps_out != nullptr) {
    steps_out[i] = total_steps;
    tests_out[i] = total_tests;
  }
}

}  // namespace

extern "C" int ptt_grid_dda(const float* ro, const float* rd, int n, const float* w2m,
                            const float* m2w, const float* nmat, const int* model_mesh,
                            const int* model_grid, int n_models, const float* bb_min,
                            const float* bb_max, const float* voxel_w, const int* voxel_start,
                            const int* vt_start, const int* vt_count, const int* vt_tris,
                            const int* tri_vidx, const float* vpos, const float* vnrm,
                            const int* mat_type, const float* mat_color, const float* mat_ri,
                            int gx, int gy, int gz, float* t_out, float* n_out, int* mt_out,
                            float* col_out, float* ri_out, int* steps_out, int* tests_out,
                            void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const GridScene s{w2m,      m2w,     nmat,     model_mesh, model_grid, bb_min,   bb_max,
                    voxel_w,  voxel_start, vt_start, vt_count, vt_tris,  tri_vidx, vpos,
                    vnrm,     mat_type, mat_color, mat_ri,   n_models,   gx,       gy,
                    gz};
  const int blocks = (n + kThreads - 1) / kThreads;
  grid_dda_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      ro, rd, n, s, t_out, n_out, mt_out, col_out, ri_out, steps_out, tests_out);
  return (int)cudaGetLastError();
}
