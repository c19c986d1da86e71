// Kernel G1: the parity engine's uniform-grid trace, persistent warps that
// refill.
//
// Replaces pathtracerap_tpu/ops/intersect.py::trace_parity (its per-model
// march _dda_one_model, :131, and the merge over models, :276), which JAX
// runs as XLA, not Pallas: a lax.while_loop over voxel steps in which the
// whole wavefront gathers (N, K) triangle rows each step, inside a scan
// over models.  Here, as in the reference's
// computeRaySceneIntersectionKernel (Renderer.cpp:363-409), a lane walks
// one ray through the models in index order: the world -> model transform
// and normalisation, the slab test and entry voxel (Renderer.cpp:252-270),
// the DDA with the strict axis choice (Renderer.cpp:331-357), and in each
// voxel its CSR bucket (the ELL row's order) through Moeller-Trumbore
// (Renderer.cpp:174-215); then the early exit (Renderer.cpp:326-329) and
// the merge on a strictly smaller world distance.
//
// The plain version is ops/intersect.py::trace_parity; this kernel repeats
// its arithmetic operation by operation (fmaf where it calls addcmul or
// dot3/cross3's fused chains, IEEE division and sqrt, no fast math: the
// range tests rely on det == 0 giving inf or NaN), and its argmin rule in
// a voxel: the first strictly smaller t wins, a NaN t counting as the
// smallest, so an accepted NaN blocks that voxel's update.
//
// What bounds it on the H100: instruction issue under divergence, not
// bytes, nor the operations its bound counts.  A voxel step issues about
// 70 instructions (index, early exit, axis choice, step) where the bound
// counts 24 flops, a triangle test about 86 (its loads, the IEEE
// reciprocal, the NaN-aware argmin) where it counts 47, and the models'
// set-up (transform, slab test) is not counted at all.  A ray's work is
// data dependent (models entered, voxels stepped, triangles tested: the
// kernel's own counters), and a warp of one-ray-a-lane lanes runs each
// bucket loop as long as its longest bucket and each model's march as
// long as its longest march.  The design:
//  * live rays only: a ray outside the `alive` mask is not traced; it gets
//    the miss record, 0 steps and 0 tests.  Compaction costs no host sync:
//    a warp takes 32 candidate indices at a time from a per-launch counter
//    (zeroed on the stream), writes the dead ones' records at once and
//    queues the live ones in shared memory;
//  * persistent warps that refill (Aila and Laine's persistent threads
//    with dynamic fetch): one wave of blocks for the card.  A lane whose
//    model's march ends parks; once kPark lanes are parked (or none
//    marches) the warp merges their models, sets up their next models,
//    writes the records of the rays that are through every model and
//    refills those lanes with new live rays.  A lane's state (ray, model,
//    DDA, best so far) stays in registers.  Two forms, as measured on the
//    reference scene (PERF.md): a coherent one for a camera's primaries
//    (lanes in step: settle only once no lane marches, cross empty voxels
//    in a tight loop, each lane tests its own bucket) and a bounce one
//    (settle once half the lanes wait; where a round's largest bucket
//    holds more than kCoopMin triangles the warp tests all its lanes'
//    buckets together, one pair a lane);
//  * the scene close to the SM: the wrapper builds, once a scene, a row of
//    every model's transforms and material, a mesh-space triangle table of
//    (v0, e1, e2) (e1 = v1 - v0, the same IEEE subtraction the test makes,
//    so the bits do not move), the triangles' averaged vertex normals, the
//    voxels' (start, count), and for the shared form a bit a voxel for a
//    non-empty bucket, the set bits before each word, a 32-bit cell a set
//    bit (start | count << 16) and the buckets' entries as 16-bit
//    triangle indices.  Each block stages the model rows, the triangle
//    table and those four into shared memory once, with cp.async: a march
//    then reads no global memory until its model's merge.  A scene whose
//    tables exceed the budget (GRID_DDA_SMEM_MAX) or whose indices pass 16
//    bits takes the same kernel with its tables in global memory.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr float kFMax = 9999999.0f;
constexpr float kFMin = -9999990.0f;
constexpr float kEps = 0.005f;
constexpr int kThreads = 768;  // one block an SM: 24 warps at up to 85 registers
constexpr int kWarps = kThreads / 32;
constexpr int kQueue = 64;  // a warp's queue of live rays (at most 31 + 32 held)
constexpr unsigned kFull = 0xffffffffu;
// a warp tests its lanes' buckets together in a round whose largest bucket
// holds more triangles than this (measured on the reference scene's
// bounce-1 wavefront: 1, 2, 4 and never; PERF.md)
constexpr int kCoopMin = 2;

// a model's row of the wrapper's table (kernels/dda.py MODEL_WORDS): the
// first three rows of world_to_model and model_to_world (4 floats each),
// the normal matrix (3 x 3, row-major), its mesh's box, its grid's voxel
// width and first voxel (an int's bits), its material type (an int's
// bits), colour and index of refraction
constexpr int kModelWords = 48;
constexpr int kW2M = 0, kM2W = 12, kNMat = 24, kBMin = 33, kBMax = 36, kVW = 39, kVBase = 42,
              kMatType = 43, kColor = 44, kRI = 47;
constexpr int kTriWords = 9;  // v0, e1, e2

struct GridArgs {
  const float* ro;             // (N, 3) world
  const float* rd;             // (N, 3) world
  const unsigned char* alive;  // (N,) bool, or null: every ray
  int n;
  const float* models;  // (I, kModelWords)
  int n_models;
  const float* tris;     // (T, 9) mesh space
  const float* tri_nrm;  // (T, 3) averaged vertex normals
  const int2* voxel;     // (NV,) (start, count) into the buckets' entries
  const int* vt_tris;    // (P,) the buckets' entries, global triangle indices
  // the shared form's tables: a bit a voxel (its bucket is not empty), the
  // set bits before each word (16-bit, two a word), a cell a set bit
  // (start | count << 16) and the entries as 16-bit indices, two a word
  const unsigned* occupied;
  const unsigned* word_rank;
  const unsigned* cells;
  const unsigned* entries;
  // 32-bit words of each staged table, multiples of 4 (shared form)
  int model_words, tri_words, occupied_words, rank_words, cell_words, entry_words;
  int gx, gy, gz;
  int* counter;  // candidates handed out, zeroed before the launch
  float* t_out;
  float* n_out;
  int* mt_out;
  float* col_out;
  float* ri_out;
  int* model_out;
  int* tri_out;
  int* steps_out;  // or null
  int* tests_out;
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

// the slab's near and far t on one axis (Renderer.cpp:150-170); zero:
// the axis's direction component is 0
__device__ __forceinline__ void slab_axis(float o, bool zero, float inv, float lo, float hi,
                                          float& near, float& far) {
  const float t_lo = zero ? kFMin : (lo - o) * inv;
  const float t_hi = zero ? kFMax : (hi - o) * inv;
  near = nan_min(t_lo, t_hi);
  far = nan_max(t_lo, t_hi);
}

// Moeller-Trumbore with the reference's epsilon rules (intersect.py
// moller_trumbore) on a table row (v0, e1 = v1 - v0, e2 = v2 - v0);
// returns whether it accepts, t in t_out
__device__ __forceinline__ bool moller_trumbore(V3 ro, V3 rd, const float* tri, float& t_out) {
  const V3 v0 = ld3(tri), e1 = ld3(tri + 3), e2 = ld3(tri + 6);
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// one table of `words` (a multiple of 4) into shared memory, 16 bytes a copy
__device__ __forceinline__ void stage(float* dst, const void* src, int words) {
  const float4* s4 = static_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int j = threadIdx.x; j < words / 4; j += kThreads) cp_async16(d4 + j, s4 + j);
}

// the record of a ray: its best hit, or the miss record (best_m -1)
__device__ __forceinline__ void write_record(const GridArgs& a, int i, float t, V3 nrm, int best_m,
                                             int best_tri, const float* models, int steps,
                                             int tests) {
  a.t_out[i] = t;
  a.n_out[3 * i] = nrm.x;
  a.n_out[3 * i + 1] = nrm.y;
  a.n_out[3 * i + 2] = nrm.z;
  V3 col = {0.0f, 0.0f, 0.0f};
  int mt = 0;
  float ri = 1.5f;
  if (best_m >= 0) {
    const float* mrow = models + kModelWords * best_m;
    mt = __float_as_int(mrow[kMatType]);
    col = ld3(mrow + kColor);
    ri = mrow[kRI];
  }
  a.mt_out[i] = mt;
  a.col_out[3 * i] = col.x;
  a.col_out[3 * i + 1] = col.y;
  a.col_out[3 * i + 2] = col.z;
  a.ri_out[i] = ri;
  a.model_out[i] = best_m;
  a.tri_out[i] = best_tri;
  if (a.steps_out != nullptr) {
    a.steps_out[i] = steps;
    a.tests_out[i] = tests;
  }
}

// Warp-uniform: the queue of live rays and whether the launch's candidates
// are all handed out.
struct WarpQueue {
  int head = 0, count = 0;
  bool exhausted = false;
};

// Lanes in `need` (a ballot) take the next live rays from the warp's
// queue, which is topped up from the launch's candidates 32 at a time:
// the dead ones among them get their records here.  Returns the ray a
// lane takes, or -1.
__device__ __forceinline__ int take_rays(const GridArgs& a, const float* models, int* queue,
                                         WarpQueue& q, unsigned need, int lane) {
  const unsigned lanes_below = (1u << lane) - 1u;
  const int wanted = __popc(need);
  while (q.count < wanted && !q.exhausted) {
    int base = 0;
    if (lane == 0) base = atomicAdd(a.counter, 32);
    base = __shfl_sync(kFull, base, 0);
    if (base >= a.n) {
      q.exhausted = true;
      break;
    }
    const int c = base + lane;
    const bool in = c < a.n;
    const bool live = in && (a.alive == nullptr || a.alive[c] != 0);
    if (in && !live) write_record(a, c, kFMax, {0.f, 0.f, 0.f}, -1, -1, models, 0, 0);
    const unsigned got = __ballot_sync(kFull, live);
    if (live) queue[(q.head + q.count + __popc(got & lanes_below)) & (kQueue - 1)] = c;
    q.count += __popc(got);
  }
  __syncwarp();
  int ray = -1;
  if ((need >> lane) & 1u) {
    const int r = __popc(need & lanes_below);
    if (r < q.count) ray = queue[(q.head + r) & (kQueue - 1)];
  }
  const int taken = min(wanted, q.count);
  q.head = (q.head + taken) & (kQueue - 1);
  q.count -= taken;
  __syncwarp();
  return ray;
}

// The voxel's first argmin (argmin's order, a NaN t the smallest): a
// later candidate replaces the running one only if strictly before it.
__device__ __forceinline__ bool later_wins(float running, float later) {
  return !isnan(running) && (isnan(later) || later < running);
}

__device__ __forceinline__ int flat_voxel(const GridArgs& a, int vbase, const int (&ivox)[3]) {
  return vbase + ivox[0] + ivox[1] * a.gx + ivox[2] * (a.gx * a.gy);
}

// After a voxel: the early exit once the march is more than 2 voxels past
// the last voxel with a hit, then one DDA step on the strictly smallest
// tmax (x if tx < ty and tx < tz, else y if ty < tz, else z).  Returns
// whether the model's march ends.
__device__ __forceinline__ bool dda_step(bool is_int, const int (&cache)[3], int (&ivox)[3],
                                         float (&tmax)[3], const float (&delta)[3],
                                         const int (&step)[3], const int (&dims)[3]) {
  const bool early = is_int && (abs(cache[0] - ivox[0]) > 2 || abs(cache[1] - ivox[1]) > 2 ||
                                abs(cache[2] - ivox[2]) > 2);
  const bool take_x = (tmax[0] < tmax[1]) & (tmax[0] < tmax[2]);
  const bool take_y = !take_x & (tmax[1] < tmax[2]);
  float t_axis;
  bool stepped_out;
  if (take_x) {
    t_axis = tmax[0];
    ivox[0] += step[0];
    stepped_out = ivox[0] == (step[0] > 0 ? dims[0] : -1);
    tmax[0] = tmax[0] + delta[0];
  } else if (take_y) {
    t_axis = tmax[1];
    ivox[1] += step[1];
    stepped_out = ivox[1] == (step[1] > 0 ? dims[1] : -1);
    tmax[1] = tmax[1] + delta[1];
  } else {
    t_axis = tmax[2];
    ivox[2] += step[2];
    stepped_out = ivox[2] == (step[2] > 0 ? dims[2] : -1);
    tmax[2] = tmax[2] + delta[2];
  }
  return early || stepped_out || t_axis >= kFMax;
}

template <bool kShared>
__device__ __forceinline__ int bucket_entry(const GridArgs& a, const unsigned short* entries,
                                           int i) {
  return kShared ? (int)entries[i] : __ldg(a.vt_tris + i);
}

// A warp's scratch: its lanes' model-space rays, and for testing their
// buckets together, the buckets and one round's results.
struct WarpScratch {
  float ray[6][32];  // ro, rd of each lane's model
  int incl[32];      // inclusive prefix of the lanes' bucket sizes
  int start[32];     // each lane's bucket start
  float res_t[32];   // a round's pairs: t (rejected: +inf), triangle, accepted
  int res_tri[32];
  int res_acc[32];
};

// The warp tests the (lane, triangle) pairs of all its lanes' buckets 32
// at a time, one pair a lane (the pair's lane found by a binary search on
// the prefix of the bucket sizes), then each lane folds its own pairs of
// the round in bucket order, as the sequential loop does.  sc: the lane's
// bucket (start, count), count 0 for a lane that does not march.
template <bool kShared>
__device__ __forceinline__ void bucket_coop(const GridArgs& a, const float* tris,
                                            const unsigned short* entries, WarpScratch& w,
                                            int lane, int2 sc, float& vt, int& vtri, bool& any) {
  int incl = sc.y;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  const int excl = incl - sc.y;
  w.incl[lane] = incl;
  w.start[lane] = sc.x;
  __syncwarp();
  bool first = true;
  for (int base = 0; base < total; base += 32) {
    const int p = base + lane;
    if (p < total) {
      int owner = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (w.incl[owner + step - 1] <= p) owner += step;
      const int k = p - (owner > 0 ? w.incl[owner - 1] : 0);
      const int tri = bucket_entry<kShared>(a, entries, w.start[owner] + k);
      const V3 ro = {w.ray[0][owner], w.ray[1][owner], w.ray[2][owner]};
      const V3 rd = {w.ray[3][owner], w.ray[4][owner], w.ray[5][owner]};
      float t;
      const bool acc = moller_trumbore(ro, rd, tris + kTriWords * tri, t);
      w.res_t[lane] = acc ? t : INFINITY;
      w.res_tri[lane] = tri;
      w.res_acc[lane] = acc;
    }
    __syncwarp();
    const int hi = incl < base + 32 ? incl : base + 32;
    for (int j = excl > base ? excl : base; j < hi; ++j) {
      const float tm = w.res_t[j - base];
      if (first || later_wins(vt, tm)) {
        vt = tm;
        vtri = w.res_tri[j - base];
      }
      first = false;
      any |= w.res_acc[j - base] != 0;
    }
    __syncwarp();
  }
}

// kShared: the tables staged into shared memory (else read from global
// memory).  kCoherent: the form for a wavefront whose rays all live and
// start together (a camera's primaries), which keeps its lanes in step:
// a warp settles only once none of its lanes marches (kPark 32), crosses
// empty voxels in a tight loop and tests each lane's bucket on its own
// lane.  The other form (bounces: rays from everywhere, in every
// direction) settles once half its lanes wait and tests the buckets of a
// round together when one holds more than kCoopMin triangles.  The
// wrapper picks the form: coherent where no liveness mask is given.
template <bool kShared, bool kCoherent>
__global__ void __launch_bounds__(kThreads, 1) grid_dda_kernel(const GridArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int queues[kWarps][kQueue];
  __shared__ WarpScratch scratch[kCoherent ? 1 : kWarps];
  constexpr int kPark = kCoherent ? 32 : 16;
  const float* models = a.models;
  const float* tris = a.tris;
  const unsigned* occupied = nullptr;
  const unsigned short* word_rank = nullptr;
  const unsigned* cells = nullptr;
  const unsigned short* entries = nullptr;
  if (kShared) {
    float* p = smem;
    stage(p, a.models, a.model_words);
    models = p;
    p += a.model_words;
    stage(p, a.tris, a.tri_words);
    tris = p;
    p += a.tri_words;
    stage(p, a.occupied, a.occupied_words);
    occupied = reinterpret_cast<const unsigned*>(p);
    p += a.occupied_words;
    stage(p, a.word_rank, a.rank_words);
    word_rank = reinterpret_cast<const unsigned short*>(p);
    p += a.rank_words;
    stage(p, a.cells, a.cell_words);
    cells = reinterpret_cast<const unsigned*>(p);
    p += a.cell_words;
    stage(p, a.entries, a.entry_words);
    entries = reinterpret_cast<const unsigned short*>(p);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  int* queue = queues[threadIdx.x >> 5];
  WarpScratch& wsm = scratch[kCoherent ? 0 : threadIdx.x >> 5];
  const int dims[3] = {a.gx, a.gy, a.gz};
  WarpQueue q;

  // the lane's ray and its state
  int ray = -1;
  int m = 0;              // the model being traced
  bool marching = false;  // inside model m's grid
  bool ended = false;     // model m's march ended: merge it
  V3 row = {0.f, 0.f, 0.f}, rdw = {0.f, 0.f, 0.f};
  float best_t = kFMax;
  V3 best_nrm = {0.f, 0.f, 0.f};
  int best_m = -1, best_tri = -1, total_steps = 0, total_tests = 0;
  // model m's march
  V3 ro = {0.f, 0.f, 0.f}, rd = {0.f, 0.f, 0.f};
  int ivox[3] = {0, 0, 0}, step[3] = {0, 0, 0}, cache[3] = {0, 0, 0};
  float tmax[3] = {0.f, 0.f, 0.f}, delta[3] = {0.f, 0.f, 0.f};
  int vbase = 0, mt_tri = -1;
  float mt = kFMax;
  bool is_int = false;

  while (true) {
    // settle the lanes that do not march: merge the model whose march
    // ended, find the next model the ray enters, write a finished ray's
    // record and take a new ray, until every lane marches or has no ray
    // left to take
    bool settle = !marching;
    while (__any_sync(kFull, settle)) {
      if (settle && ray >= 0) {
        if (ended) {
          // the model's world distance and the merge (Renderer.cpp:384-399)
          const float* mrow = models + kModelWords * m;
          const float* m2w = mrow + kM2W;
          V3 wp = mat3(m2w, 4, {fmaf(rd.x, mt, ro.x), fmaf(rd.y, mt, ro.y), fmaf(rd.z, mt, ro.z)});
          wp = {wp.x + m2w[3], wp.y + m2w[7], wp.z + m2w[11]};
          const V3 dd = sub(wp, row);
          const float world_d = sqrtf(dot3(dd, dd));
          if (is_int && best_t > world_d) {
            // the averaged (not barycentric) vertex normal of the model's
            // winner (Renderer.cpp:203); zero where no voxel improved
            const V3 n_model = mt_tri >= 0 ? ld3(a.tri_nrm + 3 * mt_tri) : V3{0.f, 0.f, 0.f};
            best_t = world_d;
            best_nrm = normalize(mat3(mrow + kNMat, 3, n_model));
            best_m = m;
            best_tri = mt_tri;
          }
          ended = false;
          ++m;
        }
        // the next model the ray enters: transform, slab test, entry voxel
        // (a model it does not march in has no hit: nothing to merge)
        for (; m < a.n_models; ++m) {
          const float* mrow = models + kModelWords * m;
          const float* w2m = mrow + kW2M;
          // world -> model: position with the translation, the direction
          // normalised; 1 / rd is taken as |v| / v (intersect.py)
          ro = mat3(w2m, 4, row);
          ro = {ro.x + w2m[3], ro.y + w2m[7], ro.z + w2m[11]};
          const V3 v = mat3(w2m, 4, rdw);
          const float len = sqrtf(dot3(v, v));
          const float o[3] = {ro.x, ro.y, ro.z};
          const float vc[3] = {v.x, v.y, v.z};
          const float inv[3] = {len / v.x, len / v.y, len / v.z};
          const float lo[3] = {mrow[kBMin], mrow[kBMin + 1], mrow[kBMin + 2]};
          const float hi[3] = {mrow[kBMax], mrow[kBMax + 1], mrow[kBMax + 2]};
          float nr[3], fr[3];
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            // rd = v / len is 0 on an axis exactly where v is, or where the
            // quotient underflows (|v| far below len): divide only then
            const bool zero = (vc[ax] == 0.0f || fabsf(vc[ax]) < len * 0x1p-100f) &&
                              vc[ax] / len == 0.0f;
            slab_axis(o[ax], zero, inv[ax], lo[ax], hi[ax], nr[ax], fr[ax]);
          }
          const float tmin = nan_max(nan_max(nr[0], nr[1]), nr[2]);
          const float tmax_box = nan_min(nan_min(fr[0], fr[1]), fr[2]);
          if ((tmax_box < 0.0f) | (tmin > tmax_box)) continue;
          rd = {v.x / len, v.y / len, v.z / len};
          const float d[3] = {rd.x, rd.y, rd.z};
          const float vw[3] = {mrow[kVW], mrow[kVW + 1], mrow[kVW + 2]};
          bool entered = true;
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            const float entry = fmaf(d[ax], tmin, o[ax]);
            entered = entered && ((entry - lo[ax]) >= -kEps);
            int iv = (int)(fabsf((entry - lo[ax]) + kEps) / vw[ax]);
            iv = iv < 0 ? 0 : iv;
            ivox[ax] = iv < dims[ax] - 1 ? iv : dims[ax] - 1;
            const bool pos = d[ax] > 0.0f;
            step[ax] = pos ? 1 : -1;
            const float pos_next = fmaf((float)(pos ? ivox[ax] + 1 : ivox[ax]), vw[ax], lo[ax]);
            const bool nonzero = d[ax] != 0.0f;
            delta[ax] = nonzero ? fabsf(vw[ax] * inv[ax]) : kFMax;
            tmax[ax] = nonzero ? (pos_next - entry) * inv[ax] : kFMax;
          }
          if (entered) {
            if (!kCoherent) {
              wsm.ray[0][lane] = ro.x;
              wsm.ray[1][lane] = ro.y;
              wsm.ray[2][lane] = ro.z;
              wsm.ray[3][lane] = rd.x;
              wsm.ray[4][lane] = rd.y;
              wsm.ray[5][lane] = rd.z;
            }
            marching = true;
            vbase = __float_as_int(mrow[kVBase]);
            mt = kFMax;
            mt_tri = -1;
            is_int = false;
            cache[0] = ivox[0];
            cache[1] = ivox[1];
            cache[2] = ivox[2];
            break;
          }
        }
        if (marching) {
          settle = false;
        } else {
          write_record(a, ray, best_t, best_nrm, best_m, best_tri, models, total_steps,
                       total_tests);
          ray = -1;
        }
      }
      const unsigned need = __ballot_sync(kFull, settle && ray < 0);
      if (need) {
        const int got = take_rays(a, models, queue, q, need, lane);
        if (settle && ray < 0) {
          if (got >= 0) {
            ray = got;
            row = ld3(a.ro + 3 * ray);
            rdw = ld3(a.rd + 3 * ray);
            m = 0;
            best_t = kFMax;
            best_nrm = {0.f, 0.f, 0.f};
            best_m = -1;
            best_tri = -1;
            total_steps = 0;
            total_tests = 0;
          } else {
            settle = false;  // nothing left to take: the lane idles
          }
        }
      }
    }
    if (__ballot_sync(kFull, marching) == 0) break;

    // march: one voxel a round for every marching lane (its bucket's first
    // argmin over accepted t, rejected: +inf; then the early exit and one
    // DDA step), until kPark lanes wait for the settling above
    while (true) {
      if (kShared && kCoherent) {
        // cross the empty voxels in a tight loop first: an empty bucket
        // leaves the model's best and its hit flag as they are, so only the
        // early exit and the step remain
        while (marching) {
          const int flat = flat_voxel(a, vbase, ivox);
          if ((occupied[flat >> 5] >> (flat & 31)) & 1u) break;
          if (dda_step(is_int, cache, ivox, tmax, delta, step, dims)) {
            marching = false;
            ended = true;
          }
          ++total_steps;
        }
      }
      int2 sc = make_int2(0, 0);  // the voxel's bucket (start, count)
      if (marching) {
        const int flat = flat_voxel(a, vbase, ivox);
        if (kShared) {
          // a set bit: the voxel's cell is its rank among the set bits
          const unsigned bits = occupied[flat >> 5], bit = 1u << (flat & 31);
          if (bits & bit) {
            const unsigned cell = cells[word_rank[flat >> 5] + __popc(bits & (bit - 1u))];
            sc = make_int2((int)(cell & 0xFFFFu), (int)(cell >> 16));
          }
        } else {
          sc = __ldg(a.voxel + flat);
        }
        total_tests += sc.y;
      }
      float vt = INFINITY;
      int vtri = -1;
      bool any = false;
      if (!kCoherent && (int)__reduce_max_sync(kFull, (unsigned)sc.y) > kCoopMin) {
        bucket_coop<kShared>(a, tris, entries, wsm, lane, sc, vt, vtri, any);
      } else if (marching) {
        for (int k = 0; k < sc.y; ++k) {
          const int tri = bucket_entry<kShared>(a, entries, sc.x + k);
          float t;
          const bool acc = moller_trumbore(ro, rd, tris + kTriWords * tri, t);
          any |= acc;
          const float tm = acc ? t : INFINITY;
          if (k == 0 || later_wins(vt, tm)) {
            vt = tm;
            vtri = tri;
          }
        }
      }
      if (marching) {
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
        if (dda_step(is_int, cache, ivox, tmax, delta, step, dims)) {
          marching = false;
          ended = true;
        }
        ++total_steps;
      }
      if (kCoherent) {
        // each lane marches on by itself: the warp settles once none does
        if (!marching) break;
        continue;
      }
      const unsigned on = __ballot_sync(kFull, marching);
      const unsigned waiting = __ballot_sync(kFull, !marching && (ray >= 0 || !q.exhausted));
      if (on == 0 || __popc(waiting) >= kPark) break;
    }
  }
}

template <bool kShared, bool kCoherent>
int launch(const GridArgs& a, int smem, cudaStream_t stream) {
  cudaError_t err;
  // the dynamic shared memory beside the static (the queues) may pass the
  // default 48 KB a block; the attribute is raised once to the largest
  // table asked for (at most 227 KB a block on the H100)
  static int smem_allowed = 0;
  if (kShared && smem > smem_allowed) {
    err = cudaFuncSetAttribute(grid_dda_kernel<kShared, kCoherent>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_dda_kernel<kShared, kCoherent>,
                                                      kThreads, kShared ? smem : 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // one wave of persistent blocks, no more than the rays could keep busy
  const int wave = sms * per_sm;
  const int needed = (a.n + kThreads - 1) / kThreads;
  const int blocks = needed < wave ? needed : wave;
  grid_dda_kernel<kShared, kCoherent><<<blocks, kThreads, kShared ? smem : 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kCoherent>
int launch_form(const GridArgs& a, int shared, cudaStream_t stream) {
  const int smem = 4 * (a.model_words + a.tri_words + a.occupied_words + a.rank_words +
                        a.cell_words + a.entry_words);
  return shared ? launch<true, kCoherent>(a, smem, stream)
                : launch<false, kCoherent>(a, 0, stream);
}

}  // namespace

// Launch G1 for n rays.  shared != 0: stage the model rows, the triangle
// table, the voxels' bits, their ranks, the cells and the 16-bit entries
// (`*_words` 32-bit words each, multiples of 4) into dynamic shared memory;
// else read the models, triangles, voxels (start, count) and 32-bit
// entries (vt_tris) from global memory.  coherent != 0: the form for a
// wavefront whose rays all live and start together.  counter: one int of
// scratch, zeroed here on the stream.
extern "C" int ptt_grid_dda(const float* ro, const float* rd, const unsigned char* alive, int n,
                            const float* models, int n_models, const float* tris,
                            const float* tri_nrm, const int* voxel, const int* vt_tris,
                            const unsigned* occupied, const unsigned* word_rank,
                            const unsigned* cells, const unsigned* entries, int model_words,
                            int tri_words, int occupied_words, int rank_words, int cell_words,
                            int entry_words, int gx, int gy, int gz, int shared,
                            int coherent, int* counter, float* t_out,
                            float* n_out, int* mt_out, float* col_out, float* ri_out,
                            int* model_out, int* tri_out, int* steps_out, int* tests_out,
                            void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const GridArgs a{ro,          rd,          alive,      n,         models,
                   n_models,    tris,        tri_nrm,    reinterpret_cast<const int2*>(voxel),
                   vt_tris,     occupied,    word_rank,  cells,     entries,
                   model_words, tri_words,   occupied_words, rank_words, cell_words,
                   entry_words, gx,          gy,         gz,        counter,
                   t_out,       n_out,       mt_out,     col_out,   ri_out,
                   model_out,   tri_out,     steps_out,  tests_out};
  return coherent ? launch_form<true>(a, shared, s) : launch_form<false>(a, shared, s);
}

// The occupancy of either form, for the wrapper's report: blocks a
// multiprocessor holds at `smem_bytes` of dynamic shared memory.
extern "C" int ptt_grid_dda_blocks_per_sm(int shared, int smem_bytes, int* out) {
  if (shared) {
    const cudaError_t err = cudaFuncSetAttribute(
        grid_dda_kernel<true, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  return shared ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      out, grid_dda_kernel<true, false>, kThreads, smem_bytes)
                : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      out, grid_dda_kernel<false, false>, kThreads, 0);
}
