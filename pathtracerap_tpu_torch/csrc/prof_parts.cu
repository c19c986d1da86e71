// Profiling kernels P1, P2 and P4: one block visit of the traversal kernels,
// taken apart so that each part can be timed alone.
//
// Replaces the TPU kernels
//   scripts/prof_kernel_parts.py::make_kernel   (P1: the product in bf16,
//       bf16x3 or f32, then the accept chain, the argmin, the attribute
//       select),
//   scripts/prof_kernel_parts2.py::make_kernel  (P2: the single-pass bf16
//       product at K = 16, 32 and 128, looped or unrolled, and `empty`),
//   scripts/prof_mega_sweep.py::empty_variant   (P4: out = w[:, 0], with or
//       without an operand the kernel never reads).
// Same contract, quirks included.  Per ray (one row of w, K values) and per
// visit blk of nb, the 4 * tb columns [blk * 4 * tb, (blk + 1) * 4 * tb) of
// ops (K, 4 * tb * nb) give s = w . ops[:, col]:
//   mm_*    best = min(best, min_col s);
//   accept  s's quadrants [s_ab | s_bc | s_ca | t * det] through the
//           explicit-mask accept chain (common.cuh's accept_t<true>), then
//           best = min(best, min over the visit's tb triangles);
//   argmin  + the first index `arg` of that minimum; on a strictly smaller
//           minimum best takes it and attrs += float(arg);
//   select  + on a strictly smaller minimum attrs = the sum of the 7
//           attribute rows of column blk * tb + arg, otherwise attrs = the
//           sum of 7 copies of attrs (the TPU kernel's where broadcasts its
//           (R, 1) carry over 7 columns); then attrs += attrs * 0.
// The output is best + attrs.  Every variant but mm_bf16 and mm_f32 takes
// the bf16x3 product: a_hi = bf16(a), a_lo = bf16(a - a_hi), the same for
// b, s = dot(a_lo, b_hi) + dot(a_hi, b_lo) + dot(a_hi, b_hi) (bf16
// rounding to nearest even).
//
// What bounds it on the H100.  The bf16 products (4.2e11 flops a pass at
// K = 16 over 800,256 rays x 16,384 columns) belong on the tensor cores;
// behind them every product takes a min (mm_*: 1.3e10 of them) or every
// (ray, triangle) pair the accept chain (3.3e9 pairs) on the CUDA cores.  At K = 16 those, not the
// products, set the pace: an f32 min (FMNMX) issues at half the FFMA rate,
// 64 a clock an SM, so the mins alone take 0.77 ms at 1.98 GHz.  The
// tensor cores' work must run beside them: with mma.sync (this kernel's
// first form) the products' time added to the mins' and the chain's;
// wgmma runs them asynchronously.  The design:
//  * every bf16 product on wgmma m64n32k16 (f32 accumulation), A from
//    registers: each warpgroup holds two 64-ray m-tiles, their rows
//    converted (and split) once into mma-style A fragments; B, 32 staged
//    positions, from shared memory.  bf16x3 chains its three passes
//    through the accumulator, lo.hi, then hi.lo, then hi.hi (the TPU
//    kernel's order).  Two accumulators for the mm_* products at K = 16
//    and 32: a step's wgmmas run while the step before is consumed (one at
//    K = 128, where A's registers leave no room, and for the chain);
//  * the operand is split once, by the wrapper (kernels/prof.py::
//    parts_operand), into bf16 in wgmma's core-matrix order (8 positions
//    x 8 rows of a 16-row step, the hi then the lo pair of each group of
//    8), a visit's triangles in groups of 8 with their four quadrants side
//    by side.  Staging is then a plain copy: 32 KB runs of a visit's
//    triangles by 16-byte cp.async into a ring of three buffers (dynamic
//    shared memory), one barrier a run, the next runs landing while this
//    one is multiplied;
//  * the accumulator layout (row lane / 4 and + 8; positions 8 c + 2
//    (lane % 4) and + 1 in registers 4 c ..) puts a triangle's four
//    quadrant sums in registers e, 4 + e, 8 + e, 12 + e of one
//    accumulator, so each thread tests its own pairs in registers.  The
//    tensor cores' sums round otherwise than the plain version's f32
//    chains, and a pair at a u, v or t bound, or near-equal t, would change
//    the answer, so they only choose candidates: chain_t_lo, a
//    conservative test whose margin covers the two sums' difference
//    (kSumErr), gives each pair a lower bound of its plain t, without a
//    branch; a lane keeps its two least bounds a row and the least one
//    left out.  At the end of a visit the quad recomputes candidates in
//    increasing bound with the plain version's rounding (pair_t: fmaf
//    chains, accept_t<true>) while a bound is not above the least t found,
//    and the warp recomputes all of a lane's pairs where one left out
//    could still win: the winner and its first index are those of the
//    chain on the plain sums.  The test and the lists cost the chain
//    variants about 8 FMNMX a pair, at half the FFMA rate;
//  * 512-ray thread blocks (the TPU's R), so that each block's re-read of
//    the operand from L2 serves 512 rays;
//  * mm_f32 stays on the CUDA cores in f32 (the TPU kernel's HIGHEST
//    precision): each thread holds four rays' rows in registers and reads
//    a column as four 16-byte broadcasts, 64 fmaf in k order for four
//    loads, so the FMAs and not the shared loads set its pace (16 KB runs:
//    its 128-thread blocks share an SM four at a time).
// The TPU grid of 512-ray tiles (P4 measures a grid step there) sets the
// copy kernel's block width.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

enum Variant : int {
  kMmBf16 = 0, kMmBf16x3 = 1, kMmF32 = 2, kAccept = 3, kArgmin = 4, kSelect = 5, kEmpty = 6
};

constexpr int kTile = 512;          // rays per thread block of the parts kernels
constexpr int kStageBytes = 32768;  // operand bytes of one staged run (the f32 kernel: half)
constexpr int kStages = 3;          // staged runs in flight (a ring in shared memory)
constexpr int kF32Rays = 4;         // rays a thread of the f32 kernel holds
constexpr int kMTiles = 2;          // 64-ray m-tiles a warpgroup of the wgmma kernel holds
constexpr int kN = 32;              // columns a wgmma: 8 triangles x 4 quadrants
constexpr int kSelectRows = 7;      // attribute rows the select variant sums

template <int K, int V>
struct Cfg {
  static constexpr bool kF32 = V == kMmF32;
  static constexpr bool kSplit = V != kMmF32 && V != kMmBf16;  // bf16x3: hi and lo
  static constexpr bool kChain = V >= kAccept;
  static constexpr int kCopies = kSplit ? 2 : 1;
  static constexpr int kSteps = kF32 ? 1 : K / 16;               // 16-row steps of a column
  static constexpr int kRecord = kF32 ? 4 * K : 32 * kCopies;    // bytes of a column's step
  static constexpr int kStage = kF32 ? kStageBytes / 2 : kStageBytes;  // bytes of a run
  static constexpr int kSmem = kStages * kStage;                       // dynamic shared memory
  static constexpr int kRun = kStage / (4 * kSteps * kRecord);         // triangles a run
  static constexpr int kWgSteps = 4 * kRun / kN;  // wgmma steps a run
  // accumulators in flight: two (the next step's products run beside this
  // step's mins) where the registers allow; one at K = 128, and for the
  // chain, whose lists and visit ends take the registers (and which is no
  // faster with two)
  static constexpr int kBufs = K >= 128 || kChain ? 1 : 2;
  static constexpr int kThreads = kF32 ? kTile / kF32Rays : 128 * kTile / (64 * kMTiles);
  static_assert(kRun % 8 == 0 && kWgSteps % kBufs == 0, "whole wgmma steps a run");
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Copy visit blk's triangles [r0, r0 + Run) into sm: for each 16-row step s
// the span of the 4 Run operand columns from position blk * 4 tb + 4 r0
// (the pre-split operand holds step s of position p at ((s * cols + p) *
// Record) bytes; a visit's triangles in order, their four quadrants side
// by side in groups of 8 triangles), laid out [s][position].
template <class C>
__device__ __forceinline__ void stage_run(char* sm, const char* __restrict__ ops, int cols, int tb,
                                          int blk, int r0) {
  constexpr int kSpan = 4 * C::kRun * C::kRecord / 16;  // 16-byte copies of one step's span
  constexpr int kCopyCount = C::kStage / 16;
  static_assert(kCopyCount % C::kThreads == 0, "every thread issues the same copies");
#pragma unroll
  for (int i0 = 0; i0 < kCopyCount; i0 += C::kThreads) {
    const int i = i0 + threadIdx.x;
    const int s = i / kSpan;
    const int off = i - s * kSpan;
    const size_t p = (size_t)blk * 4 * tb + 4 * (size_t)r0;
    cp_async16(sm + (size_t)i * 16, ops + ((size_t)s * cols + p) * C::kRecord + (size_t)off * 16);
  }
}

// The visit loop: runs of C::kRun triangles staged kStages - 1 ahead, one
// barrier a run; run(buffer, r0) consumes a run, end_visit(blk) closes a
// visit.  Unroll: P2's unrolled visit loop.
template <class C, bool Unroll, class Run, class EndVisit>
__device__ __forceinline__ void sweep_visits(char* sm, const char* __restrict__ ops, int cols, int tb,
                                             int nb, Run run, EndVisit end_visit) {
  const int per_visit = tb / C::kRun;
  const int total = nb * per_visit;
  auto issue = [&](int i) {
    if (i < total) {
      const int blk = i / per_visit;
      stage_run<C>(sm + (i % kStages) * C::kStage, ops, cols, tb, blk, (i - blk * per_visit) * C::kRun);
    }
    cp_async_commit();  // an empty group past the end keeps the counts
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  int i = 0;
  auto visit = [&](int blk) {
    for (int r = 0; r < per_visit; ++r, ++i) {
      cp_async_wait<kStages - 2>();  // run i has landed (this thread's copies)
      // wgmma reads shared memory through the async proxy
      if constexpr (!C::kF32) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // everyone's, and run i - 1's buffer is free
      issue(i + kStages - 1);
      run(sm + (i % kStages) * C::kStage, r * C::kRun);
    }
    end_visit(blk);
  };
  if (Unroll) {
#pragma unroll 8
    for (int blk = 0; blk < nb; ++blk) visit(blk);
  } else {
#pragma unroll 1
    for (int blk = 0; blk < nb; ++blk) visit(blk);
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// bf16 element kk (0-7) of a 16-byte row of a core matrix, as f32
__device__ __forceinline__ float bf16_at(const uint4& u, int kk) {
  const uint32_t word = kk < 2 ? u.x : kk < 4 ? u.y : kk < 6 ? u.z : u.w;
  return __uint_as_float(kk & 1 ? word & 0xffff0000u : word << 16);
}

// Quadrant q's sum for ray `row` and triangle j of visit blk with the plain
// version's rounding: the bf16x3 sum (dot(a_lo, b_hi) + dot(a_hi, b_lo)) +
// dot(a_hi, b_hi), each dot an fmaf chain in k order, b read back from the
// pre-split operand (K = 16: 512 bytes a group of 8 positions, hi then lo,
// each two 16-byte rows of core matrices 128 bytes apart; quadrant q of
// triangle j at position blk * 4 tb + 32 (j / 8) + 8 q + j % 8, row j % 8
// of its core matrices).
__device__ __forceinline__ float quadrant_sum(const float* __restrict__ w, const char* __restrict__ ops,
                                              size_t row, int blk, int j, int tb, int q) {
  const size_t pos = (size_t)blk * 4 * tb + 32 * (j >> 3) + 8 * q + (j & 7);
  const char* rec = ops + (pos >> 3) * 512 + (pos & 7) * 16;
  const float4* p = reinterpret_cast<const float4*>(w + row * 16);
  float m0 = 0.0f, m1 = 0.0f, m2 = 0.0f;
#pragma unroll
  for (int kb = 0; kb < 2; ++kb) {  // k 0-7, then 8-15: the hi and the lo row
    const uint4 b_hi8 = *reinterpret_cast<const uint4*>(rec + 128 * kb);
    const uint4 b_lo8 = *reinterpret_cast<const uint4*>(rec + 256 + 128 * kb);
#pragma unroll
    for (int k4 = 0; k4 < 2; ++k4) {
      const float4 x = p[2 * kb + k4];
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = 4 * k4 + i;
        const float hi = bf16_round(xs[i]), lo = bf16_round(xs[i] - hi);
        const float b_hi = bf16_at(b_hi8, kk), b_lo = bf16_at(b_lo8, kk);
        if (kb == 0 && kk == 0) {
          m0 = lo * b_hi;
          m1 = hi * b_lo;
          m2 = hi * b_hi;
        } else {
          m0 = fmaf(lo, b_hi, m0);
          m1 = fmaf(hi, b_lo, m1);
          m2 = fmaf(hi, b_hi, m2);
        }
      }
    }
  }
  return (m0 + m1) + m2;
}

// The plain version's t of a pair: accept_t<true> on its four sums, taken
// one after another (few registers: it runs where the visit's state is
// live).
__device__ __forceinline__ float pair_t(const float* __restrict__ w, const char* __restrict__ ops,
                                        size_t row, int blk, int j, int tb) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll 1
  for (int q = 0; q < 4; ++q) {
    const float x = quadrant_sum(w, ops, row, blk, j, tb, q);
    s0 = q == 0 ? x : s0;
    s1 = q == 1 ? x : s1;
    s2 = q == 2 ? x : s2;
    s3 = q == 3 ? x : s3;
  }
  return accept_t<true>(s0, s1, s2, s3);
}

// How far the tensor cores' bf16x3 sums may lie from the plain version's,
// per unit of ||a|| max||b||.  Both add the same 48 products, each exact in
// f32 (bf16 x bf16), whose magnitudes sum to at most ||a~|| ||b~|| (a~ =
// |a_hi| + |a_lo| <= 1.008 |a|, the same for b; Cauchy-Schwarz).  The
// plain version's fmaf chains lie within 18 2^-24 of that sum of
// magnitudes from the exact sum; tensor cores that align each k16 step's
// products to the largest and truncate, three steps chained, within about
// 51 2^-22 = 2^-16.3.  2^-14 keeps a factor of 4 over both, and 5 % covers
// the norms' rounding and the 1.008.
constexpr float kSumErr = 1.05f / 16384.0f;
// chain_t_lo's margins, in units of e (see there)
constexpr float kE2 = 1.1f;
constexpr float kE6 = 3.1f;
constexpr float kSideBound = -0.00501f;  // an accepted pair's -0.0050006, rounded down

// A lower bound of the t that the plain version's chain (accept_t<true> on
// its own sums) can give a pair, from the tensor cores' sums s~, each
// within e of the plain version's s (e2 = kE2 e, e6 = kE6 e, k_deg = (1 -
// 2^-20) / (2 e6), k_off below); +inf where that chain surely rejects it.  The
// two dets differ by at most D = 3.02 e (their own rounding included).
// For x = s_x / det (u, v, w = s_bc / det, t) and x~ = s~_x / det~, x~ - x =
// ((s~_x - s_x) - x (det~ - det)) / det~, so |x~ - x| <= (e + |x| D) /
// |det~|.  Where |det~| >= e6 (> D):
//  * an accepted pair has u, v, w, t >= -0.0050006 (w = 1 - u - v; the
//    chain's roundings move them by under 6e-7); then each x~ >= -0.0050006
//    - 1.0151 e / |det~| (for x >= 0, x~ < -0.005 would need |det~| < D),
//    tested as min(x~) + e2 |1 / det~| >= kSideBound;
//  * where t~ > t, t~ - t <= (e + |t| D) / |det~| with |t| <= max(|t~|,
//    0.005), under |1 / det~| (e2 + e6 |t~|).
// As |det~| <= 3 max|s| <= 3 e / kSumErr, the rest of e2 and e6 covers the
// 1-ulp reciprocal and the roundings of the x~, of the plain x and of these
// bounds.  Where |det~| < e6, |det| < 2 e6, and an accepted t (>= -0.005)
// has |t| >= (|num~| - e) / (2 e6) =: l: t >= l where l > 0.005, so t >=
// l - 0.01 either way (one FFMA: k_deg |num~| - k_off, k_off = k_deg e2 +
// 0.01).  No division, no branch.
__device__ __forceinline__ float chain_t_lo(float s_ab, float s_bc, float s_ca, float num, float e2,
                                            float e6, float k_deg, float k_off) {
  const float det = s_ab + s_bc + s_ca;
  float inv;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(inv) : "f"(det));
  const float tt = num * inv;
  const float ai = fabsf(inv);
  const float mn = fminf(fminf(s_ca * inv, s_ab * inv), fminf(s_bc * inv, tt));
  const float t_lo = fmaf(ai, e2, mn) >= kSideBound ? tt - ai * fmaf(e6, fabsf(tt), e2) : INFINITY;
  return fabsf(det) < e6 ? fmaf(fabsf(num), k_deg, -k_off) : t_lo;
}

// wgmma descriptor of a K-major B tile without swizzle: core matrices of 8
// columns x 8 rows (128 bytes, a column's 8 rows contiguous), the two row
// halves of a 16-row step 128 bytes apart (LBO), groups of 8 columns Sbo
// bytes apart (SBO).  Its low 14 bits are the address / 16, so a tile
// `off` bytes further into shared memory is the descriptor + off / 16.
template <int Sbo>
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  const uint64_t a = (uint64_t)__cvta_generic_to_shared(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(Sbo >> 4) << 32);
}

// Keeps the compiler from moving a read of an accumulator above the wait.
template <int N>
__device__ __forceinline__ void wgmma_hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>  // at most N of this warpgroup's committed groups still running
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A run's kWgSteps wgmma steps: issue(acc, i) starts step i's products in
// acc, consume(acc, i) reads them.  With two accumulators, step i + 1's
// products run on the tensor cores while step i is consumed.
template <class C, class Issue, class Consume>
__device__ __forceinline__ void wgmma_steps(float (&acc0)[kMTiles][16], float (&acc1)[kMTiles][16],
                                            Issue issue, Consume consume) {
  constexpr int S = C::kWgSteps;
  // zeros, so that no value is live across the runs (the scale_d = 0 wgmma
  // ignores them): the registers are free at a visit's end
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int k = 0; k < kN / 2; ++k) acc0[mt][k] = acc1[mt][k] = 0.0f;
  }
  if constexpr (C::kBufs == 1) {
#pragma unroll 1
    for (int i = 0; i < S; ++i) {
      issue(acc0, i);
      wgmma_wait<0>();
      consume(acc0, i);
    }
  } else {
    issue(acc0, 0);
#pragma unroll
    for (int i = 0; i < S; i += 2) {
      issue(acc1, i + 1);
      wgmma_wait<1>();
      consume(acc0, i);
      if (i + 2 < S) {
        issue(acc0, i + 2);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      consume(acc1, i + 1);
    }
  }
}

// d (+)= a . B on the tensor cores, one warpgroup: A 64 x 16 from registers
// (each warp's 16 rows as an mma.sync m16n8k16 A fragment), B 16 x 32 from
// shared memory (desc), f32 accumulation; scale_d = 0 ignores d.  Thread
// (g, t) of warp wq receives d[4 c + e] = D[16 wq + g + 8 (e / 2)][8 c + 2t
// + e % 2].
__device__ __forceinline__ void wgmma_bf16(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The bf16 kernel: warpgroup wg of the block holds rays [128 wg, 128 (wg +
// 1)) of the tile as kMTiles 64-ray m-tiles; warp wq of it rows 16 wq + g
// and + 8 of each (g = lane / 4; lane quad t = lane % 4 holds columns 2t
// and 2t + 1 of every 8).
template <int K, int V, bool Unroll>
__global__ void __launch_bounds__(Cfg<K, V>::kThreads)
parts_wgmma_kernel(const float* __restrict__ w,      // (N, K)
                   const char* __restrict__ ops,     // the pre-split operand
                   int cols,                         // 4 * tb * nb
                   const float* __restrict__ attr,   // (16, attr_cols); read by select
                   int attr_cols,
                   const float* __restrict__ bnorm,  // max ||ops column||; read by the chain
                   int tb, int nb,
                   float* __restrict__ out) {        // (N,)
  using C = Cfg<K, V>;
  constexpr int MT = kMTiles, KS = C::kSteps, kRun = C::kRun;
  constexpr int kSbo = 256 * C::kCopies;  // bytes of a group of 8 positions (hi, then lo)
  extern __shared__ uint4 smem[];
  char* sm = reinterpret_cast<char*>(smem);
  uint64_t desc_run = 0;  // the descriptor of the run being multiplied (its first group)
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wg = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3;
  const size_t row0 = (size_t)blockIdx.x * kTile + (size_t)wg * 64 * MT + wq * 16 + g;

  // A fragments: [0] row g, k 2t..2t+1; [1] row g + 8; [2], [3] k + 8
  uint32_t a_hi[MT][KS][4];
  uint32_t a_lo[C::kSplit ? MT : 1][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const size_t row = row0 + mt * 64 + (f & 1) * 8;
        const float2 x = *reinterpret_cast<const float2*>(w + row * K + s * 16 + (f >> 1) * 8 + 2 * t);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x.x, x.y);
        a_hi[mt][s][f] = bf16x2_bits(hi);
        if constexpr (C::kSplit) {
          a_lo[mt][s][f] = bf16x2_bits(
              __floats2bfloat162_rn(x.x - __low2float(hi), x.y - __high2float(hi)));
        }
      }
    }
  }

  float acc0[MT][kN / 2] = {}, acc1[MT][kN / 2] = {};
  if constexpr (C::kChain) {
    static_assert(KS == 1 && C::kSplit && MT == 2, "the K = 16 bf16x3 product, 4 rows a quad");
    // per row h (g, g + 8) of each m-tile the carry (min t, attrs), in
    // shared memory: the lists hold what the sweep needs of it.  Lane t of
    // the quad updates row t's.
    __shared__ float s_best[kTile], s_attrs[kTile];
    const int rt0 = (int)(row0 - (size_t)blockIdx.x * kTile);
    auto best = [&](int mt, int h) -> float& { return s_best[rt0 + mt * 64 + h * 8]; };
    auto attrs = [&](int mt, int h) -> float& { return s_attrs[rt0 + mt * 64 + h * 8]; };
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        best(mt, h) = PTT_F_MAX;
        attrs(mt, h) = 0.0f;
      }
    }
    // e: how far this thread's sums may lie from the plain version's
    // (kSumErr ||a~|| max ||b||, over its rows); e2 = kE2 e, e6 = kE6 e
    float e2, e6, k_deg, k_off;
    {
      float na = 0.0f;  // the largest ||a~||^2 of the thread's rows
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float ss[2] = {0.0f, 0.0f};
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const uint32_t hi = a_hi[mt][0][f], lo = a_lo[mt][0][f];
          const float x0 = fabsf(__uint_as_float(hi << 16)) + fabsf(__uint_as_float(lo << 16));
          const float x1 = fabsf(__uint_as_float(hi & 0xffff0000u)) + fabsf(__uint_as_float(lo & 0xffff0000u));
          ss[f & 1] = fmaf(x0, x0, fmaf(x1, x1, ss[f & 1]));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the quad's lanes hold the row's k in fours
          float v = ss[h] + __shfl_xor_sync(0xffffffffu, ss[h], 1);
          v = v + __shfl_xor_sync(0xffffffffu, v, 2);
          na = fmaxf(na, v);
        }
      }
      const float e = kSumErr * sqrtf(na) * *bnorm;
      e2 = kE2 * e;
      e6 = kE6 * e;
      k_deg = (1.0f - 0x1p-20f) / (2.0f * e6);
      k_off = fmaf(k_deg, e2, 0.01f);
    }

    // Per row, this lane's candidates for the visit's winner: the two least
    // lower bounds t_lo (chain_t_lo) of its pairs, c0 <= c1, at triangles
    // j0 and j1, and c2, the least t_lo of the pairs left out.  An empty
    // entry holds the row's best (lim): a pair whose t_lo is not below it
    // cannot improve the row.
    float c0[MT][2], c1[MT][2], c2[MT][2];
    int j0[MT][2], j1[MT][2];
    auto reset = [&]() {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          c0[mt][h] = c1[mt][h] = c2[mt][h] = best(mt, h);
          j0[mt][h] = j1[mt][h] = 0;
        }
      }
    };
    reset();

    int r0 = 0;  // the run's first triangle
    // step i: triangles r0 + 8 i .. + 8, their quadrants q at d[4 q + e]
    auto issue = [&](float (&d)[MT][kN / 2], int i) {
      const uint64_t d_hi = desc_run + ((kN * i * C::kRecord) >> 4), d_lo = d_hi + (256 >> 4);
      wgmma_fence();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        wgmma_bf16(d[mt], a_lo[mt][0], d_hi, 0);
        wgmma_bf16(d[mt], a_hi[mt][0], d_lo, 1);
        wgmma_bf16(d[mt], a_hi[mt][0], d_hi, 1);
      }
      wgmma_commit();
    };
    auto consume = [&](float (&d)[MT][kN / 2], int i) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        wgmma_hold<kN / 2>(d[mt]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float tl = chain_t_lo(d[mt][e], d[mt][4 + e], d[mt][8 + e], d[mt][12 + e], e2, e6, k_deg, k_off);
          // into the sorted lists, without a branch (strictly: the earlier
          // triangle first; a NaN is ignored)
          const int j = r0 + 8 * i + 2 * t + (e & 1);
          const bool b0 = tl < c0[mt][h], b1 = tl < c1[mt][h];
          c2[mt][h] = fminf(c2[mt][h], fmaxf(c1[mt][h], tl));
          c1[mt][h] = fminf(c1[mt][h], fmaxf(c0[mt][h], tl));
          c0[mt][h] = fminf(c0[mt][h], tl);
          j1[mt][h] = b0 ? j0[mt][h] : b1 ? j : j1[mt][h];
          j0[mt][h] = b0 ? j : j0[mt][h];
        }
      }
    };
    auto run_chain = [&](const char* buf, int first) {
      desc_run = wgmma_desc<kSbo>(buf);
      r0 = first;
      wgmma_steps<C>(acc0, acc1, issue, consume);
    };

    // The end of a visit settles the quad's 4 rows together, lane t
    // recomputing row t's candidate (pair_t, the plain version's rounding).
    // Candidates go in increasing (t_lo, triangle); each is recomputed while
    // its t_lo is not above the least exact t found, so every pair that can
    // win is recomputed and the first triangle wins a tie.  Where a lane's
    // pairs left out of its lists could still win (their least t_lo, c2,
    // not above that t), the warp recomputes all of that lane's pairs.  Then
    // lane t runs row t's improve/update.  The loops run while any quad of
    // the warp has work, every lane taking part in the shuffles.
    auto end_visit = [&](int blk) {
      constexpr int kRows = 2 * MT;  // row r: m-tile r / 2, half r % 2
      const int base = lane & ~3;
      float bt[kRows];  // the least exact t below lim so far, and its triangle
      int bi[kRows];
      unsigned left = 0;  // bits 2 r, 2 r + 1: row r's c0, c1 not yet settled
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int mt = r >> 1, h = r & 1;
        bt[r] = best(mt, h);
        bi[r] = 0;
        left |= ((c0[mt][h] < best(mt, h) ? 1u : 0u) | (c1[mt][h] < best(mt, h) ? 2u : 0u)) << (2 * r);
      }
      // the quad's least candidate of row r left, in (t_lo, triangle) order
      auto least = [&](int r, float& p, int& pj) {
        const int mt = r >> 1, h = r & 1;
        const unsigned lr = left >> (2 * r);
        p = lr & 1 ? c0[mt][h] : lr & 2 ? c1[mt][h] : INFINITY;
        pj = lr & 1 ? j0[mt][h] : j1[mt][h];
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          const float p2 = __shfl_xor_sync(0xffffffffu, p, o);
          const int pj2 = __shfl_xor_sync(0xffffffffu, pj, o);
          if (p2 < p || (p2 == p && pj2 < pj)) {
            p = p2;
            pj = pj2;
          }
        }
      };
      for (;;) {
        unsigned go = 0;  // bit r: row r's candidate can still win
        int pjm = 0;      // row t's, for this lane to recompute
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float p;
          int pj;
          least(r, p, pj);
          go |= (p <= bt[r] ? 1u : 0u) << r;
          if (r == t) pjm = pj;
        }
        if (!__any_sync(0xffffffffu, go != 0)) break;
        const float te_mine = (go >> t) & 1
            ? pair_t(w, ops, row0 + (t >> 1) * 64 + (t & 1) * 8, blk, pjm, tb) : PTT_F_MAX;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int mt = r >> 1, h = r & 1;
          const float te = __shfl_sync(0xffffffffu, te_mine, base + r);
          float p;
          int pj;
          least(r, p, pj);  // as above: left has not changed
          if ((go >> r) & 1) {
            if (te < bt[r] || (te == bt[r] && bt[r] < best(mt, h) && pj < bi[r])) {
              bt[r] = te;
              bi[r] = pj;
            }
            const unsigned lr = left >> (2 * r);
            if ((lr & 1) && j0[mt][h] == pj) {  // only its owner holds triangle pj
              left &= ~(1u << (2 * r));
            } else if ((lr & 2) && j1[mt][h] == pj) {
              left &= ~(2u << (2 * r));
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int mt = r >> 1, h = r & 1;
        const float lim = best(mt, h);
        // a lane whose left-out pairs may still win has all of its pairs
        // recomputed, by the warp together: lane l takes its pairs l, l + 32,
        // .. (pair p at j = 8 (p / 2) + 2 t_owner + p % 2)
        unsigned need = __ballot_sync(0xffffffffu, c2[mt][h] < lim && c2[mt][h] <= bt[r]);
        while (need) {
          const int src = __ffs(need) - 1;
          need &= need - 1;
          const size_t row = row0 - g + (src >> 2) + mt * 64 + h * 8;
          const float lim_s = __shfl_sync(0xffffffffu, lim, src);
          float x = __shfl_sync(0xffffffffu, bt[r], src);
          int xj = __shfl_sync(0xffffffffu, bi[r], src);
#pragma unroll 1
          for (int pair = lane; pair < tb / 4; pair += 32) {
            const int j = 8 * (pair >> 1) + 2 * (src & 3) + (pair & 1);
            const float te = pair_t(w, ops, row, blk, j, tb);
            if (te < x || (te == x && x < lim_s && j < xj)) {
              x = te;
              xj = j;
            }
          }
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const float x2 = __shfl_xor_sync(0xffffffffu, x, o);
            const int j2 = __shfl_xor_sync(0xffffffffu, xj, o);
            if (x2 < x || (x2 == x && x < lim_s && j2 < xj)) {
              x = x2;
              xj = j2;
            }
          }
          if ((lane >> 2) == (src >> 2)) {  // the owner's quad
            bt[r] = x;
            bi[r] = xj;
          }
        }
        if (r == t) {  // lane t updates row t's carry
          const bool improve = bt[r] < lim;
          if (V == kArgmin && improve) attrs(mt, h) = (float)bi[r] + attrs(mt, h);
          if (V == kSelect) {
            float sum;
            if (improve) {
              const float* a = attr + (size_t)blk * tb + bi[r];
              sum = a[0];
              for (int k = 1; k < kSelectRows; ++k) sum = sum + a[(size_t)k * attr_cols];
            } else {
              sum = attrs(mt, h);
              for (int k = 1; k < kSelectRows; ++k) sum = sum + attrs(mt, h);
            }
            attrs(mt, h) = sum + attrs(mt, h) * 0.0f;
          }
          if (improve) best(mt, h) = bt[r];
        }
      }
      __syncwarp();  // the quad's lanes read the carry lane t wrote
      reset();
    };

    sweep_visits<C, Unroll>(sm, ops, cols, tb, nb, run_chain, end_visit);
    if (t == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) out[row0 + mt * 64 + h * 8] = best(mt, h) + attrs(mt, h);
      }
    }
  } else {  // mm_*: one min over every visit, merged across the quad at the end
    float vmin[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) vmin[mt][0] = vmin[mt][1] = PTT_F_MAX;
    // step i: positions kN i .. + kN of the run, every 16-row step s
    auto issue = [&](float (&d)[MT][kN / 2], int i) {
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const uint64_t d_hi = desc_run + (((s * 4 * kRun + kN * i) * C::kRecord) >> 4);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (C::kSplit) {
            const uint64_t d_lo = d_hi + (256 >> 4);
            wgmma_bf16(d[mt], a_lo[mt][s], d_hi, s > 0);
            wgmma_bf16(d[mt], a_hi[mt][s], d_lo, 1);
            wgmma_bf16(d[mt], a_hi[mt][s], d_hi, 1);
          } else {
            wgmma_bf16(d[mt], a_hi[mt][s], d_hi, s > 0);
          }
        }
      }
      wgmma_commit();
    };
    auto consume = [&](float (&d)[MT][kN / 2], int) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        wgmma_hold<kN / 2>(d[mt]);
#pragma unroll
        for (int c = 0; c < kN / 8; ++c) {  // rows g (4c, 4c + 1) and g + 8 (4c + 2, 4c + 3)
          vmin[mt][0] = fminf(vmin[mt][0], fminf(d[mt][4 * c], d[mt][4 * c + 1]));
          vmin[mt][1] = fminf(vmin[mt][1], fminf(d[mt][4 * c + 2], d[mt][4 * c + 3]));
        }
      }
    };
    auto run_mm = [&](const char* buf, int) {
      desc_run = wgmma_desc<kSbo>(buf);
      wgmma_steps<C>(acc0, acc1, issue, consume);
    };

    sweep_visits<C, Unroll>(sm, ops, cols, tb, nb, run_mm, [](int) {});
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = vmin[mt][h];
        v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        if (t == 0) out[row0 + mt * 64 + h * 8] = v + 0.0f;  // best + attrs, attrs = 0
      }
    }
  }
}

// mm_f32 (K = 16): thread x of the block holds rays x + j * kThreads of the
// tile (j < kF32Rays) in registers; every thread reads the same column of
// the transposed operand (cols, 16) as four 16-byte broadcasts.
__global__ void __launch_bounds__(Cfg<16, kMmF32>::kThreads)
parts_f32_kernel(const float* __restrict__ w, const char* __restrict__ ops, int cols, int tb,
                 int nb, float* __restrict__ out) {
  using C = Cfg<16, kMmF32>;
  constexpr int K = 16, R = kF32Rays;
  extern __shared__ uint4 smem[];
  char* sm = reinterpret_cast<char*>(smem);
  const size_t ray0 = (size_t)blockIdx.x * kTile + threadIdx.x;
  float a[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4* p = reinterpret_cast<const float4*>(w + (ray0 + (size_t)r * C::kThreads) * K);
#pragma unroll
    for (int k4 = 0; k4 < K / 4; ++k4) {
      const float4 x = p[k4];
      a[r][4 * k4] = x.x;
      a[r][4 * k4 + 1] = x.y;
      a[r][4 * k4 + 2] = x.z;
      a[r][4 * k4 + 3] = x.w;
    }
  }
  float vmin[R];
#pragma unroll
  for (int r = 0; r < R; ++r) vmin[r] = PTT_F_MAX;

  auto run = [&](const char* buf, int) {
    const float4* sb = reinterpret_cast<const float4*>(buf);
#pragma unroll 2
    for (int c = 0; c < 4 * C::kRun; ++c) {
      const float4 q0 = sb[4 * c], q1 = sb[4 * c + 1], q2 = sb[4 * c + 2], q3 = sb[4 * c + 3];
      const float b[K] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w,
                          q2.x, q2.y, q2.z, q2.w, q3.x, q3.y, q3.z, q3.w};
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float acc = a[r][0] * b[0];  // f32, in k order
#pragma unroll
        for (int k = 1; k < K; ++k) acc = fmaf(a[r][k], b[k], acc);
        vmin[r] = fminf(vmin[r], acc);
      }
    }
  };
  sweep_visits<C, false>(sm, ops, cols, tb, nb, run, [](int) {});
#pragma unroll
  for (int r = 0; r < R; ++r) out[ray0 + (size_t)r * C::kThreads] = vmin[r] + 0.0f;
}

// P4 and P2's `empty`: out = w[:, 0].  `ops` is bound and never read, as
// the TPU kernel's unused operand.  What bounds it: device memory, a 32-byte
// sector read for each row's one float and 4 bytes written.  Each thread
// copies kCopyRows rows, strided by the grid so that a warp's loads stay on
// neighbouring rows, and issues all their loads before any store, in blocks
// of a tile of rows: the 800,256-row grid is one wave on the 132 SMs.
constexpr int kCopyRows = 4;

__global__ void empty_kernel(const float* __restrict__ w, int k, const float* __restrict__ ops,
                             float* __restrict__ out, int n) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t row0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v[kCopyRows];
#pragma unroll
  for (int j = 0; j < kCopyRows; ++j) {
    const size_t row = row0 + j * stride;
    v[j] = row < (size_t)n ? __ldcs(w + row * k) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kCopyRows; ++j) {
    const size_t row = row0 + j * stride;
    if (row < (size_t)n) __stcs(out + row, v[j]);
  }
}

// The parts kernel's instantiations, one tag each: (K, variant, unroll).
template <int K_, int V_, bool U_>
struct Config {
  static constexpr int K = K_, V = V_;
  static constexpr bool U = U_;
};

// f(Config<..>{}) for the instantiation of (k, variant, unroll), or
// cudaErrorInvalidValue where there is none.
template <class F>
int with_config(int k, int variant, int unroll, F f) {
  if (k == 16 && !unroll) {
    switch (variant) {
      case kMmBf16: return f(Config<16, kMmBf16, false>{});
      case kMmBf16x3: return f(Config<16, kMmBf16x3, false>{});
      case kMmF32: return f(Config<16, kMmF32, false>{});
      case kAccept: return f(Config<16, kAccept, false>{});
      case kArgmin: return f(Config<16, kArgmin, false>{});
      case kSelect: return f(Config<16, kSelect, false>{});
    }
  }
  if (variant == kMmBf16) {
    if (k == 16 && unroll) return f(Config<16, kMmBf16, true>{});
    if (k == 32 && !unroll) return f(Config<32, kMmBf16, false>{});
    if (k == 128 && !unroll) return f(Config<128, kMmBf16, false>{});
    if (k == 128 && unroll) return f(Config<128, kMmBf16, true>{});
  }
  return (int)cudaErrorInvalidValue;
}

// The kernel of configuration X with its dynamic shared memory allowed.
template <class X>
auto parts_kernel_ready(cudaError_t& err) {
  using C = Cfg<X::K, X::V>;
  if constexpr (C::kF32) {
    static_assert(!X::U, "mm_f32 has no unrolled visit loop");
    err = set_smem(parts_f32_kernel, C::kSmem);
    return parts_f32_kernel;
  } else {
    err = set_smem(parts_wgmma_kernel<X::K, X::V, X::U>, C::kSmem);
    return parts_wgmma_kernel<X::K, X::V, X::U>;
  }
}

// One launch of configuration X: grids of kTile-ray blocks.
template <class X>
cudaError_t launch_parts(const float* w, int n, const char* ops, int cols, const float* attr,
                         int attr_cols, const float* bnorm, int tb, int nb, float* out,
                         cudaStream_t stream) {
  using C = Cfg<X::K, X::V>;
  if (tb % C::kRun || n % kTile || (C::kChain && bnorm == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err;
  const auto kernel = parts_kernel_ready<X>(err);
  if (err != cudaSuccess) return err;
  if constexpr (C::kF32) {
    kernel<<<n / kTile, C::kThreads, C::kSmem, stream>>>(w, ops, cols, tb, nb, out);
  } else {
    kernel<<<n / kTile, C::kThreads, C::kSmem, stream>>>(w, ops, cols, attr, attr_cols, bnorm, tb,
                                                         nb, out);
  }
  return cudaGetLastError();
}

}  // namespace

// variant: Variant above.  k: the product's depth (16, 32 or 128; 16 for
// every variant but mm_bf16).  unroll: P2's unrolled visit loop (mm_bf16).
// rows: the empty kernel's tile of rows (threads per block).  ops: for the
// parts kernels the wrapper's pre-split operand (kernels/prof.py::
// parts_operand) of the (k, ops_cols) ops; for the empty kernel unread.
// bnorm: the chain variants' largest L2 norm of an ops column, one float on
// the device (kernels/prof.py::parts_bnorm); else unread.
extern "C" int ptt_prof_parts(const float* w, int n, int k, int rows, const void* ops,
                              int ops_cols, const float* attr, int attr_cols, const float* bnorm,
                              int tb, int nb, int variant, int unroll, float* out, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (variant == kEmpty) {
    if (rows < 32 || rows > 1024 || n % rows) return (int)cudaErrorInvalidValue;
    const int per_block = rows * kCopyRows;
    empty_kernel<<<(n + per_block - 1) / per_block, rows, 0, st>>>(
        w, k, static_cast<const float*>(ops), out, n);
    return (int)cudaGetLastError();
  }
  const char* o = static_cast<const char*>(ops);
  return with_config(k, variant, unroll, [&](auto x) {
    return (int)launch_parts<decltype(x)>(w, n, o, ops_cols, attr, attr_cols, bnorm, tb, nb, out, st);
  });
}

// The dynamic shared memory that a launch of (k, variant, unroll) allows
// its kernel, as the runtime reports it for the loaded kernel.
extern "C" int ptt_prof_parts_smem(int k, int variant, int unroll, int* bytes) {
  return with_config(k, variant, unroll, [&](auto x) {
    cudaError_t err;
    const auto kernel = parts_kernel_ready<decltype(x)>(err);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, kernel);
    *bytes = a.maxDynamicSharedSizeBytes;
    return (int)err;
  });
}
