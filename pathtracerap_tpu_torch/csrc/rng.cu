// Kernel R1: the uniform stream of the engines, one launch a chunk.
//
// Replaces no Pallas kernel: the JAX package draws these uniforms with
// jax.random (threefry2x32 in XLA; pathtracerap_tpu/pallas/megakernel.py
// chunk_uniforms, pathtracerap_tpu/ops/rng.py camera_jitter_uniforms).  The
// port first drew them as int64 torch ops (ops/rng.py chunk_uniforms_plain,
// 727 launches a call); this kernel writes the same floats, bit for bit, in
// one.  Contract, per sample s = s0 + i (i < ns), depth d and RNG tile
// k < nt (global tile tile_base + k), all on uint32 with wrap-around:
//   key_t = fold_in(fold_in(fold_in(key, s), d), tile_base + k),
//   fold_in(key, x) = threefry2x32(key, (0, x)),
//   draw j of lane l = uniform(key_t)[l * W + j]: threefry2x32(key_t, c)
//   of the count c = (l * W + j) split in (hi, lo) words, the two output
//   words XORed, the top 23 bits as the mantissa of a float in [1, 2),
//   minus 1 (exact).
// Layout: W = 4 (the shading stream) writes out (ns * n_pad, 4 * depths),
// rows in (sample, ray) order, column block b holding depth depths - b;
// W = 2 (the quality camera's jitter, depth 0, depths = 1) writes
// (n_pad, 2).  Ray r of a sample lies in tile r / tile_n at lane
// r % tile_n; rows of tiles k >= nt are zeros, rows past n_pad are not
// written (the drawn rows past it are dropped).
//
// What bounds it on the H100: the integer pipe.  A uniform is one 20-round
// hash, about 76 instructions on 32-bit integers (a round: an add, a
// funnel-shift rotate, a xor; five key injections of two adds; the
// mantissa).  The INT32 pipe retires 64 lanes a clock an SM and alone runs
// the rotates and xors, 40 a uniform; the compiler sends most adds to the
// FMA pipe (IMAD).  The output, 4 bytes a uniform, is written once.  The
// design:
//  * a thread block covers a run of one RNG tile of one sample; the
//    tile's `depths` keys (three chained hashes each) are derived once a
//    block by its first threads into shared memory;
//  * thread t of the run owns float4 (float2) element e of the tile's
//    contiguous output, e = lane * depths + b, so a warp's stores are 512
//    (256) contiguous bytes; a thread takes kPer elements kThreads apart,
//    each W independent hashes the compiler interleaves;
//  * rotations are __funnelshift_l, adds and xors wrap on uint32: equal to
//    the int64 form's `& 0xFFFFFFFF` everywhere (sample and tile indices
//    past 2**31, the tile_base + k sum, any 32-bit seed).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// 256 threads of 4 elements: of seven shapes (128 to 512 threads, 1 to 8
// elements) the fastest on the reference step's call and within 5 % of the
// fastest (256 x 8) on the Cornell render's
constexpr int kThreads = 256;
constexpr int kPer = 4;  // elements a thread
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ void round4(uint32_t& x0, uint32_t& x1, int r0, int r1, int r2, int r3) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, r0); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r1); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r2); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r3); x1 ^= x0;
}

// Threefry-2x32 (20 rounds) of the count (x0, x1) under the key (k0, k1),
// in place: jax.random's threefry2x32, ops/rng.py threefry2x32.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k1;
  x1 += k2 + 1u;
  round4(x0, x1, 17, 29, 16, 24);
  x0 += k2;
  x1 += k0 + 2u;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k0;
  x1 += k1 + 3u;
  round4(x0, x1, 17, 29, 16, 24);
  x0 += k1;
  x1 += k2 + 4u;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k2;
  x1 += k0 + 5u;
}

__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1, uint32_t data) {
  uint32_t x0 = 0u, x1 = data;
  threefry(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

__device__ __forceinline__ float draw(uint32_t k0, uint32_t k1, uint32_t hi, uint32_t lo) {
  uint32_t x0 = hi, x1 = lo;
  threefry(k0, k1, x0, x1);
  return __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
}

template <int W> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<2> { using T = float2; };

template <int W>
__device__ __forceinline__ typename Vec<W>::T draws(uint32_t k0, uint32_t k1, uint32_t hi,
                                                    uint32_t lo) {
  if constexpr (W == 4) {
    return make_float4(draw(k0, k1, hi, lo), draw(k0, k1, hi, lo + 1u),
                       draw(k0, k1, hi, lo + 2u), draw(k0, k1, hi, lo + 3u));
  } else {
    return make_float2(draw(k0, k1, hi, lo), draw(k0, k1, hi, lo + 1u));
  }
}

template <int W>
__device__ __forceinline__ typename Vec<W>::T zeros() {
  if constexpr (W == 4) {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    return make_float2(0.f, 0.f);
  }
}

// Block b: run b % chunks of row tile (b / chunks) % tiles_out of sample
// b / (chunks * tiles_out).
template <int W>
__global__ void __launch_bounds__(kThreads)
    chunk_uniforms_kernel(const long long* __restrict__ key, uint32_t s0, int depths, int n_pad,
                          int tile_n, int nt, int tiles_out, uint32_t tile_base, int chunks,
                          float* __restrict__ out) {
  extern __shared__ uint32_t tile_keys[];  // (depths, 2)
  using V = typename Vec<W>::T;
  const int chunk = blockIdx.x % chunks;
  const int st = blockIdx.x / chunks;
  const int k = st % tiles_out;
  const int si = st / tiles_out;
  const bool drawn = k < nt;  // the same for the whole block
  if (drawn) {
    for (int b = threadIdx.x; b < depths; b += kThreads) {
      uint32_t k0 = (uint32_t)__ldg(key), k1 = (uint32_t)__ldg(key + 1);
      fold_in(k0, k1, s0 + (uint32_t)si);
      fold_in(k0, k1, W == 4 ? (uint32_t)(depths - b) : 0u);
      fold_in(k0, k1, tile_base + (uint32_t)k);
      tile_keys[2 * b] = k0;
      tile_keys[2 * b + 1] = k1;
    }
    __syncthreads();
  }
  const long long ray0 = (long long)k * tile_n;  // below n_pad
  const int rows = (int)min((long long)tile_n, (long long)n_pad - ray0);
  const int elems = rows * depths;
  V* o = reinterpret_cast<V*>(out) + ((long long)si * n_pad + ray0) * depths;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = (chunk * kPer + i) * kThreads + (int)threadIdx.x;
    if (e < elems) {
      if (drawn) {
        const int lane = e / depths;
        const int b = e - lane * depths;
        const unsigned long long c = (unsigned long long)lane * W;
        o[e] = draws<W>(tile_keys[2 * b], tile_keys[2 * b + 1], (uint32_t)(c >> 32),
                        (uint32_t)c);
      } else {
        o[e] = zeros<W>();
      }
    }
  }
}

}  // namespace

// key: the (2,) int64 key on the card (words in [0, 2**32)), read there;
// samples s0 .. s0 + ns - 1 and tiles tile_base + k, both mod 2**32;
// width 4 (draws at depths depths .. 1) or 2 (the jitter: depth 0, depths
// 1); out: (ns * n_pad, width * depths) f32, contiguous.
extern "C" int ptt_chunk_uniforms(const long long* key, unsigned s0, int ns, int depths, int width,
                                  int n_pad, int tile_n, int nt, unsigned tile_base, float* out,
                                  void* stream) {
  if (ns == 0 || n_pad == 0) return (int)cudaSuccess;
  if (ns < 0 || n_pad < 0 || depths < 1 || tile_n < 1 || nt < 0 ||
      (width != 4 && width != 2) || (width == 2 && depths != 1))
    return (int)cudaErrorInvalidValue;
  const long long per_tile = (long long)tile_n * depths;
  const long long tiles_out = ((long long)n_pad + tile_n - 1) / tile_n;
  const long long chunks = (per_tile + (long long)kThreads * kPer - 1) / ((long long)kThreads * kPer);
  const long long blocks = chunks * tiles_out * ns;
  if (per_tile > 0x7FFFFFFFLL - (long long)kThreads * kPer || blocks > 0x7FFFFFFFLL ||
      (long long)depths * 8 > 48 * 1024)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)depths * 2 * sizeof(uint32_t);
  const cudaStream_t s = (cudaStream_t)stream;
  if (width == 4) {
    chunk_uniforms_kernel<4><<<(unsigned)blocks, kThreads, smem, s>>>(
        key, s0, depths, n_pad, tile_n, nt, (int)tiles_out, tile_base, (int)chunks, out);
  } else {
    chunk_uniforms_kernel<2><<<(unsigned)blocks, kThreads, smem, s>>>(
        key, s0, depths, n_pad, tile_n, nt, (int)tiles_out, tile_base, (int)chunks, out);
  }
  return (int)cudaGetLastError();
}
