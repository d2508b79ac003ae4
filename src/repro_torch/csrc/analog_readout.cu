// The OPIMA analog readout chain for Hopper (sm_90a): two passes over the
// int8 nibble planes, the auto-ranging pass and the readout pass.
//
// Replaces the TPU kernels in src/repro/kernels/analog_readout/analog_readout.py:
//   analog_fullscale_pallas / _fullscale_kernel  -> analog_fullscale()
//   analog_readout_pallas   / _readout_kernel    -> analog_readout()
//
// For activation digit planes A (PA, M, Ka), weight digit planes W (PW,
// Kw, N) with Ka <= Kw (A is zero beyond Ka) and a WDM chunk of `chunk`
// products (Kw a multiple of chunk; chunk boundaries are absolute), every
// plane pair (d, e), chunk c, row m and column n has a chunk sum
//   s = sum_{q < chunk} A[d, m, c*chunk + q] * W[e, c*chunk + q, n]
// (an exact small integer), with optional transmission noise
//   s + (sigma * sqrtf(sum_q A^2 W^2)) * z(seed, d*PW + e, c, m, n).
// Pass 1 writes max |s| over everything into one device word (zeroed by
// the caller). Pass 2 reads it, forms lsb = max(fs, 1e-6) * (1/half_levels)
// on the card, converts every chunk sum into an ADC code
// rint(s / lsb) (the IEEE divide __fdiv_rn, then round half to even), sums
// the codes per pair in integers, shift-adds the pairs by 16^(d+e) in
// uint32 and writes
//   ((float(acc) * lsb) * a_scale[m]) * w_scale[n] (+ bias[n]).
// z is a counter-based normal: a murmur3-style hash of
// (seed, pair, chunk, row, column) and Box-Muller; the key does not depend
// on tiling, so both passes draw the same normal for the same chunk sum,
// and kernels/analog_readout/ref.py evaluates the same function.
//
// What bounds it on an H100: not the bytes and not the multiply-adds but
// the work per chunk sum. A w4a4 ResNet18 request at batch 128 has about
// 8.9e9 chunk sums per pass (chunk 8); each must be ranged (pass 1) or
// converted and summed (pass 2) on the CUDA cores, one at a time.
//
// Two routes, chosen in Python (analog_readout.py analog_route) and
// passed in as `route`:
//
// ROUTE_MMA (chunks 4, 8 and 16, no noise; every main path): the chunk
// sums come out of the int8 tensor cores, and the ADC runs on full-rate
// float ops.
//   * mma.sync.m16n8k16.s32.s8.s8 with a chunk-diagonal B fragment. A k16
//     step spans CPS = 16 / chunk chunks; the fragment's column j stands
//     for output column j / CPS and chunk j % CPS of the step, and holds
//     W's four K-consecutive bytes of that column where they fall in that
//     chunk, 0 elsewhere (one select per register). Each accumulator
//     entry is then one chunk sum, as an exact int32, for 16 rows x 8
//     (column, chunk) pairs per MMA: no two chunks are ever added. The
//     multiply-adds against the zeros are wasted (1/2 at chunk 8), which
//     costs nothing at the tensor cores' rate.
//   * The MMA's C operand is 0x4B400000, the bits of 1.5 * 2^23, so each
//     result is the float 1.5 * 2^23 + s bit for bit (|s| < 2^22): the
//     int-to-float conversion costs one float subtract, not an I2F.
//   * The ADC (quotient_rn / adc_fast below): with y = __frcp_rn(lsb)
//     once per block, the quotient s / lsb correctly rounded by FMAs alone
//     (q0 = s y and two residual corrections; Markstein's theorem makes
//     the last one __fdiv_rn(s, lsb) bit for bit), then rounded to an
//     integer by adding 1.5 * 2^23 (round half to even, as
//     __float2int_rn). Eight full-rate instructions per chunk sum, no
//     MUFU, no F2I/I2F and no branch: ties (s / lsb exactly k + 1/2,
//     frequent when lsb divides small integers) cost nothing extra. Where
//     |s / lsb| could reach 2^21 (an ADC of about 12 bits or more at a
//     small full scale; a block-uniform test) every code comes from
//     __float2int_rn(__fdiv_rn(s, lsb)) itself. Either way every code
//     equals __float2int_rn(__fdiv_rn(s, lsb)) for the same s.
//   * Codes accumulate as the rounded floats' bits (1.5 * 2^23 + code)
//     shifted by 4 (d + e) into uint32; the constant part is taken off
//     once at the end. Integer sums: the result does not depend on the
//     order of the chunks. Pass 1 keeps the integer max and min of s
//     (DPX three-way max/min), one block reduction, one atomicMax.
//   * Both passes stop at Ka: chunks wholly past the activations' K have
//     s = 0 (code 0, no effect on the full scale), and no k16 step wholly
//     past Ka is run (inside the last step, up to CPS - 1 such chunks
//     come out of its MMA as zeros).
//   * A 2-D grid of 128-row x 64-column output tiles (32 at chunk 4),
//     eight warps of 32 rows x 4 or 8 MMA tiles of 8 columns each; K in
//     steps of 32 through a two-stage ring: A by cp.async (16-byte
//     pieces, zero-filled past M and Ka), W loaded into registers one
//     step ahead and transposed into K-packed words (__byte_perm) on its
//     way to shared memory, the layout from which one 32-bit load is a B
//     fragment. A fragments come from ldmatrix; every shared row is
//     padded so its fragment loads hit distinct banks.
//
// ROUTE_SIMT (any other chunk, or noise on): the chunk sums are formed on
// the CUDA cores with float FMAs (exact: every partial sum is an integer
// far below 2^24) from tiles staged as floats in shared memory, a 4x4
// micro-tile per thread; after each chunk the thread converts its 16 sums
// with __fdiv_rn (a zero sum takes code 0 without dividing: a zero
// numerator sends the divide down its slow path). Chunks of 4, 8 and 16
// are unrolled; any other chunk takes a generic loop that carries a
// partial chunk across K steps. This is the kernel the tensor-core route
// replaced; it stays as the second route and, through the C symbols
// analog_fullscale_simt / analog_readout_simt (which no wrapper calls), as
// the yardstick the new route is timed against.
//
// Bit-exactness: the divide is __fdiv_rn, never __fdividef; the ADC and
// the epilogue use __fmul_rn / __fadd_rn so nvcc cannot contract them into
// FMAs. Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int ROUTE_MMA = 0;
constexpr int ROUTE_SIMT = 1;

struct Args {
  const int8_t* a;
  const int8_t* w;
  const float* a_scale;
  const float* w_scale;
  const float* bias;
  float* fs;                     // the full-scale word
  float* out;
  int pa, pw, m, ka, k, n, chunk;  // ka: A's K; k: W's K (a chunk multiple)
  float inv_half;                // 1 / half_levels(adc_bits), as float
  float floor;                   // full-scale floor (1e-6)
  uint32_t seed;
  float sigma;
};

__device__ __forceinline__ float lsb_of(const Args& args) {
  return __fmul_rn(fmaxf(*args.fs, args.floor), args.inv_half);
}

// ---- the ADC of the tensor-core route ------------------------------------
constexpr uint32_t MAGIC_BITS = 0x4B400000u;  // bits of 1.5 * 2^23
constexpr float MAGIC = 12582912.0f;          // 1.5 * 2^23
constexpr float FAST_LIMIT = 2097152.0f;      // 2^21: |s / lsb| below it
                                              // rounds by the magic add

// s / lsb rounded to nearest, bit for bit __fdiv_rn(s, lsb), from
// y = __frcp_rn(lsb) = RN(1 / lsb) with FMAs only: q0 = RN(s y) lies
// within 1.5 ulp of s / lsb; one correction q1 = RN(q0 + y RN(s - lsb q0))
// brings it within one ulp; then Markstein's theorem (y = RN(1/b) and q
// within one ulp of a/b give a - b q exact and RN(q + y (a - b q)) =
// RN(a/b)) makes the second correction the correctly rounded quotient.
// No MUFU, no branch. Holds while nothing under- or overflows: lsb normal
// and finite, |s| <= 2^22 (checked per block, see fast_adc).
__device__ __forceinline__ float quotient_rn(float s, float lsb, float y) {
  const float q0 = __fmul_rn(s, y);
  const float q1 = fmaf(fmaf(-lsb, q0, s), y, q0);
  return fmaf(fmaf(-lsb, q1, s), y, q1);
}

// x_bits: the bits of the float 1.5 * 2^23 + s for an integer |s| <= 2^22
// (the MMA's output with C = MAGIC_BITS). Returns the bits of
// 1.5 * 2^23 + rint(__fdiv_rn(s, lsb)) (round half to even, as
// __float2int_rn) where |s / lsb| < 2^21.
__device__ __forceinline__ uint32_t adc_fast(uint32_t x_bits, float lsb,
                                             float y) {
  const float s = __fsub_rn(__uint_as_float(x_bits), MAGIC);  // exact
  return __float_as_uint(__fadd_rn(quotient_rn(s, lsb, y), MAGIC));
}

// The same code through the IEEE divide, as 1.5 * 2^23 + code in uint32.
__device__ __forceinline__ uint32_t adc_exact(uint32_t x_bits, float lsb) {
  const float s = __fsub_rn(__uint_as_float(x_bits), MAGIC);
  return (uint32_t)__float2int_rn(__fdiv_rn(s, lsb)) + MAGIC_BITS;
}

// Whether every chunk sum of a block may take adc_fast: lsb normal and
// finite, and |s| <= s_max (chunk * 128 * 128 for int8 planes) keeps
// |s / lsb| below 2^21. Otherwise (an ADC of about 12 bits or more at a
// small full scale, or a degenerate one) the block converts every chunk
// sum through the divide.
__device__ __forceinline__ bool fast_adc(float lsb, float y, float s_max) {
  return lsb >= 1.17549435e-38f && lsb <= 3.40282347e38f &&
         __fmul_rn(s_max, y) < FAST_LIMIT;
}

// ---- counter-based normals (kernels/analog_readout/ref.py chunk_normals)
__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix32(uint32_t h, uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  h = rotl32(h ^ k, 13);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// pair_key = mix32(seed, pair)
__device__ __forceinline__ float chunk_normal(uint32_t pair_key, uint32_t c,
                                              uint32_t row, uint32_t col) {
  const uint32_t h = mix32(mix32(mix32(pair_key, c), row), col);
  const uint32_t h1 = fmix32(mix32(h, 1u));
  const uint32_t h2 = fmix32(mix32(h, 2u));
  const float step = 5.9604644775390625e-08f;  // 2^-24
  const float u1 = __fmul_rn((float)((h1 >> 8) + 1u), step);  // (0, 1]
  const float u2 = __fmul_rn((float)(h2 >> 8), step);         // [0, 1)
  const float r = sqrtf(__fmul_rn(logf(u1), -2.0f));
  return __fmul_rn(r, cosf(__fmul_rn(u2, 6.283185307179586f)));
}

// ===========================================================================
// ROUTE_SIMT: the CUDA-core kernel
// ===========================================================================
namespace simt {

constexpr int BM = 64;           // output rows per block
constexpr int BN = 64;           // output columns per block
constexpr int BK = 32;           // K per shared-memory step (a multiple of
                                 // every unrolled chunk)
constexpr int TM = 4;            // rows per thread
constexpr int TN = 4;            // columns per thread
constexpr int THREADS = 256;     // 16 x 16 threads, TM x TN outputs each
constexpr int SROW_A = BM + 4;   // smem row strides in floats (16-byte rows)
constexpr int SROW_W = BN + 4;
static_assert((BM / TM) * (BN / TN) == THREADS, "thread tile");
static_assert(BM * BK == THREADS * 8 && BK * BN == THREADS * 8,
              "tile staging: 8 bytes per thread per plane");

// 8 consecutive bytes A[m, k:k+8] of one plane as floats, zero outside
// [0, M) x [0, K).
__device__ __forceinline__ void load8(float (&v)[8],
                                      const int8_t* __restrict__ row_ptr,
                                      bool row_ok, int k, int K, bool vec) {
  if (row_ok && vec && k + 7 < K) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(row_ptr + k));
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      v[b] = (float)(int8_t)(raw.x >> (8 * b));
      v[4 + b] = (float)(int8_t)(raw.y >> (8 * b));
    }
    return;
  }
#pragma unroll
  for (int b = 0; b < 8; ++b)
    v[b] = (row_ok && k + b < K) ? (float)row_ptr[k + b] : 0.0f;
}

template <bool READOUT, bool NOISE, int CHUNK>
__global__ void __launch_bounds__(THREADS)
    analog_simt_kernel(const Args args, int n_tiles_n) {
  __shared__ __align__(16) float As[BK][SROW_A];  // As[k][m]
  __shared__ __align__(16) float Ws[BK][SROW_W];  // Ws[k][n]
  __shared__ float warp_max[THREADS / 32];

  const int M = args.m, KA = args.ka, N = args.n;
  const int chunk = CHUNK > 0 ? CHUNK : args.chunk;
  // chunks wholly past Ka have s = 0 and are skipped (Kw % chunk == 0)
  const int K = (KA + chunk - 1) / chunk * chunk;
  const int tid = threadIdx.x, tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = (int)(blockIdx.x / n_tiles_n) * BM;
  const int n0 = (int)(blockIdx.x % n_tiles_n) * BN;
  const int row0 = m0 + ty * TM, col0 = n0 + tx * TN;
  // staging coordinates: A row a_r, K bytes a_kq*8..+8; W row w_k,
  // columns w_nq*8..+8
  const int a_r = tid % BM, a_kq = tid / BM;
  const int w_k = tid / (BN / 8), w_nq = tid % (BN / 8);
  const bool a_vec =
      (KA % 8 == 0) && (reinterpret_cast<uintptr_t>(args.a) % 8 == 0);
  const bool w_vec =
      (N % 8 == 0) && (reinterpret_cast<uintptr_t>(args.w) % 8 == 0);

  float lsb = 0.0f;
  if (READOUT) lsb = lsb_of(args);

  uint32_t acc[TM][TN];
  float vmax = 0.0f;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

  for (int d = 0; d < args.pa; ++d) {
    for (int e = 0; e < args.pw; ++e) {
      const int8_t* A = args.a + (size_t)d * M * KA;
      const int8_t* W = args.w + (size_t)e * args.k * N;
      const uint32_t pair_key =
          NOISE ? mix32(args.seed, (uint32_t)(d * args.pw + e)) : 0u;
      float s[TM][TN], p[TM][TN];
      uint32_t q[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] = 0.0f;
          p[i][j] = 0.0f;
          q[i][j] = 0u;
        }

      // one K index of the micro-tile's chunk sums (and squared sums)
      auto step = [&](int kk) {
        const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
        const float4 wv = *reinterpret_cast<const float4*>(&Ws[kk][tx * TN]);
        const float a[TM] = {av.x, av.y, av.z, av.w};
        const float w[TN] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            s[i][j] = fmaf(a[i], w[j], s[i][j]);
            if (NOISE)
              p[i][j] = fmaf(__fmul_rn(a[i], a[i]), __fmul_rn(w[j], w[j]),
                             p[i][j]);
          }
      };
      // the end of chunk c: noise, then the ADC (pass 2) or the range
      // (pass 1), for the 16 sums of the micro-tile
      auto convert = [&](int c) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            float v = s[i][j];
            if (NOISE)
              v = __fadd_rn(
                  v, __fmul_rn(__fmul_rn(args.sigma, sqrtf(p[i][j])),
                               chunk_normal(pair_key, (uint32_t)c,
                                            (uint32_t)(row0 + i),
                                            (uint32_t)(col0 + j))));
            if (READOUT) {
              // a zero sum has code 0 and skips the divide (see the top)
              const bool zero = v == 0.0f;
              const int code = __float2int_rn(__fdiv_rn(zero ? lsb : v, lsb));
              q[i][j] += zero ? 0u : (uint32_t)code;
            } else
              vmax = fmaxf(vmax, fabsf(v));
            s[i][j] = 0.0f;
            p[i][j] = 0.0f;
          }
      };

      int cidx = 0, cpos = 0;  // current chunk, position inside it
      for (int k0 = 0; k0 < K; k0 += BK) {
        float va[8], vw[8];
        load8(va, A + (size_t)(m0 + a_r) * KA, m0 + a_r < M, k0 + a_kq * 8,
              KA, a_vec);
        {
          const int kr = k0 + w_k, c = n0 + w_nq * 8;
          const int8_t* wrow = W + (size_t)kr * N;
          if (kr < K && w_vec && c + 7 < N) {
            const uint2 raw = __ldg(reinterpret_cast<const uint2*>(wrow + c));
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              vw[b] = (float)(int8_t)(raw.x >> (8 * b));
              vw[4 + b] = (float)(int8_t)(raw.y >> (8 * b));
            }
          } else {
#pragma unroll
            for (int b = 0; b < 8; ++b)
              vw[b] = (kr < K && c + b < N) ? (float)wrow[c + b] : 0.0f;
          }
        }
        __syncthreads();  // the previous tile is consumed
#pragma unroll
        for (int b = 0; b < 8; ++b) As[a_kq * 8 + b][a_r] = va[b];
        *reinterpret_cast<float4*>(&Ws[w_k][w_nq * 8]) =
            make_float4(vw[0], vw[1], vw[2], vw[3]);
        *reinterpret_cast<float4*>(&Ws[w_k][w_nq * 8 + 4]) =
            make_float4(vw[4], vw[5], vw[6], vw[7]);
        __syncthreads();

        const int kmax = min(BK, K - k0);
        if (CHUNK > 0) {
          // BK % CHUNK == 0 and K % CHUNK == 0: whole chunks per K step
          for (int kc = 0; kc < kmax; kc += CHUNK) {
#pragma unroll
            for (int qq = 0; qq < CHUNK; ++qq) step(kc + qq);
            convert(cidx++);
          }
        } else {
          for (int kk = 0; kk < kmax; ++kk) {
            step(kk);
            if (++cpos == chunk) {
              cpos = 0;
              convert(cidx++);
            }
          }
        }
      }
      if (READOUT) {
        const int shift = 4 * (d + e);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += q[i][j] << shift;
      }
    }
  }

  if (READOUT) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = row0 + i;
      if (row >= M) continue;
      const float a_s = args.a_scale[row];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = col0 + j;
        if (col >= N) continue;
        float f = __fmul_rn(
            __fmul_rn(__fmul_rn(__int2float_rn((int32_t)acc[i][j]), lsb),
                      a_s),
            args.w_scale[col]);
        if (args.bias != nullptr) f = __fadd_rn(f, args.bias[col]);
        args.out[(size_t)row * N + col] = f;
      }
    }
  } else {
    // block max, then one atomic on the float's bits (all values >= 0)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
    if ((tid & 31) == 0) warp_max[tid >> 5] = vmax;
    __syncthreads();
    if (tid == 0) {
      float bmax = warp_max[0];
#pragma unroll
      for (int i = 1; i < THREADS / 32; ++i) bmax = fmaxf(bmax, warp_max[i]);
      if (bmax > 0.0f)
        atomicMax(reinterpret_cast<unsigned int*>(args.fs),
                  __float_as_uint(bmax));
    }
  }
}

template <bool READOUT, bool NOISE, int CHUNK>
cudaError_t launch(const Args& args, cudaStream_t stream) {
  const long long n_tiles_n = (args.n + BN - 1) / BN;
  const long long tiles = n_tiles_n * ((args.m + BM - 1) / BM);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (tiles > 0)
    analog_simt_kernel<READOUT, NOISE, CHUNK>
        <<<(unsigned)tiles, THREADS, 0, stream>>>(args, (int)n_tiles_n);
  return cudaGetLastError();
}

template <bool READOUT, bool NOISE>
cudaError_t dispatch_chunk(const Args& args, cudaStream_t stream) {
  switch (args.chunk) {
    case 4:
      return launch<READOUT, NOISE, 4>(args, stream);
    case 8:
      return launch<READOUT, NOISE, 8>(args, stream);
    case 16:
      return launch<READOUT, NOISE, 16>(args, stream);
    default:
      return launch<READOUT, NOISE, 0>(args, stream);
  }
}

template <bool READOUT>
cudaError_t dispatch(const Args& args, bool noise, cudaStream_t stream) {
  return noise ? dispatch_chunk<READOUT, true>(args, stream)
               : dispatch_chunk<READOUT, false>(args, stream);
}

}  // namespace simt

// ===========================================================================
// ROUTE_MMA: chunk sums on the int8 tensor cores, the full-rate ADC
// ===========================================================================
namespace mma {

constexpr int WARPS_M = 4;       // warps along M
constexpr int WARPS_N = 2;       // warps along N
constexpr int MT = 2;            // 16-row MMA tiles per warp
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int BM = WARPS_M * MT * 16;  // 128 output rows per block
constexpr int BK = 32;           // K per stage: two k16 steps
constexpr int SROW = BK + 16;    // shared row stride in bytes (conflict-free
                                 // ldmatrix and B-word loads)
static_assert(BM * BK / 16 == THREADS, "one 16-byte A piece per thread");

// Geometry of one chunk length: a k16 step holds CPS chunks, an MMA's 8
// columns cover COLS output columns, a warp NT MMA tiles along N (64
// output columns a block, 32 at chunk 4), a block BN output columns; a
// lane keeps NV code sums per MMA tile (32 in all).
template <int CHUNK>
struct Geo {
  static constexpr int CPS = 16 / CHUNK;
  static constexpr int COLS = 8 / CPS;
  static constexpr int NT = 32 / COLS < 8 ? 32 / COLS : 8;
  static constexpr int BN = WARPS_N * NT * COLS;
  static constexpr int NV = CPS == 1 ? 4 : 2;
  // chunk sums each code sum takes per k16 step
  static constexpr uint32_t PER_STEP = CPS == 1 ? 1u : 2u;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// D = A (16x16 s8, row) * B (16x8 s8, col) + C, int32
__device__ __forceinline__ void mma_s8_k16(uint32_t (&d)[4], uint32_t a0,
                                           uint32_t a1, uint32_t b,
                                           uint32_t c) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%7,%7,%7};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "r"(c));
}

// 16 consecutive bytes p[0..15] of one row, zero at and beyond `valid`
__device__ __forceinline__ uint4 load16_masked(const int8_t* p, int valid) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < valid) v[b >> 2] |= (uint32_t)(uint8_t)p[b] << (8 * (b & 3));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// r[i] holds bytes (i, 0..3) of a 4x4 byte block; o[j] gets bytes
// (0..3, j): column j of the block packed row-first.
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4],
                                             uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// The 4x4 bytes W[k:k+4, n:n+4] of one plane, transposed: o[j] packs
// W[k+i, n+j] for i = 0..3 into byte i (four K-consecutive values of
// column n+j, a B fragment's register); zero outside [0, K) x [0, N).
__device__ __forceinline__ void load_w_block(uint32_t (&o)[4],
                                             const int8_t* __restrict__ w,
                                             int k, int n, int K, int N,
                                             bool vec) {
  if (vec && n < N && k + 3 < K) {  // vec: N % 4 == 0, so n + 3 < N
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = __ldg(reinterpret_cast<const unsigned int*>(
          w + (size_t)(k + i) * N + n));
    transpose4x4(r, o);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k + i < K && n + j < N)
        o[j] |= (uint32_t)(uint8_t)w[(size_t)(k + i) * N + n + j]
                << (8 * i);
}

template <bool READOUT, int CHUNK, int PA, int PW>
__global__ void __launch_bounds__(THREADS, 2)
    analog_mma_kernel(const Args args, int n_tiles_n) {
  using G = Geo<CHUNK>;
  constexpr int BN = G::BN;
  constexpr int A_BYTES = PA * BM * SROW;
  constexpr int W_BYTES = PW * BN * SROW;
  constexpr int STAGE = A_BYTES + W_BYTES;
  constexpr int W_BLOCKS = PW * (BK / 4) * (BN / 4);  // 4x4 blocks a stage
  static_assert(W_BLOCKS <= THREADS, "one W block per thread");
  __shared__ __align__(16) int8_t smem[2 * STAGE];
  __shared__ int warp_max[THREADS / 32];

  const int M = args.m, KA = args.ka, KW = args.k, N = args.n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int m0 = (int)(blockIdx.x / n_tiles_n) * BM;
  const int n0 = (int)(blockIdx.x % n_tiles_n) * BN;
  // K stops at Ka: later chunks are all zero. n_k stages, n_steps k16
  // steps (the last stage's second step is skipped when wholly past Ka)
  const int n_k = (KA + BK - 1) / BK;
  const int n_steps = (KA + 15) / 16;

  // A staging: row a_r, bytes a_kq*16..+16 of each plane
  const int a_r = tid >> 1, a_kq = tid & 1;
  const bool a_vec =
      (KA % 16 == 0) && (reinterpret_cast<uintptr_t>(args.a) % 16 == 0);
  // W staging: plane w_e, the 4x4 block at K w_kb*4, columns w_nb*4
  const bool w_stager = tid < W_BLOCKS;
  const int w_e = tid / ((BK / 4) * (BN / 4));
  const int w_kb = (tid % ((BK / 4) * (BN / 4))) / (BN / 4);
  const int w_nb = tid % (BN / 4);
  const bool w_vec =
      (N % 4 == 0) && (reinterpret_cast<uintptr_t>(args.w) % 4 == 0);

  auto a_stage = [&](int s) { return smem + s * STAGE; };
  auto w_stage = [&](int s) { return smem + s * STAGE + A_BYTES; };

  // issue tile kt's A copies into stage s (cp.async, or plain loads
  // returned in `ra` where K is not 16-byte aligned)
  auto load_a = [&](int kt, int s, uint4 (&ra)[PA]) {
    const int row = m0 + a_r, k = kt * BK + a_kq * 16;
#pragma unroll
    for (int d = 0; d < PA; ++d) {
      const int8_t* src = args.a + ((size_t)d * M + row) * KA + k;
      int8_t* dst = a_stage(s) + (d * BM + a_r) * SROW + a_kq * 16;
      if (a_vec) {
        const bool ok = row < M && k < KA;
        cp_async16(dst, ok ? src : args.a, ok);
      } else {
        ra[d] = row < M && k < KA ? load16_masked(src, KA - k)
                                  : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  auto store_a = [&](int s, const uint4 (&ra)[PA]) {
    if (a_vec) return;
#pragma unroll
    for (int d = 0; d < PA; ++d)
      *reinterpret_cast<uint4*>(a_stage(s) + (d * BM + a_r) * SROW +
                                a_kq * 16) = ra[d];
  };
  auto load_w = [&](int kt, uint32_t (&rw)[4]) {
    if (w_stager)
      load_w_block(rw, args.w + (size_t)w_e * KW * N, kt * BK + w_kb * 4,
                   n0 + w_nb * 4, KW, N, w_vec);
  };
  auto store_w = [&](int s, const uint32_t (&rw)[4]) {
    if (!w_stager) return;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(w_stage(s) +
                                   (w_e * BN + w_nb * 4 + j) * SROW +
                                   w_kb * 4) = rw[j];
  };

  float lsb = 0.0f, y = 0.0f;
  bool fast = true;
  if (READOUT) {
    lsb = lsb_of(args);
    y = __frcp_rn(lsb);
    fast = fast_adc(lsb, y, (float)(CHUNK * 128 * 128));
  }
  // the MMA's C: 1.5 * 2^23 as float bits for the ADC, 0 for the range
  const uint32_t c_init = READOUT ? MAGIC_BITS : 0u;
  // this lane's B column j = g: output column g / CPS, chunk g % CPS of
  // the step; its bytes k = 4 tig..4 tig + 3 lie in chunk 4 tig / CHUNK
  const bool b_on = (4 * tig) / CHUNK == g % G::CPS;
  const int b_col = wn * G::NT * G::COLS + g / G::CPS;  // + ni * COLS

  uint32_t acc[MT][G::NT][G::NV];
  int vmax = 0, vmin = 0;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NT; ++ni)
#pragma unroll
      for (int v = 0; v < G::NV; ++v) acc[mi][ni][v] = 0u;

  // stage s holding tile kt: its k16 steps below Ka, every plane pair, MMA
  // tile and chunk sum; FAST: the block's ADC takes adc_fast (fast_adc)
  auto compute = [&](int s, int kt, auto fast_c) {
    constexpr bool FAST = decltype(fast_c)::value;
    uint32_t af[PA][MT][4];
#pragma unroll
    for (int d = 0; d < PA; ++d)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int q = lane >> 3;  // ldmatrix: lane's matrix and row
        ldmatrix_x4(af[d][mi],
                    a_stage(s) +
                        (d * BM + wm * MT * 16 + mi * 16 + (q & 1) * 8 +
                         (lane & 7)) * SROW + (q >> 1) * 16);
      }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (kt * (BK / 16) + kk >= n_steps) break;
      uint32_t bf[PW][G::NT];
#pragma unroll
      for (int e = 0; e < PW; ++e)
#pragma unroll
        for (int ni = 0; ni < G::NT; ++ni) {
          const uint32_t word = *reinterpret_cast<const uint32_t*>(
              w_stage(s) + (e * BN + b_col + ni * G::COLS) * SROW +
              kk * 16 + tig * 4);
          bf[e][ni] = b_on ? word : 0u;
        }
#pragma unroll
      for (int d = 0; d < PA; ++d)
#pragma unroll
        for (int e = 0; e < PW; ++e)
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int ni = 0; ni < G::NT; ++ni) {
              uint32_t x[4];
              mma_s8_k16(x, af[d][mi][2 * kk], af[d][mi][2 * kk + 1],
                         bf[e][ni], c_init);
              if (READOUT) {
                uint32_t code[4];
#pragma unroll
                for (int v = 0; v < 4; ++v)
                  code[v] = FAST ? adc_fast(x[v], lsb, y)
                                 : adc_exact(x[v], lsb);
                const int shift = 4 * (d + e);
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                  // CPS == 1: a code sum per entry; else entries v and
                  // v + 1 (same row, chunks of one column) share one
                  const int slot = G::CPS == 1 ? v : v >> 1;
                  acc[mi][ni][slot] += code[v] << shift;
                }
              } else {
                vmax = __vimax3_s32(vmax, (int)x[0], (int)x[1]);
                vmax = __vimax3_s32(vmax, (int)x[2], (int)x[3]);
                vmin = __vimin3_s32(vmin, (int)x[0], (int)x[1]);
                vmin = __vimin3_s32(vmin, (int)x[2], (int)x[3]);
              }
            }
    }
  };

  // the K loop through the two-stage ring
  auto k_loop = [&](auto fast_c) {
    uint4 ra[PA];
    uint32_t rw[4];
    load_a(0, 0, ra);
    cp_async_commit();
    load_w(0, rw);
    store_a(0, ra);
    store_w(0, rw);
    cp_async_wait_all();
    __syncthreads();
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt & 1;
      const bool next = kt + 1 < n_k;
      if (next) {  // tile kt + 1 into the other stage while computing
        load_a(kt + 1, s ^ 1, ra);
        cp_async_commit();
        load_w(kt + 1, rw);
      }
      compute(s, kt, fast_c);
      if (next) {
        store_a(s ^ 1, ra);
        store_w(s ^ 1, rw);
      }
      cp_async_wait_all();
      __syncthreads();
    }
  };
  if (n_k > 0) {
    // the dividing K loop is compiled only for the readout pass: the
    // ranging pass has no ADC
    if constexpr (!READOUT)
      k_loop(std::true_type{});
    else if (fast)
      k_loop(std::true_type{});
    else
      k_loop(std::false_type{});
  }

  if (READOUT) {
    // take off the constant 1.5 * 2^23 each code carried in: every code
    // sum took PER_STEP chunk sums per k16 step of every plane pair
    uint32_t magic = 0u;
#pragma unroll
    for (int d = 0; d < PA; ++d)
#pragma unroll
      for (int e = 0; e < PW; ++e) magic += MAGIC_BITS << (4 * (d + e));
    const uint32_t off = magic * (G::PER_STEP * (uint32_t)n_steps);
    const int col_base = n0 + wn * G::NT * G::COLS;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < G::NT; ++ni)
#pragma unroll
        for (int v = 0; v < G::NV; ++v) {
          uint32_t total = acc[mi][ni][v] - off;
          int row, col;
          bool mine = true;
          if (G::CPS == 1) {
            row = g + 8 * (v >> 1);
            col = ni * 8 + 2 * tig + (v & 1);
          } else if (G::CPS == 2) {
            row = g + 8 * v;
            col = ni * 4 + tig;
          } else {  // lanes tig, tig ^ 1 hold the two halves of a column
            total += __shfl_xor_sync(0xffffffffu, total, 1);
            row = g + 8 * v;
            col = ni * 2 + (tig >> 1);
            mine = (tig & 1) == 0;
          }
          row += m0 + wm * MT * 16 + mi * 16;
          col += col_base;
          if (!mine || row >= M || col >= N) continue;
          float f = __fmul_rn(
              __fmul_rn(__fmul_rn(__int2float_rn((int32_t)total), lsb),
                        args.a_scale[row]),
              args.w_scale[col]);
          if (args.bias != nullptr) f = __fadd_rn(f, args.bias[col]);
          args.out[(size_t)row * N + col] = f;
        }
  } else {
    // block max of |s|, then one atomic on the float's bits (values >= 0;
    // |s| < 2^22, so the float is exact)
    int vabs = max(vmax, -vmin);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      vabs = max(vabs, __shfl_xor_sync(0xffffffffu, vabs, o));
    if (lane == 0) warp_max[warp] = vabs;
    __syncthreads();
    if (tid == 0) {
      int bmax = warp_max[0];
#pragma unroll
      for (int i = 1; i < THREADS / 32; ++i) bmax = max(bmax, warp_max[i]);
      if (bmax > 0)
        atomicMax(reinterpret_cast<unsigned int*>(args.fs),
                  __float_as_uint((float)bmax));
    }
  }
}

template <bool READOUT, int CHUNK, int PA, int PW>
cudaError_t launch(const Args& args, cudaStream_t stream) {
  constexpr int BN = Geo<CHUNK>::BN;
  const long long n_tiles_n = (args.n + BN - 1) / BN;
  const long long tiles = n_tiles_n * ((args.m + BM - 1) / BM);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (tiles > 0)
    analog_mma_kernel<READOUT, CHUNK, PA, PW>
        <<<(unsigned)tiles, THREADS, 0, stream>>>(args, (int)n_tiles_n);
  return cudaGetLastError();
}

template <bool READOUT, int CHUNK>
cudaError_t dispatch_planes(const Args& args, cudaStream_t stream) {
  if (args.pa == 1)
    return args.pw == 1 ? launch<READOUT, CHUNK, 1, 1>(args, stream)
                        : launch<READOUT, CHUNK, 1, 2>(args, stream);
  return args.pw == 1 ? launch<READOUT, CHUNK, 2, 1>(args, stream)
                      : launch<READOUT, CHUNK, 2, 2>(args, stream);
}

template <bool READOUT>
cudaError_t dispatch(const Args& args, cudaStream_t stream) {
  switch (args.chunk) {
    case 4:
      return dispatch_planes<READOUT, 4>(args, stream);
    case 8:
      return dispatch_planes<READOUT, 8>(args, stream);
    case 16:
      return dispatch_planes<READOUT, 16>(args, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace mma

// The ADC of the tensor-core route against the IEEE divide, for every
// integer s in [lo, lo + count): counts[0] += chunk sums where
// quotient_rn differs from __fdiv_rn(s, lsb) or, where |s / lsb| < 2^21,
// adc_fast's code from __float2int_rn(__fdiv_rn(s, lsb)); counts[1] +=
// the chunk sums in that range (whose codes the magic add rounds).
__global__ void adc_check_kernel(float lsb, int lo, long long count,
                                 unsigned long long* counts) {
  const float y = __frcp_rn(lsb);
  unsigned long long bad = 0, rounded = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x) {
    const int s = lo + (int)i;
    const float want_q = __fdiv_rn((float)s, lsb);
    bad += __float_as_uint(quotient_rn((float)s, lsb, y)) !=
           __float_as_uint(want_q);
    if (fabsf(want_q) < FAST_LIMIT) {
      ++rounded;
      bad += adc_fast((uint32_t)s + MAGIC_BITS, lsb, y) !=
             (uint32_t)__float2int_rn(want_q) + MAGIC_BITS;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    bad += __shfl_xor_sync(0xffffffffu, bad, o);
    rounded += __shfl_xor_sync(0xffffffffu, rounded, o);
  }
  if ((threadIdx.x & 31) == 0) {
    if (bad) atomicAdd(counts, bad);
    if (rounded) atomicAdd(counts + 1, rounded);
  }
}

template <bool READOUT>
cudaError_t run(const Args& args, bool noise, int route,
                cudaStream_t stream) {
  if (args.pa < 1 || args.pa > 2 || args.pw < 1 || args.pw > 2 ||
      args.chunk < 1 || args.k % args.chunk != 0 || args.ka < 0 ||
      args.ka > args.k)
    return cudaErrorInvalidValue;
  if (route == ROUTE_MMA) {
    if (noise) return cudaErrorInvalidValue;
    return mma::dispatch<READOUT>(args, stream);
  }
  if (route != ROUTE_SIMT) return cudaErrorInvalidValue;
  return simt::dispatch<READOUT>(args, noise, stream);
}

Args make_args(const void* a, const void* w, const void* a_scale,
               const void* w_scale, const void* bias, void* fs, void* out,
               int pa, int pw, int m, int ka, int k, int n, int chunk,
               float inv_half, float floor, unsigned int seed, float sigma) {
  Args args;
  args.a = static_cast<const int8_t*>(a);
  args.w = static_cast<const int8_t*>(w);
  args.a_scale = static_cast<const float*>(a_scale);
  args.w_scale = static_cast<const float*>(w_scale);
  args.bias = static_cast<const float*>(bias);
  args.fs = static_cast<float*>(fs);
  args.out = static_cast<float*>(out);
  args.pa = pa;
  args.pw = pw;
  args.m = m;
  args.ka = ka;
  args.k = k;
  args.n = n;
  args.chunk = chunk;
  args.inv_half = inv_half;
  args.floor = floor;
  args.seed = seed;
  args.sigma = sigma;
  return args;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Pass 1: max |chunk sum (+ noise)| into *fs (one float, zeroed by the
// caller). a (pa, m, ka), w (pw, k, n), ka <= k, k a multiple of chunk;
// route 0 = tensor cores (chunk 4, 8 or 16, no noise), 1 = CUDA cores.
// Returns cudaGetLastError() after the launch.
int analog_fullscale(const void* a, const void* w, void* fs, int pa, int pw,
                     int m, int ka, int k, int n, int chunk, int noise,
                     unsigned int seed, float sigma, int route,
                     void* stream) {
  const Args args = make_args(a, w, nullptr, nullptr, nullptr, fs, nullptr,
                              pa, pw, m, ka, k, n, chunk, 0.0f, 0.0f, seed,
                              sigma);
  return run<false>(args, noise != 0, route,
                    static_cast<cudaStream_t>(stream));
}

// Pass 2: reads *fs, writes the (M, N) float32 readout; bias (N,) may be
// null. Shapes and routes as for pass 1. Returns cudaGetLastError() after
// the launch.
int analog_readout(const void* a, const void* w, const void* a_scale,
                   const void* w_scale, const void* bias, const void* fs,
                   void* out, int pa, int pw, int m, int ka, int k, int n,
                   int chunk, float inv_half, float floor, int noise,
                   unsigned int seed, float sigma, int route, void* stream) {
  const Args args = make_args(a, w, a_scale, w_scale, bias,
                              const_cast<void*>(fs), out, pa, pw, m, ka, k, n,
                              chunk, inv_half, floor, seed, sigma);
  return run<true>(args, noise != 0, route,
                   static_cast<cudaStream_t>(stream));
}

// Yardsticks: the CUDA-core kernel at any chunk, with or without noise.
int analog_fullscale_simt(const void* a, const void* w, void* fs, int pa,
                          int pw, int m, int ka, int k, int n, int chunk,
                          int noise, unsigned int seed, float sigma,
                          void* stream) {
  return analog_fullscale(a, w, fs, pa, pw, m, ka, k, n, chunk, noise, seed,
                          sigma, ROUTE_SIMT, stream);
}

int analog_readout_simt(const void* a, const void* w, const void* a_scale,
                        const void* w_scale, const void* bias, const void* fs,
                        void* out, int pa, int pw, int m, int ka, int k,
                        int n, int chunk, float inv_half, float floor,
                        int noise, unsigned int seed, float sigma,
                        void* stream) {
  return analog_readout(a, w, a_scale, w_scale, bias, fs, out, pa, pw, m, ka,
                        k, n, chunk, inv_half, floor, noise, seed, sigma,
                        ROUTE_SIMT, stream);
}

// The tensor-core route's ADC against the IEEE divide for every integer
// s in [lo, hi] at one lsb; counts (2,) uint64, zeroed by the caller.
int analog_adc_check(float lsb, int lo, int hi, void* counts,
                     void* stream) {
  if (hi < lo || lo < -(1 << 22) || hi > (1 << 22))
    return cudaErrorInvalidValue;
  adc_check_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      lsb, lo, (long long)hi - lo + 1,
      static_cast<unsigned long long*>(counts));
  return cudaGetLastError();
}

}  // extern "C"
