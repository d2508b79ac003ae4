// The OPIMA analog readout chain for Hopper (sm_90a): two passes over the
// int8 nibble planes, the auto-ranging pass and the readout pass.
//
// Replaces the TPU kernels in src/repro/kernels/analog_readout/analog_readout.py:
//   analog_fullscale_pallas / _fullscale_kernel  -> analog_fullscale()
//   analog_readout_pallas   / _readout_kernel    -> analog_readout()
//
// For digit planes A (PA, M, K) and W (PW, K, N) and a WDM chunk of `chunk`
// products (K a multiple of chunk; chunk boundaries are absolute), every
// plane pair (d, e), chunk c, row m and column n has a chunk sum
//   s = sum_{q < chunk} A[d, m, c*chunk + q] * W[e, c*chunk + q, n]
// (an exact small integer in float32), with optional transmission noise
//   s + (sigma * sqrtf(sum_q A^2 W^2)) * z(seed, d*PW + e, c, m, n).
// Pass 1 writes max |s| over everything into one device word (zeroed by
// the caller). Pass 2 reads it, forms lsb = max(fs, 1e-6) * (1/half_levels)
// on the card, converts every chunk sum into an ADC code
// rint(s / lsb) (IEEE divide, round half to even), sums the codes per pair
// in integers, shift-adds the pairs by 16^(d+e) in uint32 and writes
//   ((float(acc) * lsb) * a_scale[m]) * w_scale[n] (+ bias[n]).
// z is a counter-based normal: a murmur3-style hash of
// (seed, pair, chunk, row, column) and Box-Muller; the key does not depend
// on tiling, so both passes draw the same normal for the same chunk sum,
// and kernels/analog_readout/ref.py evaluates the same function.
//
// What bounds it on an H100: not the bytes and not the multiply-adds but
// the ADC. The readout pass converts one chunk sum per (pair, chunk, row,
// column): Pa*Pw*M*N*K/chunk conversions, each an IEEE divide (a MUFU
// reciprocal plus a few FMAs and a range check) and a float-to-int
// conversion, ~1.1e9 of them for one w4a4 ResNet18 stage-0 layer at batch
// 128. On the CNN path 30-50% of the chunk sums are exactly zero (ReLU
// zeros, padded K), and a zero numerator makes the divide take its slow
// path, for the whole warp; so a zero sum takes code 0 without dividing
// (exact: rint(0 / lsb) = 0), which more than halves the readout pass on
// ResNet18. A chunk of 8 is also shorter than any int8 tensor-core product
// (mma.sync needs k >= 16, wgmma 32 bytes), which would add two chunks
// together before the ADC sees them.
//
// What the design does about it: the chunk sums are formed on the CUDA
// cores with float FMAs (exact: |digit| <= 15, so every partial sum is an
// integer far below 2^24), from tiles staged once per K step in shared
// memory as floats, so the inner loop is two 16-byte shared loads and 16
// FMAs per K index for a 4x4 micro-tile per thread. After each chunk the
// thread converts its 16 sums at once. Codes accumulate in integer
// registers, so the result does not depend on the order of the chunks.
// A 2-D grid of 64x64 output tiles, each block looping over K with
// nothing carried between blocks; pass 1 reduces its block's max in the
// block and does one atomicMax on the float's bits (values are >= 0, so
// unsigned order is float order, and the result is order-free).
// Chunks of 4, 8 and 16 are compiled with the chunk loop unrolled; any
// other chunk takes a generic loop that carries a partial chunk across K
// steps. Ragged M, N and K are masked in the loads and stores.
//
// Bit-exactness: the divide is __fdiv_rn, never __fdividef; the epilogue
// and the noise term use __fmul_rn / __fadd_rn so nvcc cannot contract
// them into FMAs. Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

struct Args {
  const int8_t* a;
  const int8_t* w;
  const float* a_scale;
  const float* w_scale;
  const float* bias;
  float* fs;                     // the full-scale word
  float* out;
  int pa, pw, m, k, n, chunk;
  float inv_half;                // 1 / half_levels(adc_bits), as float
  float floor;                   // full-scale floor (1e-6)
  uint32_t seed;
  float sigma;
};

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
    analog_kernel(const Args args, int n_tiles_n) {
  __shared__ __align__(16) float As[BK][SROW_A];  // As[k][m]
  __shared__ __align__(16) float Ws[BK][SROW_W];  // Ws[k][n]
  __shared__ float warp_max[THREADS / 32];

  const int M = args.m, K = args.k, N = args.n;
  const int chunk = CHUNK > 0 ? CHUNK : args.chunk;
  const int tid = threadIdx.x, tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = (int)(blockIdx.x / n_tiles_n) * BM;
  const int n0 = (int)(blockIdx.x % n_tiles_n) * BN;
  const int row0 = m0 + ty * TM, col0 = n0 + tx * TN;
  // staging coordinates: A row a_r, K bytes a_kq*8..+8; W row w_k,
  // columns w_nq*8..+8
  const int a_r = tid % BM, a_kq = tid / BM;
  const int w_k = tid / (BN / 8), w_nq = tid % (BN / 8);
  const bool a_vec =
      (K % 8 == 0) && (reinterpret_cast<uintptr_t>(args.a) % 8 == 0);
  const bool w_vec =
      (N % 8 == 0) && (reinterpret_cast<uintptr_t>(args.w) % 8 == 0);

  float lsb = 0.0f;
  if (READOUT) lsb = __fmul_rn(fmaxf(*args.fs, args.floor), args.inv_half);

  uint32_t acc[TM][TN];
  float vmax = 0.0f;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

  for (int d = 0; d < args.pa; ++d) {
    for (int e = 0; e < args.pw; ++e) {
      const int8_t* A = args.a + (size_t)d * M * K;
      const int8_t* W = args.w + (size_t)e * K * N;
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
        load8(va, A + (size_t)(m0 + a_r) * K, m0 + a_r < M, k0 + a_kq * 8, K,
              a_vec);
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
    analog_kernel<READOUT, NOISE, CHUNK>
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
  if (args.pa < 1 || args.pa > 2 || args.pw < 1 || args.pw > 2 ||
      args.chunk < 1 || args.k % args.chunk != 0)
    return cudaErrorInvalidValue;
  return noise ? dispatch_chunk<READOUT, true>(args, stream)
               : dispatch_chunk<READOUT, false>(args, stream);
}

Args make_args(const void* a, const void* w, const void* a_scale,
               const void* w_scale, const void* bias, void* fs, void* out,
               int pa, int pw, int m, int k, int n, int chunk, float inv_half,
               float floor, unsigned int seed, float sigma) {
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
// caller). Returns cudaGetLastError() after the launch.
int analog_fullscale(const void* a, const void* w, void* fs, int pa, int pw,
                     int m, int k, int n, int chunk, int noise,
                     unsigned int seed, float sigma, void* stream) {
  const Args args = make_args(a, w, nullptr, nullptr, nullptr, fs, nullptr,
                              pa, pw, m, k, n, chunk, 0.0f, 0.0f, seed,
                              sigma);
  return dispatch<false>(args, noise != 0, static_cast<cudaStream_t>(stream));
}

// Pass 2: reads *fs, writes the (M, N) float32 readout; bias (N,) may be
// null. Returns cudaGetLastError() after the launch.
int analog_readout(const void* a, const void* w, const void* a_scale,
                   const void* w_scale, const void* bias, const void* fs,
                   void* out, int pa, int pw, int m, int k, int n, int chunk,
                   float inv_half, float floor, int noise, unsigned int seed,
                   float sigma, void* stream) {
  const Args args = make_args(a, w, a_scale, w_scale, bias,
                              const_cast<void*>(fs), out, pa, pw, m, k, n,
                              chunk, inv_half, floor, seed, sigma);
  return dispatch<true>(args, noise != 0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
