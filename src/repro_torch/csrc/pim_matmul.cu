// Bit-sliced (nibble-plane) integer matmul for Hopper (sm_90a), with the
// aggregation unit's fused dequantization epilogue.
//
// Replaces the TPU kernels in src/repro/kernels/pim_matmul/pim_matmul.py:
//   pim_matmul_fused_pallas / _pim_matmul_fused_kernel  (EPI = kDequant)
//   pim_matmul_pallas       / _pim_matmul_kernel        (EPI = kRawInt32)
//
// It computes, for int8 digit planes A (PA, M, K) and W (PW, K, N),
//   acc[m, n] = sum_{d,e} 16^(d+e) * sum_k A[d, m, k] * W[e, k, n]
// modulo 2^32, then either writes acc as int32 or the float32
//   ((float(acc) * a_scale[m]) * w_scale[n]) (+ bias[n])
// and, on request, the int32 row-sums of acc (the ABFT input).
//
// What bounds it on an H100: at w4a4 the convolution layers of the CNN
// path have M in the tens of thousands, K up to a few thousand and N of
// 64..512, so the int8 activation planes (M*K bytes per plane) and the
// float32 output (4*M*N bytes) dominate the traffic. With N = 64 a layer
// does ~128 int8 operations per byte moved, below the card's ~590
// (1979 TOPS / 3.35 TB/s): the early layers are bound by device memory,
// the last stage (N = 512, K = 4608) by int8 tensor-core throughput.
//
// What the design does about it: a 2-D grid over (M, N) output tiles,
// each block looping over K with nothing carried between blocks. Every
// block stages its A and W tiles in shared memory once per K step (W is
// transposed on the way, so both MMA operands are K-contiguous) and
// prefetches the next K step into registers while the tensor cores work
// on the current one. Each plane pair is multiplied on the int8 tensor
// cores (mma.sync m16n8k32 s8*s8->s32) into one accumulator per shift
// level d+e, so the shift-and-add runs once per output, in the epilogue,
// in uint32 (wraparound is defined there; signed overflow is not). The
// output is written once, straight from registers. Ragged M, N and K are
// masked in the loads and stores: the caller pads nothing.
//
// The epilogue uses __fmul_rn / __fadd_rn so that nvcc cannot contract
// the bias add into an FMA: the result equals the plain PyTorch version
// (two roundings) bit for bit. Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // output rows per block
constexpr int BN = 64;           // output columns per block
constexpr int BK = 64;           // K per shared-memory step
constexpr int THREADS = 256;     // 8 warps: 4 down M x 2 across N
constexpr int SROW = BK + 16;    // smem row stride in bytes: 20 words,
                                 // conflict-free fragment loads
constexpr int WARP_M = 32;
constexpr int WARP_N = 32;
constexpr int MI = WARP_M / 16;  // m16 tiles per warp
constexpr int NI = WARP_N / 8;   // n8 tiles per warp
constexpr int A_CHUNKS = BM * BK / 16 / THREADS;  // 16-byte A chunks
constexpr int W_NQ = BN / 4;                      // 4x4-byte W chunks
static_assert(A_CHUNKS * THREADS * 16 == BM * BK, "A staging");
static_assert((BK / 4) * (BN / 4) == THREADS, "W staging: one chunk each");

enum Epilogue { kRawInt32 = 0, kDequant = 1 };

struct Args {
  const int8_t* a;
  const int8_t* w;
  const float* a_scale;
  const float* w_scale;
  const float* bias;
  void* out;
  int32_t* rowsum;
  int m, k, n;
  int a_vec;  // K % 16 == 0 and A 16-byte aligned: 16-byte loads
  int w_vec;  // N % 4 == 0 and W 4-byte aligned: 4-byte loads
};

__device__ __forceinline__ void mma_s8(uint32_t (&c)[4],
                                       const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 consecutive bytes A[m, k:k+16] of one plane; zero outside [0,M)x[0,K).
__device__ __forceinline__ uint4 load_a_chunk(const int8_t* __restrict__ a,
                                              int m, int k, int M, int K,
                                              bool vec) {
  if (m < M && k < K && vec)  // vec: K % 16 == 0, so k + 15 < K
    return __ldg(reinterpret_cast<const uint4*>(a + (size_t)m * K + k));
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  if (m < M) {
    const int8_t* row = a + (size_t)m * K;
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (k + b < K)
        v[b >> 2] |= (uint32_t)(uint8_t)row[k + b] << (8 * (b & 3));
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// The 4x4 bytes W[k:k+4, n:n+4] of one plane, transposed: o[j] packs
// W[k+i, n+j] for i = 0..3 into byte i, i.e. four K-consecutive values of
// column n+j, the layout the MMA's B operand reads.
__device__ __forceinline__ void load_w_chunk(uint32_t (&o)[4],
                                             const int8_t* __restrict__ w,
                                             int k, int n, int K, int N,
                                             bool vec) {
  if (vec && n < N && k + 3 < K) {  // vec: N % 4 == 0, so n + 3 < N
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = __ldg(reinterpret_cast<const unsigned int*>(
          w + (size_t)(k + i) * N + n));
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    o[0] = __byte_perm(t0, t2, 0x5410);
    o[1] = __byte_perm(t0, t2, 0x7632);
    o[2] = __byte_perm(t1, t3, 0x5410);
    o[3] = __byte_perm(t1, t3, 0x7632);
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

template <int PA, int PW, int EPI, bool HAS_BIAS, bool WANT_ROWSUM>
__global__ void __launch_bounds__(THREADS)
    pim_matmul_kernel(const Args args, int n_tiles_n) {
  constexpr int LEVELS = PA + PW - 1;  // shift levels d + e
  __shared__ __align__(16) int8_t As[PA][BM][SROW];
  __shared__ __align__(16) int8_t Bs[PW][BN][SROW];

  const int M = args.m, K = args.k, N = args.n;
  const int m0 = (int)(blockIdx.x / n_tiles_n) * BM;
  const int n0 = (int)(blockIdx.x % n_tiles_n) * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // MMA group / thread in group
  const int wm = (warp & 3) * WARP_M;
  const int wn = (warp >> 2) * WARP_N;
  const bool a_vec = args.a_vec != 0, w_vec = args.w_vec != 0;
  const size_t a_plane = (size_t)M * K, w_plane = (size_t)K * N;

  // staging coordinates: A chunk c -> row c / (BK/16), 16-byte column
  // c % (BK/16); W chunk -> (kq, nq), nq fastest for coalesced reads
  const int w_nq = tid % W_NQ, w_kq = tid / W_NQ;

  uint32_t acc[LEVELS][MI][NI][4];
#pragma unroll
  for (int s = 0; s < LEVELS; ++s)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[s][mi][ni][r] = 0u;

  uint4 ra[PA][A_CHUNKS];
  uint32_t rw[PW][4];

  auto fetch = [&](int k0) {
#pragma unroll
    for (int d = 0; d < PA; ++d)
#pragma unroll
      for (int i = 0; i < A_CHUNKS; ++i) {
        const int c = tid + i * THREADS;
        ra[d][i] = load_a_chunk(args.a + d * a_plane, m0 + c / (BK / 16),
                                k0 + (c % (BK / 16)) * 16, M, K, a_vec);
      }
#pragma unroll
    for (int e = 0; e < PW; ++e)
      load_w_chunk(rw[e], args.w + e * w_plane, k0 + 4 * w_kq,
                   n0 + 4 * w_nq, K, N, w_vec);
  };
  auto stash = [&]() {
#pragma unroll
    for (int d = 0; d < PA; ++d)
#pragma unroll
      for (int i = 0; i < A_CHUNKS; ++i) {
        const int c = tid + i * THREADS;
        *reinterpret_cast<uint4*>(
            &As[d][c / (BK / 16)][(c % (BK / 16)) * 16]) = ra[d][i];
      }
#pragma unroll
    for (int e = 0; e < PW; ++e)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(&Bs[e][4 * w_nq + j][4 * w_kq]) =
            rw[e][j];
  };

  const int n_k = (K + BK - 1) / BK;
  fetch(0);
  stash();
  __syncthreads();
  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) fetch((kt + 1) * BK);  // in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[PA][MI][4];
      uint32_t bf[PW][NI][2];
#pragma unroll
      for (int d = 0; d < PA; ++d)
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const int r = wm + mi * 16 + g;
          af[d][mi][0] = *reinterpret_cast<const uint32_t*>(
              &As[d][r][kk + t * 4]);
          af[d][mi][1] = *reinterpret_cast<const uint32_t*>(
              &As[d][r + 8][kk + t * 4]);
          af[d][mi][2] = *reinterpret_cast<const uint32_t*>(
              &As[d][r][kk + 16 + t * 4]);
          af[d][mi][3] = *reinterpret_cast<const uint32_t*>(
              &As[d][r + 8][kk + 16 + t * 4]);
        }
#pragma unroll
      for (int e = 0; e < PW; ++e)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int c = wn + ni * 8 + g;
          bf[e][ni][0] = *reinterpret_cast<const uint32_t*>(
              &Bs[e][c][kk + t * 4]);
          bf[e][ni][1] = *reinterpret_cast<const uint32_t*>(
              &Bs[e][c][kk + 16 + t * 4]);
        }
#pragma unroll
      for (int d = 0; d < PA; ++d)
#pragma unroll
        for (int e = 0; e < PW; ++e)
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int ni = 0; ni < NI; ++ni)
              mma_s8(acc[d + e][mi][ni], af[d][mi], bf[e][ni]);
    }
    __syncthreads();
    if (kt + 1 < n_k) {
      stash();
      __syncthreads();
    }
  }

  // epilogue: shift-and-add in uint32, then int32 out or dequantize
  uint32_t rs[MI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) rs[mi][0] = rs[mi][1] = 0u;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r >> 1;  // c0,c1: row g; c2,c3: row g + 8
        uint32_t v = 0u;
#pragma unroll
        for (int s = 0; s < LEVELS; ++s) v += acc[s][mi][ni][r] << (4 * s);
        const int row = m0 + wm + mi * 16 + g + 8 * h;
        const int col = n0 + wn + ni * 8 + t * 2 + (r & 1);
        if (col < N) {
          if (WANT_ROWSUM) rs[mi][h] += v;
          if (row < M) {
            const size_t o = (size_t)row * N + col;
            if (EPI == kRawInt32) {
              static_cast<int32_t*>(args.out)[o] = (int32_t)v;
            } else {
              float f = __fmul_rn(
                  __fmul_rn(__int2float_rn((int32_t)v), args.a_scale[row]),
                  args.w_scale[col]);
              if (HAS_BIAS) f = __fadd_rn(f, args.bias[col]);
              static_cast<float*>(args.out)[o] = f;
            }
          }
        }
      }
  if (WANT_ROWSUM) {
    // the 4 threads of a group hold one row's 8 columns per n8 tile;
    // wraparound addition is associative, so the atomics are exact
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v = rs[mi][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const int row = m0 + wm + mi * 16 + g + 8 * h;
        if (t == 0 && row < M)
          atomicAdd(reinterpret_cast<unsigned int*>(args.rowsum + row), v);
      }
  }
}

template <int PA, int PW, int EPI, bool HAS_BIAS, bool WANT_ROWSUM>
cudaError_t launch(const Args& args, cudaStream_t stream) {
  const long long n_tiles_n = (args.n + BN - 1) / BN;
  const long long tiles = n_tiles_n * ((args.m + BM - 1) / BM);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (tiles > 0)
    pim_matmul_kernel<PA, PW, EPI, HAS_BIAS, WANT_ROWSUM>
        <<<(unsigned)tiles, THREADS, 0, stream>>>(args, (int)n_tiles_n);
  return cudaGetLastError();
}

template <int EPI, bool HAS_BIAS, bool WANT_ROWSUM>
cudaError_t dispatch_planes(int pa, int pw, const Args& args,
                            cudaStream_t stream) {
  if (pa == 1 && pw == 1)
    return launch<1, 1, EPI, HAS_BIAS, WANT_ROWSUM>(args, stream);
  if (pa == 1 && pw == 2)
    return launch<1, 2, EPI, HAS_BIAS, WANT_ROWSUM>(args, stream);
  if (pa == 2 && pw == 1)
    return launch<2, 1, EPI, HAS_BIAS, WANT_ROWSUM>(args, stream);
  if (pa == 2 && pw == 2)
    return launch<2, 2, EPI, HAS_BIAS, WANT_ROWSUM>(args, stream);
  return cudaErrorInvalidValue;
}

Args make_args(const void* a, const void* w, const void* a_scale,
               const void* w_scale, const void* bias, void* out,
               void* rowsum, int m, int k, int n) {
  Args args;
  args.a = static_cast<const int8_t*>(a);
  args.w = static_cast<const int8_t*>(w);
  args.a_scale = static_cast<const float*>(a_scale);
  args.w_scale = static_cast<const float*>(w_scale);
  args.bias = static_cast<const float*>(bias);
  args.out = out;
  args.rowsum = static_cast<int32_t*>(rowsum);
  args.m = m;
  args.k = k;
  args.n = n;
  args.a_vec = (k % 16 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0);
  args.w_vec = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(w) % 4 == 0);
  return args;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// (PA, M, K) x (PW, K, N) int8 planes -> (M, N) float32 with the fused
// dequant epilogue; bias (N,) and rowsum (M,) int32 (zeroed by the caller)
// may be null. Returns cudaGetLastError() after the launch.
int pim_matmul_fused(const void* a, const void* w, const void* a_scale,
                     const void* w_scale, const void* bias, void* out,
                     void* rowsum, int pa, int pw, int m, int k, int n,
                     void* stream) {
  const Args args =
      make_args(a, w, a_scale, w_scale, bias, out, rowsum, m, k, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool has_bias = bias != nullptr, want_rowsum = rowsum != nullptr;
  if (has_bias && want_rowsum)
    return dispatch_planes<kDequant, true, true>(pa, pw, args, s);
  if (has_bias)
    return dispatch_planes<kDequant, true, false>(pa, pw, args, s);
  if (want_rowsum)
    return dispatch_planes<kDequant, false, true>(pa, pw, args, s);
  return dispatch_planes<kDequant, false, false>(pa, pw, args, s);
}

// The same accumulator written as raw (M, N) int32, no epilogue.
int pim_matmul_int(const void* a, const void* w, void* out, int pa, int pw,
                   int m, int k, int n, void* stream) {
  const Args args = make_args(a, w, nullptr, nullptr, nullptr, out, nullptr,
                              m, k, n);
  return dispatch_planes<kRawInt32, false, false>(
      pa, pw, args, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
