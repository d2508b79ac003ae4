// Bit-sliced (nibble-plane) integer matmul for Hopper (sm_90a), with the
// aggregation unit's fused dequantization epilogue.
//
// Replaces the TPU kernels in src/repro/kernels/pim_matmul/pim_matmul.py:
//   pim_matmul_fused_pallas / _pim_matmul_fused_kernel  (dequant epilogue)
//   pim_matmul_pallas       / _pim_matmul_kernel        (raw int32)
//
// It computes, for int8 digit planes A (PA, M, K) and W (PW, K, N),
//   acc[m, n] = sum_{d,e} 16^(d+e) * sum_k A[d, m, k] * W[e, k, n]
// modulo 2^32, then either writes acc as int32 or the float32
//   ((float(acc) * a_scale[m]) * w_scale[n]) (+ bias[n])
// and, on request, the int32 row-sums of acc (the ABFT input).
//
// Two routes of one function, chosen by M in the Python wrapper
// (kernels/pim_matmul/pim_matmul.py small_m_grid), which passes the
// strip width and the number of K splits here; strip 0 means the tiled
// route. Both give the same bits: wraparound addition is associative and
// commutative, so any split of K and any order of combining uint32
// partial sums is exact.
//
// Tiled route (M > 64: the CNN layers, LM prefill, ResNet18's fc at
// M = 128). What bounds it on an H100: the convolution layers have M in
// the tens of thousands, K up to a few thousand and N of 64..512; with
// N = 64 a layer does ~128 int8 operations per byte moved, below the
// card's ~590 (1979 TOPS / 3.35 TB/s), so the early layers are bound by
// device memory, the last stage (N = 512, K = 4608) and prefill by int8
// tensor-core throughput. Design: a 2-D grid over 128 x 64 output tiles,
// each block looping over K with nothing carried between blocks, A and W
// staged in shared memory per 64-deep K step (W transposed on the way so
// both MMA operands are K-contiguous), the next step prefetched into
// registers while the tensor cores (mma.sync m16n8k32 s8*s8->s32) work
// on the current one; one accumulator per shift level d+e, shift-added
// in uint32 in the epilogue.
//
// Small-M route (M <= 64: LM decode, M = batch). What bounds it: every
// weight byte is used M times, so a launch must stream the (K, N) planes
// from HBM (hymba's decode step: 1.29 GB of planes over 224 launches,
// 0.8-11.3 MB each); measured on an H100 it pays a fixed ~5 us a launch
// (launch, first DRAM latency, the cluster barrier), then streams at
// ~1.5-2 TB/s, so the small projections (k/v: 0.8 MB) are bound by
// launch latency and the large ones by bytes. Design:
//   - each launch is a programmatic dependent launch: it overlaps the
//     previous kernel's tail and waits for it before touching memory
//     (measured on an H100, it shortens a replayed decode step);
//   - a block owns a strip of 32 or 64 output columns (whole 32-byte
//     sectors of each W row) and one of `splits` K ranges; the splits of
//     a strip form one thread-block cluster (up to 16 blocks), so a
//     projection stays one launch with no global scratch, memset or
//     second pass;
//   - a cp.async ring of SM_STAGES x 128 K rows (the W strip and the
//     tokens' activation rows, 16-byte copies) keeps 3 stages in flight;
//   - swapped operands: 16 weight columns fill the MMA's m16 side and up
//     to 8 tokens its n8 side, so no MMA row multiplies padding; each
//     thread reads 4 W rows x 4 columns from shared memory (row stride
//     strip + 16 bytes: at most 2-way bank conflicts) and transposes them
//     with byte_perm;
//   - each warp owns 32 columns of the strip and a share of each stage's
//     32-row slices; the shift levels are folded into one uint32
//     accumulator per output as the MMAs retire; the warps' partials
//     meet in shared memory, the cluster's through distributed shared
//     memory, and every rank of the cluster runs the epilogue for its
//     share of the strip.
// Ragged M, N and K are masked in the loads and stores on both routes:
// the caller pads nothing.
//
// The epilogue uses __fmul_rn / __fadd_rn so that nvcc cannot contract
// the bias add into an FMA: the result equals the plain PyTorch version
// (two roundings) bit for bit. Build without --use_fast_math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
  int w_vec16;  // N % 16 == 0 and W 16-byte aligned: 16-byte copies
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

// ---------------------------------------------------------------------------
// Small-M route
// ---------------------------------------------------------------------------
constexpr int SM_BK = 128;           // K rows per ring stage
constexpr int SM_STAGES = 4;         // ring depth (3 stages in flight)
constexpr int SM_THREADS = 128;      // 4 warps
constexpr int SM_ASTR = SM_BK + 16;  // A row stride: 36 words, conflict-free
constexpr int SM_MAX_M = 64;
constexpr int SM_MAX_SPLITS = 16;    // the H100's non-portable cluster size
constexpr int SM_SMEM_LIMIT = 232448;  // shared memory a block can have

enum SmallEpilogue { kDequantBit = 1, kBiasBit = 2, kRowsumBit = 4 };

// A ring stage holds the strip's W rows (PW planes x SM_BK rows, each of
// strip + 16 bytes: the pad leaves the transposing reads at most 2-way
// bank conflicts, with 16-byte copies) and the same K rows of the tokens'
// activation planes. After the K loop the ring holds the warps' partial
// sums (128 x MP words whatever the strip) and the strip's sum (MP x strip
// words).
template <int PA, int PW, int NT>
struct SmallLayout {
  static constexpr int MP = 8 * NT;                  // token rows staged
  static constexpr int A_BYTES = PA * MP * SM_ASTR;
  __host__ __device__ static constexpr int w_bytes(int strip) {
    return PW * SM_BK * (strip + 16);
  }
  __host__ __device__ static constexpr int stage(int strip) {
    return w_bytes(strip) + A_BYTES;
  }
  __host__ __device__ static constexpr int smem(int strip) {
    return SM_STAGES * stage(strip) > 4 * MP * (128 + strip)
               ? SM_STAGES * stage(strip)
               : 4 * MP * (128 + strip);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async with zero fill: `valid` false copies no byte and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes p[0..15] of one row, zero at and beyond `valid`
__device__ __forceinline__ uint4 load16_masked(const int8_t* p, int valid) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < valid) v[b >> 2] |= (uint32_t)(uint8_t)p[b] << (8 * (b & 3));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// One ring stage: the strip's W rows [k0, k0 + SM_BK) of every plane and
// the same K rows of every token's activation planes, in 16-byte pieces;
// zero beyond k_hi (the split's end), M and N.
template <int PA, int PW, int NT>
__device__ __forceinline__ void small_load_stage(int8_t* stage,
                                                 const Args& args, int strip,
                                                 int n0, int k0, int k_hi,
                                                 int tid) {
  using L = SmallLayout<PA, PW, NT>;
  const int M = args.m, K = args.k, N = args.n;
  const int wstr = strip + 16, per_row = strip / 16;
  const int w_pieces = PW * SM_BK * per_row;
  for (int c = tid; c < w_pieces; c += SM_THREADS) {
    const int e = c / (SM_BK * per_row), r = (c / per_row) % SM_BK;
    const int q = c % per_row, k = k0 + r, n = n0 + 16 * q;
    int8_t* dst = stage + (e * SM_BK + r) * wstr + 16 * q;
    const int8_t* plane = args.w + (size_t)e * K * N;
    if (args.w_vec16) {  // N % 16 == 0: a piece is all in or all out
      const bool ok = k < k_hi && n < N;
      cp_async16(dst, ok ? plane + (size_t)k * N + n : args.w, ok);
    } else {
      *reinterpret_cast<uint4*>(dst) =
          k < k_hi ? load16_masked(plane + (size_t)k * N + n, N - n)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  int8_t* as = stage + L::w_bytes(strip);
  constexpr int A_PIECES = PA * L::MP * (SM_BK / 16);
  for (int c = tid; c < A_PIECES; c += SM_THREADS) {
    const int d = c / (L::MP * 8), row = (c / 8) % L::MP, q = c % 8;
    const int k = k0 + 16 * q;
    int8_t* dst = as + (d * L::MP + row) * SM_ASTR + 16 * q;
    const int8_t* plane = args.a + (size_t)d * M * K;
    if (args.a_vec) {  // K % 16 == 0, so is k_hi: a piece is all in or out
      const bool ok = row < M && k < k_hi;
      cp_async16(dst, ok ? plane + (size_t)row * K + k : args.a, ok);
    } else {
      *reinterpret_cast<uint4*>(dst) =
          row < M && k < k_hi
              ? load16_masked(plane + (size_t)row * K + k, k_hi - k)
              : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Grid: strips x splits blocks, the splits of a strip one cluster (block
// rank = K split). Warp (wn, wk) owns columns 32 wn .. 32 wn + 31 of the
// strip and every (4 / (strip / 32))-th 32-row slice of a stage, from
// slice wk. Swapped MMA operands: the m16 side is 16 weight columns, the
// n8 side 8 tokens. Thread (g, t) reads the warp's columns 4g .. 4g + 3,
// so MMA row g of m16 tile i is the warp's column 4g + 2i and row g + 8
// is column 4g + 2i + 1.
template <int PA, int PW, int NT>
__global__ void __launch_bounds__(SM_THREADS)
    pim_matmul_small_m_kernel(const Args args, int strip, int splits,
                              int k_per, int epi) {
  using L = SmallLayout<PA, PW, NT>;
  extern __shared__ __align__(16) int8_t smem[];
  // launched as a programmatic dependent: wait for the kernels before it
  // (which write the activation planes and scales) before any access
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n0 = (int)(blockIdx.x / splits) * strip;
  const int M = args.m, K = args.k, N = args.n;
  const int k_lo = min(K, rank * k_per);
  const int k_hi = min(K, k_lo + k_per);
  const int n_kt = (k_hi - k_lo + SM_BK - 1) / SM_BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int warps_n = strip / 32, warps_k = 4 / warps_n;
  const int wn = warp % warps_n, wk = warp / warps_n;
  const int wstr = strip + 16, stage_bytes = L::stage(strip);

  uint32_t acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0u;

#pragma unroll
  for (int s = 0; s < SM_STAGES - 1; ++s) {
    if (s < n_kt)
      small_load_stage<PA, PW, NT>(smem + s * stage_bytes, args, strip, n0,
                                   k_lo + s * SM_BK, k_hi, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<SM_STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free to refill
    const int nxt = kt + SM_STAGES - 1;
    if (nxt < n_kt)
      small_load_stage<PA, PW, NT>(smem + (nxt % SM_STAGES) * stage_bytes,
                                   args, strip, n0, k_lo + nxt * SM_BK, k_hi,
                                   tid);
    cp_async_commit();
    const int8_t* ws = smem + (kt % SM_STAGES) * stage_bytes;
    const int8_t* as = ws + L::w_bytes(strip);
    for (int kk = 32 * wk; kk < SM_BK; kk += 32 * warps_k) {
      if (k_lo + kt * SM_BK + kk >= k_hi) break;
      uint32_t wf[PW][2][4];  // [plane][k half][column 4g + c]
#pragma unroll
      for (int e = 0; e < PW; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int8_t* base = ws + (e * SM_BK + kk + 16 * h + 4 * t) * wstr +
                               32 * wn + 4 * g;
          uint32_t r[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            r[i] = *reinterpret_cast<const uint32_t*>(base + i * wstr);
          transpose4x4(r, wf[e][h]);
        }
      uint32_t bf[PA][NT][2];
#pragma unroll
      for (int d = 0; d < PA; ++d)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int8_t* row =
              as + (d * L::MP + j * 8 + g) * SM_ASTR + kk + 4 * t;
          bf[d][j][0] = *reinterpret_cast<const uint32_t*>(row);
          bf[d][j][1] = *reinterpret_cast<const uint32_t*>(row + 16);
        }
#pragma unroll
      for (int d = 0; d < PA; ++d)
#pragma unroll
        for (int e = 0; e < PW; ++e)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const uint32_t af[4] = {wf[e][0][2 * i], wf[e][0][2 * i + 1],
                                    wf[e][1][2 * i], wf[e][1][2 * i + 1]};
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              if (d + e == 0) {
                mma_s8(acc[i][j], af, bf[d][j]);
              } else {  // fold the shift level in as the MMA retires
                uint32_t c[4] = {0u, 0u, 0u, 0u};
                mma_s8(c, af, bf[d][j]);
#pragma unroll
                for (int r = 0; r < 4; ++r)
                  acc[i][j][r] += c[r] << (4 * (d + e));
              }
            }
          }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the partial sums

  // each K group of warps' partials, then their sum, as [token][column]
  const int tile = L::MP * strip;
  uint32_t* part = reinterpret_cast<uint32_t*>(smem);
  uint32_t* sum = part + warps_k * tile;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        part[wk * tile + (j * 8 + 2 * t + (r & 1)) * strip + 32 * wn +
             4 * g + 2 * i + (r >> 1)] = acc[i][j][r];
  __syncthreads();
  for (int e = tid; e < tile; e += SM_THREADS) {
    uint32_t v = part[e];
    for (int q = 1; q < warps_k; ++q) v += part[q * tile + e];
    sum[e] = v;
  }
  cluster.sync();  // every rank's sum is ready to be read remotely

  // rank r finishes elements r * 128 + tid, then every splits * 128-th;
  // a warp's 32 elements lie in one token's row
  constexpr int PER_THREAD = (L::MP * 64 + SM_THREADS - 1) / SM_THREADS;
  uint32_t got[PER_THREAD];
#pragma unroll
  for (int x = 0; x < PER_THREAD; ++x) {
    const int e = (rank + x * splits) * SM_THREADS + tid;
    got[x] = 0u;
    if (e < tile)
#pragma unroll
      for (int q = 0; q < SM_MAX_SPLITS; ++q)
        if (q < splits) got[x] += cluster.map_shared_rank(sum, q)[e];
  }
  // no remote read after this: the other ranks may leave once all arrive
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
#pragma unroll
  for (int x = 0; x < PER_THREAD; ++x) {
    const int e = (rank + x * splits) * SM_THREADS + tid;
    if (e >= tile) break;  // whole warps: tile is a multiple of 128
    const uint32_t v = got[x];
    const int row = e / strip, col = n0 + e % strip;
    if (row < M && col < N) {
      const size_t o = (size_t)row * N + col;
      if (epi & kDequantBit) {
        float f = __fmul_rn(
            __fmul_rn(__int2float_rn((int32_t)v), args.a_scale[row]),
            args.w_scale[col]);
        if (epi & kBiasBit) f = __fadd_rn(f, args.bias[col]);
        static_cast<float*>(args.out)[o] = f;
      } else {
        static_cast<int32_t*>(args.out)[o] = (int32_t)v;
      }
    }
    if (epi & kRowsumBit) {
      uint32_t rs = col < N ? v : 0u;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      if (lane == 0 && row < M)
        atomicAdd(reinterpret_cast<unsigned int*>(args.rowsum + row), rs);
    }
  }
  // keep this block's shared memory until every rank has read it
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int PA, int PW, int NT>
cudaError_t launch_small(const Args& args, int strip, int splits, int epi,
                         cudaStream_t stream) {
  using L = SmallLayout<PA, PW, NT>;
  auto kernel = pim_matmul_small_m_kernel<PA, PW, NT>;
  const int smem = L::smem(strip);
  const long long strips = (args.n + strip - 1) / strip;
  if (strips * splits > 0x7fffffffLL || smem > SM_SMEM_LIMIT)
    return cudaErrorInvalidValue;
  if (strips == 0 || args.m == 0) return cudaGetLastError();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static unsigned long long attrs_set = 0ull;  // devices already set up
  if (dev >= 64 || !(attrs_set >> dev & 1ull)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SM_SMEM_LIMIT);
    if (err == cudaSuccess)  // clusters of more than 8 blocks
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    if (dev < 64) attrs_set |= 1ull << dev;
  }
  // each split a whole number of stages; the chooser makes none empty
  const int k_per = ((args.k + splits - 1) / splits + SM_BK - 1) / SM_BK *
                    SM_BK;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(strips * splits));
  cfg.blockDim = dim3(SM_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // the launch overlaps the previous kernel's tail; the kernel waits
  // (griddepcontrol.wait) before touching memory
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kernel, args, strip, splits, k_per, epi);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int PA, int PW>
cudaError_t dispatch_tokens(const Args& args, int strip, int splits, int epi,
                            cudaStream_t stream) {
  const int tiles = (args.m + 7) / 8;  // n8 tiles of tokens
  if (tiles <= 1)
    return launch_small<PA, PW, 1>(args, strip, splits, epi, stream);
  if (tiles <= 2)
    return launch_small<PA, PW, 2>(args, strip, splits, epi, stream);
  if (tiles <= 4)
    return launch_small<PA, PW, 4>(args, strip, splits, epi, stream);
  return launch_small<PA, PW, 8>(args, strip, splits, epi, stream);
}

cudaError_t dispatch_small(int pa, int pw, const Args& args, int strip,
                           int splits, int epi, cudaStream_t stream) {
  if ((strip != 32 && strip != 64) || splits < 1 ||
      splits > SM_MAX_SPLITS || args.m > SM_MAX_M)
    return cudaErrorInvalidValue;
  if (pa == 1 && pw == 1)
    return dispatch_tokens<1, 1>(args, strip, splits, epi, stream);
  if (pa == 1 && pw == 2)
    return dispatch_tokens<1, 2>(args, strip, splits, epi, stream);
  if (pa == 2 && pw == 1)
    return dispatch_tokens<2, 1>(args, strip, splits, epi, stream);
  if (pa == 2 && pw == 2)
    return dispatch_tokens<2, 2>(args, strip, splits, epi, stream);
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
  args.w_vec16 =
      (n % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  return args;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// (PA, M, K) x (PW, K, N) int8 planes -> (M, N) float32 with the fused
// dequant epilogue; bias (N,) and rowsum (M,) int32 (zeroed by the caller)
// may be null. strip 0 takes the tiled route; otherwise the small-M route
// with strips of `strip` columns and `splits` K splits (the wrapper's
// small_m_grid). Returns cudaGetLastError() after the launch.
int pim_matmul_fused(const void* a, const void* w, const void* a_scale,
                     const void* w_scale, const void* bias, void* out,
                     void* rowsum, int pa, int pw, int m, int k, int n,
                     int strip, int splits, void* stream) {
  const Args args =
      make_args(a, w, a_scale, w_scale, bias, out, rowsum, m, k, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool has_bias = bias != nullptr, want_rowsum = rowsum != nullptr;
  if (strip != 0)
    return dispatch_small(pa, pw, args, strip, splits,
                          kDequantBit | (has_bias ? kBiasBit : 0) |
                              (want_rowsum ? kRowsumBit : 0),
                          s);
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
                   int m, int k, int n, int strip, int splits,
                   void* stream) {
  const Args args = make_args(a, w, nullptr, nullptr, nullptr, out, nullptr,
                              m, k, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (strip != 0) return dispatch_small(pa, pw, args, strip, splits, 0, s);
  return dispatch_planes<kRawInt32, false, false>(pa, pw, args, s);
}

// The tiled route at any M, as a yardstick for the small-M route: the
// Python wrappers never call these; chip_smoke.py times them.
int pim_matmul_fused_tiled(const void* a, const void* w, const void* a_scale,
                           const void* w_scale, const void* bias, void* out,
                           void* rowsum, int pa, int pw, int m, int k, int n,
                           void* stream) {
  return pim_matmul_fused(a, w, a_scale, w_scale, bias, out, rowsum, pa, pw,
                          m, k, n, 0, 0, stream);
}

int pim_matmul_int_tiled(const void* a, const void* w, void* out, int pa,
                         int pw, int m, int k, int n, void* stream) {
  return pim_matmul_int(a, w, out, pa, pw, m, k, n, 0, 0, stream);
}

}  // extern "C"
