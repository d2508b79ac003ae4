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
// Three routes of one function, chosen by shape in the Python wrapper
// (kernels/pim_matmul/pim_matmul.py small_m_grid), which passes the route
// here. All give the same bits: wraparound addition is associative and
// commutative, so any split of K and any order of combining uint32
// partial sums is exact.
//
// wgmma route (M > 64 with K and N multiples of 16: the CNN layers, LM
// prefill). What bounds it on an H100: the convolution layers have M in
// the tens of thousands, K up to a few thousand and N of 64..512; with
// N = 64 a layer does ~128 int8 operations per byte moved, below the
// card's ~590 (1979 TOPS / 3.35 TB/s), so the early layers are bound by
// device memory, the last stage (N = 512, K = 4608) and prefill by int8
// tensor-core throughput, which only wgmma reaches. Design
// (pim_matmul_wgmma_kernel): persistent blocks of two consumer warpgroups
// and one transposing warpgroup walk 256 x 128 output tiles (128 rows
// where that leaves SMs idle, 64 columns where N = 64 or where two or
// three shift levels need their own accumulators); TMA brings the
// K-major activation planes, 128-byte swizzled, into a ring of 4 stages
// and the N-major weight planes into a ring of their own; int8 wgmma
// takes K-major operands only, and the planes keep the JAX layout
// (PW, K, N) (one copy; a K-major second copy would double plan memory),
// so the transposing warpgroup turns each weight tile into the K-major
// swizzled layout in shared memory (byte_perm on 4x4 blocks, stores
// spread over all banks), into a third ring; the consumers keep one
// wgmma group in flight (m64nBNk32 s32.s8.s8, one accumulator set per
// shift level d + e), shift-add the levels in uint32 in the epilogue and
// store from registers. Measured on an H100 the route is bound by shared
// memory bandwidth (wgmma's operand reads, TMA's writes, the
// transposition) and by its epilogue, which the consumers run between
// tiles (chip_smoke.py times it beside the same kernel on K-major planes,
// the pim_matmul_fused_kmajor yardstick). Integer wgmma without
// .satfinite wraps mod 2^32 like mma.sync, so a level's sum may overflow.
//
// mma.sync route (M > 64 where TMA cannot describe the planes: K or N
// not a multiple of 16, as ResNet18's fc with N = 100, or planes not
// 16-byte aligned): the kernel the wgmma route replaced, a 2-D grid over
// 128 x 64 output tiles, A and W staged in shared memory per 64-deep K
// step (W transposed on the way with byte_perm), mma.sync m16n8k32
// s8*s8->s32, one accumulator per shift level.
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
// Ragged M, N and K are masked in the loads and stores on every route
// (TMA zero-fills what lies outside the planes): the caller pads nothing.
//
// The epilogue uses __fmul_rn / __fadd_rn so that nvcc cannot contract
// the bias add into an FMA: the result equals the plain PyTorch version
// (two roundings) bit for bit. Build without --use_fast_math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_s8.cuh"

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
// wgmma route
// ---------------------------------------------------------------------------
constexpr int WG_BK = 128;                     // K bytes per stage: one
                                               // 128-byte swizzle row
constexpr int WG_CONSUMERS = 256;    // two consumer warpgroups (warps 0-7)
constexpr int WG_TRANSPOSERS = 128;  // one transposing warpgroup (8-11)
constexpr int WG_THREADS = WG_CONSUMERS + WG_TRANSPOSERS;
constexpr int WG_SMEM_LIMIT = 232448;          // shared memory a block can have

enum Route { kWgmma = 0, kMmaSync = 1, kSmallM = 2 };
// epilogue bits of the wgmma and small-M routes
enum EpilogueBits { kDequantBit = 1, kBiasBit = 2, kRowsumBit = 4 };

// Three rings of K steps in shared memory: the activation planes' tiles
// (PA x BM rows x 128 K bytes, K-major, swizzled by TMA; SA deep), the
// weight planes' tiles as TMA lands them, N-major (PW x 128 K rows x BN
// bytes; SW deep), and the same tiles transposed into the K-major swizzled
// layout wgmma reads (PW x BN rows x 128 K bytes; SB deep). With KMAJOR
// the weights arrive K-major and TMA fills the third ring directly.
template <int PA, int PW, int BM, int BN, bool KMAJOR>
struct WgLayout {
  static constexpr int A_BYTES = PA * BM * WG_BK;
  static constexpr int B_BYTES = PW * BN * WG_BK;
  static constexpr int W_BYTES = KMAJOR ? 0 : PW * WG_BK * BN;
  static constexpr int SA = 4;
  // the rest (less 1024 bytes of alignment slack and 1024 of barriers)
  static constexpr int FIT =
      (WG_SMEM_LIMIT - 2048 - SA * A_BYTES) / (W_BYTES + B_BYTES);
  static constexpr int SB = FIT < 4 ? FIT : 4;
  static constexpr int SW = KMAJOR ? 0 : SB;
  static constexpr int SMEM =
      SA * A_BYTES + SW * W_BYTES + SB * B_BYTES + 2048;
  // a transposed tile is written while two are read
  static_assert(SB >= 3, "the transposed ring needs 3 stages");
  static_assert(BN == 64 || BN == 128, "tile width");
  static_assert(BM == 128 || BM == 256, "tile height: 1 or 2 x 64 rows for "
                                        "each consumer warpgroup");
};

// transpose4x4 with the columns rotated: o[q] packs column (q + rot) % 4
// of the 4x4 byte block r[0..3] (rows first), for the byte selectors
// wg_selectors(rot) gives. The rotation costs nothing (the selectors are
// registers) and spreads a warp's 16-byte stores over all banks.
__device__ __forceinline__ void transpose4x4_rot(const uint32_t* r,
                                                 uint32_t sel_lo,
                                                 uint32_t sel_hi,
                                                 uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], sel_lo);
  const uint32_t t1 = __byte_perm(r[0], r[1], sel_hi);
  const uint32_t t2 = __byte_perm(r[2], r[3], sel_lo);
  const uint32_t t3 = __byte_perm(r[2], r[3], sel_hi);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ uint32_t wg_selector(int c0, int c1) {
  return (uint32_t)c0 | (uint32_t)(c0 + 4) << 4 | (uint32_t)c1 << 8 |
         (uint32_t)(c1 + 4) << 12;
}

// Persistent blocks walk the output tiles (BM x BN, M fastest), both
// roles in the same order, K step by K step (step j of a block is K step
// j % n_k of its (j / n_k)-th tile):
//   - warps 8-11 wait for step j's N-major weight tile (`wfull`) and for
//     the transposed ring's slot (`bfree`), transpose the tile (each thread
//     2 units of 16 or 8 K rows x 4 columns: conflict-free 4-byte loads of
//     whole N-major rows, byte_perm, 16- or 8-byte stores spread over all
//     banks by a rotation of the columns) and arrive on `tfull`; then their
//     first thread has TMA bring step j + SW's weight tile into the slot
//     they just read. With KMAJOR that thread only has TMA fill the
//     transposed ring.
//   - warps 0-7, two consumer warpgroups on rows [0, BM/2) and [BM/2, BM)
//     in BM/128 products of 64 rows each, wait for step j's activation tile
//     (`afull`) and transposed weight tile (`tfull`), issue the step's
//     wgmmas (one s32 accumulator set per shift level d + e and 64 rows,
//     64 x BN each) and keep them in flight while the next step's are
//     issued: the step before is waited for and its slots released then
//     (`afree`, `bfree`), and thread 0 has TMA bring the activation tile of
//     the step that reuses the freed slot, SA - 1 steps ahead.
// A warp for TMA alone would make 13 warps, which leaves 128 registers a
// thread: the 256-row tiles' accumulators would spill. The epilogue
// shift-adds the levels in uint32 and stores straight from the
// accumulators, while the loads and the transposers run ahead into the
// next tile.
template <int PA, int PW, int BM, int BN, bool KMAJOR>
__global__ void __launch_bounds__(WG_THREADS, 1)
    pim_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                            const __grid_constant__ CUtensorMap w_map,
                            const Args args, int epi, int tiles_m,
                            int n_tiles) {
  using L = WgLayout<PA, PW, BM, BN, KMAJOR>;
  constexpr int LEVELS = PA + PW - 1;
  constexpr int SA = L::SA, SB = L::SB, SW = L::SW;
  constexpr int MI = BM / 128;  // 64-row products per consumer warpgroup
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  uint8_t* base =
      wg_smem + ((1024u - (sm90::smem_u32(wg_smem) & 1023u)) & 1023u);
  uint8_t* a_ring = base;
  uint8_t* b_ring = a_ring + SA * L::A_BYTES;
  uint8_t* w_ring = b_ring + SB * L::B_BYTES;
  uint64_t* afull = reinterpret_cast<uint64_t*>(w_ring + SW * L::W_BYTES);
  uint64_t* afree = afull + SA;
  uint64_t* tfull = afree + SA;
  uint64_t* bfree = tfull + SB;
  uint64_t* wfull = bfree + SB;  // SW of them

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < SA; ++s) {
      sm90::mbar_init(&afull[s], 1);
      sm90::mbar_init(&afree[s], WG_CONSUMERS);
    }
    for (int s = 0; s < SB; ++s) {
      sm90::mbar_init(&tfull[s], KMAJOR ? 1 : WG_TRANSPOSERS);
      sm90::mbar_init(&bfree[s], WG_CONSUMERS);
    }
    for (int s = 0; s < SW; ++s) sm90::mbar_init(&wfull[s], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  const int n_k = (args.k + WG_BK - 1) / WG_BK;
  const int my_tiles =
      n_tiles > (int)blockIdx.x
          ? (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x
          : 0;
  const int total = my_tiles * n_k;
  // the output tile and K offset of step j
  auto step_at = [&](int j, int& m0, int& n0, int& k0) {
    const int q = j / n_k, tile = (int)blockIdx.x + q * (int)gridDim.x;
    m0 = (tile % tiles_m) * BM;
    n0 = (tile / tiles_m) * BN;
    k0 = (j - q * n_k) * WG_BK;
  };

  if (warp >= WG_CONSUMERS / 32) {  // the transposers
    const int tt = tid - WG_CONSUMERS;
    auto load_w = [&](int j) {  // TMA for step j's weight tile
      int m0, n0, k0;
      step_at(j, m0, n0, k0);
      if constexpr (KMAJOR) {
        sm90::mbar_expect_tx(&tfull[j % SB], L::B_BYTES);
        sm90::tma_load_3d(b_ring + (j % SB) * L::B_BYTES, &w_map,
                          &tfull[j % SB], k0, n0, 0);
      } else {
        sm90::mbar_expect_tx(&wfull[j % SW], L::W_BYTES);
        sm90::tma_load_3d(w_ring + (j % SW) * L::W_BYTES, &w_map,
                          &wfull[j % SW], n0, k0, 0);
      }
    };
    if constexpr (KMAJOR) {  // the weights need no transposing: load them
      if (tt == 0)
        for (int j = 0; j < total; ++j) {
          if (j >= SB) sm90::mbar_wait(&bfree[j % SB], ((j / SB) - 1) & 1);
          load_w(j);
        }
    } else {
    if (tt == 0)
      for (int j = 0; j < SW && j < total; ++j) load_w(j);
    constexpr int KU = BN == 128 ? 16 : 8;  // K rows per unit
    constexpr int NG = BN / 4;              // 4-column groups per row
    // unit tt + 128 x: n-group ng, K rows ku .. ku + KU - 1 (128 % NG == 0,
    // so both units share ng and its rotation)
    const int ng = tt % NG, rot = (ng >> 1) & 3;
    const uint32_t sel_lo = wg_selector(rot, (rot + 1) & 3);
    const uint32_t sel_hi = wg_selector((rot + 2) & 3, (rot + 3) & 3);
    for (int j = 0; j < total; ++j) {
      const int sb = j % SB, sw = j % SW;
      if (j >= SB) sm90::mbar_wait(&bfree[sb], ((j / SB) - 1) & 1);
      sm90::mbar_wait(&wfull[sw], (j / SW) & 1);
#pragma unroll
      for (int e = 0; e < PW; ++e)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int ku = KU * ((tt + WG_TRANSPOSERS * x) / NG);
          const uint8_t* src =
              w_ring + sw * L::W_BYTES + e * WG_BK * BN + ku * BN + 4 * ng;
          uint32_t r[KU];
#pragma unroll
          for (int i = 0; i < KU; ++i)
            r[i] = *reinterpret_cast<const uint32_t*>(src + i * BN);
          uint32_t o[KU / 4][4];
#pragma unroll
          for (int b = 0; b < KU / 4; ++b)
            transpose4x4_rot(r + 4 * b, sel_lo, sel_hi, o[b]);
          uint8_t* dst = b_ring + sb * L::B_BYTES + e * BN * WG_BK;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int n = 4 * ng + ((q + rot) & 3);
            uint8_t* p =
                dst + n * WG_BK + ((((ku >> 4) ^ (n & 7)) << 4) | (ku & 8));
            if constexpr (KU == 16)
              *reinterpret_cast<uint4*>(p) =
                  make_uint4(o[0][q], o[1][q], o[2][q], o[3][q]);
            else
              *reinterpret_cast<uint2*>(p) = make_uint2(o[0][q], o[1][q]);
          }
        }
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&tfull[sb]);
      // every transposer has read slot sw: refill it
      asm volatile("bar.sync 1, %0;\n" ::"n"(WG_TRANSPOSERS) : "memory");
      if (tt == 0 && j + SW < total) load_w(j + SW);
    }
    }
    return;
  }

  // ---- consumers ----
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  auto load_a = [&](int j) {  // thread 0: TMA for step j's activation tile
    int m0, n0, k0;
    step_at(j, m0, n0, k0);
    sm90::mbar_expect_tx(&afull[j % SA], L::A_BYTES);
    sm90::tma_load_3d(a_ring + (j % SA) * L::A_BYTES, &a_map, &afull[j % SA],
                      k0, m0, 0);
  };
  auto release = [&](int j) {  // step j's products are done
    sm90::mbar_arrive(&afree[j % SA]);
    sm90::mbar_arrive(&bfree[j % SB]);
    if (tid == 0 && j + SA < total) {
      sm90::mbar_wait(&afree[j % SA], (j / SA) & 1);  // every consumer
      load_a(j + SA);
    }
    __syncwarp();
  };
  if (tid == 0)
    for (int j = 0; j < SA && j < total; ++j) load_a(j);
  __syncwarp();
  uint32_t acc[LEVELS][MI][BN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
#pragma unroll
    for (int s = 0; s < LEVELS; ++s)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[s][mi][i] = 0u;
    for (int kt = 0; kt < n_k; ++kt, ++it) {
      sm90::mbar_wait(&afull[it % SA], (it / SA) & 1);
      sm90::mbar_wait(&tfull[it % SB], (it / SB) & 1);
      const uint8_t* a_st =
          a_ring + (it % SA) * L::A_BYTES + wg * MI * 64 * WG_BK;
      const uint8_t* b_st = b_ring + (it % SB) * L::B_BYTES;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 32; ++kk)
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int d = 0; d < PA; ++d)
#pragma unroll
            for (int e = 0; e < PW; ++e)
              sm90::mma_s8<BN>(
                  acc[d + e][mi],
                  sm90::desc_sw128(a_st + (d * BM + mi * 64) * WG_BK) +
                      2 * kk,
                  sm90::desc_sw128(b_st + e * BN * WG_BK) + 2 * kk);
      sm90::wgmma_commit();
      if (kt > 0) {  // the step before is done: release its slots
        sm90::wgmma_wait<1>();
        release(it - 1);
      }
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int s2 = 0; s2 < LEVELS; ++s2)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sm90::fence_operand(acc[s2][mi][i]);
    if (n_k > 0) release(it - 1);

    // epilogue: shift-and-add in uint32, then int32 out or dequantize;
    // register 4j + 2h + c of product mi is row 64 mi + 16 wl + g + 8h,
    // column 8j + 2t + c
    const int M = args.m, N = args.n;
    const int m0 = (tile % tiles_m) * BM, n0 = (tile / tiles_m) * BN;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int row0 = m0 + 64 * (wg * MI + mi) + 16 * wl + g;
      float as[2] = {0.f, 0.f};
      if (epi & kDequantBit)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (row0 + 8 * h < M) as[h] = args.a_scale[row0 + 8 * h];
      uint32_t rs[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;  // N % 16 == 0: col + 1 < N too
        if (col >= N) continue;
        float2 ws = make_float2(0.f, 0.f), bs = make_float2(0.f, 0.f);
        if (epi & kDequantBit) {
          ws = make_float2(args.w_scale[col], args.w_scale[col + 1]);
          if (epi & kBiasBit)
            bs = make_float2(args.bias[col], args.bias[col + 1]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v0 = 0u, v1 = 0u;
#pragma unroll
          for (int s = 0; s < LEVELS; ++s) {
            v0 += acc[s][mi][4 * j + 2 * h] << (4 * s);
            v1 += acc[s][mi][4 * j + 2 * h + 1] << (4 * s);
          }
          rs[h] += v0 + v1;
          const int row = row0 + 8 * h;
          if (row >= M) continue;
          const size_t o = (size_t)row * N + col;
          if (epi & kDequantBit) {
            float f0 = __fmul_rn(
                __fmul_rn(__int2float_rn((int32_t)v0), as[h]), ws.x);
            float f1 = __fmul_rn(
                __fmul_rn(__int2float_rn((int32_t)v1), as[h]), ws.y);
            if (epi & kBiasBit) {
              f0 = __fadd_rn(f0, bs.x);
              f1 = __fadd_rn(f1, bs.y);
            }
            *reinterpret_cast<float2*>(static_cast<float*>(args.out) + o) =
                make_float2(f0, f1);
          } else {
            *reinterpret_cast<int2*>(static_cast<int32_t*>(args.out) + o) =
                make_int2((int32_t)v0, (int32_t)v1);
          }
        }
      }
      if (epi & kRowsumBit) {
        // the 4 threads of a group hold one row's 8 columns per n8 tile;
        // wraparound addition is associative, so the atomics are exact
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v = rs[h];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (t == 0 && row0 + 8 * h < M)
            atomicAdd(
                reinterpret_cast<unsigned int*>(args.rowsum + row0 + 8 * h),
                v);
        }
      }
    }
  }
}

// The current device's SM count, looked up once per device.
int sm_count() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  static int counts[64] = {0};
  if (dev < 64 && counts[dev] > 0) return counts[dev];
  int count = 0;
  if (cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < 64) counts[dev] = count;
  return count;
}

// cuTensorMapEncodeTiled is a driver-API function; it is looked up through
// the runtime, so the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 3-D int8 tensor (d2, d1, d0), d0 innermost, as boxes of (b2, b1, b0);
// the 128-byte swizzle for the operand tiles wgmma reads.
bool encode_map(CUtensorMap* map, const void* data, uint64_t d0, uint64_t d1,
                uint64_t d2, uint32_t b0, uint32_t b1, uint32_t b2,
                bool swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0, d0 * d1};
  const cuuint32_t box[3] = {b0, b1, b2};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(data),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// w is (PW, K, N) N-major, or with KMAJOR the yardstick's (PW, N, K) copy.
template <int PA, int PW, int BM, int BN, bool KMAJOR>
cudaError_t launch_wgmma(const Args& args, int epi, cudaStream_t stream) {
  using L = WgLayout<PA, PW, BM, BN, KMAJOR>;
  auto kernel = pim_matmul_wgmma_kernel<PA, PW, BM, BN, KMAJOR>;
  const long long tiles_m = (args.m + BM - 1) / BM;
  const long long tiles = tiles_m * ((args.n + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (tiles == 0) return cudaGetLastError();
  CUtensorMap a_map, w_map;
  const bool ok =
      encode_map(&a_map, args.a, args.k, args.m, PA, WG_BK, BM, PA, true) &&
      (KMAJOR ? encode_map(&w_map, args.w, args.k, args.n, PW, WG_BK, BN, PW,
                           true)
              : encode_map(&w_map, args.w, args.n, args.k, PW, BN, WG_BK, PW,
                           false));
  if (!ok) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static unsigned long long attrs_set = 0ull;  // devices already set up
  if (dev >= 64 || !(attrs_set >> dev & 1ull)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 64) attrs_set |= 1ull << dev;
  }
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const int blocks = (int)(tiles < sms ? tiles : sms);
  kernel<<<blocks, WG_THREADS, L::SMEM, stream>>>(a_map, w_map, args, epi,
                                                  (int)tiles_m, (int)tiles);
  return cudaGetLastError();
}

// What TMA can describe: K and N multiples of 16 bytes (the row strides),
// 16-byte aligned planes, a non-empty K.
bool wgmma_takes(const Args& args) {
  return args.k >= 16 && args.k % 16 == 0 && args.n % 16 == 0 &&
         reinterpret_cast<uintptr_t>(args.a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(args.w) % 16 == 0;
}

// 256-row tiles where they still give every SM a tile: each weight tile
// then serves twice the rows, which halves the weight bytes and the
// transposition per operation (the route is bound by what L2 can feed the
// SMs); 128-row tiles otherwise.
template <int PA, int PW, int BN, bool KMAJOR>
cudaError_t launch_wgmma_rows(const Args& args, int epi,
                              cudaStream_t stream) {
  const long long tall =
      (long long)((args.m + 255) / 256) * ((args.n + BN - 1) / BN);
  if (tall >= sm_count())
    return launch_wgmma<PA, PW, 256, BN, KMAJOR>(args, epi, stream);
  return launch_wgmma<PA, PW, 128, BN, KMAJOR>(args, epi, stream);
}

cudaError_t dispatch_wgmma(int pa, int pw, const Args& args, int epi,
                           cudaStream_t stream) {
  if (!wgmma_takes(args)) return cudaErrorInvalidValue;
  // w4a4: one accumulator set, 64 x 128 (64 x 64 where N = 64) per product,
  // two products per consumer warpgroup on 256-row tiles; two or three
  // shift levels: a set of 64 x 64 per level, 128-row tiles
  if (pa == 1 && pw == 1)
    return args.n > 64
               ? launch_wgmma_rows<1, 1, 128, false>(args, epi, stream)
               : launch_wgmma_rows<1, 1, 64, false>(args, epi, stream);
  if (pa == 1 && pw == 2)
    return launch_wgmma<1, 2, 128, 64, false>(args, epi, stream);
  if (pa == 2 && pw == 1)
    return launch_wgmma<2, 1, 128, 64, false>(args, epi, stream);
  if (pa == 2 && pw == 2)
    return launch_wgmma<2, 2, 128, 64, false>(args, epi, stream);
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
// may be null. `route` is the wrapper's choice (kernels/pim_matmul/
// pim_matmul.py small_m_grid): 0 the wgmma route, 1 the mma.sync route, 2
// the small-M route with strips of `strip` columns and `splits` K splits.
// Returns cudaGetLastError() after the launch.
int pim_matmul_fused(const void* a, const void* w, const void* a_scale,
                     const void* w_scale, const void* bias, void* out,
                     void* rowsum, int pa, int pw, int m, int k, int n,
                     int route, int strip, int splits, void* stream) {
  const Args args =
      make_args(a, w, a_scale, w_scale, bias, out, rowsum, m, k, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool has_bias = bias != nullptr, want_rowsum = rowsum != nullptr;
  const int epi = kDequantBit | (has_bias ? kBiasBit : 0) |
                  (want_rowsum ? kRowsumBit : 0);
  if (route == kSmallM) return dispatch_small(pa, pw, args, strip, splits, epi, s);
  if (route == kWgmma) return dispatch_wgmma(pa, pw, args, epi, s);
  if (route != kMmaSync) return cudaErrorInvalidValue;
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
                   int m, int k, int n, int route, int strip, int splits,
                   void* stream) {
  const Args args = make_args(a, w, nullptr, nullptr, nullptr, out, nullptr,
                              m, k, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kSmallM) return dispatch_small(pa, pw, args, strip, splits, 0, s);
  if (route == kWgmma) return dispatch_wgmma(pa, pw, args, 0, s);
  if (route != kMmaSync) return cudaErrorInvalidValue;
  return dispatch_planes<kRawInt32, false, false>(pa, pw, args, s);
}

// Yardsticks, which the Python wrappers never call; chip_smoke.py times
// them. The wgmma route at any M (against the small-M route):
int pim_matmul_fused_tiled(const void* a, const void* w, const void* a_scale,
                           const void* w_scale, const void* bias, void* out,
                           void* rowsum, int pa, int pw, int m, int k, int n,
                           void* stream) {
  return pim_matmul_fused(a, w, a_scale, w_scale, bias, out, rowsum, pa, pw,
                          m, k, n, kWgmma, 0, 0, stream);
}

int pim_matmul_int_tiled(const void* a, const void* w, void* out, int pa,
                         int pw, int m, int k, int n, void* stream) {
  return pim_matmul_int(a, w, out, pa, pw, m, k, n, kWgmma, 0, 0, stream);
}

// The mma.sync kernel the wgmma route replaced, at any M and shape:
int pim_matmul_fused_mma_sync(const void* a, const void* w,
                              const void* a_scale, const void* w_scale,
                              const void* bias, void* out, void* rowsum,
                              int pa, int pw, int m, int k, int n,
                              void* stream) {
  return pim_matmul_fused(a, w, a_scale, w_scale, bias, out, rowsum, pa, pw,
                          m, k, n, kMmaSync, 0, 0, stream);
}

int pim_matmul_int_mma_sync(const void* a, const void* w, void* out, int pa,
                            int pw, int m, int k, int n, void* stream) {
  return pim_matmul_int(a, w, out, pa, pw, m, k, n, kMmaSync, 0, 0, stream);
}

// The wgmma route with the weight planes given K-major, (PW, N, K), so that
// TMA lands them in the layout wgmma reads and nothing is transposed: what
// a second, K-major copy of the planes would buy. w4a4, N > 64.
int pim_matmul_fused_kmajor(const void* a, const void* w_k,
                            const void* a_scale, const void* w_scale,
                            const void* bias, void* out, void* rowsum,
                            int pa, int pw, int m, int k, int n,
                            void* stream) {
  const Args args =
      make_args(a, w_k, a_scale, w_scale, bias, out, rowsum, m, k, n);
  if (pa != 1 || pw != 1 || n <= 64 || !wgmma_takes(args))
    return cudaErrorInvalidValue;
  return launch_wgmma_rows<1, 1, 128, true>(
      args,
      kDequantBit | (bias != nullptr ? kBiasBit : 0) |
          (rowsum != nullptr ? kRowsumBit : 0),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
