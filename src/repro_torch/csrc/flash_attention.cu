// Masked GQA flash attention for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernel in src/repro/kernels/flash_attention/
// flash_attention.py:
//   flash_attention_pallas / _flash_kernel  -> flash_fwd()
// and adds its gradient (the TPU kernel has none; the training step
// differentiates through it): flash_bwd_dq(), flash_bwd_dkv() and, with
// GQA, flash_bwd_sum().
//
// q is (B, S, H, D), k and v are (B, S, KV, D), contiguous; head h reads
// kv head h / (H / KV). With q pre-scaled by 1/sqrt(D), the forward is an
// online softmax over key tiles: a running max m, a running denominator l
// and a float32 accumulator; masked logits are -1e30 (not -inf), the
// denominator is clamped at 1e-37, and the mask is the JAX kernel's:
//   ok = (causal ? qpos >= kpos : true) || kpos < prefix
//   if window > 0: ok &&= (qpos - kpos < window) || kpos < prefix.
// It also writes the log-sum-exp m + log(l) of every row, (B, H, S) float32,
// which the backward uses to recompute P = exp(S - lse) tile by tile.
//
// The backward (float32) is up to three launches, each its own entry
// point. The first, flash_bwd_dq, one block per (b, h, tile of 32
// queries), forms Delta = rowsum(dO * O), writes it out, and accumulates
// dQ = dS K / sqrt(D) over the key tiles, with dS = P * (dO V^T - Delta).
// The second, flash_bwd_dkv, one block per (b, query head, key tile),
// walks the head's query tiles and accumulates dV = P^T dO and dK = dS^T Q
// / sqrt(D) of that query head; with GQA (rep = H / KV > 1) these are
// partials, and the third, flash_bwd_sum, adds the rep heads of each kv
// head in head order. No atomics: the result does not depend on the order
// blocks run in. (Summing the rep heads inside one block per kv head would
// leave 128 blocks at gemma3-1b's shapes, the first key tile of a causal
// layer walking 256 query tiles: about 1.8x the time of a global layer's
// backward.) Blocks are numbered so that the heaviest tiles of a causal
// mask start first.
//
// Tiles: a key tile lies wholly outside the mask of a query tile when it
// is past the causal frontier, or when every pair is at least `window`
// apart, and holds no prefix key. Such a tile is skipped. That gives the
// same result as processing it: every row of a causal or windowed mask has
// a valid key in the diagonal tile, a masked logit adds exp(-1e30 - m) = 0
// once the row has seen a valid key, and what it adds before is multiplied
// by exp(-1e30 - m) = 0 when the first valid key arrives.
//
// What bounds it on an H100: at gemma3-1b's training shapes (B 2, S 2048,
// H 4, KV 1, D 256, window 512 or global) it does 4 float32 multiply-adds
// per unmasked (query, key, column) in the forward, and 10 in the backward
// (S, dP, dQ in the first launch; S, dP, dV, dK in the second); the bytes
// (q, k, v, o and their gradients, each once) are a few tens of MB, a few
// microseconds at 3.35 TB/s. So it is bound by operations: 67 TFLOP/s of
// CUDA-core float32 for the forward, the tensor cores for the backward.
//
// Forward (float32 FMAs on the CUDA cores; TF32 keeps 10 mantissa bits
// and would miss the JAX kernel's rtol 2e-4): the Pallas blocks (512 x
// 512, rep heads folded into a query tile) need megabytes of VMEM; here a
// block owns 64 query rows of one head (8 warps x 8 rows) and streams key
// tiles of 32 rows through dynamic shared memory (up to 137 KB at D = 256,
// set with cudaFuncSetAttribute). In the logit product lane j of a warp
// owns key j of the tile, so the row max and row sum of the online softmax
// are warp shuffles; in the value product lane l owns columns l, l + 32,
// ..., so each shared-memory load of a value feeds 8 rows. Keys are stored
// transposed with rows padded to 33 floats, so that lanes reading
// consecutive keys, and lanes reading consecutive columns of one key, hit
// different banks. Head dims are padded with zeros to 32 * CT (CT = 1, 2,
// 4 or 8 columns per lane), so D may be anything up to 256. Rows past S (a
// ragged last tile) are masked and never stored. bf16 inputs are widened to
// float32 in shared memory and the output is rounded to bf16 once, as the
// JAX kernel casts its f32 accumulator. With one block per SM nothing hides
// the latency of a tile's loads, so where D % 4 == 0 and the rows are
// aligned they move in 16-byte loads (8-byte for bf16), several issued
// before the first is stored; otherwise element by element.
//
// The two backward passes run on the tensor cores at float32 accuracy:
// every product is 3xTF32 (mma_tf32x3.cuh: x = hi + lo, each rounded as
// cvt.rna.tf32.f32 does; lo hi + hi lo + hi hi into float32 accumulators,
// the small terms first). The tensor cores truncate when they add into an
// accumulator, so an accumulator that takes every query or key of a long
// sequence drifts by the same sign at each add (at the global layer's
// 2,048 queries, about 2.7e-5 of the largest gradient); each tile
// therefore sums into fresh fragments, which join the running sums by
// float32 adds that round to nearest. chip_smoke.py (phase 12) holds each
// pass, the CUDA-core kernel it replaced and the plain version against a
// float64 evaluation of the same inputs, the pass within 1e-5 of each
// gradient's largest magnitude. Rows of the tiles are padded to DV + 4
// floats (4 mod 32 banks), so that the fragment loads (8 rows x 4 columns,
// or 4 row pairs x 8 columns) hit 32 distinct banks. Q is not pre-scaled
// (cp.async copies bytes as they are): the logits and the gradient that
// takes them are scaled by 1/sqrt(D) instead.
//
// dK/dV (flash_bwd_dkv_kernel): a block owns 32 keys of one query head (8
// warps); per live tile of 32 queries:
//   1. S^T = K Q^T and dP^T = V dO^T (mma.sync m16n8k8): warp (product,
//      key half, column half) splits its 16-key K or V fragment once per
//      8 columns and uses it against all four 8-query fragments;
//   2. the two column halves meet in a 16 KB exchange in shared memory,
//      where warp w forms P^T = mask ? exp(S^T - lse) : 0 and dS^T =
//      P^T (dP^T - delta) for one 16 x 8 fragment, splits them once and
//      writes them back in the A-fragment order of step 3 (the
//      accumulator's (c0, c2, c1, c3): with the reduction pair k = t, t + 4
//      of a step taken as queries 2t, 2t + 1, an accumulator fragment is
//      lane for lane an A fragment), so that each lane loads its hi and lo
//      fragments with two 16-byte loads and no shuffles;
//   3. dV += P^T dO and dK += dS^T Q: warp w owns DV / 8 columns (at
//      D = 256: 2 x 4 fragments of each, 64 accumulators a thread, and
//      the tile's own fragments, in two column halves).
// Q, dO, lse and delta move by cp.async into two stages, the next live
// query tile while this one multiplies; K and V stay for the block. Shared
// memory at D = 256: K and V 66,560 bytes, the two stages 133,632, the
// exchange 16,384: 216,576 of the 227 KB a block may have, so one block of
// 8 warps per SM. ptxas (-O3, sm_90a): 232 registers at D = 256, no
// spills.
//
// dQ (flash_bwd_dq_kernel) is the same design with the roles of queries
// and keys swapped: a block owns 32 queries of one head (8 warps), whose
// Q, dO, lse and delta stay; per live tile of 32 keys:
//   1. S = Q K^T and dP = dO V^T: warp (product, query half, column half)
//      splits its 16-query Q or dO fragment once per 8 columns and uses it
//      against all four 8-key fragments. K and V need no transposed copy:
//      the B fragment (t, g) of K^T is K[g][t], read from the row-major
//      tile;
//   2. the halves meet in the exchange, where warp w forms P and dS =
//      P (dP - delta) for one 16 x 8 fragment, splits dS once and writes it
//      back in A-fragment order (the reduction pair k = t, t + 4 of a step
//      taken as keys 2t, 2t + 1);
//   3. dQ += dS K: warp w owns DV / 8 columns (at D = 256: 2 x 4
//      fragments, 32 accumulators a thread, and the tile's own fragments);
//      K's B fragment (keys 2t, 2t + 1 at column g) is row-major again.
// K and V move by cp.async into two stages, the next live key tile while
// this one multiplies. Delta is the CUDA-core kernel's computation, bit for
// bit (a lane's float32 FMAs over its columns, then a warp sum), formed
// while the first key tile lands. Shared memory at D = 256: Q and dO
// 66,560 bytes, lse and delta 256, the two stages 133,120, the exchange
// 16,384: 216,320, one block of 8 warps per SM. ptxas (-O3, sm_90a): 159
// registers at D = 256, no spills. 32-query blocks also visit fewer masked
// pairs than the 64-query blocks of the CUDA-core kernel.
//
// What bounds the backward passes now: mma.sync and what feeds it.
// mma.sync does not reach the 495 TFLOP/s of dense TF32 that wgmma does,
// and every float32 product costs three of them. The work that feeds them
// (the split, 5 integer and float operations per element; shared-memory
// loads; exp) issues from the same warps, and with 2 warps per scheduler
// and three barriers per tile it overlaps the tensor pipe little; in the
// dQ pass step 1 splits the block's resident Q and dO fragments again for
// every key tile (kept split, they would not fit in registers or shared
// memory). At the global layer's shape dK/dV runs at about 3.7x its 3xTF32
// bound on an H100, dQ at about 4.3x (chip_smoke.py, phase 12). wgmma
// (which reads both operands from shared memory, so the split operands
// would have to be stored there, and dO and Q K-major for dK/dV) is later
// work.
//
// The CUDA-core dQ and dK/dV kernels these replaced stay in the library as
// flash_bwd_dq_simt() and flash_bwd_dkv_simt(), yardsticks for timing; no
// wrapper calls them.
//
// Later work (not done here): wgmma for the backward passes, and TMA with
// a ring of key tiles for the forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBq = 64;          // query rows of a forward block (and
                                 // of the CUDA-core dQ yardstick's)
constexpr int kRows = kBq / kWarps;   // 8 query rows per warp
constexpr int kBk = 32;          // key rows of a tile (one per lane)
constexpr int kBq2 = 32;         // query rows of a dK/dV step, a dQ block
constexpr int kRows2 = kBq2 / kWarps; // 4 rows per warp there
constexpr int kKs = kBk + 1;     // padded row of the transposed key tile
constexpr int kPs = kBq2 + 4;    // padded row of the transposed P tile
constexpr float kNegInf = -1e30f;

struct Geo {
  int B, S, H, KV, D, rep;
  int causal, window, prefix;
  int vec;       // D % 4 == 0 and every row 16-byte (bf16: 8-byte) aligned
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The JAX kernel's mask, plus the ragged edge (positions past S).
__device__ __forceinline__ bool pair_ok(int qp, int kp, const Geo& g) {
  if (qp >= g.S || kp >= g.S) return false;
  bool ok = g.causal ? (qp >= kp) : true;
  ok = ok || (kp < g.prefix);
  if (g.window > 0) ok = ok && ((qp - kp < g.window) || (kp < g.prefix));
  return ok;
}

// False only when every pair of [q0, q0+nq) x [k0, k0+nk) is masked.
__device__ __forceinline__ bool tile_live(int q0, int nq, int k0, int nk,
                                          const Geo& g) {
  if (k0 < g.prefix) return true;
  const int qlast = min(q0 + nq, g.S) - 1;
  const int klast = min(k0 + nk, g.S) - 1;
  if (g.causal && k0 > qlast) return false;
  if (g.window > 0 && q0 - klast >= g.window) return false;
  return true;
}

__device__ __forceinline__ size_t q_index(const Geo& g, int b, int t, int h,
                                          int c) {
  return ((static_cast<size_t>(b) * g.S + t) * g.H + h) * g.D + c;
}

__device__ __forceinline__ size_t kv_index(const Geo& g, int b, int t, int h,
                                           int c) {
  return ((static_cast<size_t>(b) * g.S + t) * g.KV + h) * g.D + c;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Tile loads from device memory into shared memory, zero past S and past
// D. With g.vec each thread moves 4 consecutive columns per load, and the
// loads of a batch are all issued before their stores, so that several
// are in flight at once (with one block per SM, nothing else hides their
// latency); otherwise one column per load.
constexpr int kBatch = 4;

// ROWS x DV rows [t0, t0 + ROWS) of head h of a (B, S, nh, D) tensor,
// row-major, times `mul`.
template <int ROWS, int DV, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          const Geo& g, int b, int t0, int h,
                                          int nh, float mul) {
  if (g.vec) {
    constexpr int kIters = ROWS * DV / 4 / kThreads;
    constexpr int kStep = kIters < kBatch ? kIters : kBatch;
    static_assert(ROWS * DV % (4 * kThreads) == 0 && kIters % kStep == 0,
                  "tile does not split evenly over the block");
#pragma unroll
    for (int i0 = 0; i0 < kIters; i0 += kStep) {
      float4 val[kStep];
#pragma unroll
      for (int i = 0; i < kStep; ++i) {
        const int idx = threadIdx.x + (i0 + i) * kThreads;
        const int r = idx / (DV / 4), c = (idx % (DV / 4)) * 4, t = t0 + r;
        val[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t < g.S && c < g.D)
          val[i] = load4(src + ((static_cast<size_t>(b) * g.S + t) * nh + h) *
                                   g.D + c);
      }
#pragma unroll
      for (int i = 0; i < kStep; ++i) {
        const int idx = threadIdx.x + (i0 + i) * kThreads;
        const int r = idx / (DV / 4), c = (idx % (DV / 4)) * 4;
        *reinterpret_cast<float4*>(&dst[r * DV + c]) =
            make_float4(val[i].x * mul, val[i].y * mul, val[i].z * mul,
                        val[i].w * mul);
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < ROWS * DV; idx += kThreads) {
    const int r = idx / DV, c = idx - r * DV, t = t0 + r;
    float val = 0.f;
    if (t < g.S && c < g.D)
      val = to_f(src[((static_cast<size_t>(b) * g.S + t) * nh + h) * g.D +
                     c]) * mul;
    dst[idx] = val;
  }
}

// kBk x DV key-side tile (keys [k0, k0 + kBk) of kv head h), stored
// transposed: dst[c * kKs + j].
template <int DV, typename T>
__device__ __forceinline__ void load_keys_t(float* dst, const T* src,
                                            const Geo& g, int b, int k0,
                                            int h) {
  if (g.vec) {
    constexpr int kIters = kBk * DV / 4 / kThreads;
    constexpr int kStep = kIters < kBatch ? kIters : kBatch;
    static_assert(kBk * DV % (4 * kThreads) == 0 && kIters % kStep == 0,
                  "tile does not split evenly over the block");
#pragma unroll
    for (int i0 = 0; i0 < kIters; i0 += kStep) {
      float4 val[kStep];
#pragma unroll
      for (int i = 0; i < kStep; ++i) {
        const int idx = threadIdx.x + (i0 + i) * kThreads;
        const int j = idx / (DV / 4), c = (idx % (DV / 4)) * 4, t = k0 + j;
        val[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t < g.S && c < g.D) val[i] = load4(src + kv_index(g, b, t, h, c));
      }
#pragma unroll
      for (int i = 0; i < kStep; ++i) {
        const int idx = threadIdx.x + (i0 + i) * kThreads;
        const int j = idx / (DV / 4), c = (idx % (DV / 4)) * 4;
        dst[c * kKs + j] = val[i].x;
        dst[(c + 1) * kKs + j] = val[i].y;
        dst[(c + 2) * kKs + j] = val[i].z;
        dst[(c + 3) * kKs + j] = val[i].w;
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kBk * DV; idx += kThreads) {
    const int j = idx / DV, c = idx - j * DV, t = k0 + j;
    float val = 0.f;
    if (t < g.S && c < g.D) val = to_f(src[kv_index(g, b, t, h, c)]);
    dst[c * kKs + j] = val;
  }
}

__host__ __device__ inline size_t fwd_smem_floats(int dv) {
  return static_cast<size_t>(kBq) * dv + static_cast<size_t>(dv) * kKs +
         static_cast<size_t>(kBk) * dv + kBq * kBk;
}
__host__ __device__ inline size_t dq_simt_smem_floats(int dv) {
  return 2 * static_cast<size_t>(kBq) * dv +
         2 * static_cast<size_t>(dv) * kKs + kBq * kBk;
}
__host__ __device__ inline size_t dkv_simt_smem_floats(int dv) {
  return 2 * static_cast<size_t>(dv) * kKs +
         2 * static_cast<size_t>(kBq2) * dv + 2 * kBk * kPs + 2 * kBq2;
}

// The tensor-core passes (flash_bwd_dkv_kernel, flash_bwd_dq_kernel). The
// K, V, Q and dO tiles keep rows of dv + 4 floats, a stride of 4 mod 32
// banks, so that the fragment loads (8 rows x 4 columns, or 4 row pairs x 8
// columns) hit 32 distinct banks.
__host__ __device__ constexpr int dkv_row(int dv) { return dv + 4; }
// The exchange between the two products of a query tile: its 2 x 4
// fragments (16 keys x 8 queries each) x 4 slots x 32 lanes, 16 bytes each
constexpr int kXFloats = 4 * kBk * kBq2;
// K and V; two stages of Q, dO and the rows' lse and delta; the exchange.
__host__ __device__ inline size_t dkv_smem_floats(int dv) {
  return 2 * static_cast<size_t>(kBk) * dkv_row(dv) +
         2 * (2 * static_cast<size_t>(kBq2) * dkv_row(dv) + 2 * kBq2) +
         kXFloats;
}
// The tensor-core dQ pass: Q and dO and the rows' lse and delta; two
// stages of K and V; the exchange.
__host__ __device__ inline size_t dq_smem_floats(int dv) {
  return 2 * static_cast<size_t>(kBq2) * dkv_row(dv) + 2 * kBq2 +
         2 * (2 * static_cast<size_t>(kBk) * dkv_row(dv)) + kXFloats;
}

// ---------------------------------------------------------------------------
// forward: grid (H, B, ceil(S / 64)), the last query tiles first
// ---------------------------------------------------------------------------
template <typename T, int CT>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Geo g) {
  constexpr int DV = 32 * CT;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // kBq x DV, pre-scaled
  float* kt = qs + kBq * DV;      // DV x kKs, transposed keys
  float* vs = kt + DV * kKs;      // kBk x DV
  float* ps = vs + kBk * DV;      // kBq x kBk, this tile's probabilities
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBq, h = blockIdx.x,
            b = blockIdx.y;
  const int kvh = h / g.rep;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * kRows;

  load_rows<kBq, DV>(qs, q, g, b, q0, h, g.H, g.scale);
  float acc[kRows][CT], m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < CT; ++t) acc[r][t] = 0.f;
  }

  const int n_tiles = (g.S + kBk - 1) / kBk;
  for (int kt_i = 0; kt_i < n_tiles; ++kt_i) {
    const int k0 = kt_i * kBk;
    if (!tile_live(q0, kBq, k0, kBk, g)) continue;
    __syncthreads();   // the previous tile is consumed (and q is loaded)
    load_keys_t<DV>(kt, k, g, b, k0, kvh);
    load_rows<kBk, DV>(vs, v, g, b, k0, kvh, g.KV, 1.f);
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    for (int c = 0; c < DV; c += 4) {
      const float k0v = kt[c * kKs + lane], k1v = kt[(c + 1) * kKs + lane];
      const float k2v = kt[(c + 2) * kKs + lane];
      const float k3v = kt[(c + 3) * kKs + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&qs[(r0 + r) * DV + c]);
        s[r] = fmaf(qv.x, k0v, s[r]);
        s[r] = fmaf(qv.y, k1v, s[r]);
        s[r] = fmaf(qv.z, k2v, s[r]);
        s[r] = fmaf(qv.w, k3v, s[r]);
      }
    }
    const int kp = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float sv = pair_ok(q0 + r0 + r, kp, g) ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float alpha = expf(m[r] - m_new);
      const float p = expf(sv - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < CT; ++t) acc[r][t] *= alpha;
      ps[(r0 + r) * kBk + lane] = p;
    }
    __syncwarp();      // a warp reads back only its own rows of ps
    for (int j = 0; j < kBk; j += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pv[r] = *reinterpret_cast<const float4*>(&ps[(r0 + r) * kBk + j]);
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        const float* vcol = vs + j * DV + lane + 32 * t;
        const float v0 = vcol[0], v1 = vcol[DV], v2 = vcol[2 * DV],
                    v3 = vcol[3 * DV];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float a = acc[r][t];
          a = fmaf(pv[r].x, v0, a);
          a = fmaf(pv[r].y, v1, a);
          a = fmaf(pv[r].z, v2, a);
          a = fmaf(pv[r].w, v3, a);
          acc[r][t] = a;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= g.S) continue;
    const float denom = fmaxf(l[r], 1e-37f);
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      const int c = lane + 32 * t;
      if (c < g.D) o[q_index(g, b, qp, h, c)] = from_f<T>(acc[r][t] / denom);
    }
    if (lane == 0)
      lse[(static_cast<size_t>(b) * g.H + h) * g.S + qp] = m[r] + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// backward, launch 1, the CUDA-core version (the first design): Delta and dQ
// in float32 FMAs. Kept as a yardstick for the tensor-core kernel below (C
// symbol flash_bwd_dq_simt); the wrappers never call it. Grid (H, B,
// ceil(S / 64)), the last query tiles first.
// ---------------------------------------------------------------------------
template <int CT>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_simt_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ o,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         float* __restrict__ dq, float* __restrict__ delta,
                         Geo g) {
  constexpr int DV = 32 * CT;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // kBq x DV, pre-scaled
  float* dos = qs + kBq * DV;     // kBq x DV
  float* kt = dos + kBq * DV;     // DV x kKs
  float* vt = kt + DV * kKs;      // DV x kKs
  float* dss = vt + DV * kKs;     // kBq x kBk
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBq, h = blockIdx.x,
            b = blockIdx.y;
  const int kvh = h / g.rep;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * kRows;

  load_rows<kBq, DV>(qs, q, g, b, q0, h, g.H, g.scale);
  load_rows<kBq, DV>(dos, dout, g, b, q0, h, g.H, 1.f);
  __syncthreads();

  float lse_r[kRows], del[kRows], acc[kRows][CT];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + r0 + r;
    float part = 0.f;
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      const int c = lane + 32 * t;
      if (qp < g.S && c < g.D)
        part = fmaf(dos[(r0 + r) * DV + c], o[q_index(g, b, qp, h, c)], part);
    }
    del[r] = warp_sum(part);
    const size_t row = (static_cast<size_t>(b) * g.H + h) * g.S + qp;
    lse_r[r] = qp < g.S ? lse[row] : 0.f;
    if (lane == 0 && qp < g.S) delta[row] = del[r];
#pragma unroll
    for (int t = 0; t < CT; ++t) acc[r][t] = 0.f;
  }

  const int n_tiles = (g.S + kBk - 1) / kBk;
  for (int kt_i = 0; kt_i < n_tiles; ++kt_i) {
    const int k0 = kt_i * kBk;
    if (!tile_live(q0, kBq, k0, kBk, g)) continue;
    __syncthreads();
    load_keys_t<DV>(kt, k, g, b, k0, kvh);
    load_keys_t<DV>(vt, v, g, b, k0, kvh);
    __syncthreads();

    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
    for (int c = 0; c < DV; c += 4) {
      float kc[4], vc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kc[i] = kt[(c + i) * kKs + lane];
        vc[i] = vt[(c + i) * kKs + lane];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&qs[(r0 + r) * DV + c]);
        const float4 dv4 =
            *reinterpret_cast<const float4*>(&dos[(r0 + r) * DV + c]);
        s[r] = fmaf(qv.x, kc[0], s[r]);
        s[r] = fmaf(qv.y, kc[1], s[r]);
        s[r] = fmaf(qv.z, kc[2], s[r]);
        s[r] = fmaf(qv.w, kc[3], s[r]);
        dp[r] = fmaf(dv4.x, vc[0], dp[r]);
        dp[r] = fmaf(dv4.y, vc[1], dp[r]);
        dp[r] = fmaf(dv4.z, vc[2], dp[r]);
        dp[r] = fmaf(dv4.w, vc[3], dp[r]);
      }
    }
    const int kp = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float p =
          pair_ok(q0 + r0 + r, kp, g) ? expf(s[r] - lse_r[r]) : 0.f;
      dss[(r0 + r) * kBk + lane] = p * (dp[r] - del[r]);
    }
    __syncwarp();
    for (int j = 0; j < kBk; j += 4) {
      float4 dsv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        dsv[r] = *reinterpret_cast<const float4*>(&dss[(r0 + r) * kBk + j]);
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        const float* kcol = kt + (lane + 32 * t) * kKs + j;
        const float k0v = kcol[0], k1v = kcol[1], k2v = kcol[2],
                    k3v = kcol[3];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float a = acc[r][t];
          a = fmaf(dsv[r].x, k0v, a);
          a = fmaf(dsv[r].y, k1v, a);
          a = fmaf(dsv[r].z, k2v, a);
          a = fmaf(dsv[r].w, k3v, a);
          acc[r][t] = a;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= g.S) continue;
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      const int c = lane + 32 * t;
      if (c < g.D) dq[q_index(g, b, qp, h, c)] = acc[r][t] * g.scale;
    }
  }
}

// ---------------------------------------------------------------------------
// backward, launch 2, the CUDA-core version (the first design): dK and dV of
// one query head in float32 FMAs. Kept as a yardstick for the tensor-core
// kernel below (C symbol flash_bwd_dkv_simt); the wrappers never call it.
// Grid (H, B, ceil(S / 32)), the first key tiles first.
// ---------------------------------------------------------------------------
template <int CT>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_simt_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          Geo g) {
  // dk, dv: (B, S, H, D) partials, or (B, S, KV, D) when rep == 1
  constexpr int DV = 32 * CT;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;               // DV x kKs, this block's keys
  float* vt = kt + DV * kKs;      // DV x kKs, its values
  float* qs = vt + DV * kKs;      // kBq2 x DV, pre-scaled
  float* dos = qs + kBq2 * DV;    // kBq2 x DV
  float* pt = dos + kBq2 * DV;    // kBk x kPs, P transposed
  float* dst = pt + kBk * kPs;    // kBk x kPs, dS transposed
  float* lses = dst + kBk * kPs;  // kBq2
  float* dels = lses + kBq2;      // kBq2
  const int k0 = blockIdx.z * kBk, h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / g.rep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i0 = warp * kRows2;   // query rows of this warp (S, dP)
  const int j0 = warp * kRows2;   // key rows of this warp (dK, dV)

  load_keys_t<DV>(kt, k, g, b, k0, kvh);
  load_keys_t<DV>(vt, v, g, b, k0, kvh);
  float dk_acc[kRows2][CT], dv_acc[kRows2][CT];
#pragma unroll
  for (int r = 0; r < kRows2; ++r)
#pragma unroll
    for (int t = 0; t < CT; ++t) dk_acc[r][t] = dv_acc[r][t] = 0.f;

  const int kp = k0 + lane;
  const int n_qtiles = (g.S + kBq2 - 1) / kBq2;
  for (int qt_i = 0; qt_i < n_qtiles; ++qt_i) {
    const int q0 = qt_i * kBq2;
    if (!tile_live(q0, kBq2, k0, kBk, g)) continue;
    __syncthreads();   // the previous step's tiles are consumed
    load_rows<kBq2, DV>(qs, q, g, b, q0, h, g.H, g.scale);
    load_rows<kBq2, DV>(dos, dout, g, b, q0, h, g.H, 1.f);
    for (int i = threadIdx.x; i < kBq2; i += kThreads) {
      const int qp = q0 + i;
      const size_t row = (static_cast<size_t>(b) * g.H + h) * g.S + qp;
      lses[i] = qp < g.S ? lse[row] : 0.f;
      dels[i] = qp < g.S ? delta[row] : 0.f;
    }
    __syncthreads();

    float s[kRows2], dp[kRows2];
#pragma unroll
    for (int r = 0; r < kRows2; ++r) s[r] = dp[r] = 0.f;
    for (int c = 0; c < DV; c += 4) {
      float kc[4], vc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kc[i] = kt[(c + i) * kKs + lane];
        vc[i] = vt[(c + i) * kKs + lane];
      }
#pragma unroll
      for (int r = 0; r < kRows2; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&qs[(i0 + r) * DV + c]);
        const float4 dv4 =
            *reinterpret_cast<const float4*>(&dos[(i0 + r) * DV + c]);
        s[r] = fmaf(qv.x, kc[0], s[r]);
        s[r] = fmaf(qv.y, kc[1], s[r]);
        s[r] = fmaf(qv.z, kc[2], s[r]);
        s[r] = fmaf(qv.w, kc[3], s[r]);
        dp[r] = fmaf(dv4.x, vc[0], dp[r]);
        dp[r] = fmaf(dv4.y, vc[1], dp[r]);
        dp[r] = fmaf(dv4.z, vc[2], dp[r]);
        dp[r] = fmaf(dv4.w, vc[3], dp[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows2; ++r) {
      const int i = i0 + r;
      const float p =
          pair_ok(q0 + i, kp, g) ? expf(s[r] - lses[i]) : 0.f;
      pt[lane * kPs + i] = p;
      dst[lane * kPs + i] = p * (dp[r] - dels[i]);
    }
    __syncthreads();   // other warps read these keys' columns

    for (int i = 0; i < kBq2; i += 4) {
      float4 pv[kRows2], dsv[kRows2];
#pragma unroll
      for (int r = 0; r < kRows2; ++r) {
        pv[r] = *reinterpret_cast<const float4*>(&pt[(j0 + r) * kPs + i]);
        dsv[r] = *reinterpret_cast<const float4*>(&dst[(j0 + r) * kPs + i]);
      }
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        const int c = lane + 32 * t;
        const float d0 = dos[i * DV + c], d1 = dos[(i + 1) * DV + c],
                    d2 = dos[(i + 2) * DV + c], d3 = dos[(i + 3) * DV + c];
        const float q0v = qs[i * DV + c], q1v = qs[(i + 1) * DV + c],
                    q2v = qs[(i + 2) * DV + c], q3v = qs[(i + 3) * DV + c];
#pragma unroll
        for (int r = 0; r < kRows2; ++r) {
          float a = dv_acc[r][t];
          a = fmaf(pv[r].x, d0, a);
          a = fmaf(pv[r].y, d1, a);
          a = fmaf(pv[r].z, d2, a);
          a = fmaf(pv[r].w, d3, a);
          dv_acc[r][t] = a;
          float e = dk_acc[r][t];
          e = fmaf(dsv[r].x, q0v, e);
          e = fmaf(dsv[r].y, q1v, e);
          e = fmaf(dsv[r].z, q2v, e);
          e = fmaf(dsv[r].w, q3v, e);
          dk_acc[r][t] = e;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows2; ++r) {
    const int t_row = k0 + j0 + r;
    if (t_row >= g.S) continue;
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      const int c = lane + 32 * t;
      if (c < g.D) {
        const size_t at = q_index(g, b, t_row, h, c);
        dk[at] = dk_acc[r][t];
        dv[at] = dv_acc[r][t];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward, launch 2: dK and dV of one query head on the tensor cores
// (3xTF32 mma.sync, float32 accuracy); grid (H, B, ceil(S / 32)), the first
// key tiles (the most query tiles under a causal mask) first. With rep > 1
// it writes the head's partial sums (B, S, H, D), and flash_bwd_sum_heads
// adds the rep heads of each kv head in order.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}
// every group but the one committed last has landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Start copying rows [t0, t0 + ROWS) of head h of a (B, S, nh, D) float32
// tensor into dst (rows of dkv_row(DV) floats); zeros past S and past D.
// 16-byte copies where g.vec, else one per element.
template <int ROWS, int DV>
__device__ __forceinline__ void async_rows(float* dst, const float* src,
                                           const Geo& g, int b, int t0, int h,
                                           int nh) {
  constexpr int kRow = dkv_row(DV);
  if (g.vec) {
    static_assert(ROWS * DV % (4 * kThreads) == 0, "uneven tile");
#pragma unroll
    for (int i = 0; i < ROWS * DV / 4 / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (DV / 4), c = (idx % (DV / 4)) * 4, t = t0 + r;
      const bool ok = t < g.S && c < g.D;
      cp_async16(dst + r * kRow + c,
                 ok ? src + ((static_cast<size_t>(b) * g.S + t) * nh + h) *
                                g.D + c
                    : src,
                 ok);
    }
    return;
  }
  static_assert(ROWS * DV % kThreads == 0, "uneven tile");
#pragma unroll 4
  for (int i = 0; i < ROWS * DV / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / DV, c = idx % DV, t = t0 + r;
    const bool ok = t < g.S && c < g.D;
    cp_async4(dst + r * kRow + c,
              ok ? src + ((static_cast<size_t>(b) * g.S + t) * nh + h) * g.D +
                       c
                 : src,
              ok);
  }
}

// The first query tile at or after qt that is live for the key tile at k0
// (n when none is); the same on every thread of the block.
__device__ __forceinline__ int next_live(int qt, int n, int k0,
                                         const Geo& g) {
  while (qt < n && !tile_live(qt * kBq2, kBq2, k0, kBk, g)) ++qt;
  return qt;
}

// Step 1 of both tensor-core passes: C = A B^T for 32 rows of A (the block's
// own tile) against 32 rows of B (the streamed tile), both row-major with
// rows of kRow floats; the B fragment (t, g) of B^T is B[g][t]. Warp
// (pv, pm, ph) passes its product's A and B (pv = 0 or 1) and sums rows
// 16 pm + [0, 16) of A against all of B over the columns of half ph, so
// that each split of its A fragment feeds four products; the partial sums
// of fragment (pm, n) go to slot (pv, ph) of the exchange.
template <int DV, int kRow>
__device__ __forceinline__ void tile_products(float4* xs, const float* a,
                                              const float* b, int pv, int pm,
                                              int ph, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
  // the small terms of the split go to their own accumulators, so that no
  // mma waits on the one before it
  float big[4][4] = {}, small[4][4] = {};
  const int c0 = ph * (DV / 2);
  a += (16 * pm + gq) * kRow + tq + c0;
  b += gq * kRow + tq + c0;
#pragma unroll
  for (int c = 0; c < DV / 2; c += 8) {
    const tf32x3::FragA af = tf32x3::frag_a(a[c], a[8 * kRow + c], a[c + 4],
                                            a[8 * kRow + c + 4]);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float* bp = b + 8 * n * kRow + c;
      tf32x3::mma3(big[n], small[n], af, tf32x3::frag_b(bp[0], bp[4]));
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
    xs[(4 * pm + n) * 128 + (2 * pv + ph) * 32 + lane] =
        make_float4(big[n][0] + small[n][0], big[n][1] + small[n][1],
                    big[n][2] + small[n][2], big[n][3] + small[n][3]);
}

// hi (lo = false) or lo parts of an accumulator fragment's split elements
// in the A-fragment order (c0, c2, c1, c3): with the reduction pair k = t,
// t + 4 of a step taken as columns 2t, 2t + 1, an accumulator fragment is
// lane for lane an A fragment.
__device__ __forceinline__ float4 a_order(const tf32x3::Split* v, bool lo) {
  return lo ? make_float4(__uint_as_float(v[0].lo), __uint_as_float(v[2].lo),
                          __uint_as_float(v[1].lo), __uint_as_float(v[3].lo))
            : make_float4(__uint_as_float(v[0].hi), __uint_as_float(v[2].hi),
                          __uint_as_float(v[1].hi), __uint_as_float(v[3].hi));
}

template <int CT>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, Geo g) {
  // dk, dv: (B, S, H, D) partials, or (B, S, KV, D) when rep == 1
  using tf32x3::FragA;
  using tf32x3::FragB;
  constexpr int DV = 32 * CT;
  constexpr int kRow = dkv_row(DV);
  // dV += P^T dO and dK += dS^T Q: the block's 2 x DV / 8 output tiles of
  // 16 x 8 per matrix, kWN warps along the columns, kWM along the keys
  constexpr int kWN = DV / 8 < kWarps ? DV / 8 : kWarps;
  constexpr int kWM = kWarps / kWN;
  constexpr int kMT = 2 / kWM;            // key m-tiles of a warp
  constexpr int kNT = DV / 8 / kWN;       // column n-tiles of a warp
  constexpr int kNH = kNT > 1 ? 2 : 1;    // column halves of a tile's sums
  static_assert(kBk == 32 && kBq2 == 32 && kWarps == 8,
                "the warp roles below assume 32 x 32 tiles and 8 warps");
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                       // kBk x kRow, this block's keys
  float* vs = ks + kBk * kRow;            // kBk x kRow, its values
  float* stages = vs + kBk * kRow;        // 2 x [Q | dO], kBq2 x kRow each
  float* rows = stages + 4 * kBq2 * kRow; // 2 x [lse | delta], kBq2 each
  // the exchange, fragment (m, n) at xs + (4 m + n) * 128 + slot * 32 +
  // lane: first the products' partial sums, then P^T and dS^T, split
  float4* xs = reinterpret_cast<float4*>(rows + 4 * kBq2);
  const int k0 = blockIdx.z * kBk, h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / g.rep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int n_qtiles = (g.S + kBq2 - 1) / kBq2;

  // one query tile's Q, dO, lse and delta into stage s
  auto load_tile = [&](int s, int qt) {
    float* qs = stages + s * 2 * kBq2 * kRow;
    const int q0 = qt * kBq2;
    async_rows<kBq2, DV>(qs, q, g, b, q0, h, g.H);
    async_rows<kBq2, DV>(qs + kBq2 * kRow, dout, g, b, q0, h, g.H);
    if (threadIdx.x < 2 * kBq2) {
      const int i = threadIdx.x % kBq2, qp = q0 + i;
      const float* src = threadIdx.x < kBq2 ? lse : delta;
      const bool ok = qp < g.S;
      cp_async4(rows + s * 2 * kBq2 + threadIdx.x,
                ok ? src + (static_cast<size_t>(b) * g.H + h) * g.S + qp
                   : src,
                ok);
    }
  };

  async_rows<kBk, DV>(ks, k, g, b, k0, kvh, g.KV);
  async_rows<kBk, DV>(vs, v, g, b, k0, kvh, g.KV);
  int qt = next_live(0, n_qtiles, k0, g);
  if (qt < n_qtiles) load_tile(0, qt);
  cp_async_commit();

  float dk_acc[kMT][kNT][4], dv_acc[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[mi][ni][e] = dv_acc[mi][ni][e] = 0.f;

  // S^T = K Q^T (pv = 0) or dP^T = V dO^T (pv = 1): warp (pv, pm, ph) sums
  // keys 16 pm + [0, 16) against all 32 queries over the columns of half
  // ph, so each split of its K or V fragment feeds four products
  const int pv = warp >> 2, pm = (warp >> 1) & 1, ph = warp & 1;
  // P^T and dS^T of fragment (warp / 4, warp % 4) form in warp `warp`
  const int fm = warp >> 2, fn = warp & 3;
  // dV, dK: warp (wm, wn) owns key m-tiles wm * kMT + [0, kMT) and column
  // n-tiles wn * kNT + [0, kNT)
  const int wm = warp / kWN, wn = warp % kWN;
  int st = 0;
  while (qt < n_qtiles) {
    cp_async_wait_all();
    __syncthreads();   // tile qt landed; the previous tile is consumed
    const int nxt = next_live(qt + 1, n_qtiles, k0, g);
    if (nxt < n_qtiles) load_tile(st ^ 1, nxt);
    cp_async_commit();
    const int q0 = qt * kBq2;
    const float* qs = stages + st * 2 * kBq2 * kRow;
    const float* dos = qs + kBq2 * kRow;
    const float* lses = rows + st * 2 * kBq2;
    const float* dels = lses + kBq2;

    tile_products<DV, kRow>(xs, pv ? vs : ks, pv ? dos : qs, pv, pm, ph,
                            lane);
    __syncthreads();   // the four partial sums of every fragment are in

    {
      // P^T = mask ? exp(S^T - lse) : 0 and dS^T = P^T (dP^T - delta) on
      // fragment (fm, fn): element e is key 16 fm + gq + 8 (e / 2), query
      // 8 fn + 2 tq + e % 2
      float4* x = xs + warp * 128 + lane;
      const float4 s0 = x[0], s1 = x[32], d0 = x[64], d1 = x[96];
      const float sv[4] = {s0.x + s1.x, s0.y + s1.y, s0.z + s1.z,
                           s0.w + s1.w};
      const float dpv[4] = {d0.x + d1.x, d0.y + d1.y, d0.z + d1.z,
                            d0.w + d1.w};
      tf32x3::Split ps[4], dss[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * fn + 2 * tq + (e & 1);
        const int j = 16 * fm + gq + 8 * (e >> 1);
        const float pe = pair_ok(q0 + i, k0 + j, g)
                             ? expf(sv[e] * g.scale - lses[i])
                             : 0.f;
        ps[e] = tf32x3::split(pe);
        dss[e] = tf32x3::split(pe * (dpv[e] - dels[i]));
      }
      // stored as the A fragment of the next products (rows keys, the
      // reduction pair of a step queries 2t, 2t + 1), split; slots P hi,
      // P lo, dS hi, dS lo. Each lane overwrites only what it read.
      x[0] = a_order(ps, false);
      x[32] = a_order(ps, true);
      x[64] = a_order(dss, false);
      x[96] = a_order(dss, true);
    }
    __syncthreads();   // every warp reads all of P^T and dS^T

    // dV += P^T dO and dK += dS^T Q over the tile's queries, 8 at a time.
    // The tensor cores truncate when they add into an accumulator, so the
    // error of a long chain grows with its length and one sign: each tile
    // sums into fresh fragments, which join the running sums by float32
    // adds (round to nearest); in column halves, to bound the registers.
#pragma unroll
    for (int nh = 0; nh < kNH; ++nh) {
      float tk[kMT][kNT / kNH][4] = {}, tv[kMT][kNT / kNH][4] = {};
#pragma unroll
      for (int kk = 0; kk < kBq2 / 8; ++kk) {
        FragA pa[kMT], da[kMT];
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          const float4* x = xs + (4 * (wm * kMT + mi) + kk) * 128 + lane;
          const float4 ph4 = x[0], pl4 = x[32], dh4 = x[64], dl4 = x[96];
          pa[mi] = {{{__float_as_uint(ph4.x), __float_as_uint(pl4.x)},
                     {__float_as_uint(ph4.y), __float_as_uint(pl4.y)},
                     {__float_as_uint(ph4.z), __float_as_uint(pl4.z)},
                     {__float_as_uint(ph4.w), __float_as_uint(pl4.w)}}};
          da[mi] = {{{__float_as_uint(dh4.x), __float_as_uint(dl4.x)},
                     {__float_as_uint(dh4.y), __float_as_uint(dl4.y)},
                     {__float_as_uint(dh4.z), __float_as_uint(dl4.z)},
                     {__float_as_uint(dh4.w), __float_as_uint(dl4.w)}}};
        }
#pragma unroll
        for (int j = 0; j < kNT / kNH; ++j) {
          const int ni = nh * (kNT / kNH) + j;
          const int at = (8 * kk + 2 * tq) * kRow + 8 * (wn * kNT + ni) + gq;
          const FragB df = tf32x3::frag_b(dos[at], dos[at + kRow]);
          const FragB qf = tf32x3::frag_b(qs[at], qs[at + kRow]);
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi) {
            tf32x3::mma3(tv[mi][j], pa[mi], df);
            tf32x3::mma3(tk[mi][j], da[mi], qf);
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int j = 0; j < kNT / kNH; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dv_acc[mi][nh * (kNT / kNH) + j][e] += tv[mi][j][e];
            dk_acc[mi][nh * (kNT / kNH) + j][e] += tk[mi][j][e];
          }
    }
    qt = nxt;
    st ^= 1;
  }
  cp_async_wait_all();

#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t_row = k0 + 16 * (wm * kMT + mi) + gq + 8 * (e >> 1);
        const int c = 8 * (wn * kNT + ni) + 2 * tq + (e & 1);
        if (t_row < g.S && c < g.D) {
          const size_t at = q_index(g, b, t_row, h, c);
          dk[at] = dk_acc[mi][ni][e] * g.scale;
          dv[at] = dv_acc[mi][ni][e];
        }
      }
}

// ---------------------------------------------------------------------------
// backward, launch 1: Delta and dQ of one head on the tensor cores (3xTF32
// mma.sync, float32 accuracy), the dK/dV kernel above with the roles of
// queries and keys swapped; grid (H, B, ceil(S / 32)), the last query tiles
// (the most key tiles under a causal mask) first.
// ---------------------------------------------------------------------------
// The first key tile at or after kt that is live for the query tile at q0
// (n when none is); the same on every thread of the block.
__device__ __forceinline__ int next_live_key(int kt, int n, int q0,
                                             const Geo& g) {
  while (kt < n && !tile_live(q0, kBq2, kt * kBk, kBk, g)) ++kt;
  return kt;
}

template <int CT>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dq,
                    float* __restrict__ delta, Geo g) {
  using tf32x3::FragA;
  constexpr int DV = 32 * CT;
  constexpr int kRow = dkv_row(DV);
  // dQ += dS K: the block's 2 x DV / 8 output tiles of 16 x 8, kWN warps
  // along the columns, kWM along the queries
  constexpr int kWN = DV / 8 < kWarps ? DV / 8 : kWarps;
  constexpr int kWM = kWarps / kWN;
  constexpr int kMT = 2 / kWM;            // query m-tiles of a warp
  constexpr int kNT = DV / 8 / kWN;       // column n-tiles of a warp
  constexpr int kRowsW = kBq2 / kWarps;   // rows of a warp's delta
  static_assert(kBk == 32 && kBq2 == 32 && kWarps == 8,
                "the warp roles below assume 32 x 32 tiles and 8 warps");
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // kBq2 x kRow, this block's queries
  float* dos = qs + kBq2 * kRow;          // kBq2 x kRow, their dO
  float* lses = dos + kBq2 * kRow;        // kBq2
  float* dels = lses + kBq2;              // kBq2
  float* stages = dels + kBq2;            // 2 x [K | V], kBk x kRow each
  // the exchange, fragment (m, n) at xs + (4 m + n) * 128 + slot * 32 +
  // lane: first the products' partial sums, then dS, split
  float4* xs = reinterpret_cast<float4*>(stages + 4 * kBk * kRow);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBq2, h = blockIdx.x,
            b = blockIdx.y;
  const int kvh = h / g.rep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int n_ktiles = (g.S + kBk - 1) / kBk;

  // one key tile's K and V into stage s
  auto load_tile = [&](int s, int kt) {
    float* ks = stages + s * 2 * kBk * kRow;
    async_rows<kBk, DV>(ks, k, g, b, kt * kBk, kvh, g.KV);
    async_rows<kBk, DV>(ks + kBk * kRow, v, g, b, kt * kBk, kvh, g.KV);
  };

  async_rows<kBq2, DV>(qs, q, g, b, q0, h, g.H);
  async_rows<kBq2, DV>(dos, dout, g, b, q0, h, g.H);
  if (threadIdx.x < kBq2) {
    const int qp = q0 + threadIdx.x;
    const bool ok = qp < g.S;
    cp_async4(lses + threadIdx.x,
              ok ? lse + (static_cast<size_t>(b) * g.H + h) * g.S + qp : lse,
              ok);
  }
  cp_async_commit();
  int kt = next_live_key(0, n_ktiles, q0, g);
  if (kt < n_ktiles) load_tile(0, kt);
  cp_async_commit();
  cp_async_wait_prior();
  __syncthreads();   // Q, dO and lse landed; the first key tile may not

  // Delta = rowsum(dO * O) as the CUDA-core kernel forms it (lane l sums
  // columns l, l + 32, ... in float32 FMAs, then the warp sums its lanes),
  // so that it is the same bits; warp w owns rows kRowsW w + [0, kRowsW)
#pragma unroll
  for (int r = 0; r < kRowsW; ++r) {
    const int i = warp * kRowsW + r, qp = q0 + i;
    float part = 0.f;
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      const int c = lane + 32 * t;
      if (qp < g.S && c < g.D)
        part = fmaf(dos[i * kRow + c], o[q_index(g, b, qp, h, c)], part);
    }
    const float del = warp_sum(part);
    if (lane == 0) {
      dels[i] = del;
      if (qp < g.S) delta[(static_cast<size_t>(b) * g.H + h) * g.S + qp] = del;
    }
  }

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // S = Q K^T (pv = 0) or dP = dO V^T (pv = 1): warp (pv, pm, ph) sums
  // queries 16 pm + [0, 16) against all 32 keys over the columns of half
  // ph, so each split of its Q or dO fragment feeds four products. K and V
  // are row-major: the B fragment (t, g) of K^T is K[g][t].
  const int pv = warp >> 2, pm = (warp >> 1) & 1, ph = warp & 1;
  // dS of fragment (warp / 4, warp % 4) forms in warp `warp`
  const int fm = warp >> 2, fn = warp & 3;
  // dQ: warp (wm, wn) owns query m-tiles wm * kMT + [0, kMT) and column
  // n-tiles wn * kNT + [0, kNT)
  const int wm = warp / kWN, wn = warp % kWN;
  int st = 0;
  while (kt < n_ktiles) {
    cp_async_wait_all();
    __syncthreads();   // tile kt landed; the previous tile is consumed
    const int nxt = next_live_key(kt + 1, n_ktiles, q0, g);
    if (nxt < n_ktiles) load_tile(st ^ 1, nxt);
    cp_async_commit();
    const int k0 = kt * kBk;
    const float* ks = stages + st * 2 * kBk * kRow;
    const float* vs = ks + kBk * kRow;

    tile_products<DV, kRow>(xs, pv ? dos : qs, pv ? vs : ks, pv, pm, ph,
                            lane);
    __syncthreads();   // the four partial sums of every fragment are in

    {
      // P = mask ? exp(S / sqrt(D) - lse) : 0 and dS = P (dP - delta) on
      // fragment (fm, fn): element e is query 16 fm + gq + 8 (e / 2), key
      // 8 fn + 2 tq + e % 2
      float4* x = xs + warp * 128 + lane;
      const float4 s0 = x[0], s1 = x[32], d0 = x[64], d1 = x[96];
      const float sv[4] = {s0.x + s1.x, s0.y + s1.y, s0.z + s1.z,
                           s0.w + s1.w};
      const float dpv[4] = {d0.x + d1.x, d0.y + d1.y, d0.z + d1.z,
                            d0.w + d1.w};
      tf32x3::Split dss[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * fm + gq + 8 * (e >> 1);
        const int j = 8 * fn + 2 * tq + (e & 1);
        const float pe = pair_ok(q0 + i, k0 + j, g)
                             ? expf(sv[e] * g.scale - lses[i])
                             : 0.f;
        dss[e] = tf32x3::split(pe * (dpv[e] - dels[i]));
      }
      // stored as the A fragment of dQ += dS K (rows queries, the
      // reduction pair of a step keys 2t, 2t + 1), split; slots dS hi, dS
      // lo. Each lane overwrites only what it read.
      x[0] = a_order(dss, false);
      x[32] = a_order(dss, true);
    }
    __syncthreads();   // every warp reads all of dS

    {
      // dQ += dS K over the tile's keys, 8 at a time. The tensor cores
      // truncate when they add into an accumulator, so the error of a long
      // chain grows with its length and one sign: each tile sums into
      // fresh fragments, which join the running sums by float32 adds
      // (round to nearest).
      float td[kMT][kNT][4] = {};
#pragma unroll
      for (int kk = 0; kk < kBk / 8; ++kk) {
        FragA da[kMT];
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          const float4* x = xs + (4 * (wm * kMT + mi) + kk) * 128 + lane;
          const float4 h4 = x[0], l4 = x[32];
          da[mi] = {{{__float_as_uint(h4.x), __float_as_uint(l4.x)},
                     {__float_as_uint(h4.y), __float_as_uint(l4.y)},
                     {__float_as_uint(h4.z), __float_as_uint(l4.z)},
                     {__float_as_uint(h4.w), __float_as_uint(l4.w)}}};
        }
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) {
          const int at = (8 * kk + 2 * tq) * kRow + 8 * (wn * kNT + ni) + gq;
          const tf32x3::FragB kf = tf32x3::frag_b(ks[at], ks[at + kRow]);
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi)
            tf32x3::mma3(td[mi][ni], da[mi], kf);
        }
      }
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += td[mi][ni][e];
    }
    kt = nxt;
    st ^= 1;
  }
  cp_async_wait_all();

#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = q0 + 16 * (wm * kMT + mi) + gq + 8 * (e >> 1);
        const int c = 8 * (wn * kNT + ni) + 2 * tq + (e & 1);
        if (qp < g.S && c < g.D)
          dq[q_index(g, b, qp, h, c)] = acc[mi][ni][e] * g.scale;
      }
}

// backward, launch 3 (rep > 1 only): dK and dV of each kv head, the sum of
// its rep query heads' partials in head order from 0.f, the plain
// sequential adds bit for bit. A streaming pass, bound by device memory
// (42 MB at gemma3-1b's training shape): one warp per (b, t, kv) row, the
// row's base offsets computed once per row in 32-bit and 64-bit integers,
// lanes on neighbouring 16-byte pieces of the row (4-byte pieces where D %
// 4 != 0 or a pointer is not 16-byte aligned), and enough warps in flight
// to fill every SM.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_sum_heads(const float* __restrict__ dk_part,
                    const float* __restrict__ dv_part, float* __restrict__ dk,
                    float* __restrict__ dv, Geo g, int rows) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows;
       row += stride) {
    const int bt = row / g.KV, kvh = row - bt * g.KV;  // row = bt * KV + kvh
    const size_t in = (static_cast<size_t>(bt) * g.H +
                       static_cast<size_t>(kvh) * g.rep) * g.D;
    const size_t out = static_cast<size_t>(row) * g.D;
    if (VEC) {
      for (int c = 4 * lane; c < g.D; c += 128) {
        float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
        for (int r = 0; r < g.rep; ++r) {
          const size_t o = in + static_cast<size_t>(r) * g.D + c;
          const float4 pk = __ldg(reinterpret_cast<const float4*>(dk_part + o));
          const float4 pv = __ldg(reinterpret_cast<const float4*>(dv_part + o));
          sk.x += pk.x; sk.y += pk.y; sk.z += pk.z; sk.w += pk.w;
          sv.x += pv.x; sv.y += pv.y; sv.z += pv.z; sv.w += pv.w;
        }
        *reinterpret_cast<float4*>(dk + out + c) = sk;
        *reinterpret_cast<float4*>(dv + out + c) = sv;
      }
    } else {
      for (int c = lane; c < g.D; c += 32) {
        float sk = 0.f, sv = 0.f;
        for (int r = 0; r < g.rep; ++r) {
          const size_t o = in + static_cast<size_t>(r) * g.D + c;
          sk += dk_part[o];
          sv += dv_part[o];
        }
        dk[out + c] = sk;
        dv[out + c] = sv;
      }
    }
  }
}

int columns_per_lane(int d) {
  if (d <= 32) return 1;
  if (d <= 64) return 2;
  if (d <= 128) return 4;
  if (d <= 256) return 8;
  return 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();  // keep the next check clean
  return err;
}

template <typename T, int CT>
int launch_fwd(const T* q, const T* k, const T* v, T* o, float* lse,
               const Geo& g, cudaStream_t st) {
  const size_t smem = fwd_smem_floats(32 * CT) * sizeof(float);
  cudaError_t err = allow_smem(flash_fwd_kernel<T, CT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.H, g.B, (g.S + kBq - 1) / kBq);
  flash_fwd_kernel<T, CT><<<grid, kThreads, smem, st>>>(q, k, v, o, lse, g);
  return cudaGetLastError();
}

template <int CT, bool kSimt>
int launch_bwd_dq(const float* q, const float* k, const float* v,
                  const float* o, const float* dout, const float* lse,
                  float* dq, float* delta, const Geo& g, cudaStream_t st) {
  const int dv_cols = 32 * CT;
  const size_t smem = (kSimt ? dq_simt_smem_floats(dv_cols)
                             : dq_smem_floats(dv_cols)) * sizeof(float);
  auto kernel = kSimt ? flash_bwd_dq_simt_kernel<CT>
                      : flash_bwd_dq_kernel<CT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int rows = kSimt ? kBq : kBq2;
  const dim3 grid(g.H, g.B, (g.S + rows - 1) / rows);
  kernel<<<grid, kThreads, smem, st>>>(q, k, v, o, dout, lse, dq, delta, g);
  return cudaGetLastError();
}

template <int CT, bool kSimt>
int launch_bwd_dkv(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* delta,
                   float* dk, float* dv, const Geo& g, cudaStream_t st) {
  const int dv_cols = 32 * CT;
  const size_t smem = (kSimt ? dkv_simt_smem_floats(dv_cols)
                             : dkv_smem_floats(dv_cols)) * sizeof(float);
  auto kernel = kSimt ? flash_bwd_dkv_simt_kernel<CT>
                      : flash_bwd_dkv_kernel<CT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.H, g.B, (g.S + kBk - 1) / kBk);
  kernel<<<grid, kThreads, smem, st>>>(q, k, v, dout, lse, delta, dk, dv, g);
  return cudaGetLastError();
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

Geo make_geo(int b, int s, int h, int kv, int d, int causal, int window,
             int prefix, bool vec) {
  Geo g;
  g.B = b;
  g.S = s;
  g.H = h;
  g.KV = kv;
  g.D = d;
  g.rep = h / kv;
  g.causal = causal;
  g.window = window;
  g.prefix = prefix;
  g.vec = vec && d % 4 == 0;
  g.scale = 1.0f / sqrtf(static_cast<float>(d));
  return g;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of dynamic shared memory one block needs at head dim d:
// which = 0 forward, 1 backward dQ, 2 backward dK/dV, 3 and 4 the CUDA-core
// yardsticks of dQ and dK/dV.
long long flash_smem_bytes(int which, int d) {
  const int ct = columns_per_lane(d);
  if (ct == 0 || which < 0 || which > 4) return -1;
  const int dv = 32 * ct;
  const size_t f[5] = {fwd_smem_floats(dv), dq_smem_floats(dv),
                       dkv_smem_floats(dv), dq_simt_smem_floats(dv),
                       dkv_simt_smem_floats(dv)};
  return static_cast<long long>(f[which] * sizeof(float));
}

// o (B, S, H, D) in q's dtype and lse (B, H, S) float32 from q (B, S, H, D)
// and k, v (B, S, KV, D), all contiguous; bf16 = 0 for float32, 1 for
// bfloat16 inputs and output; D <= 256, H % KV == 0. Returns cudaSuccess or
// the error of the attribute call or the launch (cudaGetLastError()).
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int bf16, int b, int s, int h, int kv, int d,
              int causal, int window, int prefix, void* stream) {
  const size_t row_align = bf16 ? 8 : 16;
  const Geo g = make_geo(b, s, h, kv, d, causal, window, prefix,
                         aligned(q, row_align) && aligned(k, row_align) &&
                             aligned(v, row_align));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define REPRO_FWD(T, CT)                                                     \
  return launch_fwd<T, CT>(static_cast<const T*>(q), static_cast<const T*>(k), \
                           static_cast<const T*>(v), static_cast<T*>(o), l,  \
                           g, st)
  switch (columns_per_lane(d) * (bf16 ? -1 : 1)) {
    case 1: REPRO_FWD(float, 1);
    case 2: REPRO_FWD(float, 2);
    case 4: REPRO_FWD(float, 4);
    case 8: REPRO_FWD(float, 8);
    case -1: REPRO_FWD(__nv_bfloat16, 1);
    case -2: REPRO_FWD(__nv_bfloat16, 2);
    case -4: REPRO_FWD(__nv_bfloat16, 4);
    case -8: REPRO_FWD(__nv_bfloat16, 8);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FWD
}

// Backward, launch 1: dq (B, S, H, D) and delta (B, H, S) from q, k, v,
// o, dout and the forward's lse; everything float32 and contiguous. simt =
// 0 runs the tensor-core kernel (the one the wrappers call), 1 the
// CUDA-core yardstick.
static int bwd_dq(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const void* lse, void* dq, void* delta,
                  int b, int s, int h, int kv, int d, int causal, int window,
                  int prefix, void* stream, bool simt) {
  const Geo g = make_geo(b, s, h, kv, d, causal, window, prefix,
                         aligned(q, 16) && aligned(k, 16) && aligned(v, 16) &&
                             aligned(dout, 16));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_BWD_DQ(CT)                                                     \
  return simt ? launch_bwd_dq<CT, true>(ARGS) : launch_bwd_dq<CT, false>(ARGS)
#define ARGS                                                                 \
  static_cast<const float*>(q), static_cast<const float*>(k),                \
      static_cast<const float*>(v), static_cast<const float*>(o),            \
      static_cast<const float*>(dout), static_cast<const float*>(lse),       \
      static_cast<float*>(dq), static_cast<float*>(delta), g, st
  switch (columns_per_lane(d)) {
    case 1: REPRO_BWD_DQ(1);
    case 2: REPRO_BWD_DQ(2);
    case 4: REPRO_BWD_DQ(4);
    case 8: REPRO_BWD_DQ(8);
    default: return cudaErrorInvalidValue;
  }
#undef ARGS
#undef REPRO_BWD_DQ
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const void* lse, void* dq, void* delta,
                 int b, int s, int h, int kv, int d, int causal, int window,
                 int prefix, void* stream) {
  return bwd_dq(q, k, v, o, dout, lse, dq, delta, b, s, h, kv, d, causal,
                window, prefix, stream, false);
}

// The same arguments and result through the CUDA-core kernel it replaced, for
// timing the tensor-core kernel against it; no wrapper calls it.
int flash_bwd_dq_simt(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* dq, void* delta, int b, int s, int h, int kv,
                      int d, int causal, int window, int prefix,
                      void* stream) {
  return bwd_dq(q, k, v, o, dout, lse, dq, delta, b, s, h, kv, d, causal,
                window, prefix, stream, true);
}

// Backward, launch 2: dk and dv of every query head, (B, S, H, D) (with
// H == KV these are the gradients), from q, k, v, dout, the forward's lse
// and launch 1's delta; everything float32 and contiguous. simt = 0 runs
// the tensor-core kernel (the one the wrappers call), 1 the CUDA-core
// yardstick.
static int bwd_dkv(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int b, int s, int h, int kv, int d,
                   int causal, int window, int prefix, void* stream,
                   bool simt) {
  const Geo g = make_geo(b, s, h, kv, d, causal, window, prefix,
                         aligned(q, 16) && aligned(k, 16) && aligned(v, 16) &&
                             aligned(dout, 16));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_BWD_DKV(CT)                                                    \
  return simt ? launch_bwd_dkv<CT, true>(ARGS)                               \
              : launch_bwd_dkv<CT, false>(ARGS)
#define ARGS                                                                 \
  static_cast<const float*>(q), static_cast<const float*>(k),                \
      static_cast<const float*>(v), static_cast<const float*>(dout),         \
      static_cast<const float*>(lse), static_cast<const float*>(delta),      \
      static_cast<float*>(dk), static_cast<float*>(dv), g, st
  switch (columns_per_lane(d)) {
    case 1: REPRO_BWD_DKV(1);
    case 2: REPRO_BWD_DKV(2);
    case 4: REPRO_BWD_DKV(4);
    case 8: REPRO_BWD_DKV(8);
    default: return cudaErrorInvalidValue;
  }
#undef ARGS
#undef REPRO_BWD_DKV
}

int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int b, int s, int h, int kv, int d,
                  int causal, int window, int prefix, void* stream) {
  return bwd_dkv(q, k, v, dout, lse, delta, dk, dv, b, s, h, kv, d, causal,
                 window, prefix, stream, false);
}

// The same arguments and result through the CUDA-core kernel it replaced, for
// timing the tensor-core kernel against it; no wrapper calls it.
int flash_bwd_dkv_simt(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int b, int s, int h, int kv,
                       int d, int causal, int window, int prefix,
                       void* stream) {
  return bwd_dkv(q, k, v, dout, lse, delta, dk, dv, b, s, h, kv, d, causal,
                 window, prefix, stream, true);
}

// Backward, launch 3 (H > KV): dk and dv (B, S, KV, D), each kv head the
// sum of its H / KV query heads' dk_part and dv_part (B, S, H, D) in head
// order; float32, contiguous.
int flash_bwd_sum(const void* dk_part, const void* dv_part, void* dk,
                  void* dv, int b, int s, int h, int kv, int d,
                  void* stream) {
  if (b < 1 || s < 1 || kv < 1 || d < 1 || h % kv)
    return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(b) * s * kv;
  if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Geo g = make_geo(b, s, h, kv, d, 0, 0, 0, false);
  const long long want = (rows + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  const bool vec = d % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(dk_part) |
                     reinterpret_cast<uintptr_t>(dv_part) |
                     reinterpret_cast<uintptr_t>(dk) |
                     reinterpret_cast<uintptr_t>(dv)) & 15) == 0;
  auto kernel = vec ? flash_bwd_sum_heads<true> : flash_bwd_sum_heads<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dk_part), static_cast<const float*>(dv_part),
      static_cast<float*>(dk), static_cast<float*>(dv), g,
      static_cast<int>(rows));
  return cudaGetLastError();
}

}  // extern "C"
