// The chunked Mamba2 SSD (state-space duality) scan for Hopper (sm_90a).
//
// Replaces the TPU kernel in src/repro/kernels/ssd_scan/ssd_scan.py:
//   ssd_scan_pallas / _ssd_kernel  -> ssd_scan()
//
// For every row z of BH = batch * heads, with x (BH, L, P), a (BH, L) and
// b, c (BH, L, N), all float32, the sequence is cut into chunks of Q steps
// with an (N, P) state S carried between them. Within a chunk, with
// cl = cumsum(log(max(a, 1e-37))):
//   y_i = sum_{j <= i} (c_i . b_j) exp(cl_i - cl_j) x_j + exp(cl_i) (c_i S)
//   S  <- exp(cl_last) S + sum_j (b_j exp(cl_last - cl_j)) x_j^T
// and the state after the last chunk is written out. A ragged tail
// (L % Q != 0) is masked: the missing steps are x = b = c = 0, a = 1,
// which leaves the state and the valid rows unchanged, so the result is
// exact, not an approximation.
//
// What bounds it on an H100: bytes. At the serving shapes (hymba-1.5b: BH
// 400, L 512, Q 128, N 16, P 64; mamba2-370m: BH 256, N 128) one launch
// must move 133-210 MB (0.040-0.063 ms at 3.35 TB/s), while its 2.9-7.5
// GFLOP take 0.018-0.046 ms on the tensor cores at 3xTF32 (a third of the
// 495 TFLOP/s dense TF32 peak); on the CUDA cores (67 TFLOP/s) the work
// alone would take 0.044-0.113 ms.
//
// What the design does about it: the work is spread over (row, chunk) and
// every contraction runs on the tensor cores at float32 accuracy.
//   1. ssd_chunk_kernel, one block of four warps per (row, chunk): stages
//      the chunk's b and x in shared memory, forms cl by a warp scan, and
//      writes y_intra = (C B^T o L) X into y, its own chunk state
//      dS = (B o exp(cl_last - cl))^T X and its decay exp(cl_last) into a
//      scratch buffer. A warp owns 16 rows of the chunk at a time (heaviest
//      first, dealt out back and forth so that the warps' triangles
//      balance) and forms their scores 16 columns at a time, only for
//      j <= i: exp(cl_i - cl_j) above the diagonal may be inf, so it is
//      selected away and never multiplied by a 0/1 mask. The Q x Q score
//      matrix is never held; the scores stay in registers, where an
//      accumulator fragment is reused as the next product's A fragment
//      (its columns 2t, 2t + 1 become the reduction pair k = t, t + 4).
//      c goes straight from device memory into registers, up to 128
//      columns of a warp's 16 rows in one batch of loads (the first
//      batch issued before the staging wait), which keeps the block at b
//      and x: 103 KB at mamba2's N = 128, two blocks per SM. Staging is
//      cp.async, every copy in flight at once.
//   2. ssd_state_kernel, one thread per state element: folds the chunk
//      states in chunk order, S = exp(cl_last) S + dS (the plain
//      version's order), writing each chunk's starting state over its dS
//      and the final state to sfin. Deterministic, no atomics.
//   3. ssd_inter_kernel, one block per (row, chunk > 0): stages the
//      chunk's starting state and adds exp(cl_i) (C S) to y, its c and
//      y loads issued before the products that need them.
// The four contractions (C B^T, scores X, (B o decay)^T X and C S) are
// 3xTF32 mma.sync.m16n8k8 (csrc/mma_tf32x3.cuh): each operand split into
// two TF32 values, three products, the small ones in an accumulator of
// their own, so that no sum loses bits to the tensor cores' truncating
// adds beyond a float32 chain's; the decay and exp math stays on the CUDA
// cores, with the accurate logf/expf (no --use_fast_math). Shared-memory
// rows are padded so that every fragment load hits 32 distinct banks. Any
// N and any P <= 128 work: tiles are padded with zeros in shared memory
// to whole passes (so the hot loops carry no bound) and masked on store;
// P above 64 takes a second pass over its columns, N above 128 a second
// batch of c.
//
// The kernel it replaced, one block per row walking its chunks in order on
// the CUDA cores, stays in this source as the yardstick ssd_scan_serial,
// which no wrapper calls.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kScanThreads = 256;
constexpr int kJBlocks = 2;    // score columns per pass: 2 blocks of 8
constexpr int kPTiles = 8;     // y columns per pass: 8 tiles of 8
constexpr float kLogFloor = 1e-37f;

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Reduction steps of 8 columns of c held in registers at a time: 2 for
// N <= 16, else 16. b's columns and the state's rows are padded with zeros
// to whole multiples of 8 such steps, so that no loop over them needs a
// bound.
__host__ __device__ inline int c_steps(int n) { return n <= 16 ? 2 : 16; }
__host__ __device__ inline int n_pad(int n) { return round_up(n, 8 * c_steps(n)); }

// Shared-memory row strides, in floats. A fragment load reads 8 rows at
// 4 consecutive columns (or 4 row pairs at 8 columns): b's stride is 4 mod
// 8 with an odd multiple of 4, x's and the state's are such that 2t rows
// (or t rows) apart land 8 banks apart. x and the state hold P padded with
// zeros to whole passes of 64 columns, so that no loop over column tiles
// needs a bound.
__host__ __device__ inline int p_pad(int p) { return round_up(p, 8 * kPTiles); }
__host__ __device__ inline int b_stride(int n) { return n_pad(n) + 4; }
__host__ __device__ inline int x_stride(int p) { return p_pad(p) + 4; }
__host__ __device__ inline int s_stride(int p) { return p_pad(p) + 8; }

// Chunk pass: b (Qp x NS), x (Qp x XS), cl and exp(cl_last - cl) (Qp each).
__host__ __device__ inline size_t chunk_smem_floats(int p, int n, int q) {
  const size_t qp = round_up(q, 16);
  return qp * (b_stride(n) + x_stride(p) + 2);
}

// Inter-chunk pass: the starting state (n_pad x SS) and cl (Qp).
__host__ __device__ inline size_t inter_smem_floats(int p, int n, int q) {
  return static_cast<size_t>(n_pad(n)) * s_stride(p) + round_up(q, 16);
}

// In-place inclusive prefix sum of v[0, q) by one warp: each lane sums a
// run of consecutive entries, then the lanes' totals are scanned with
// shuffles and each run is offset by the totals before it.
__device__ void warp_inclusive_scan(float* v, int q, int lane) {
  const int per = (q + 31) / 32;
  const int lo = min(lane * per, q);
  const int hi = min(lo + per, q);
  float run = 0.f;
  for (int j = lo; j < hi; ++j) {
    run += v[j];
    v[j] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.f;
  for (int j = lo; j < hi; ++j) v[j] += before;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Starts copying rows [0, rows) of a contiguous row-major (rows x w) global
// matrix into shared memory at row stride ld (16-byte copies where the rows
// allow them), and writes zeros to columns [w, wpad) of those rows and to
// columns [0, wpad) of rows [rows, rows_pad). Every copy is in flight at
// once; chunk_logs waits for them.
__device__ void stage(float* dst, int ld, const float* src, int rows,
                      int rows_pad, int w, int wpad) {
  if (w % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int w4 = w / 4;
    for (int e = threadIdx.x; e < rows * w4; e += blockDim.x) {
      const int r = e / w4;
      cp_async16(dst + r * ld + 4 * (e - r * w4), src + 4 * e);
    }
  } else {
    for (int e = threadIdx.x; e < rows * w; e += blockDim.x) {
      const int r = e / w;
      cp_async4(dst + r * ld + e - r * w, src + e);
    }
  }
  const int padw = wpad - w;
  if (padw > 0)
    for (int e = threadIdx.x; e < rows * padw; e += blockDim.x) {
      const int r = e / padw;
      dst[r * ld + w + e - r * padw] = 0.f;
    }
  for (int e = threadIdx.x; e < (rows_pad - rows) * wpad; e += blockDim.x) {
    const int r = e / wpad;
    dst[(rows + r) * ld + e - r * wpad] = 0.f;
  }
}

// cl[j] = log(max(a_0, 1e-37)) + ... + log(max(a_j, 1e-37)) for j < qc,
// and cl[qc - 1] for qc <= j < qv (the missing steps are a = 1). Waits for
// the block's copies in flight, and ends with the block synchronised.
__device__ void chunk_logs(float* cl, const float* az, int qc, int qv) {
  for (int j = threadIdx.x; j < qv; j += blockDim.x)
    cl[j] = j < qc ? logf(fmaxf(__ldg(az + j), kLogFloor)) : 0.f;
  cp_async_wait_all();
  __syncthreads();
  if (threadIdx.x < 32) warp_inclusive_scan(cl, qv, threadIdx.x);
  __syncthreads();
}

// c's element (i, k) of this chunk, zero outside the qc valid rows and the
// N columns.
__device__ __forceinline__ float c_at(const float* cz, int i, int k, int qc,
                                      int n) {
  return i < qc && k < n ? __ldg(cz + static_cast<size_t>(i) * n + k) : 0.f;
}

// The A fragments of c for this lane's rows ia = i0 + g, ib = ia + 8 over
// KS reduction steps from column k0 (step s: columns k0 + 8 s + t and
// + 4), all loads issued before any is used.
template <int KS>
__device__ __forceinline__ void load_c(float (&cr)[KS][4], const float* cz,
                                       int i0, int k0, int qc, int n) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int k = k0 + 8 * s + t;
    cr[s][0] = c_at(cz, i0 + g, k, qc, n);
    cr[s][1] = c_at(cz, i0 + g + 8, k, qc, n);
    cr[s][2] = c_at(cz, i0 + g, k + 4, qc, n);
    cr[s][3] = c_at(cz, i0 + g + 8, k + 4, qc, n);
  }
}

// One block per (row z, chunk ci): y_intra into y, the chunk's own state
// and decay into the scratch buffer. c is held in registers KS reduction
// steps (8 KS columns) at a time; a warp forms SG column tiles of the
// state per pass.
template <int KS, int SG>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ b, const float* __restrict__ c,
                 float* __restrict__ y, float* __restrict__ states,
                 float* __restrict__ decays, int L, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int nc = gridDim.y;
  const int z = blockIdx.x, ci = blockIdx.y;
  const int start = ci * Q;
  const int qc = min(Q, L - start);   // valid steps in this chunk
  const int qv = round_up(qc, 16);    // rows of whole 16-row tiles
  const int NS = b_stride(N), XS = x_stride(P), Qp = round_up(Q, 16);
  float* bs = smem;                   // Qp x NS
  float* xs = bs + Qp * NS;           // Qp x XS
  float* cl = xs + Qp * XS;           // Qp
  float* wd = cl + Qp;                // Qp, exp(cl_last - cl_j)
  const size_t row0 = static_cast<size_t>(z) * L + start;
  const float* cz = c + row0 * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ptiles = p_pad(P) / 8;

  // y_intra comes in units of (16-row tile, group of up to 8 column
  // tiles), the heaviest tiles (last rows, most columns j <= i) first,
  // dealt to the warps back and forth; the c loads of a warp's first unit
  // are issued now, to land during the staging and the state product
  const int rtiles = qv / 16, pgroups = ptiles / kPTiles;
  const int units = rtiles * pgroups;
  const int nkb = (N + 8 * KS - 1) / (8 * KS);
  float cr[KS][4];
  if (nkb == 1 && warp < units)
    load_c<KS>(cr, cz, 16 * (rtiles - 1 - warp / pgroups), 0, qc, N);

  stage(bs, NS, b + row0 * N, qc, qv, N, n_pad(N));
  stage(xs, XS, x + row0 * P, qc, qv, P, p_pad(P));
  chunk_logs(cl, a + row0, qc, qv);
  const float cl_last = cl[qv - 1];
  for (int j = threadIdx.x; j < qv; j += kThreads)
    wd[j] = expf(cl_last - cl[j]);
  if (threadIdx.x == 0)
    decays[static_cast<size_t>(z) * nc + ci] = expf(cl_last);
  __syncthreads();

  // the chunk's own state (b o exp(cl_last - cl))^T x, N x P: units of
  // (16 state rows, SG column tiles)
  const int mtiles = round_up(N, 16) / 16, sgroups = ptiles / SG;
  const int jend = round_up(qc, 8);
  float* sz = states + (static_cast<size_t>(z) * nc + ci) * N * P;
  for (int u = warp; u < mtiles * sgroups; u += kWarps) {
    const int m0 = 16 * (u / sgroups), pt0 = SG * (u % sgroups);
    float sbig[SG][4] = {}, ssmall[SG][4] = {};
#pragma unroll 2
    for (int j0 = 0; j0 < jend; j0 += 8) {
      // the reduction pair k = t, t + 4 is steps ja, ja + 1
      const int ja = j0 + 2 * t;
      const float wa = wd[ja], wb = wd[ja + 1];
      const float* ra = bs + ja * NS + m0 + g;
      const float* rb = ra + NS;
      const tf32x3::FragA fb = tf32x3::frag_a(ra[0] * wa, ra[8] * wa,
                                              rb[0] * wb, rb[8] * wb);
#pragma unroll
      for (int pt = 0; pt < SG; ++pt) {
        const float* xp = xs + ja * XS + 8 * (pt0 + pt) + g;
        tf32x3::mma3(sbig[pt], ssmall[pt], fb, tf32x3::frag_b(xp[0], xp[XS]));
      }
    }
#pragma unroll
    for (int pt = 0; pt < SG; ++pt) {
      const int p = 8 * (pt0 + pt) + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = m0 + g + 8 * h;
        if (n >= N) continue;
        float* sp = sz + static_cast<size_t>(n) * P + p;
        if (p < P) sp[0] = sbig[pt][2 * h] + ssmall[pt][2 * h];
        if (p + 1 < P) sp[1] = sbig[pt][2 * h + 1] + ssmall[pt][2 * h + 1];
      }
    }
  }

  // y_intra
  for (int round = 0; round * kWarps < units; ++round) {
    const int s = round * kWarps + (round & 1 ? kWarps - 1 - warp : warp);
    if (s >= units) continue;
    const int i0 = 16 * (rtiles - 1 - s / pgroups);
    const int pt0 = kPTiles * (s % pgroups);
    const int ia = i0 + g, ib = ia + 8;   // this lane's rows
    const float cla = cl[ia], clb = cl[ib];
    if (nkb == 1 && round > 0) load_c<KS>(cr, cz, i0, 0, qc, N);
    float ybig[kPTiles][4] = {}, ysmall[kPTiles][4] = {};
    const int nj = (i0 + 16) / 8;         // column blocks with some j <= i
    for (int jb0 = 0; jb0 < nj; jb0 += kJBlocks) {
      // scores c_i . b_j for this tile's rows and 16 columns
      float gbig[kJBlocks][4] = {}, gsmall[kJBlocks][4] = {};
      for (int kb = 0; kb < nkb; ++kb) {
        if (nkb > 1) load_c<KS>(cr, cz, i0, 8 * KS * kb, qc, N);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int k0 = 8 * (KS * kb + ks);
          const tf32x3::FragA fc =
              tf32x3::frag_a(cr[ks][0], cr[ks][1], cr[ks][2], cr[ks][3]);
#pragma unroll
          for (int q = 0; q < kJBlocks; ++q) {
            const float* bp = bs + (8 * (jb0 + q) + g) * NS + k0 + t;
            tf32x3::mma3(gbig[q], gsmall[q], fc, tf32x3::frag_b(bp[0], bp[4]));
          }
        }
      }
      // times exp(cl_i - cl_j) where j <= i (selected, never masked by a
      // multiply), then scores . x; the fragment's columns j, j + 1 are the
      // reduction pair k = t, t + 4 of the next product
#pragma unroll
      for (int q = 0; q < kJBlocks; ++q) {
        const int j = 8 * (jb0 + q) + 2 * t;
        const float clj = cl[j], clj1 = cl[j + 1];
        const float s00 = gbig[q][0] + gsmall[q][0];
        const float s01 = gbig[q][1] + gsmall[q][1];
        const float s10 = gbig[q][2] + gsmall[q][2];
        const float s11 = gbig[q][3] + gsmall[q][3];
        const tf32x3::FragA fm = tf32x3::frag_a(
            j <= ia ? s00 * expf(cla - clj) : 0.f,
            j <= ib ? s10 * expf(clb - clj) : 0.f,
            j + 1 <= ia ? s01 * expf(cla - clj1) : 0.f,
            j + 1 <= ib ? s11 * expf(clb - clj1) : 0.f);
#pragma unroll
        for (int pt = 0; pt < kPTiles; ++pt) {
          const float* xp = xs + j * XS + 8 * (pt0 + pt) + g;
          tf32x3::mma3(ybig[pt], ysmall[pt], fm,
                       tf32x3::frag_b(xp[0], xp[XS]));
        }
      }
    }
#pragma unroll
    for (int pt = 0; pt < kPTiles; ++pt) {
      const int p = 8 * (pt0 + pt) + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = h ? ib : ia;
        if (i >= qc) continue;
        float* yp = y + (row0 + i) * P + p;
        if (p < P) yp[0] = ybig[pt][2 * h] + ysmall[pt][2 * h];
        if (p + 1 < P) yp[1] = ybig[pt][2 * h + 1] + ysmall[pt][2 * h + 1];
      }
    }
  }
}

// One thread per element of a row's (N, P) state: the chunk states folded
// in chunk order, S = decay S + dS, as the plain version folds them (a
// product, then a sum, each rounded); chunk ci's dS is overwritten by its
// starting state (chunk 0's, zero, is never read and not written), and
// the final state goes to sfin. Each batch of up to kFoldBatch chunks is
// loaded before any of it is overwritten, so the loads are in flight
// together.
constexpr int kFoldBatch = 8;

__global__ void __launch_bounds__(kScanThreads)
ssd_state_kernel(float* __restrict__ states, const float* __restrict__ decays,
                 float* __restrict__ sfin, int np, int nc) {
  const int z = blockIdx.x;
  const int e = blockIdx.y * kScanThreads + threadIdx.x;
  if (e >= np) return;
  float* sp = states + static_cast<size_t>(z) * nc * np + e;
  const float* dz = decays + static_cast<size_t>(z) * nc;
  float s = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kFoldBatch) {
    float ds[kFoldBatch], dk[kFoldBatch];
#pragma unroll
    for (int k = 0; k < kFoldBatch; ++k) {
      const bool ok = c0 + k < nc;
      ds[k] = ok ? sp[static_cast<size_t>(c0 + k) * np] : 0.f;
      dk[k] = ok ? __ldg(dz + c0 + k) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kFoldBatch; ++k) {
      const int ci = c0 + k;
      if (ci >= nc) break;
      if (ci) sp[static_cast<size_t>(ci) * np] = s;
      s = __fadd_rn(__fmul_rn(dk[k], s), ds[k]);
    }
  }
  sfin[static_cast<size_t>(z) * np + e] = s;
}

// One block per (row z, chunk ci >= 1): y += exp(cl_i) (c_i S_start).
template <int KS>
__global__ void __launch_bounds__(kThreads)
ssd_inter_kernel(const float* __restrict__ a, const float* __restrict__ c,
                 const float* __restrict__ states, float* __restrict__ y,
                 int L, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int nc = gridDim.y + 1;
  const int z = blockIdx.x, ci = blockIdx.y + 1;
  const int start = ci * Q;
  const int qc = min(Q, L - start);
  const int qv = round_up(qc, 16);
  const int SS = s_stride(P);
  float* ss = smem;                              // n_pad x SS
  float* cl = ss + n_pad(N) * SS;                // Qp
  const size_t row0 = static_cast<size_t>(z) * L + start;
  const float* cz = c + row0 * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pgroups = p_pad(P) / (8 * kPTiles);
  const int units = qv / 16 * pgroups;
  const int nkb = (N + 8 * KS - 1) / (8 * KS);
  float cr[KS][4];
  if (nkb == 1 && warp < units)
    load_c<KS>(cr, cz, 16 * (warp / pgroups), 0, qc, N);

  stage(ss, SS, states + (static_cast<size_t>(z) * nc + ci) * N * P, N,
        n_pad(N), P, p_pad(P));
  chunk_logs(cl, a + row0, qc, qv);

  for (int u = warp; u < units; u += kWarps) {
    const int i0 = 16 * (u / pgroups), pt0 = kPTiles * (u % pgroups);
    const int ia = i0 + g, ib = ia + 8;
    if (nkb == 1 && u != warp) load_c<KS>(cr, cz, i0, 0, qc, N);
    // this lane's y_intra, loaded now to land during the products
    float yv[2][kPTiles][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = h ? ib : ia;
#pragma unroll
      for (int pt = 0; pt < kPTiles; ++pt) {
        const int p = 8 * (pt0 + pt) + 2 * t;
        const float* yr = y + (row0 + i) * P + p;
        yv[h][pt][0] = i < qc && p < P ? yr[0] : 0.f;
        yv[h][pt][1] = i < qc && p + 1 < P ? yr[1] : 0.f;
      }
    }
    float big[kPTiles][4] = {}, small[kPTiles][4] = {};
    for (int kb = 0; kb < nkb; ++kb) {
      if (nkb > 1) load_c<KS>(cr, cz, i0, 8 * KS * kb, qc, N);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int k0 = 8 * (KS * kb + ks);
        const tf32x3::FragA fc =
            tf32x3::frag_a(cr[ks][0], cr[ks][1], cr[ks][2], cr[ks][3]);
#pragma unroll
        for (int pt = 0; pt < kPTiles; ++pt) {
          const float* sp = ss + (k0 + t) * SS + 8 * (pt0 + pt) + g;
          tf32x3::mma3(big[pt], small[pt], fc,
                       tf32x3::frag_b(sp[0], sp[4 * SS]));
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = h ? ib : ia;
      if (i >= qc) continue;
      const float e = expf(cl[i]);
      float* yr = y + (row0 + i) * P;
#pragma unroll
      for (int pt = 0; pt < kPTiles; ++pt) {
        const int p = 8 * (pt0 + pt) + 2 * t;
#pragma unroll
        for (int k = 0; k < 2; ++k)
          if (p + k < P)
            yr[p + k] = __fadd_rn(yv[h][pt][k],
                                  __fmul_rn(e, big[pt][2 * h + k] +
                                                   small[pt][2 * h + k]));
      }
    }
  }
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();  // clear it for the next launch
  return err;
}

// One call's arguments: inputs, outputs, the scratch buffer (chunk states
// (BH, nc, N, P), then decays (BH, nc)), sizes and stream.
struct Scan {
  const float *x, *a, *b, *c;
  float *y, *sfin, *scratch;
  int bh, l, p, n, chunk, nc;
  cudaStream_t st;
};

// The three launches of one scan, c held KS reduction steps at a time
// and SG column tiles of the state per warp pass: the chunk pass, the fold
// over chunks, the inter-chunk output (none when there is one chunk).
template <int KS, int SG>
cudaError_t launch_scan(const Scan& s) {
  float* states = s.scratch;
  float* decays = states + static_cast<size_t>(s.bh) * s.nc * s.n * s.p;
  const size_t smem1 = chunk_smem_floats(s.p, s.n, s.chunk) * sizeof(float);
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(ssd_chunk_kernel<KS, SG>), smem1);
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<KS, SG><<<dim3(s.bh, s.nc), kThreads, smem1, s.st>>>(
      s.x, s.a, s.b, s.c, s.y, states, decays, s.l, s.p, s.n, s.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int np = s.n * s.p;
  ssd_state_kernel<<<dim3(s.bh, (np + kScanThreads - 1) / kScanThreads),
                     kScanThreads, 0, s.st>>>(states, decays, s.sfin, np,
                                              s.nc);
  err = cudaGetLastError();
  if (err != cudaSuccess || s.nc == 1) return err;

  const size_t smem3 = inter_smem_floats(s.p, s.n, s.chunk) * sizeof(float);
  err = allow_smem(reinterpret_cast<const void*>(ssd_inter_kernel<KS>),
                   smem3);
  if (err != cudaSuccess) return err;
  ssd_inter_kernel<KS><<<dim3(s.bh, s.nc - 1), kThreads, smem3, s.st>>>(
      s.a, s.c, states, s.y, s.l, s.p, s.n, s.chunk);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The yardstick: the kernel this source held before, one block of 256
// threads per row walking its chunks in order with S in shared memory,
// every product a float32 FMA on the CUDA cores (register-tiled: a warp
// owns four rows, a lane CP columns), scores in row tiles of 32.
// ---------------------------------------------------------------------------
namespace serial {

constexpr int kThreads = 256;
constexpr int kRowTile = 32;      // rows of a tile: 8 warps x 4 rows
constexpr int kRowsPerWarp = 4;

__host__ __device__ inline int row_tile(int q) {
  return q < kRowTile ? q : kRowTile;
}

// Shared-memory floats: x (Q x P), b (Q x (N+1)), S (N x P), c rows
// (TI x (N+1)), scores (TI x Q), cl (Q), decay to the chunk's end (Q).
__host__ __device__ inline size_t smem_floats(int p, int n, int q) {
  const size_t ns = static_cast<size_t>(n) + 1;
  const size_t ti = static_cast<size_t>(row_tile(q));
  return static_cast<size_t>(q) * p + q * ns + static_cast<size_t>(n) * p +
         ti * ns + ti * q + 2 * static_cast<size_t>(q);
}

template <int CP>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, const float* __restrict__ c,
                float* __restrict__ y, float* __restrict__ sfin, int L,
                int P, int N, int Q) {
  extern __shared__ float smem[];
  const int NS = N + 1;
  const int TI = row_tile(Q);
  float* xs = smem;             // Q x P
  float* bs = xs + Q * P;       // Q x NS
  float* ss = bs + Q * NS;      // N x P, the carried state
  float* cs = ss + N * P;       // TI x NS, the current row tile of c
  float* sc = cs + TI * NS;     // TI x Q, the current row tile of scores
  float* cl = sc + TI * Q;      // Q
  float* wd = cl + Q;           // Q, exp(cl_last - cl_j)

  const size_t z = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * kRowsPerWarp;   // this warp's first row
  const float* xz = x + z * L * P;
  const float* az = a + z * L;
  const float* bz = b + z * L * N;
  const float* cz = c + z * L * N;
  float* yz = y + z * L * P;

  for (int e = tid; e < N * P; e += kThreads) ss[e] = 0.f;

  for (int start = 0; start < L; start += Q) {
    const int qc = min(Q, L - start);   // valid steps in this chunk
    for (int e = tid; e < Q * P; e += kThreads) {
      const int j = e / P;
      xs[e] = j < qc ? xz[static_cast<size_t>(start) * P + e] : 0.f;
    }
    for (int e = tid; e < Q * N; e += kThreads) {
      const int j = e / N, n = e - j * N;
      bs[j * NS + n] = j < qc ? bz[static_cast<size_t>(start) * N + e] : 0.f;
    }
    for (int j = tid; j < Q; j += kThreads)
      cl[j] = j < qc ? logf(fmaxf(az[start + j], kLogFloor)) : 0.f;
    __syncthreads();
    if (tid < 32) warp_inclusive_scan(cl, Q, tid);
    __syncthreads();
    const float cl_last = cl[Q - 1];
    for (int j = tid; j < Q; j += kThreads) wd[j] = expf(cl_last - cl[j]);

    for (int i0 = 0; i0 < qc; i0 += TI) {
      const int ti = min(TI, Q - i0);
      for (int e = tid; e < ti * N; e += kThreads) {
        const int i = e / N, n = e - i * N;
        cs[i * NS + n] = i0 + i < qc
            ? cz[static_cast<size_t>(start + i0) * N + e] : 0.f;
      }
      __syncthreads();
      // this warp's rows of the tile that exist (row < ti)
      const int nrows = max(0, min(kRowsPerWarp, ti - r0));
      const int last = i0 + r0 + nrows - 1;   // its last chunk position
      // scores: (c_i . b_j) exp(cl_i - cl_j) for j <= i, else 0; the lane
      // takes columns j0 = lane + 32 m and j1 = j0 + 32
      for (int m = 0; m * 32 < Q; m += 2) {
        const int j0 = lane + 32 * m, j1 = j0 + 32;
        float d[kRowsPerWarp][2] = {};
        if (nrows > 0 && j0 <= last) {
          for (int n = 0; n < N; ++n) {
            const float b0 = bs[j0 * NS + n];
            const float b1 = j1 < Q ? bs[j1 * NS + n] : 0.f;
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
              const float cv = r < nrows ? cs[(r0 + r) * NS + n] : 0.f;
              d[r][0] = fmaf(cv, b0, d[r][0]);
              d[r][1] = fmaf(cv, b1, d[r][1]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          if (r >= nrows) break;
          const int row = i0 + r0 + r;
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int j = k ? j1 : j0;
            if (j < Q)
              sc[(r0 + r) * Q + j] =
                  j <= row ? d[r][k] * expf(cl[row] - cl[j]) : 0.f;
          }
        }
      }
      __syncthreads();
      // y of the tile: scores . x + exp(cl_i) (c_i S)
      if (nrows > 0 && i0 + r0 < qc) {
        float intra[kRowsPerWarp][CP] = {};
        float inter[kRowsPerWarp][CP] = {};
        const int jmax = min(last, qc - 1);
        for (int j = 0; j <= jmax; ++j) {
          float xv[CP];
#pragma unroll
          for (int mm = 0; mm < CP; ++mm) {
            const int p = lane + 32 * mm;
            xv[mm] = p < P ? xs[j * P + p] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const float sv = r < nrows ? sc[(r0 + r) * Q + j] : 0.f;
#pragma unroll
            for (int mm = 0; mm < CP; ++mm)
              intra[r][mm] = fmaf(sv, xv[mm], intra[r][mm]);
          }
        }
        for (int n = 0; n < N; ++n) {
          float sv[CP];
#pragma unroll
          for (int mm = 0; mm < CP; ++mm) {
            const int p = lane + 32 * mm;
            sv[mm] = p < P ? ss[n * P + p] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const float cv = r < nrows ? cs[(r0 + r) * NS + n] : 0.f;
#pragma unroll
            for (int mm = 0; mm < CP; ++mm)
              inter[r][mm] = fmaf(cv, sv[mm], inter[r][mm]);
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int row = i0 + r0 + r;
          if (r >= nrows || row >= qc) break;
          const float e = expf(cl[row]);
#pragma unroll
          for (int mm = 0; mm < CP; ++mm) {
            const int p = lane + 32 * mm;
            if (p < P)
              yz[static_cast<size_t>(start + row) * P + p] =
                  intra[r][mm] + e * inter[r][mm];
          }
        }
      }
      __syncthreads();
    }
    // every y of the chunk has read the old state: carry it on; warp w
    // updates state rows n0 .. n0 + 3 for n0 = r0, r0 + 32, ...
    const float decay = expf(cl_last);
    for (int n0 = r0; n0 < N; n0 += kThreads / 32 * kRowsPerWarp) {
      float acc[kRowsPerWarp][CP] = {};
      for (int j = 0; j < qc; ++j) {
        float xv[CP];
#pragma unroll
        for (int mm = 0; mm < CP; ++mm) {
          const int p = lane + 32 * mm;
          xv[mm] = p < P ? xs[j * P + p] : 0.f;
        }
        const float w = wd[j];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float bv = n0 + r < N ? bs[j * NS + n0 + r] * w : 0.f;
#pragma unroll
          for (int mm = 0; mm < CP; ++mm)
            acc[r][mm] = fmaf(bv, xv[mm], acc[r][mm]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (n0 + r >= N) break;
#pragma unroll
        for (int mm = 0; mm < CP; ++mm) {
          const int p = lane + 32 * mm;
          if (p < P) {
            float* sp = ss + (n0 + r) * P + p;
            *sp = decay * *sp + acc[r][mm];
          }
        }
      }
    }
    __syncthreads();
  }
  float* sz = sfin + z * N * P;
  for (int e = tid; e < N * P; e += kThreads) sz[e] = ss[e];
}

template <int CP>
int launch(const float* x, const float* a, const float* b, const float* c,
           float* y, float* sfin, int bh, int l, int p, int n, int chunk,
           cudaStream_t stream) {
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(ssd_scan_kernel<CP>),
                 smem_floats(p, n, chunk) * sizeof(float));
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<CP><<<bh, kThreads, smem_floats(p, n, chunk) *
                                           sizeof(float), stream>>>(
      x, a, b, c, y, sfin, l, p, n, chunk);
  return cudaGetLastError();
}

}  // namespace serial

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of dynamic shared memory the larger of ssd_scan's blocks (the
// chunk pass's) needs for (P, N, chunk).
long long ssd_scan_smem_bytes(int p, int n, int chunk) {
  const size_t f = chunk_smem_floats(p, n, chunk);
  const size_t g = inter_smem_floats(p, n, chunk);
  return static_cast<long long>((f > g ? f : g) * sizeof(float));
}

// Floats of the scratch buffer ssd_scan needs: the chunk states (BH, nc,
// N, P), then the chunk decays (BH, nc), nc = ceil(L / chunk).
long long ssd_scan_scratch_floats(int bh, int l, int p, int n, int chunk) {
  const long long nc = (l + chunk - 1) / chunk;
  return static_cast<long long>(bh) * nc * (static_cast<long long>(n) * p + 1);
}

// y (BH, L, P) and the final state (BH, N, P) from x (BH, L, P), a (BH, L),
// b and c (BH, L, N); all float32 and contiguous; P <= 128; scratch as
// ssd_scan_scratch_floats says (no initial values needed). Three launches
// on one stream: the chunk pass, the fold over chunks, the inter-chunk
// output (none when L <= chunk). Returns cudaSuccess, or the error of an
// attribute call or of a launch (cudaGetLastError()).
int ssd_scan(const void* x, const void* a, const void* b, const void* c,
             void* y, void* sfin, void* scratch, int bh, int l, int p, int n,
             int chunk, void* stream) {
  if (bh < 1 || l < 1 || p < 1 || p > 128 || n < 1 || chunk < 1 ||
      chunk > l)
    return cudaErrorInvalidValue;
  const int nc = (l + chunk - 1) / chunk;
  if (nc > 65535) return cudaErrorInvalidValue;
  const Scan s{static_cast<const float*>(x), static_cast<const float*>(a),
               static_cast<const float*>(b), static_cast<const float*>(c),
               static_cast<float*>(y), static_cast<float*>(sfin),
               static_cast<float*>(scratch), bh, l, p, n, chunk, nc,
               static_cast<cudaStream_t>(stream)};
  // up to 16 state rows: one 16-row tile of the state, so its product is
  // split four ways over the column tiles; else 16-row tiles of 8 column
  // tiles (a 64-column pass)
  return c_steps(n) == 2 ? launch_scan<2, 2>(s) : launch_scan<16, 8>(s);
}

// The yardstick: the same function through the serial CUDA-core kernel
// (one block per row, chunks in order). Same arguments as ssd_scan
// without the scratch buffer.
int ssd_scan_serial(const void* x, const void* a, const void* b,
                    const void* c, void* y, void* sfin, int bh, int l, int p,
                    int n, int chunk, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(sfin);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p <= 32)
    return serial::launch<1>(xf, af, bf, cf, yf, sf, bh, l, p, n, chunk, st);
  if (p <= 64)
    return serial::launch<2>(xf, af, bf, cf, yf, sf, bh, l, p, n, chunk, st);
  if (p <= 128)
    return serial::launch<4>(xf, af, bf, cf, yf, sf, bh, l, p, n, chunk, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
