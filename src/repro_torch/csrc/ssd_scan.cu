// The chunked Mamba2 SSD (state-space duality) scan for Hopper (sm_90a).
//
// Replaces the TPU kernel in src/repro/kernels/ssd_scan/ssd_scan.py:
//   ssd_scan_pallas / _ssd_kernel  -> ssd_scan()
//
// For every row z of BH = batch * heads, with x (BH, L, P), a (BH, L) and
// b, c (BH, L, N), all float32, the sequence is cut into chunks of Q steps
// that run in order with an (N, P) state S carried between them. Within a
// chunk, with cl = cumsum(log(max(a, 1e-37))):
//   y_i = sum_{j <= i} (c_i . b_j) exp(cl_i - cl_j) x_j + exp(cl_i) (c_i S)
//   S  <- exp(cl_last) S + sum_j (b_j exp(cl_last - cl_j)) x_j^T
// and the state after the last chunk is written out. A ragged tail
// (L % Q != 0) is masked: the missing steps are x = b = c = 0, a = 1,
// which leaves the state and the valid rows unchanged, so the result is
// exact, not an approximation.
//
// What bounds it on an H100: at the serving shapes (hymba-1.5b: BH 400,
// L 512, Q 128, N 16, P 64; mamba2-370m: N 128) the bound is the float32
// work of the quadratic chunk form, about 5-11 GFLOP per launch against
// the 67 TFLOP/s of the CUDA cores (0.08-0.16 ms), ahead of the 130-210 MB
// that must move (0.04-0.06 ms). The chunk axis is sequential, so the grid
// is only BH blocks, one or two waves of the 132 SMs.
//
// What the design does about it (a simple design, right first): one block
// of 256 threads per row z walks its chunks in order and keeps S in shared
// memory, so the state never touches device memory between chunks. Per
// chunk it stages x and b, forms cl by a warp scan, and then works through
// the chunk's rows in tiles of 32: stage c's rows, form the tile's scores
// (only j <= i is computed; exp(cl_i - cl_j) above the diagonal would be
// exp of a positive number and may be inf, so it is never formed and never
// multiplied by a 0/1 mask, which would give NaN), then the tile's y. The
// full Q x Q score matrix is never held: at mamba2's Q = 128, N = 128,
// P = 64 it would take the block past the 227 KB of shared memory. The
// state update follows once every y of the chunk has read the old S.
// The three contractions are register-tiled: a warp owns four rows, a lane
// a few columns, so that each shared-memory load feeds several FMAs (a
// first version with one output per thread, two loads per FMA, was bound
// by the shared-memory load rate and ran slower than the plain version).
// Every product is a float32 FMA on the CUDA cores: TF32 tensor cores keep
// 10 mantissa bits and would miss the reference's rtol 2e-4. logf/expf are
// the accurate versions (no --use_fast_math). Rows of b and c are padded
// to N + 1 floats in shared memory so that the lanes of a warp reading
// consecutive j hit different banks. P is at most 128 (columns per lane
// are a template parameter).
//
// Later work (not done here): chunk-parallel states followed by a short
// scan over chunks, to put more than BH blocks on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

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

// One block per row z. CP = columns of P per lane (P <= 32 * CP). In the
// three contractions warp w owns four rows (of the row tile, or of the
// state) and lane l the columns l, l + 32, ...: per step of the reduction
// a thread loads its CP (or two) column values once and four row values
// that all lanes share (one broadcast each), then does 4 x CP FMAs, where
// a thread per output would load two values for every FMA.
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
      cl[j] = j < qc ? logf(fmaxf(az[start + j], 1e-37f)) : 0.f;
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
  const size_t smem = smem_floats(p, n, chunk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that the next launch's check is clean
    return err;
  }
  ssd_scan_kernel<CP><<<bh, kThreads, smem, stream>>>(x, a, b, c, y, sfin, l,
                                                      p, n, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of dynamic shared memory one block needs for (P, N, chunk).
long long ssd_scan_smem_bytes(int p, int n, int chunk) {
  return static_cast<long long>(smem_floats(p, n, chunk) * sizeof(float));
}

// y (BH, L, P) and the final state (BH, N, P) from x (BH, L, P), a (BH, L),
// b and c (BH, L, N); all float32 and contiguous; P <= 128. Returns
// cudaSuccess, or the error of the attribute call or of the launch
// (cudaGetLastError()).
int ssd_scan(const void* x, const void* a, const void* b, const void* c,
             void* y, void* sfin, int bh, int l, int p, int n, int chunk,
             void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(sfin);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p <= 32) return launch<1>(xf, af, bf, cf, yf, sf, bh, l, p, n, chunk, st);
  if (p <= 64) return launch<2>(xf, af, bf, cf, yf, sf, bh, l, p, n, chunk, st);
  if (p <= 128)
    return launch<4>(xf, af, bf, cf, yf, sf, bh, l, p, n, chunk, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
