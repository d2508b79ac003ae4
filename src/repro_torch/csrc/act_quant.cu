// The fused activation quantizer for Hopper (sm_90a): float32 or bfloat16
// rows to per-row scales and int8 nibble planes, in one pass.
//
// Replaces no TPU kernel: the JAX package leaves this step to XLA, which
// fuses it (src/repro/core/pim.py _quantize_activations, quantize and
// to_nibbles). Eager PyTorch cannot fuse it and ran it as ~18 launches a
// matmul, most of them over the whole (M, K) matrix in int32 or float32.
//
// For each row r of x (M, K), float32 or bfloat16, with qmax =
// 2^(bits-1) - 1 and rnd() a rounding to x's type:
//   amax  = max_k |x[r, k]|
//   s     = rnd(rnd(max(amax, 1e-8)) * (1 / qmax))
//   c     = clamp(rint(rnd(x[r, k] / s)), -qmax, qmax)
//   scale[r] = s (as float32); planes[d, r, k] = sign(c) * ((|c| >> 4d) &
// 15), and planes[d, r, K:Kp] = 0: the (Pa, M, Kp) layout B1 takes, Pa =
// 1 up to 4 bits (the one plane is the code) and 2 up to 8 (then the
// (M, K) codes are written too). Bit for bit what the eager path gives on
// the card, which computes in x's type with float32 arithmetic under
// each bfloat16 operation: rint rounds half to even as torch.round does;
// x / s is an IEEE divide (a tensor by a tensor there); the scale is a
// multiply by the float reciprocal of qmax, which is what PyTorch's CUDA
// true-divide makes of a tensor divided by a host scalar; the abs-max is
// exact in any order. Rows are finite: a NaN or an infinity gives codes
// the eager path need not share. Nothing here may be built with
// fast-math flags.
//
// What bounds it on an H100: bytes. Each element is read once (4 bytes,
// 2 for bfloat16) and each code written once per plane (1 byte; Pa more
// for the padding): ResNet18's batch of 128 moves ~2.7 GB (0.81 ms at
// 3.35 TB/s), a qwen3-4b prefill of 4,096 rows ~19.6 GB over its 252
// matmuls.
//
// What the design does about it: a group of threads owns a row and keeps
// the first NV vectors each thread loads in registers, so the codes come
// from registers after the group's max and the row crosses the memory
// bus once; only rows longer than the group's registers hold (K > 16,384
// at the largest group) load their tail a second time, from L2. A group
// is a power of two of threads chosen by K on the host (act_quant.py
// quant_grid): a few threads for ResNet18's short rows, several warps for
// an LM's long ones; the group's max is a butterfly of shuffles within
// the warp and, for groups wider than a warp, one pass through shared
// memory. Loads are four elements and stores char4 where K, Kp and the
// row stride allow (VEC = 4), else one element a thread (VEC = 1);
// either way neighbouring threads touch neighbouring addresses.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NV = 8;            // vector loads a thread keeps in registers
constexpr int MAX_BLOCK = 512;   // threads a block (act_quant.py)

// Four or one elements of type T at p, as floats (exact: bfloat16 is a
// float32 with its low 16 bits zero).
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float* v) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 4) v[0] = *p;
    else v[0] = __bfloat162float(*p);
  } else if constexpr (sizeof(T) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = lo.x;
    v[1] = lo.y;
    v[2] = hi.x;
    v[3] = hi.y;
  }
}

// v rounded to T (round to nearest even, as PyTorch stores a bfloat16
// result computed in float32)
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (sizeof(T) == 4) return v;
  else return __bfloat162float(__float2bfloat16_rn(v));
}

template <int VEC>
__device__ __forceinline__ void store(int8_t* p, const int* c) {
  if constexpr (VEC == 1) {
    *p = static_cast<int8_t>(c[0]);
  } else {
    *reinterpret_cast<char4*>(p) = make_char4(
        static_cast<signed char>(c[0]), static_cast<signed char>(c[1]),
        static_cast<signed char>(c[2]), static_cast<signed char>(c[3]));
  }
}

template <int VEC>
__device__ __forceinline__ void zero(int8_t* p) {
  const int c[4] = {0, 0, 0, 0};
  store<VEC>(p, c);
}

template <typename T>
struct Rows {
  const T* x;
  long long ldx;     // elements between rows of x
  int8_t* planes;    // (pa, m, kp)
  int8_t* values;    // (m, k) codes, or null when pa == 1
  float* scale;      // (m,)
  int m, k, kp, pa;
  float qmax, inv_qmax;
};

// The code of one element (the eager path's order of operations).
template <typename T>
__device__ __forceinline__ int code(float v, float s, float qmax) {
  const float q = rintf(rnd<T>(__fdiv_rn(v, s)));
  return __float2int_rn(fminf(fmaxf(q, -qmax), qmax));
}

// VEC codes of one vector into the planes (and the codes' own matrix for
// two planes) at element offset `at` of the row.
template <typename T, int VEC>
__device__ __forceinline__ void put(const Rows<T>& r, long long row, int at,
                                    const float* v, float s) {
  int c[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) c[e] = code<T>(v[e], s, r.qmax);
  const size_t plane = static_cast<size_t>(r.m) * r.kp;
  int8_t* p0 = r.planes + static_cast<size_t>(row) * r.kp + at;
  if (r.pa == 1) {
    store<VEC>(p0, c);
    return;
  }
  store<VEC>(r.values + static_cast<size_t>(row) * r.k + at, c);
  int lo[VEC], hi[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int mag = abs(c[e]);
    lo[e] = c[e] < 0 ? -(mag & 15) : (mag & 15);
    hi[e] = c[e] < 0 ? -(mag >> 4) : (mag >> 4);
  }
  store<VEC>(p0, lo);
  store<VEC>(p0 + plane, hi);
}

// One row per group of 2^glog threads, blockDim.x / 2^glog rows a block.
// Every thread runs every shuffle and barrier, rows past M included.
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_BLOCK)
    act_quant_kernel(Rows<T> r, int glog) {
  const int group = 1 << glog;
  const int lane = threadIdx.x & (group - 1);
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> glog) +
      (threadIdx.x >> glog);
  const bool live = row < r.m;
  const T* xr = r.x + (live ? row : 0) * r.ldx;
  const int kv = r.k / VEC;

  // pass 1: the loads (the first NV kept) and the row's abs-max
  float cache[NV][VEC];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = i * group + lane;
    if (live && j < kv) {
      load<T, VEC>(xr + j * VEC, cache[i]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) amax = fmaxf(amax, fabsf(cache[i][e]));
    }
  }
  for (int j = NV * group + lane; live && j < kv; j += group) {
    float v[VEC];
    load<T, VEC>(xr + j * VEC, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }

  // the group's max: shuffles within the warp, then shared memory
  for (int off = (group < 32 ? group : 32) >> 1; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (group > 32) {
    __shared__ float red[MAX_BLOCK / 32];
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
    __syncthreads();
    const int first = (threadIdx.x >> glog) << (glog - 5);
    amax = red[first];
    for (int w = 1; w < (group >> 5); ++w) amax = fmaxf(amax, red[first + w]);
  }
  const float s = rnd<T>(__fmul_rn(rnd<T>(fmaxf(amax, 1e-8f)), r.inv_qmax));
  if (!live) return;
  if (lane == 0) r.scale[row] = s;

  // pass 2: codes from the registers, the tail loaded again
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = i * group + lane;
    if (j < kv) put<T, VEC>(r, row, j * VEC, cache[i], s);
  }
  for (int j = NV * group + lane; j < kv; j += group) {
    float v[VEC];
    load<T, VEC>(xr + j * VEC, v);
    put<T, VEC>(r, row, j * VEC, v, s);
  }
  // zero columns K..Kp of every plane
  const size_t plane = static_cast<size_t>(r.m) * r.kp;
  for (int j = kv + lane; j < r.kp / VEC; j += group)
    for (int d = 0; d < r.pa; ++d)
      zero<VEC>(r.planes + d * plane + static_cast<size_t>(row) * r.kp +
                j * VEC);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Scales (M,) float32, planes (Pa, M, Kp) int8 and, for bits > 4, the
// codes (M, K) int8 of the rows x (float32, or bfloat16 when `bf16`; row
// stride ldx elements, unit column stride), 2 <= bits <= 8, Pa = 1 up to
// 4 bits, else 2. `vec` 1 or 4 (4 needs K, Kp and ldx multiples of 4 and
// x aligned to four elements), a group of 2^glog threads a row, `rows`
// rows a block (group * rows a multiple of 32, at most 512). One launch
// on `stream`. Returns cudaSuccess, cudaErrorInvalidValue for arguments
// outside these, or the launch's cudaGetLastError().
int act_quant(const void* x, long long ldx, void* planes, void* values,
              void* scale, int m, int k, int kp, int bits, int bf16, int vec,
              int glog, int rows, void* stream) {
  const int block = (1 << glog) * rows;
  const uintptr_t align = (bf16 ? 2 : 4) * vec;
  if (m < 1 || k < 1 || kp < k || ldx < k || bits < 2 || bits > 8 ||
      glog < 0 || glog > 9 || rows < 1 || block % 32 || block > MAX_BLOCK ||
      (vec != 1 && vec != 4) || reinterpret_cast<uintptr_t>(x) % align ||
      (vec == 4 && (k % 4 || kp % 4 || ldx % 4)) ||
      (bits > 4 && values == nullptr))
    return cudaErrorInvalidValue;
  const long long grid = (static_cast<long long>(m) + rows - 1) / rows;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int qmax = (1 << (bits - 1)) - 1;
  // the reciprocal as PyTorch forms it for a host-scalar divisor: on the
  // host, in float
  const float inv_qmax = 1.0f / static_cast<float>(qmax);
  const int pa = bits > 4 ? 2 : 1;
  const dim3 g(static_cast<unsigned>(grid));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const Rows<__nv_bfloat16> r{static_cast<const __nv_bfloat16*>(x), ldx,
                                static_cast<int8_t*>(planes),
                                static_cast<int8_t*>(values),
                                static_cast<float*>(scale), m, k, kp, pa,
                                static_cast<float>(qmax), inv_qmax};
    if (vec == 4)
      act_quant_kernel<__nv_bfloat16, 4><<<g, block, 0, st>>>(r, glog);
    else
      act_quant_kernel<__nv_bfloat16, 1><<<g, block, 0, st>>>(r, glog);
  } else {
    const Rows<float> r{static_cast<const float*>(x), ldx,
                        static_cast<int8_t*>(planes),
                        static_cast<int8_t*>(values),
                        static_cast<float*>(scale), m, k, kp, pa,
                        static_cast<float>(qmax), inv_qmax};
    if (vec == 4)
      act_quant_kernel<float, 4><<<g, block, 0, st>>>(r, glog);
    else
      act_quant_kernel<float, 1><<<g, block, 0, st>>>(r, glog);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
