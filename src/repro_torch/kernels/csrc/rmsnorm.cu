// RMSNorm forward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::rmsnorm: x viewed
// as [rows, d]; per row the f32 mean of x^2, then x * rsqrt(var + eps) * w,
// written in x's dtype.
//
// What bounds it on the H100: memory. It does ~3 flops per element against
// 2 * bytes(dtype) moved, far below the card's ~295 flop/byte ridge, so the
// least time is 2 * rows * d * bytes / 3.35 TB/s. The design reads x with
// 16-byte loads where the row allows it (d % 8 == 0 for bf16, d % 4 == 0 for
// f32, aligned base and strides), reduces in f32 registers, warp shuffles and
// (for long rows) shared memory, then makes a second pass over the row (an L1
// hit) to scale and store. Short rows (d <= 1024, e.g. the qk-norm heads of
// 128) get one warp each, eight rows per block, so no block idles on a
// 128-wide row; long rows (d = 4096) get a 256-thread block each.
//
// Rows are addressed as row_offset = (row / inner_n) * outer_stride
// + (row % inner_n) * inner_stride (in elements), which covers any [N, H, d]
// view with a contiguous last dimension (a head slice of a fused projection)
// without a copy. The output is contiguous [rows, d].
//
// No atomics and a launch configuration fixed by (dtype, d): the reduction
// order is the same on every run, so reruns are bitwise identical.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpRowsMaxD = 1024;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC consecutive elements; one 16-byte access when VEC * sizeof(T) == 16.
template <typename T, int VEC>
__device__ __forceinline__ void load_chunk(const T* p, float (&out)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_float(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_chunk(T* p, const float (&in)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_float<T>(in[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_float<T>(in[i]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long row_offset(int row, int inner_n,
                                                int outer_stride,
                                                int inner_stride) {
  return (long long)(row / inner_n) * outer_stride +
         (long long)(row % inner_n) * inner_stride;
}

// Sum of squares of this thread's chunks of one row (fixed order).
template <typename T, int VEC>
__device__ __forceinline__ float row_sumsq(const T* xr, int nchunk, int first,
                                           int step) {
  float ss = 0.f;
  for (int c = first; c < nchunk; c += step) {
    float v[VEC];
    load_chunk<T, VEC>(xr + (long long)c * VEC, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) ss = fmaf(v[i], v[i], ss);
  }
  return ss;
}

template <typename T, int VEC>
__device__ __forceinline__ void row_scale(const T* xr, const T* w, T* yr,
                                          int nchunk, int first, int step,
                                          float inv) {
  for (int c = first; c < nchunk; c += step) {
    float v[VEC], g[VEC];
    load_chunk<T, VEC>(xr + (long long)c * VEC, v);
    load_chunk<T, VEC>(w + (long long)c * VEC, g);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = v[i] * inv * g[i];
    store_chunk<T, VEC>(yr + (long long)c * VEC, v);
  }
}

// One warp per row, kThreads / 32 rows per block.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_warp_rows(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ y, int rows, int d, int inner_n,
                  int outer_stride, int inner_stride, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + warp;
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + row_offset(row, inner_n, outer_stride, inner_stride);
  T* yr = y + (long long)row * d;
  const int nchunk = d / VEC;
  const float ss = warp_sum(row_sumsq<T, VEC>(xr, nchunk, lane, 32));
  const float inv = rsqrtf(ss / (float)d + eps);
  row_scale<T, VEC>(xr, w, yr, nchunk, lane, 32, inv);
}

// One block of kThreads per row.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_block_rows(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, int rows, int d, int inner_n,
                   int outer_stride, int inner_stride, float eps) {
  __shared__ float partial[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x;
  const T* xr = x + row_offset(row, inner_n, outer_stride, inner_stride);
  T* yr = y + (long long)row * d;
  const int nchunk = d / VEC;
  float ss = warp_sum(row_sumsq<T, VEC>(xr, nchunk, threadIdx.x, kThreads));
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  ss = lane < kThreads / 32 ? partial[lane] : 0.f;
  ss = warp_sum(ss);  // every warp reduces the same values the same way
  const float inv = rsqrtf(ss / (float)d + eps);
  row_scale<T, VEC>(xr, w, yr, nchunk, threadIdx.x, kThreads, inv);
}

template <typename T, int VEC>
void launch_vec(const T* x, const T* w, T* y, int rows, int d, int inner_n,
                int outer_stride, int inner_stride, float eps,
                cudaStream_t stream) {
  if (d <= kWarpRowsMaxD) {
    const int per_block = kThreads / 32;
    const int blocks = (rows + per_block - 1) / per_block;
    rmsnorm_warp_rows<T, VEC><<<blocks, kThreads, 0, stream>>>(
        x, w, y, rows, d, inner_n, outer_stride, inner_stride, eps);
  } else {
    rmsnorm_block_rows<T, VEC><<<rows, kThreads, 0, stream>>>(
        x, w, y, rows, d, inner_n, outer_stride, inner_stride, eps);
  }
}

template <typename T>
void launch(const void* x, const void* w, void* y, int rows, int d,
            int inner_n, int outer_stride, int inner_stride, float eps,
            cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned =
      d % kVec == 0 && outer_stride % kVec == 0 && inner_stride % kVec == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (aligned) {
    launch_vec<T, kVec>(xt, wt, yt, rows, d, inner_n, outer_stride,
                        inner_stride, eps, stream);
  } else {
    launch_vec<T, 1>(xt, wt, yt, rows, d, inner_n, outer_stride,
                     inner_stride, eps, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = success).
int rmsnorm_fwd(const void* x, const void* w, void* y, int dtype, int rows,
                int d, int inner_n, int outer_stride, int inner_stride,
                float eps, void* stream) {
  if (rows <= 0 || d <= 0 || inner_n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, w, y, rows, d, inner_n, outer_stride, inner_stride, eps,
                  s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, y, rows, d, inner_n, outer_stride,
                          inner_stride, eps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
