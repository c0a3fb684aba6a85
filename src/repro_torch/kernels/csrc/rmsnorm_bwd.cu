// RMSNorm backward, alone and for the fused residual add, for Hopper
// (sm_90a), bound to Python through ctypes.
//
// The JAX package differentiates its jnp norm and has no backward kernel;
// this is the gradient of the port's forward kernel csrc/rmsnorm.cu (which
// replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::rmsnorm), so that
// training on the card runs through hand-written kernels both ways.
//
// Per row of x viewed as [rows, d] (all in f32):
//   rstd = rsqrt(mean(x^2) + eps),  g = dy * w,
//   dx   = rstd * g - x * rstd^3 * sum(x * g) / d        (written in x's dtype)
//   dw   = sum over rows of dy * x * rstd                 (written in w's dtype)
// The fused entry is the gradient of (s = x + r, y = rmsnorm(s)): ds, the
// gradient that reaches s from later uses, is added to the norm's dx in f32
// before the one cast, and the result is the gradient of both x and r.
//
// What bounds it on the H100: memory, as the forward. It reads x, dy (and
// ds) once for the row pass and writes dx; dw reads x and dy a second time
// (an L2 hit at the model's sizes). The least time is (3 rows d + d)
// bytes / 3.35 TB/s, fused (4 rows d + d).
//
// Design (a simple kernel that is right; speed is for later work):
// * rms_bwd_rows: one warp per row. Lanes stride over the row (scalar
//   loads, so any alignment is taken); two f32 sums (x^2 and x*g) reduced
//   by shuffles in a fixed order; a second pass over the row writes dx.
//   It also writes rstd per row to a scratch buffer for the dw kernels.
// * dw without atomics: rms_bwd_dw_part gives each block a range of 256
//   columns and a fixed chunk of rows, a thread per column summing its
//   rows in order into a float64 partial [n_chunks, d]; rms_bwd_dw_reduce
//   sums the partials of each column in chunk order and rounds once to w's
//   dtype. dw sums 65,536 rows at the qk-norm's train shape: an f32 sum in
//   that order was off by 6e-4, float64 keeps the sum itself exact to well
//   below the f32 result's rounding. The chunk count is a function of
//   (rows, d) alone.
// So reruns are bitwise identical.
//
// Rows are addressed as the forward addresses them: row_offset =
// (row / inner_n) * outer_stride + (row % inner_n) * inner_stride, for x,
// dy and ds each. dx is contiguous [rows, d].

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTargetBlocks = 1024;   // dw partial blocks to aim for

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
  return __float2bfloat16(v);
}

struct View {
  int inner_n, outer_stride, inner_stride;
  __device__ __forceinline__ int64_t row(int r) const {
    return static_cast<int64_t>(r / inner_n) * outer_stride +
           static_cast<int64_t>(r % inner_n) * inner_stride;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_bwd_rows(const T* __restrict__ dy, const T* __restrict__ x,
             const T* __restrict__ ds, const T* __restrict__ w,
             T* __restrict__ dx, float* __restrict__ rstd_out, int rows,
             int d, View vdy, View vx, View vds, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + vx.row(row);
  const T* dyr = dy + vdy.row(row);
  float sxx = 0.f, sxg = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float xv = to_float(xr[c]);
    const float g = to_float(dyr[c]) * to_float(w[c]);
    sxx = fmaf(xv, xv, sxx);
    sxg = fmaf(xv, g, sxg);
  }
  sxx = warp_sum(sxx);
  sxg = warp_sum(sxg);
  const float rstd = rsqrtf(sxx / static_cast<float>(d) + eps);
  const float coef = rstd * rstd * rstd * sxg / static_cast<float>(d);
  if (lane == 0) rstd_out[row] = rstd;
  T* dxr = dx + static_cast<int64_t>(row) * d;
  const T* dsr = ds ? ds + vds.row(row) : nullptr;
  for (int c = lane; c < d; c += 32) {
    const float g = to_float(dyr[c]) * to_float(w[c]);
    float v = rstd * g - to_float(xr[c]) * coef;
    if (dsr) v += to_float(dsr[c]);
    dxr[c] = from_float<T>(v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_bwd_dw_part(const T* __restrict__ dy, const T* __restrict__ x,
                const float* __restrict__ rstd, double* __restrict__ part,
                int rows, int d, int rows_per_chunk, View vdy, View vx) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int chunk = blockIdx.y;
  if (c >= d) return;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  double acc = 0.0;
  for (int r = r0; r < r1; ++r) {
    acc = fma(static_cast<double>(to_float(dy[vdy.row(r) + c])),
              static_cast<double>(to_float(x[vx.row(r) + c])) * rstd[r], acc);
  }
  part[static_cast<int64_t>(chunk) * d + c] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_bwd_dw_reduce(const double* __restrict__ part, T* __restrict__ dw,
                  int n_chunks, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  double acc = 0.0;
  for (int k = 0; k < n_chunks; ++k) acc += part[static_cast<int64_t>(k) * d + c];
  dw[c] = from_float<T>(static_cast<float>(acc));
}

}  // namespace

extern "C" {

// Rows a dw chunk covers, so that the partial kernel has about
// kTargetBlocks blocks; a function of (rows, d) alone. The caller sizes
// the partial buffer as ceil(rows / rows_per_chunk) x d doubles.
int rmsnorm_bwd_rows_per_chunk(int rows, int d) {
  const int col_blocks = (d + kThreads - 1) / kThreads;
  int chunks = kTargetBlocks / col_blocks;
  if (chunks < 1) chunks = 1;
  if (chunks > rows) chunks = rows;
  return (rows + chunks - 1) / chunks;
}

// dtype: 0 = float32, 1 = bfloat16. dy, x and ds (nullptr: none) through
// their row views; dx contiguous [rows, d]; dw [d]. scratch holds
// n_chunks * d doubles (the dw partials) followed by rows floats (rstd).
// Returns cudaGetLastError() after the launches (0 = success).
int rmsnorm_bwd(const void* dy, const void* x, const void* ds, const void* w,
                void* dx, void* dw, void* scratch, int dtype, int rows, int d,
                int dy_inner_n, int dy_outer, int dy_inner, int x_inner_n,
                int x_outer, int x_inner, int ds_inner_n, int ds_outer,
                int ds_inner, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const View vdy{dy_inner_n, dy_outer, dy_inner};
  const View vx{x_inner_n, x_outer, x_inner};
  const View vds{ds_inner_n, ds_outer, ds_inner};
  const int rpc = rmsnorm_bwd_rows_per_chunk(rows, d);
  const int n_chunks = (rows + rpc - 1) / rpc;
  double* part = static_cast<double*>(scratch);
  float* rstd =
      reinterpret_cast<float*>(part + static_cast<int64_t>(n_chunks) * d);
  const dim3 row_grid((rows + kWarps - 1) / kWarps);
  const dim3 part_grid((d + kThreads - 1) / kThreads, n_chunks);
  const dim3 red_grid((d + kThreads - 1) / kThreads);
  if (dtype == 0) {
    using T = float;
    rms_bwd_rows<T><<<row_grid, kThreads, 0, st>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x),
        static_cast<const T*>(ds), static_cast<const T*>(w),
        static_cast<T*>(dx), rstd, rows, d, vdy, vx, vds, eps);
    rms_bwd_dw_part<T><<<part_grid, kThreads, 0, st>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x), rstd, part,
        rows, d, rpc, vdy, vx);
    rms_bwd_dw_reduce<T><<<red_grid, kThreads, 0, st>>>(
        part, static_cast<T*>(dw), n_chunks, d);
  } else if (dtype == 1) {
    using T = __nv_bfloat16;
    rms_bwd_rows<T><<<row_grid, kThreads, 0, st>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x),
        static_cast<const T*>(ds), static_cast<const T*>(w),
        static_cast<T*>(dx), rstd, rows, d, vdy, vx, vds, eps);
    rms_bwd_dw_part<T><<<part_grid, kThreads, 0, st>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x), rstd, part,
        rows, d, rpc, vdy, vx);
    rms_bwd_dw_reduce<T><<<red_grid, kThreads, 0, st>>>(
        part, static_cast<T*>(dw), n_chunks, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rmsnorm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
