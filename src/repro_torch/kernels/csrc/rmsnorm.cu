// RMSNorm forward, alone and fused with the residual add before it, for
// Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::rmsnorm: x viewed
// as [rows, d]; per row the f32 mean of x^2, then x * rsqrt(var + eps) * w,
// written in x's dtype. The fused entry takes the residual add that the
// models do before most norms: s = x + r, rounded to x's dtype exactly as a
// separate `x + r` rounds it, then y = rmsnorm(s, w); one launch reads x, r
// and w and writes s and y.
//
// What bounds it on the H100: memory. It does ~4 flops per element against
// 2 (fused: 4) accesses of bytes(dtype), far below the card's ~295 flop/byte
// ridge, so the least time is (2 rows d + d) bytes / 3.35 TB/s, fused
// (4 rows d + d) bytes. At decode (4 or 128 rows) the time is the launch
// and one chain of memory latencies; the design keeps that chain to one
// load round:
// * One pass with the row in registers. Each thread issues all its 16-byte
//   loads of x (and r), and of w, before the reduction; y is formed from
//   registers and written with 16-byte stores, without a second read.
// * Threads per row (TPR) and 16-byte chunks per thread (CPT) are fixed at
//   compile time for the row widths of the served models, so that every
//   thread does the same loads: a 128-wide bf16 row (the qk-norm heads) is
//   16 lanes of one chunk, two rows a warp and 16 rows a block; d = 3584,
//   4096 and 7168 are 224, 256 and 448 threads of two chunks.
// * The narrow widths (whisper-tiny's d 384, xlstm-350m's d 1024) are
//   rows of 48 and 128 bf16 chunks, too few for a block of their own: a
//   row there is 16 lanes of three chunks (16 rows a block) or 32 lanes of
//   four (8 rows a block); in f32, 32 lanes of three or eight. What bounds
//   them is the number of rows in flight: one row a 256-thread block with
//   eight chunk slots a thread (the generic layout before) held 171-211
//   registers a thread, one block an SM, and ran [4, 1500, 384] in ~45
//   waves of one load round each; sized to the row, a thread holds 3-4
//   chunks of x, r and w (62-80 registers) and a block 8-16 rows.
// * Any other aligned row up to 2048 chunks takes the generic single-pass
//   kernel with the smallest layout that covers it (predicated loads): a
//   warp of 1, 2 or 4 chunks a lane up to 128 chunks, then 128 threads of
//   two, then 256 threads of 2, 4 or 8, so that every lane of a row holds
//   at least one chunk.
// * Rows that are not 16-byte aligned (the scalar path) or longer than
//   that take the two-pass kernels: the sum of squares, then a second read
//   of the row (an L1 hit; the fused form reads back the s it wrote).
//
// Rows are addressed as row_offset = (row / inner_n) * outer_stride
// + (row % inner_n) * inner_stride (in elements), which covers any [N, H, d]
// view with a contiguous last dimension (a head slice of a fused projection)
// without a copy. s and y are contiguous [rows, d].
//
// No atomics and a launch configuration fixed by (dtype, d, alignment): the
// reduction order is the same on every run, so reruns are bitwise
// identical, and the fused y equals rmsnorm of its own s bit for bit (the
// same kernel template reduces the same values in the same order).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // block of the warp and generic kernels
constexpr int kRegsMaxChunks = 2048;  // one pass in registers up to here
constexpr int kWarpRowsMaxD = 1024; // two-pass: a warp per row up to here

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

// v <- v + g rounded to T: the residual sum as a separate add rounds it.
template <typename T, int VEC>
__device__ __forceinline__ void add_round(float (&v)[VEC],
                                          const float (&g)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = to_float(from_float<T>(v[i] + g[i]));
}

// Sum over groups of `width` lanes (a power of two <= 32), every lane of
// the warp taking part; each group gets its own total.
template <int width>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct View {  // a two-level row view, in elements
  int inner_n, outer_stride, inner_stride;
};

__device__ __forceinline__ long long row_offset(int row, View v) {
  return (long long)(row / v.inner_n) * v.outer_stride +
         (long long)(row % v.inner_n) * v.inner_stride;
}

// What one launch does: x (+ r) over `rows` rows of d; s (fused only) and
// y contiguous.
template <typename T>
struct Args {
  const T* x;
  const T* r;  // null: plain rmsnorm
  const T* w;
  T* s;
  T* y;
  int rows, d;
  View vx, vr;
  float eps;
};

// ------------------------------------------------------ one pass, registers

// TPR threads per row, CPT chunks of VEC elements a thread; chunk k of a
// thread is lane + k * TPR. kExact: d == TPR * CPT * VEC, no predicates.
// Rows of TPR <= 32 lanes share a block of kThreads (kThreads / TPR rows);
// a longer row has a block of its own.
template <typename T, int VEC, int TPR, int CPT, bool kExact, bool kAdd>
__global__ void __launch_bounds__(TPR <= 32 ? kThreads : TPR)
rmsnorm_regs(Args<T> a) {
  constexpr int kRowsPerBlock = TPR <= 32 ? kThreads / TPR : 1;
  const int lane = threadIdx.x % TPR;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / TPR;
  const bool live = row < a.rows;  // the group stays for the shuffles
  const int nchunk = a.d / VEC;

  float v[CPT][VEC], g[CPT][VEC], rv[kAdd ? CPT : 1][VEC];
  if (live) {
    // every load of the row is issued before any of them is used
    const T* xr = a.x + row_offset(row, a.vx);
    const T* rr = kAdd ? a.r + row_offset(row, a.vr) : nullptr;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = lane + k * TPR;
      if (kExact || c < nchunk) {
        load_chunk<T, VEC>(xr + (long long)c * VEC, v[k]);
        if constexpr (kAdd)
          load_chunk<T, VEC>(rr + (long long)c * VEC, rv[k]);
        load_chunk<T, VEC>(a.w + (long long)c * VEC, g[k]);
      }
    }
    if constexpr (kAdd) {
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int c = lane + k * TPR;
        if (kExact || c < nchunk) {
          add_round<T, VEC>(v[k], rv[k]);
          store_chunk<T, VEC>(a.s + (long long)row * a.d + (long long)c * VEC,
                              v[k]);
        }
      }
    }
  }

  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = lane + k * TPR;
    if (live && (kExact || c < nchunk)) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) ss = fmaf(v[k][i], v[k][i], ss);
    }
  }
  if constexpr (TPR <= 32) {
    ss = group_sum<TPR>(ss);
  } else {
    __shared__ float partial[TPR / 32];
    const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
    ss = group_sum<32>(ss);
    if (wl == 0) partial[warp] = ss;
    __syncthreads();
    ss = wl < TPR / 32 ? partial[wl] : 0.f;
    ss = group_sum<32>(ss);  // every warp reduces the same values alike
  }
  if (!live) return;
  const float inv = rsqrtf(ss / (float)a.d + a.eps);
  T* yr = a.y + (long long)row * a.d;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = lane + k * TPR;
    if (kExact || c < nchunk) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[k][i] = v[k][i] * inv * g[k][i];
      store_chunk<T, VEC>(yr + (long long)c * VEC, v[k]);
    }
  }
}

template <typename T, int VEC, int TPR, int CPT, bool kExact, bool kAdd>
void launch_regs(const Args<T>& a, cudaStream_t stream) {
  constexpr int kRowsPerBlock = TPR <= 32 ? kThreads / TPR : 1;
  constexpr int kBlock = TPR <= 32 ? kThreads : TPR;
  const int blocks = (a.rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_regs<T, VEC, TPR, CPT, kExact, kAdd>
      <<<blocks, kBlock, 0, stream>>>(a);
}

// ------------------------------------------------- two passes (scalar path)

// Sum of squares of this thread's chunks of one row (fixed order); the
// fused form forms s = x + r here and writes it.
template <typename T, int VEC, bool kAdd>
__device__ __forceinline__ float row_sumsq(const Args<T>& a, int row,
                                           int first, int step) {
  const T* xr = a.x + row_offset(row, a.vx);
  const int nchunk = a.d / VEC;
  float ss = 0.f;
  for (int c = first; c < nchunk; c += step) {
    float v[VEC];
    load_chunk<T, VEC>(xr + (long long)c * VEC, v);
    if constexpr (kAdd) {
      float g[VEC];
      load_chunk<T, VEC>(a.r + row_offset(row, a.vr) + (long long)c * VEC, g);
      add_round<T, VEC>(v, g);
      store_chunk<T, VEC>(a.s + (long long)row * a.d + (long long)c * VEC, v);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) ss = fmaf(v[i], v[i], ss);
  }
  return ss;
}

// y from a second read of the row: x, or the s this thread wrote.
template <typename T, int VEC, bool kAdd>
__device__ __forceinline__ void row_scale(const Args<T>& a, int row,
                                          int first, int step, float inv) {
  const T* src = kAdd ? a.s + (long long)row * a.d
                      : a.x + row_offset(row, a.vx);
  T* yr = a.y + (long long)row * a.d;
  const int nchunk = a.d / VEC;
  for (int c = first; c < nchunk; c += step) {
    float v[VEC], g[VEC];
    load_chunk<T, VEC>(src + (long long)c * VEC, v);
    load_chunk<T, VEC>(a.w + (long long)c * VEC, g);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = v[i] * inv * g[i];
    store_chunk<T, VEC>(yr + (long long)c * VEC, v);
  }
}

// One warp per row, kThreads / 32 rows per block.
template <typename T, int VEC, bool kAdd>
__global__ void __launch_bounds__(kThreads) rmsnorm_warp_rows(Args<T> a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + warp;
  if (row >= a.rows) return;  // the whole warp leaves together
  const float ss = group_sum<32>(row_sumsq<T, VEC, kAdd>(a, row, lane, 32));
  const float inv = rsqrtf(ss / (float)a.d + a.eps);
  row_scale<T, VEC, kAdd>(a, row, lane, 32, inv);
}

// One block of kThreads per row.
template <typename T, int VEC, bool kAdd>
__global__ void __launch_bounds__(kThreads) rmsnorm_block_rows(Args<T> a) {
  __shared__ float partial[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x;
  float ss = group_sum<32>(
      row_sumsq<T, VEC, kAdd>(a, row, threadIdx.x, kThreads));
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  ss = lane < kThreads / 32 ? partial[lane] : 0.f;
  ss = group_sum<32>(ss);  // every warp reduces the same values the same way
  const float inv = rsqrtf(ss / (float)a.d + a.eps);
  row_scale<T, VEC, kAdd>(a, row, threadIdx.x, kThreads, inv);
}

template <typename T, int VEC, bool kAdd>
void launch_two_pass(const Args<T>& a, cudaStream_t stream) {
  if (a.d <= kWarpRowsMaxD) {
    const int per_block = kThreads / 32;
    const int blocks = (a.rows + per_block - 1) / per_block;
    rmsnorm_warp_rows<T, VEC, kAdd><<<blocks, kThreads, 0, stream>>>(a);
  } else {
    rmsnorm_block_rows<T, VEC, kAdd><<<a.rows, kThreads, 0, stream>>>(a);
  }
}

// ------------------------------------------------------------------ route

template <typename T, bool kAdd>
void launch(const Args<T>& a, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  auto fits = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  bool aligned = a.d % kVec == 0 && a.vx.outer_stride % kVec == 0 &&
                 a.vx.inner_stride % kVec == 0 && fits(a.x) && fits(a.w) &&
                 fits(a.y);
  if (kAdd)
    aligned = aligned && a.vr.outer_stride % kVec == 0 &&
              a.vr.inner_stride % kVec == 0 && fits(a.r) && fits(a.s);
  if (!aligned) {
    launch_two_pass<T, 1, kAdd>(a, stream);
    return;
  }
  // the served widths: every thread does the same number of loads
  const int nchunk = a.d / kVec;
  switch (nchunk) {
    case 16:    // d 128 bf16
      return launch_regs<T, kVec, 16, 1, true, kAdd>(a, stream);
    case 32:    // d 256 bf16, d 128 f32
      return launch_regs<T, kVec, 32, 1, true, kAdd>(a, stream);
    case 48:    // d 384 bf16 (whisper-tiny): 16 rows a block
      return launch_regs<T, kVec, 16, 3, true, kAdd>(a, stream);
    case 96:    // d 384 f32: 8 rows a block
      return launch_regs<T, kVec, 32, 3, true, kAdd>(a, stream);
    case 128:   // d 1024 bf16 (xlstm-350m): 8 rows a block
      return launch_regs<T, kVec, 32, 4, true, kAdd>(a, stream);
    case 448:   // d 3584 bf16
      return launch_regs<T, kVec, 224, 2, true, kAdd>(a, stream);
    case 512:   // d 4096 bf16
      return launch_regs<T, kVec, 256, 2, true, kAdd>(a, stream);
    case 896:   // d 7168 bf16, d 3584 f32
      return launch_regs<T, kVec, 448, 2, true, kAdd>(a, stream);
    case 1024:  // d 4096 f32
      return launch_regs<T, kVec, 256, 4, true, kAdd>(a, stream);
    case 1792:  // d 7168 f32
      return launch_regs<T, kVec, 448, 4, true, kAdd>(a, stream);
    default:
      break;
  }
  if constexpr (sizeof(T) == 4) {
    if (nchunk == 256)  // d 1024 f32: 8 rows a block
      return launch_regs<T, kVec, 32, 8, true, kAdd>(a, stream);
  }
  // the generic layouts: the fewest chunk slots a thread that cover the row
  if (nchunk <= 32)
    launch_regs<T, kVec, 32, 1, false, kAdd>(a, stream);
  else if (nchunk <= 64)
    launch_regs<T, kVec, 32, 2, false, kAdd>(a, stream);
  else if (nchunk <= 128)
    launch_regs<T, kVec, 32, 4, false, kAdd>(a, stream);
  else if (nchunk <= 256)
    launch_regs<T, kVec, 128, 2, false, kAdd>(a, stream);
  else if (nchunk <= 512)
    launch_regs<T, kVec, kThreads, 2, false, kAdd>(a, stream);
  else if (nchunk <= 1024)
    launch_regs<T, kVec, kThreads, 4, false, kAdd>(a, stream);
  else if (nchunk <= kRegsMaxChunks)
    launch_regs<T, kVec, kThreads, 8, false, kAdd>(a, stream);
  else
    launch_two_pass<T, kVec, kAdd>(a, stream);
}

template <bool kAdd>
int dispatch(int dtype, const void* x, const void* r, const void* w, void* s,
             void* y, int rows, int d, View vx, View vr, float eps,
             void* stream) {
  if (rows <= 0 || d <= 0 || vx.inner_n <= 0 || (kAdd && vr.inner_n <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float, kAdd>({static_cast<const float*>(x),
                         static_cast<const float*>(r),
                         static_cast<const float*>(w), static_cast<float*>(s),
                         static_cast<float*>(y), rows, d, vx, vr, eps},
                        st);
  } else if (dtype == 1) {
    using B = __nv_bfloat16;
    launch<B, kAdd>({static_cast<const B*>(x), static_cast<const B*>(r),
                     static_cast<const B*>(w), static_cast<B*>(s),
                     static_cast<B*>(y), rows, d, vx, vr, eps},
                    st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x is addressed through its row view
// (inner_n, outer_stride, inner_stride); y is contiguous [rows, d]. Returns
// cudaGetLastError() after the launch (0 = success).
int rmsnorm_fwd(const void* x, const void* w, void* y, int dtype, int rows,
                int d, int inner_n, int outer_stride, int inner_stride,
                float eps, void* stream) {
  const View vx{inner_n, outer_stride, inner_stride};
  return dispatch<false>(dtype, x, nullptr, w, nullptr, y, rows, d, vx, vx,
                         eps, stream);
}

// The fused residual add: s = x + r (rounded to the dtype), y = rmsnorm(s).
// x and r each through their own row view; s and y contiguous [rows, d].
int add_rmsnorm_fwd(const void* x, const void* r, const void* w, void* s,
                    void* y, int dtype, int rows, int d, int x_inner_n,
                    int x_outer_stride, int x_inner_stride, int r_inner_n,
                    int r_outer_stride, int r_inner_stride, float eps,
                    void* stream) {
  return dispatch<true>(dtype, x, r, w, s, y, rows, d,
                        View{x_inner_n, x_outer_stride, x_inner_stride},
                        View{r_inner_n, r_outer_stride, r_inner_stride}, eps,
                        stream);
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
