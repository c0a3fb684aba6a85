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
//   dx   = rstd * g - x * rstd^3 * sum(x * g) / d       (written in x's dtype)
//   dw   = sum over rows of dy * x * rstd                 (written in w's dtype)
// The fused entry is the gradient of (s = x + r, y = rmsnorm(s)): ds, the
// gradient that reaches s from later uses, is added to the norm's dx in f32
// before the one cast, and the result is the gradient of both x and r.
//
// What bounds it on the H100: memory, as the forward. x, dy (and ds) are
// read once and dx written once, so the least time is (3 rows d + d) bytes
// / 3.35 TB/s, fused (4 rows d + d).
//
// Design: two launches at the wide widths, one at the narrow ones.
// * rms_bwd_regs, one pass with the row in registers, as the forward's
//   rmsnorm_regs: each thread issues all its 16-byte loads of x, dy (and
//   ds) before the reductions (loading the next row ahead of the current
//   row's reductions was slower on the H100: more registers, fewer
//   blocks). Threads per row (TPR) and 16-byte chunks a thread (CPT) are
//   fixed at compile time for d 128 (16 lanes, 16 rows a block), 3584,
//   4096 and 7168 (224, 256 and 448 threads), and the f32 widths alike;
//   other aligned rows of up to 32 chunks take a predicated warp. Both
//   row sums (x^2 and x g) go through one fixed shuffle tree (and, across
//   warps, shared memory read back by every warp alike); dx is formed
//   from registers and written with 16-byte stores. Each block takes a
//   fixed run of rows and w once; every thread keeps dy x rstd for its
//   columns in float64 over the run, and the block writes one float64 dw
//   partial [d] (rows sharing a block's columns are summed through shared
//   memory in slot order).
// * The narrow widths (whisper-tiny's d 384, xlstm-350m's d 1024; 48 and
//   128 bf16 chunks) take rms_bwd_narrow, one pass in the same way but
//   with many rows a block: 16 lanes of three chunks (16 rows an
//   iteration) or 32 lanes of four (8 rows), in f32 32 lanes of three or
//   eight. What bounds them is the rows in flight, so registers: the
//   rms_bwd_regs layout at these widths needed 244-246 registers a thread
//   at d 1024 (one block an SM, and 24-32 float64 accumulators a thread).
//   rms_bwd_narrow holds x, dy, ds and w as the raw 16-byte chunks it
//   loaded (4 registers a chunk, widened where used) and keeps the block's
//   dw column sums with the thread that owns the column: each iteration
//   every thread writes its float64 products dy x rstd to shared memory,
//   one chunk slot k at a time, and each owner adds them in slot order.
//   The slots of one k take kThreads * VEC doubles (16 KB in bf16; two
//   buffers, 32 KB, so one barrier a k), not the [slots][d] array that
//   rms_bwd_regs's slot sum would need at these widths (48-64 KB, above
//   the 48 KB of static shared memory a block may have). Its launch is
//   cooperative: after a grid barrier the same blocks sum the partials
//   into dw (8 columns at a time, 32 strided groups of partials, then the
//   groups, in order), so the narrow widths take one launch; a second
//   launch cost ~2.3 us more at xlstm-350m's [4, 512, 1024] on the H100,
//   a quarter of the whole. The grid is at most regs_blocks_target(d)
//   blocks and no more than fit the card at once (two an SM in bf16).
// * rms_bwd_dw_reduce (after rms_bwd_regs) sums the partials of each
//   column in a fixed order (eight strided groups, then the groups) and
//   rounds once to w's dtype.
//   The sums across rows stay in float64: an f32 sum missed the dw
//   tolerance by 2.8x at 65,536 rows.
// Rows that are not 16-byte aligned or of other widths take the generic
// path of three launches: rms_bwd_rows (a warp per row, scalar loads, the
// row read twice, rstd to scratch), rms_bwd_dw_part (a thread per column
// over a fixed chunk of rows, float64) and the same reduce.
// The run of rows a block takes is a function of (rows, d) and the route,
// which (dtype, d, alignment) fix (and, for the cooperative grid, the
// card's SM count), and no sum is atomic, so reruns are bitwise
// identical.
//
// Rows are addressed as the forward addresses them: row_offset =
// (row / inner_n) * outer_stride + (row % inner_n) * inner_stride, for x,
// dy and ds each. dx is contiguous [rows, d].

#include <cooperative_groups.h>
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

// dw from the float64 partials [n, d]: 32 columns a block (a warp reads 32
// consecutive doubles), eight groups of partials k = g, g + 8, ... each
// summed in order by one thread, then the eight group sums in order; one
// rounding to w's dtype.
constexpr int kReduceGroups = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_bwd_dw_reduce(const double* __restrict__ part, T* __restrict__ dw,
                  int n, int d) {
  __shared__ double red[kReduceGroups][32];
  const int lane = threadIdx.x % 32, grp = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  double acc = 0.0;
  if (c < d) {
#pragma unroll 8
    for (int k = grp; k < n; k += kReduceGroups)
      acc += part[static_cast<int64_t>(k) * d + c];
  }
  red[grp][lane] = acc;
  __syncthreads();
  if (grp == 0 && c < d) {
    double t = 0.0;
#pragma unroll
    for (int g = 0; g < kReduceGroups; ++g) t += red[g][lane];
    dw[c] = from_float<T>(static_cast<float>(t));
  }
}

// ------------------------------------------------ one pass, registers

// Chunks of VEC = 16 / sizeof(T) consecutive elements: one 16-byte access.
template <typename T, int VEC>
__device__ __forceinline__ void load_chunk(const T* p, float (&out)[VEC]) {
  static_assert(VEC * sizeof(T) == 16, "a chunk is 16 bytes");
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_float(e[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_chunk(T* p, const float (&in)[VEC]) {
  static_assert(VEC * sizeof(T) == 16, "a chunk is 16 bytes");
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[i] = from_float<T>(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Sum over groups of ``width`` lanes (a power of two <= 32), every lane of
// the warp taking part; each group gets its own total.
template <int width>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
struct Args {
  const T* dy;
  const T* x;
  const T* ds;  // null: the plain norm's backward
  const T* w;
  T* dx;
  T* dw;
  double* part;  // [blocks, d] float64 dw partials
  int rows, d, rows_per_block;
  View vdy, vx, vds;
  float eps;
};

// TPR threads per row, CPT chunks of VEC elements a thread; chunk k of a
// thread is lane + k * TPR. kExact: d == TPR * CPT * VEC, no predicates.
// Rows of TPR <= 32 lanes share a block of kThreads (kSlots = kThreads /
// TPR rows an iteration); a longer row has the block to itself. Block b
// takes rows [b rows_per_block, (b + 1) rows_per_block).
template <typename T, int VEC, int TPR, int CPT, bool kExact, bool kDs>
__global__ void __launch_bounds__(TPR <= 32 ? kThreads : TPR)
rms_bwd_regs(Args<T> a) {
  constexpr int kSlots = TPR <= 32 ? kThreads / TPR : 1;
  constexpr int kWidth = TPR * CPT * VEC;  // the columns the threads cover
  constexpr int kWarpsRow = TPR > 32 ? TPR / 32 : 1;
  const int lane = threadIdx.x % TPR, slot = threadIdx.x / TPR;
  const int nchunk = a.d / VEC;
  const int r0 = blockIdx.x * a.rows_per_block;
  const int r1 = min(a.rows, r0 + a.rows_per_block);
  const float inv_d = 1.f / static_cast<float>(a.d);

  float w[CPT][VEC];
  double acc[CPT][VEC];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = lane + k * TPR;
    if (kExact || c < nchunk) load_chunk<T, VEC>(a.w + c * VEC, w[k]);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[k][i] = 0.0;
  }
  // per-warp partial sums of a row, double-buffered by iteration parity
  __shared__ float2 partial[2][kWarpsRow];

  for (int it = 0, base = r0; base < r1; ++it, base += kSlots) {
    const int row = base + slot;
    const bool live = row < r1;  // the group stays for the shuffles
    float x[CPT][VEC], dy[CPT][VEC], ds[kDs ? CPT : 1][VEC];
    if (live) {
      // every load of the row is issued before any of them is used
      const T* xr = a.x + a.vx.row(row);
      const T* dyr = a.dy + a.vdy.row(row);
      const T* dsr = kDs ? a.ds + a.vds.row(row) : nullptr;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int c = lane + k * TPR;
        if (kExact || c < nchunk) {
          load_chunk<T, VEC>(xr + c * VEC, x[k]);
          load_chunk<T, VEC>(dyr + c * VEC, dy[k]);
          if constexpr (kDs) load_chunk<T, VEC>(dsr + c * VEC, ds[k]);
        }
      }
    }
    float sxx = 0.f, sxg = 0.f;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = lane + k * TPR;
      if (live && (kExact || c < nchunk)) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          sxx = fmaf(x[k][i], x[k][i], sxx);
          sxg = fmaf(x[k][i], dy[k][i] * w[k][i], sxg);
        }
      }
    }
    if constexpr (TPR <= 32) {
      sxx = group_sum<TPR>(sxx);
      sxg = group_sum<TPR>(sxg);
    } else {
      const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
      sxx = group_sum<32>(sxx);
      sxg = group_sum<32>(sxg);
      if (wl == 0) partial[it & 1][warp] = make_float2(sxx, sxg);
      __syncthreads();
      const float2 p =
          wl < kWarpsRow ? partial[it & 1][wl] : make_float2(0.f, 0.f);
      sxx = group_sum<32>(p.x);  // every warp reduces the same values alike
      sxg = group_sum<32>(p.y);
    }
    if (!live) continue;
    const float rstd = rsqrtf(sxx * inv_d + a.eps);
    const float coef = rstd * rstd * rstd * sxg * inv_d;
    T* dxr = a.dx + static_cast<int64_t>(row) * a.d;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = lane + k * TPR;
      if (kExact || c < nchunk) {
        float v[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          v[i] = rstd * (dy[k][i] * w[k][i]) - x[k][i] * coef;
          if constexpr (kDs) v[i] += ds[k][i];
          acc[k][i] = fma(static_cast<double>(dy[k][i]),
                          static_cast<double>(x[k][i]) * rstd, acc[k][i]);
        }
        store_chunk<T, VEC>(dxr + c * VEC, v);
      }
    }
  }

  double* out = a.part + static_cast<int64_t>(blockIdx.x) * a.d;
  if constexpr (kSlots == 1) {  // each thread's columns are its own
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = lane + k * TPR;
      if (kExact || c < nchunk) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) out[c * VEC + i] = acc[k][i];
      }
    }
  } else {  // the slots' sums of each column, in slot order
    __shared__ double red[kSlots][kWidth];
#pragma unroll
    for (int k = 0; k < CPT; ++k)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        red[slot][(lane + k * TPR) * VEC + i] = acc[k][i];
    __syncthreads();
    for (int c = threadIdx.x; c < a.d; c += kThreads) {
      double t = 0.0;
#pragma unroll
      for (int sl = 0; sl < kSlots; ++sl) t += red[sl][c];
      out[c] = t;
    }
  }
}

// ------------------------------------------- one pass, narrow rows

// Raw 16-byte chunks, widened to f32 where they are used: a chunk held
// across the reductions costs 4 registers, not VEC.
__device__ __forceinline__ uint4 load_raw(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename T>
__device__ __forceinline__ float elem(const uint4& raw, int i) {
  return to_float(reinterpret_cast<const T*>(&raw)[i]);
}

// The narrow widths (d 384 and 1024), launched cooperatively: rows of
// CPT > 1 chunks a lane on TPR <= 32 lanes, kSlots = kThreads / TPR rows
// an iteration, block b taking rows [b rows_per_block, (b + 1)
// rows_per_block), then, after a grid barrier, dw. As rms_bwd_regs,
// but sized so that two blocks fit an SM: x, dy, ds and w are held as
// loaded (raw chunks), and the block's dw column sums are kept by the
// thread that owns the column (CPT doubles a thread) instead of CPT * VEC
// float64 accumulators in every thread. Each iteration, for each chunk
// slot k, every thread writes its products dy x rstd (float64) to shared
// memory and each column's owner adds the live slots in slot order (two
// buffers, one barrier a k); the sums run over the block's rows in row
// order, and each owner writes its columns' sums as the block's partial.
template <typename T, int VEC, int TPR, int CPT, bool kDs>
__global__ void __launch_bounds__(kThreads) rms_bwd_narrow(Args<T> a) {
  constexpr int kSlots = kThreads / TPR;
  constexpr int kSpan = TPR * VEC;  // the columns of one chunk slot k
  static_assert(TPR <= 32 && kSpan <= kThreads, "a narrow layout");
  // red[buf][slot][i * TPR + lane]: element i of the lane's chunk; a
  // warp's stores (one i) and the owners' reads are consecutive doubles.
  // 2 x 16 KB in bf16, 2 x 8 KB in f32.
  __shared__ double red[2][kSlots][kSpan];
  const int lane = threadIdx.x % TPR, slot = threadIdx.x / TPR;
  const int r0 = blockIdx.x * a.rows_per_block;
  const int r1 = min(a.rows, r0 + a.rows_per_block);
  const float inv_d = 1.f / static_cast<float>(a.d);
  // thread t < kSpan owns column k kSpan + (t % TPR) VEC + t / TPR of each k
  const bool owner = threadIdx.x < kSpan;
  const int own_col = (threadIdx.x % TPR) * VEC + threadIdx.x / TPR;

  uint4 w[CPT];
  double colsum[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    w[k] = load_raw(a.w + (lane + k * TPR) * VEC);
    colsum[k] = 0.0;
  }
  int buf = 0;
  for (int base = r0; base < r1; base += kSlots) {
    const int row = base + slot;
    const int nlive = min(kSlots, r1 - base);
    const bool live = slot < nlive;  // the group stays for the shuffles
    uint4 x[CPT], dy[CPT], ds[kDs ? CPT : 1];
    float sxx = 0.f, sxg = 0.f;
    if (live) {
      // every load of the row is issued before any of them is used
      const T* xr = a.x + a.vx.row(row);
      const T* dyr = a.dy + a.vdy.row(row);
      const T* dsr = kDs ? a.ds + a.vds.row(row) : nullptr;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int c = (lane + k * TPR) * VEC;
        x[k] = load_raw(xr + c);
        dy[k] = load_raw(dyr + c);
        if constexpr (kDs) ds[k] = load_raw(dsr + c);
      }
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xv = elem<T>(x[k], i);
          sxx = fmaf(xv, xv, sxx);
          sxg = fmaf(xv, elem<T>(dy[k], i) * elem<T>(w[k], i), sxg);
        }
      }
    }
    sxx = group_sum<TPR>(sxx);
    sxg = group_sum<TPR>(sxg);
    const float rstd = rsqrtf(sxx * inv_d + a.eps);
    const float coef = rstd * rstd * rstd * sxg * inv_d;
    T* dxr = a.dx + static_cast<int64_t>(row) * a.d;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      if (live) {
        float v[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xv = elem<T>(x[k], i), dyv = elem<T>(dy[k], i);
          v[i] = rstd * (dyv * elem<T>(w[k], i)) - xv * coef;
          if constexpr (kDs) v[i] += elem<T>(ds[k], i);
          red[buf][slot][i * TPR + lane] =
              static_cast<double>(dyv) * (static_cast<double>(xv) * rstd);
        }
        store_chunk<T, VEC>(dxr + (lane + k * TPR) * VEC, v);
      }
      // k's products are in; the barrier also means every owner has read
      // the other buffer (k - 1), which k + 1 writes
      __syncthreads();
      if (owner) {
        for (int sl = 0; sl < nlive; ++sl)
          colsum[k] += red[buf][sl][threadIdx.x];
      }
      buf ^= 1;
    }
  }
  if (owner) {
    double* out = a.part + static_cast<int64_t>(blockIdx.x) * a.d;
#pragma unroll
    for (int k = 0; k < CPT; ++k) out[k * kSpan + own_col] = colsum[k];
  }
  // every block's partial is written (the grid barrier fences memory);
  // then dw: the grid takes runs of kCols columns in turn, and in each
  // run 32 groups sum the partials g, g + 32, ... in order, then one
  // thread a column sums the 32 groups in order
  cooperative_groups::this_grid().sync();
  constexpr int kCols = 8, kGroups = kThreads / kCols;
  __shared__ double grp[kGroups][kCols];
  const int g = threadIdx.x / kCols, j = threadIdx.x % kCols;
  const int n = gridDim.x;
  for (int c0 = blockIdx.x * kCols; c0 < a.d; c0 += n * kCols) {
    const int c = c0 + j;
    double acc = 0.0;
    if (c < a.d) {
#pragma unroll 4
      for (int p = g; p < n; p += kGroups)
        acc += a.part[static_cast<int64_t>(p) * a.d + c];
    }
    grp[g][j] = acc;
    __syncthreads();
    if (g == 0 && c < a.d) {
      double t = 0.0;
#pragma unroll
      for (int q = 0; q < kGroups; ++q) t += grp[q][j];
      a.dw[c] = from_float<T>(static_cast<float>(t));
    }
    __syncthreads();
  }
}

// Rows a block of the one-pass kernels takes: about `blocks` blocks, a
// whole number of the kernel's row slots. A function of (rows, blocks,
// slots); both kernels aim at regs_blocks_target(d).
constexpr int kRegsBlocksNarrow = 512;   // d <= 256: partials are small
constexpr int kRegsBlocksWide = 264;     // two blocks an SM on the H100

int regs_blocks_target(int d) {
  return d <= 256 ? kRegsBlocksNarrow : kRegsBlocksWide;
}

int rows_per_block(int rows, int blocks, int slots) {
  const int per = (rows + blocks - 1) / blocks;
  return (per + slots - 1) / slots * slots;
}

template <typename T, int VEC, int TPR, int CPT, bool kExact>
void launch_regs(Args<T> a, cudaStream_t stream) {
  constexpr int kSlots = TPR <= 32 ? kThreads / TPR : 1;
  constexpr int kBlock = TPR <= 32 ? kThreads : TPR;
  a.rows_per_block = rows_per_block(a.rows, regs_blocks_target(a.d), kSlots);
  const int blocks = (a.rows + a.rows_per_block - 1) / a.rows_per_block;
  if (a.ds)
    rms_bwd_regs<T, VEC, TPR, CPT, kExact, true>
        <<<blocks, kBlock, 0, stream>>>(a);
  else
    rms_bwd_regs<T, VEC, TPR, CPT, kExact, false>
        <<<blocks, kBlock, 0, stream>>>(a);
  rms_bwd_dw_reduce<T><<<(a.d + 31) / 32, kThreads, 0, stream>>>(
      a.part, a.dw, blocks, a.d);
}

// One cooperative launch (the grid barrier needs every block resident):
// about regs_blocks_target(d) blocks, and no more than fit the card at
// once.
template <typename T, int VEC, int TPR, int CPT>
void launch_narrow(Args<T> a, cudaStream_t stream) {
  const void* fn =
      a.ds ? reinterpret_cast<const void*>(
                 &rms_bwd_narrow<T, VEC, TPR, CPT, true>)
           : reinterpret_cast<const void*>(
                 &rms_bwd_narrow<T, VEC, TPR, CPT, false>);
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    0) != cudaSuccess)
    return;  // the error stays for cudaGetLastError
  const int fit = sms * per_sm, target = regs_blocks_target(a.d);
  a.rows_per_block =
      rows_per_block(a.rows, target < fit ? target : fit, kThreads / TPR);
  const int blocks = (a.rows + a.rows_per_block - 1) / a.rows_per_block;
  void* args[] = {&a};
  cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args, 0,
                              stream);
}

// ------------------------------------------------------------------ route

// Rows a generic dw chunk covers, so that the partial kernel has about
// kTargetBlocks blocks; a function of (rows, d) alone.
int generic_rows_per_chunk(int rows, int d) {
  const int col_blocks = (d + kThreads - 1) / kThreads;
  int chunks = kTargetBlocks / col_blocks;
  if (chunks < 1) chunks = 1;
  if (chunks > rows) chunks = rows;
  return (rows + chunks - 1) / chunks;
}

template <typename T>
void run(Args<T> a, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  auto fits = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  auto view_fits = [](View v) {
    return v.outer_stride % kVec == 0 && v.inner_stride % kVec == 0;
  };
  const bool aligned =
      a.d % kVec == 0 && view_fits(a.vx) && view_fits(a.vdy) &&
      fits(a.x) && fits(a.dy) && fits(a.w) && fits(a.dx) &&
      (a.ds == nullptr || (view_fits(a.vds) && fits(a.ds)));
  if (aligned) {
    // the served widths: every thread does the same loads
    switch (a.d / kVec) {
      case 16:    // d 128 bf16
        return launch_regs<T, kVec, 16, 1, true>(a, st);
      case 32:    // d 256 bf16, d 128 f32
        return launch_regs<T, kVec, 32, 1, true>(a, st);
      case 48:    // d 384 bf16 (whisper-tiny): 16 rows an iteration
        return launch_narrow<T, kVec, 16, 3>(a, st);
      case 96:    // d 384 f32: 8 rows an iteration
        return launch_narrow<T, kVec, 32, 3>(a, st);
      case 128:   // d 1024 bf16 (xlstm-350m): 8 rows an iteration
        return launch_narrow<T, kVec, 32, 4>(a, st);
      case 448:   // d 3584 bf16
        return launch_regs<T, kVec, 224, 2, true>(a, st);
      case 512:   // d 4096 bf16
        return launch_regs<T, kVec, 256, 2, true>(a, st);
      case 896:   // d 7168 bf16, d 3584 f32
        return launch_regs<T, kVec, 448, 2, true>(a, st);
      default:
        break;
    }
    if constexpr (sizeof(T) == 4) {  // f32: d 1024 eight chunks a lane,
                                     // 4096 and 7168 four a thread
      if (a.d == 1024) return launch_narrow<T, kVec, 32, 8>(a, st);
      if (a.d == 4096) return launch_regs<T, kVec, 256, 4, true>(a, st);
      if (a.d == 7168) return launch_regs<T, kVec, 448, 4, true>(a, st);
    }
    if (a.d / kVec <= 32)
      return launch_regs<T, kVec, 32, 1, false>(a, st);
  }
  // generic: rstd per row, then the dw partials, then the reduce
  const int rpc = generic_rows_per_chunk(a.rows, a.d);
  const int n_chunks = (a.rows + rpc - 1) / rpc;
  float* rstd = reinterpret_cast<float*>(
      a.part + static_cast<int64_t>(n_chunks) * a.d);
  const dim3 row_grid((a.rows + kWarps - 1) / kWarps);
  const dim3 part_grid((a.d + kThreads - 1) / kThreads, n_chunks);
  const dim3 red_grid((a.d + 31) / 32);
  rms_bwd_rows<T><<<row_grid, kThreads, 0, st>>>(
      a.dy, a.x, a.ds, a.w, a.dx, rstd, a.rows, a.d, a.vdy, a.vx, a.vds,
      a.eps);
  rms_bwd_dw_part<T><<<part_grid, kThreads, 0, st>>>(
      a.dy, a.x, rstd, a.part, a.rows, a.d, rpc, a.vdy, a.vx);
  rms_bwd_dw_reduce<T><<<red_grid, kThreads, 0, st>>>(a.part, a.dw,
                                                      n_chunks, a.d);
}

}  // namespace

extern "C" {

// Bytes of scratch the backward needs for (rows, d): the float64 dw
// partials of whichever route runs (and, on the generic path, rows f32
// rstd).
long long rmsnorm_bwd_scratch_bytes(int rows, int d) {
  const int rpc = generic_rows_per_chunk(rows, d);
  const long long generic = 8LL * ((rows + rpc - 1) / rpc) * d + 4LL * rows;
  const int blocks = rows < regs_blocks_target(d) ? rows
                                                  : regs_blocks_target(d);
  const long long regs = 8LL * blocks * d;
  return generic > regs ? generic : regs;
}

// dtype: 0 = float32, 1 = bfloat16. dy, x and ds (nullptr: none) through
// their row views; dx contiguous [rows, d]; dw [d]; scratch holds
// rmsnorm_bwd_scratch_bytes(rows, d) bytes. Returns cudaGetLastError()
// after the launches (0 = success).
int rmsnorm_bwd(const void* dy, const void* x, const void* ds, const void* w,
                void* dx, void* dw, void* scratch, int dtype, int rows, int d,
                int dy_inner_n, int dy_outer, int dy_inner, int x_inner_n,
                int x_outer, int x_inner, int ds_inner_n, int ds_outer,
                int ds_inner, float eps, void* stream) {
  if (rows <= 0 || d <= 0 || dy_inner_n <= 0 || x_inner_n <= 0 ||
      ds_inner_n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const View vdy{dy_inner_n, dy_outer, dy_inner};
  const View vx{x_inner_n, x_outer, x_inner};
  const View vds{ds_inner_n, ds_outer, ds_inner};
  double* part = static_cast<double*>(scratch);
  if (dtype == 0) {
    using T = float;
    run<T>({static_cast<const T*>(dy), static_cast<const T*>(x),
            static_cast<const T*>(ds), static_cast<const T*>(w),
            static_cast<T*>(dx), static_cast<T*>(dw), part, rows, d, 0, vdy,
            vx, vds, eps},
           st);
  } else if (dtype == 1) {
    using T = __nv_bfloat16;
    run<T>({static_cast<const T*>(dy), static_cast<const T*>(x),
            static_cast<const T*>(ds), static_cast<const T*>(w),
            static_cast<T*>(dx), static_cast<T*>(dw), part, rows, d, 0, vdy,
            vx, vds, eps},
           st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rmsnorm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
