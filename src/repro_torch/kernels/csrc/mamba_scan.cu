// Mamba2 SSD chunk scan for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py::mamba_chunk_scan
// (body _kernel): for every (batch, head) the sequence is cut into chunks of
// T steps, taken in order; with ca = cumsum(da) over the chunk,
//   y[t]  = sum_{s <= t} (C_t . B_s) exp(ca_t - ca_s) dt_s x_s     (intra)
//         + exp(ca_t) C_t . h                                       (inter)
//   h    <- exp(ca_T) h + sum_s exp(ca_T - ca_s) dt_s x_s B_s^T      (carry)
// with h [P, N] in f32 starting from zero; y is written in the requested
// dtype and the final h in f32. B and C are shared by all heads.
//
// What bounds it on the H100: at the zamba2-7b serve shape (x [4, 512, 112,
// 64] bf16, N = 64, T = 128, y in f32) it moves ~98 MB (x, B, C, dt, da read
// once, y and h written once) against ~7.5 GFLOP of causal work, so the
// least time is the ~29 us of memory traffic.
//
// Two kernels, chosen by the input dtype; neither is a fallback for the
// other.
//
// bf16: mamba_ssd_scan_tc, on the tensor cores.
// * Numerics. Every product whose operands are both bf16 is one bf16 wgmma
//   pass with f32 accumulation: S = C B^T is exact in its products. Each
//   product with an f32 operand splits that operand into three bf16 terms,
//   hi = bf16(a), mid = bf16(a - hi) and lo = bf16(a - hi - mid), which
//   carry a to its last bit, and accumulates the three passes into one f32
//   accumulator: the decayed score tile in scores x, h in C h, and w_s B_s
//   in the carry. Every decay exponent (ca_t - ca_s, ca_T - ca_s, ca_t) is
//   formed in float64 from a float64 cumulative sum and rounded to f32
//   only as the argument of expf: |ca| reaches ~150 within a chunk, and the
//   difference of two such f32 sums lost up to ~1e-5 of each decay. With
//   two terms, or with f32 sums, f32 y used up to 1.1 of the 3e-4
//   tolerance on some serve-shape draws; with both fixes ~0.02
//   (tests/test_torch_kernels.py holds an emulation of this arithmetic
//   against the exact recurrence). y is built in f32 and rounded once at
//   the store.
// * Work: one CTA of four warpgroups per (pair of heads, batch entry): 224
//   CTAs at the serve shape, one an SM (~225 KB of shared memory). For
//   each head, warpgroup r takes rows t = 64 r .. 64 r + 63 of a chunk and
//   only the causal columns s < 64 (r + 1), 32 at a time: S = C B^T by
//   wgmma m64n32k16 (both K-major in shared memory), the mask
//   exp(ca_t - ca_s) dt_s (s <= t < T) applied to the accumulator in
//   registers, split into three terms and fed as the register A operand of
//   scores x (x MN-major, as V in the attention kernel), then C h with
//   h's three terms MN-major from shared memory. Warpgroup 0 of a head also
//   runs the carry h^T <- exp(ca_T) h^T + (w B)^T x, M = N rows, K = T,
//   A = w_s B[s][n] split in registers one 16-step k-slice at a time,
//   x MN-major; it keeps h in f32 in shared memory and writes h's three
//   terms once a chunk. Two named barriers
//   hand h between the head's warpgroups, so the other one computes its
//   next scores while the carry runs.
// * Copies: a 2-stage ring of chunk tiles, all bf16 (x of both heads, B,
//   C: 128 rows x 64 columns, 128-byte swizzle), each with a full and an
//   empty mbarrier. Warp 0 issues chunk k + 1's copies as chunk k begins:
//   x, B, C by TMA over tensor maps of the strided inputs (box rows = T,
//   so rows past T stay zero; columns past P or N arrive as zeros), dt and
//   da by cp.async. The tiles' layout needs 16-byte aligned bases and
//   strides in whole 16 bytes; the wrapper copies an input that is not.
// * ca = cumsum(da) is a float64 warp scan (4 steps a lane, then
//   shuffles); the scan, the sums and the launch are fixed, there are no
//   atomics, and reruns are bitwise equal.
//
// f32: mamba_ssd_scan, every product as f32 FMAs on the FP32 pipes (the
//   reduced card-vs-CPU checks and the chunk-invariance check rest on
//   full-f32 products).
// * One CTA of 256 threads per (head, batch); the chunk loop runs inside the
//   CTA, in order. That loop replaces the TPU kernel's sequential third grid
//   axis: h [P, N] stays in f32 shared memory across chunks and is written
//   to device memory once, at the end.
// * Per chunk, x [T, P], B^T and C^T [N, T] (transposed so that a thread
//   reads 4 or 8 consecutive positions as float4s) and dt are staged in
//   shared memory as f32, ca = cumsum(da) as float64 (every decay exponent
//   is a float64 difference, as in the bf16 kernel); the [T, T] score tile
//   is built there too (stored as [s][t]). At T = 128, P = N = 64 this is
//   ~179 KiB of dynamic shared memory, allowed per launch with
//   cudaFuncSetAttribute.
// * Each stage is register-tiled: scores 8 x 8 per thread, y 4 x 8, the h
//   update 4 x 4. Padding rows and columns (T, P, N rounded up to the tile)
//   are zero in shared memory and never stored, so T, P and N are taken at
//   run time (T <= 128, P <= 64, N <= 64; T need not be a power of two).
//
// Both: x, B, C, dt and da are read through (batch, seq, head) strides in
// elements, so the model's split views of its conv output go in without a
// copy; y [B, S, H, P] and h [B, H, P, N] are new contiguous tensors. The
// cumulative sum and every dot product run in a fixed order, there are no
// atomics and the launch configuration is fixed by the shapes: reruns are
// bitwise identical.

#include <cuda.h>  // CUtensorMap and its enums (types only; no libcuda link)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;
constexpr int kMaxP = 64;
constexpr int kMaxN = 64;

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

struct Dims {
  int seqlen, heads, p, n, chunk;
  int tp, pp, np;  // chunk and P rounded up to 8, N rounded up to 4
};

struct Strides {  // in elements
  int x_b, x_s, x_h, b_b, b_s, c_b, c_s, dt_b, dt_s, dt_h, da_b, da_s, da_h;
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared-memory floats for one CTA (see the layout in the kernel).
__host__ __device__ inline size_t smem_floats(const Dims& d) {
  return (size_t)d.tp * d.pp + 2 * (size_t)d.np * d.tp +
         (size_t)d.tp * d.tp + (size_t)d.np * d.pp + 5 * (size_t)d.tp;
}

template <typename Tout>
__global__ void __launch_bounds__(kThreads)
mamba_ssd_scan(const float* __restrict__ x, const float* __restrict__ bm,
               const float* __restrict__ cm, const float* __restrict__ dt,
               const float* __restrict__ da, Tout* __restrict__ y,
               float* __restrict__ hout, Dims d, Strides st) {
  extern __shared__ __align__(16) float smem[];
  const int T = d.chunk, P = d.p, N = d.n;
  const int TP = d.tp, PP = d.pp, NP = d.np;
  float* xs = smem;              // [TP][PP]   x[t][p]
  float* bT = xs + TP * PP;      // [NP][TP]   B[t][n] at bT[n * TP + t]
  float* cT = bT + NP * TP;      // [NP][TP]   C[t][n] at cT[n * TP + t]
  float* sc = cT + NP * TP;      // [TP][TP]   score[t][s] at sc[s * TP + t]
  float* hT = sc + TP * TP;      // [NP][PP]   h[p][n] at hT[n * PP + p]
  // [TP] cumulative log decay in float64 (hT + NP * PP is a multiple of 8
  // floats from the base, so 8-byte aligned)
  double* ca = reinterpret_cast<double*>(hT + NP * PP);
  float* ea = reinterpret_cast<float*>(ca + TP);  // [TP] exp(ca_t)
  float* ws = ea + TP;           // [TP]       exp(ca_T - ca_s) dt_s
  float* dts = ws + TP;          // [TP]       dt_s

  const int tid = threadIdx.x;
  const int h = blockIdx.x, bi = blockIdx.y;
  const int nchunks = d.seqlen / T;

  // Padding stays zero for the whole run: staging writes valid entries only.
  const int total = (int)smem_floats(d);
  for (int e = tid; e < total; e += kThreads) smem[e] = 0.f;

  const float* xb = x + (long long)bi * st.x_b + (long long)h * st.x_h;
  const float* bb = bm + (long long)bi * st.b_b;
  const float* cb = cm + (long long)bi * st.c_b;
  const float* dtb = dt + (long long)bi * st.dt_b + (long long)h * st.dt_h;
  const float* dab = da + (long long)bi * st.da_b + (long long)h * st.da_h;

  for (int ch = 0; ch < nchunks; ++ch) {
    const int t0 = ch * T;
    __syncthreads();  // the previous chunk is consumed

    // 1. stage the chunk as f32
    for (int e = tid; e < T * P; e += kThreads) {
      const int t = e / P, p = e % P;
      xs[t * PP + p] = xb[(long long)(t0 + t) * st.x_s + p];
    }
    for (int e = tid; e < T * N; e += kThreads) {
      const int t = e / N, n = e % N;
      bT[n * TP + t] = bb[(long long)(t0 + t) * st.b_s + n];
      cT[n * TP + t] = cb[(long long)(t0 + t) * st.c_s + n];
    }
    for (int t = tid; t < T; t += kThreads) {
      dts[t] = dtb[(long long)(t0 + t) * st.dt_s];
      ca[t] = dab[(long long)(t0 + t) * st.da_s];
    }
    __syncthreads();

    // 2. cumulative log decay in float64, in order, then the per-step
    //    factors; each exponent is rounded to f32 only for expf
    if (tid == 0) {
      double acc = 0.0;
      for (int t = 0; t < T; ++t) {
        acc += ca[t];
        ca[t] = acc;
      }
    }
    __syncthreads();
    const double ca_last = ca[T - 1];
    for (int t = tid; t < T; t += kThreads) {
      ea[t] = expf((float)ca[t]);
      ws[t] = expf((float)(ca_last - ca[t])) * dts[t];
    }

    // 3. scores[t][s] = (C_t . B_s) exp(ca_t - ca_s) dt_s for s <= t < T,
    //    else 0; 8 x 8 per thread, tiles above the diagonal are all zero
    {
      const int nt = TP / 8;
      for (int tile = tid; tile < nt * nt; tile += kThreads) {
        const int ti = tile / nt, si = tile % nt;
        const int tr = ti * 8, sr = si * 8;
        float acc[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
        if (si <= ti) {
          for (int n = 0; n < N; ++n) {
            const float* cn = cT + n * TP;
            const float* bn = bT + n * TP;
            const float4 c0 = ld4(cn + tr), c1 = ld4(cn + tr + 4);
            const float4 b0 = ld4(bn + sr), b1 = ld4(bn + sr + 4);
            const float cv[8] = {c0.x, c0.y, c0.z, c0.w,
                                 c1.x, c1.y, c1.z, c1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                                 b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int s = sr + j;
          float out[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int t = tr + i;
            out[i] = (s <= t && t < T)
                         ? acc[i][j] * (expf((float)(ca[t] - ca[s])) *
                                        dts[s])
                         : 0.f;
          }
          st4(sc + s * TP + tr, out[0], out[1], out[2], out[3]);
          st4(sc + s * TP + tr + 4, out[4], out[5], out[6], out[7]);
        }
      }
    }
    __syncthreads();

    // 4. y[t][p] = sum_{s <= t} scores[t][s] x[s][p] + exp(ca_t) C_t . h[p];
    //    4 x 8 per thread
    {
      const int np8 = PP / 8;
      const int ntile = (TP / 4) * np8;
      for (int tile = tid; tile < ntile; tile += kThreads) {
        const int tr = (tile / np8) * 4, pr = (tile % np8) * 8;
        float yi[4][8], ye[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) yi[i][j] = ye[i][j] = 0.f;
        const int s_end = min(T, tr + 4);
        for (int s = 0; s < s_end; ++s) {
          const float4 sv = ld4(sc + s * TP + tr);
          const float4 x0 = ld4(xs + s * PP + pr);
          const float4 x1 = ld4(xs + s * PP + pr + 4);
          const float svv[4] = {sv.x, sv.y, sv.z, sv.w};
          const float xv[8] = {x0.x, x0.y, x0.z, x0.w,
                               x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              yi[i][j] = fmaf(svv[i], xv[j], yi[i][j]);
        }
        for (int n = 0; n < N; ++n) {
          const float4 cv4 = ld4(cT + n * TP + tr);
          const float4 h0 = ld4(hT + n * PP + pr);
          const float4 h1 = ld4(hT + n * PP + pr + 4);
          const float cv[4] = {cv4.x, cv4.y, cv4.z, cv4.w};
          const float hv[8] = {h0.x, h0.y, h0.z, h0.w,
                               h1.x, h1.y, h1.z, h1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              ye[i][j] = fmaf(cv[i], hv[j], ye[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = tr + i;
          if (t >= T) continue;
          const float e = ea[t];
          Tout* yp =
              y + (((long long)bi * d.seqlen + t0 + t) * d.heads + h) * P;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int p = pr + j;
            if (p < P) yp[p] = from_float<Tout>(yi[i][j] + ye[i][j] * e);
          }
        }
      }
    }
    __syncthreads();  // every read of the old h is done

    // 5. h[p][n] <- exp(ca_T) h[p][n] + sum_s (ws_s x[s][p]) B[s][n];
    //    4 (n) x 4 (p) per thread, each thread owns its h entries
    {
      const float decay = expf((float)ca_last);
      const int np4 = PP / 4;
      const int ntile = (NP / 4) * np4;
      for (int tile = tid; tile < ntile; tile += kThreads) {
        const int nr = (tile / np4) * 4, pr = (tile % np4) * 4;
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int s = 0; s < T; ++s) {
          const float w = ws[s];
          const float4 xv = ld4(xs + s * PP + pr);
          const float xw[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
          float bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) bv[i] = bT[(nr + i) * TP + s];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(xw[j], bv[i], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* hp = hT + (nr + i) * PP + pr;
          const float4 old = ld4(hp);
          st4(hp, decay * old.x + acc[i][0], decay * old.y + acc[i][1],
              decay * old.z + acc[i][2], decay * old.w + acc[i][3]);
        }
      }
    }
  }
  __syncthreads();

  float* ho = hout + ((long long)bi * d.heads + h) * (long long)(P * N);
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e % N;
    ho[e] = hT[n * PP + p];
  }
}

template <typename Tout>
int launch(const void* x, const void* b, const void* c, const float* dt,
           const float* da, void* y, float* hout, int batch, const Dims& d,
           const Strides& st, cudaStream_t stream) {
  const size_t bytes = smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mamba_ssd_scan<Tout>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(d.heads, batch);
  mamba_ssd_scan<Tout><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(b),
      static_cast<const float*>(c), dt, da, static_cast<Tout*>(y), hout, d,
      st);
  return 0;
}

// ------------------------------------------------- bf16: tensor-core kernel

namespace tc {

constexpr int kHeads = 2;                   // heads per CTA
constexpr int kWarpgroups = 2 * kHeads;     // two 64-row halves per head
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kStages = 2;                  // ring of chunk tiles
constexpr int kRowBytes = 128;              // 64 bf16: one swizzled row
constexpr int kAtomBytes = 8 * kRowBytes;   // 8 rows: one swizzle atom
constexpr int kHalfBytes = 64 * kRowBytes;  // 64 rows of a tile
constexpr int kTileBytes = 2 * kHalfBytes;  // 128 rows x 64 columns
constexpr int kTerms = 3;                    // bf16 terms of an f32 operand

// Shared memory, from a 1024-byte aligned base: per stage the x tiles of
// the CTA's heads, then the B and C tiles (each [128 rows][64 columns]
// bf16, 128-byte swizzled as the TMA writes them); h's three bf16 terms
// per head ([n rows][p columns], the same layout); h in f32 per head, in
// the accumulator layout of the warpgroup that carries it (element e of
// thread i at e * 128 + i); per stage and head dt and da; per stage and
// warpgroup ca in float64 and w_s = exp(ca_T - ca_s) dt_s in f32 (230,432
// bytes allocated, under the 232,448 a block may have); a full and an
// empty barrier per stage.
struct Smem {
  static constexpr int kStage = (kHeads + 2) * kTileBytes;
  static constexpr int kH = kStages * kStage;
  static constexpr int kHf = kH + kHeads * kTerms * kHalfBytes;
  static constexpr int kDt = kHf + kHeads * 32 * 128 * 4;
  static constexpr int kScan = kDt + kStages * kHeads * 2 * 128 * 4;
  static constexpr int kScanBytes = 128 * (8 + 4);  // ca f64, w_s f32
  static constexpr int kBars = kScan + kStages * kWarpgroups * kScanBytes;
  static constexpr int kBytes = kBars + 8 * 2 * kStages;
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base
};

struct Shape {
  int seqlen, heads, p, n, chunk, nchunks;
};

// Which dimension (1..3) of a tensor map holds seq, head and batch: the
// host orders them by stride (B and C have no head dimension: h = 0).
struct Perm {
  int s, h, b;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A 4-byte asynchronous copy into shared memory, and an arrival on an
// mbarrier once this thread's copies so far have landed.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

// Named barriers (id 0 is __syncthreads): a producer-consumer hand-off
// between the two warpgroups of a head, and a barrier within a warpgroup.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ int coord(const Perm& p, int d, int s, int h,
                                     int b) {
  return p.s == d ? s : p.h == d ? h : b;
}

// One box of x's 4-D tensor map (P, then seq, head, batch by stride).
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int s, int h, int b,
                                          Perm p) {
  const int c1 = coord(p, 1, s, h, b), c2 = coord(p, 2, s, h, b),
            c3 = coord(p, 3, s, h, b);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// One box of B's or C's 3-D tensor map (N, then seq, batch by stride).
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int s, int b,
                                          Perm p) {
  const int c1 = p.s == 1 ? s : b, c2 = p.s == 2 ? s : b;
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// A K-major operand (its 64 rows along M or N, K along the swizzled rows):
// k-step kk starts 32 bytes further along the rows.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 32, 16, kAtomBytes);
}

// An MN-major operand (rows along K, 64 columns along M or N): k-step kk
// starts 16 rows (two swizzle atoms) further down.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 2 * kAtomBytes, kHalfBytes, kAtomBytes);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define MS_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory: A
// K-major, B K-major (kTransB 0) or MN-major (kTransB 1).
template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : MS_D8(0), MS_D8(8), MS_D8(16), MS_D8(24)
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB));
}

// D[64 x 32] (+)= A[64 x 16] B[32 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : MS_D8(0), MS_D8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A in registers (bf16 fragments),
// B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : MS_D8(0), MS_D8(8), MS_D8(16), MS_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef MS_D8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The three bf16 terms of a pair of f32 values v: hi = bf16(v),
// mid = bf16(v - hi) and lo = bf16(v - hi - mid). Each difference is exact
// in f32 and each term takes 8 of v's 24 significant bits, so
// hi + mid + lo is v (outside the subnormal range). t[0..2] = hi, mid, lo.
__device__ __forceinline__ void split3(float v0, float v1, uint32_t* t) {
  const float h0 = bf16_round(v0), h1 = bf16_round(v1);
  const float r0 = v0 - h0, r1 = v1 - h1;
  const float m0 = bf16_round(r0), m1 = bf16_round(r1);
  t[0] = pack_bf16(h0, h1);
  t[1] = pack_bf16(m0, m1);
  t[2] = pack_bf16(r0 - m0, r1 - m1);
}

// Named barrier ids: for head hh, kRead(hh) (its carry warpgroup may
// overwrite h: the other warpgroup has read it) and kWritten(hh) (h of the
// next chunk is in shared memory); kOwn(wg) within one warpgroup.
__device__ __forceinline__ int kRead(int hh) { return 1 + 2 * hh; }
__device__ __forceinline__ int kWritten(int hh) { return 2 + 2 * hh; }
__device__ __forceinline__ int kOwn(int wg) { return 1 + 2 * kHeads + wg; }

// The byte offset of bf16 element (s, n) of a [rows][64] tile in the TMA's
// 128-byte swizzle: 16-byte chunk c of row s sits at chunk c ^ (s % 8).
__device__ __forceinline__ int swz(int s, int n) {
  return s * kRowBytes + ((((n >> 3) ^ (s & 7)) << 4) | ((n & 7) * 2));
}

// The bf16 element at a shared-memory address, as f32.
__device__ __forceinline__ float bf16_smem(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.b16 %0, [%1];" : "=h"(v) : "r"(addr));
  return __bfloat162float(__ushort_as_bfloat16(v));
}


// This thread's index, read so that the compiler recomputes what depends
// on it where it is used instead of keeping it live across the chunk loop.
__device__ __forceinline__ int thread_index() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

template <typename Tout>
__device__ __forceinline__ void store_pair(Tout* p, float v0, float v1,
                                           bool pair);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float v0,
                                                  float v1, bool pair) {
  if (pair)
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  else
    p[0] = v0;
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p,
                                                          float v0, float v1,
                                                          bool pair) {
  if (pair)
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  else
    p[0] = __float2bfloat16_rn(v0);
}

// One CTA per (pair of heads, batch entry); the chunk loop runs inside it,
// in order. Its 16 warps are four warpgroups, wg = 2 hh + r: head hh of
// the pair, rows t = 64 r .. 64 r + 63 of each chunk. Warp 0 also fills a
// 2-stage ring (x of both heads, B and C by TMA; dt and da by cp.async),
// issuing chunk k + 1's copies as chunk k begins.
//
// Accumulator fragments (m64n64) of thread t = 32 w + lane of a
// warpgroup: rows 16 w + lane / 4 (+ 8 for i = 1), columns
// 8 j + 2 (lane % 4) + c, held in d[4 j + 2 i + c]; they are also the
// A-fragment layout of a following register-A wgmma (k-step kk covers
// j = 2 kk, 2 kk + 1).
template <typename Tout>
__global__ void __launch_bounds__(kThreads, 1)
mamba_ssd_scan_tc(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap tcm,
                  const float* __restrict__ dt, const float* __restrict__ da,
                  Tout* __restrict__ y, float* __restrict__ hout, Shape sh,
                  Strides st, Perm px, Perm pb, Perm pc) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // the same bytes, generic
  auto x_tile = [&](int s, int hh) {
    return base + s * Smem::kStage + hh * kTileBytes;
  };
  auto b_tile = [&](int s) {
    return base + s * Smem::kStage + kHeads * kTileBytes;
  };
  auto c_tile = [&](int s) { return b_tile(s) + kTileBytes; };
  auto h_tile = [&](int hh, int part) {  // part 0: hi, 1: mid, 2: lo
    return base + Smem::kH + (kTerms * hh + part) * kHalfBytes;
  };
  auto dts_of = [&](int s, int hh) {  // dt [128], then da [128]
    return reinterpret_cast<float*>(gbase + Smem::kDt) +
           (s * kHeads + hh) * 2 * 128;
  };
  auto scan_of = [&](int s, int wg) {  // ca [128] f64, then w_s [128] f32
    return reinterpret_cast<double*>(gbase + Smem::kScan +
                                     (s * kWarpgroups + wg) *
                                         Smem::kScanBytes);
  };
  auto full = [&](int s) { return base + Smem::kBars + 8 * s; };
  auto empty = [&](int s) { return base + Smem::kBars + 8 * (kStages + s); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h0 = blockIdx.x * kHeads, bi = blockIdx.y;
  const int T = sh.chunk;

  // Zero the tiles, h and dt/da once: the copies write rows t < T only,
  // so rows past T (and the state h = 0) stay zero for the whole run.
  for (int e = tid; e < Smem::kBars / 16; e += kThreads)
    reinterpret_cast<uint4*>(gbase)[e] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 33);  // 32 lanes' dt/da copies, the TMA's bytes
      mbar_init(empty(s), kWarpgroups);  // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  // Chunk k's copies, issued by warp 0 into stage k % 2 once the four
  // warpgroups have released it: x of both heads, B and C by TMA (the
  // tx bytes), dt and da by the 32 lanes with cp.async (one arrival each
  // when its copies land).
  auto issue = [&](int k) {
    const int s = k % kStages, t0 = k * T;
    // the n-th refill of a stage waits for its n-th release (a fresh
    // barrier's "previous phase" counts as done)
    mbar_wait(empty(s), ((k / kStages) & 1) ^ 1);
    for (int hh = 0; hh < kHeads; ++hh) {
      const int hd = min(h0 + hh, sh.heads - 1);
      float* d_s = dts_of(s, hh);
      for (int t = lane; t < T; t += 32) {
        const long long at = (long long)t0 + t;
        cp_async4(d_s + t, dt + (long long)bi * st.dt_b + at * st.dt_s +
                               (long long)hd * st.dt_h);
        cp_async4(d_s + 128 + t, da + (long long)bi * st.da_b +
                                     at * st.da_s + (long long)hd * st.da_h);
      }
    }
    cp_async_arrive(full(s));
    if (lane == 0) {
      mbar_expect(full(s), (kHeads + 2) * T * kRowBytes);
      for (int hh = 0; hh < kHeads; ++hh)
        tma_load4(x_tile(s, hh), &tx, full(s), t0,
                  min(h0 + hh, sh.heads - 1), bi, px);
      tma_load3(b_tile(s), &tb, full(s), t0, bi, pb);
      tma_load3(c_tile(s), &tcm, full(s), t0, bi, pc);
    }
  };
  if (warp == 0)
    for (int k = 0; k < min(kStages, sh.nchunks); ++k) issue(k);

  const int wg = warp / 4, hh = wg / 2, r = wg % 2;
  const int head = h0 + hh;
  const bool live = head < sh.heads;  // not the spare of an odd head count
  const bool signal = tid % 128 == 0;
  // r == 0 carries h^T [n][p] of the head in f32 from chunk to chunk
  float* hf = reinterpret_cast<float*>(gbase + Smem::kHf) + hh * 32 * 128 +
              tid % 128;
  if (r == 0) bar_arrive(kWritten(hh), 256);  // h = 0 is in shared memory

  for (int k = 0; k < sh.nchunks; ++k) {
    const int s = k % kStages, t0 = k * T;
    if (warp == 0 && k > 0 && k + 1 < sh.nchunks) issue(k + 1);
    const int me = thread_index() % 128;
    const int row = 16 * (me / 32) + (me % 32) / 4;  // rows row, row + 8
    const int col = 2 * (me % 4);                    // columns col, col + 1
    mbar_wait(full(s), (k / kStages) & 1);
    const float* dts = dts_of(s, hh);
    double* ca = scan_of(s, wg);
    float* ws = reinterpret_cast<float*>(ca + 128);
    if (warp % 4 == 0) {
      // ca = cumsum(da) in float64: lane l sums t = 4 l .. 4 l + 3 in
      // order, then a shuffle scan of the lane totals (positions past T
      // add da = 0)
      double v[4], run = 0.0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        run += dts[128 + 4 * lane + j];
        v[j] = run;
      }
      double incl = run;
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const double u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      double excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0;
#pragma unroll
      for (int j = 0; j < 4; ++j) ca[4 * lane + j] = excl + v[j];
      __syncwarp();
      const double last = ca[T - 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = 4 * lane + j;
        ws[t] = expf((float)(last - ca[t])) * dts[t];  // dt = 0 past T
      }
    }
    bar_sync(kOwn(wg), 128);

    // y_intra = scores x over the causal columns s < 64 (r + 1), 32 at a
    // time: S = C B^T (both K-major), the decay mask on S in registers,
    // then S = hi + mid + lo as three register A operands against x
    // (MN-major)
    float yacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
    for (int sq = 0; sq < 2 * (r + 1); ++sq) {  // columns 32 sq ..
      float sacc[16];
      fence_regs(sacc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n32(sacc, kmajor(c_tile(s) + r * kHalfBytes, kk),
                     kmajor(b_tile(s) + sq * 32 * kRowBytes, kk), kk > 0);
      wg_commit();
      wg_wait_all();
      fence_regs(sacc);
      double ca_row[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) ca_row[i] = ca[64 * r + row + 8 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int sc = 32 * sq + 8 * j + col + c;
          const double ca_s = ca[sc];
          const float dt_s = dts[sc];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int t = 64 * r + row + 8 * i;
            float& v = sacc[4 * j + 2 * i + c];
            v = (sc <= t && t < T)
                    ? v * (expf((float)(ca_row[i] - ca_s)) * dt_s)
                    : 0.f;
          }
        }
      // a[kk][term]: the A fragments of k-step kk (columns 32 sq + 16 kk ..)
      uint32_t a[2][kTerms][4];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint32_t t3[kTerms];
        split3(sacc[2 * q], sacc[2 * q + 1], t3);
#pragma unroll
        for (int e = 0; e < kTerms; ++e) a[q / 4][e][q % 4] = t3[e];
      }
      fence_regs(yacc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t dx = mnmajor(x_tile(s, hh), 2 * sq + kk);
#pragma unroll
        for (int e = 0; e < kTerms; ++e) wgmma_rs(yacc, a[kk][e], dx);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(yacc);
    }

    // y_inter = C h: C K-major, h = hi + mid + lo MN-major, from shared
    // memory
    if (r == 1) bar_sync(kWritten(hh), 256);
    float hy[32];
    fence_regs(hy);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dc = kmajor(c_tile(s) + r * kHalfBytes, kk);
#pragma unroll
      for (int e = 0; e < kTerms; ++e)
        wgmma_ss<1>(hy, dc, mnmajor(h_tile(hh, e), kk), kk > 0 || e > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(hy);
    if (r == 1) {
      bar_arrive(kRead(hh), 256);
      if (signal) mbar_arrive(empty(s));
    }

    // y = y_intra + exp(ca_t) y_inter, rounded once to Tout
    if (live) {
      const bool pairs = (sh.p & 1) == 0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = 64 * r + row + 8 * i;
        if (t >= T) continue;
        const float e = expf((float)ca[t]);
        Tout* yp = y + (((long long)bi * sh.seqlen + t0 + t) * sh.heads +
                        head) * sh.p;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = 8 * j + col;
          if (p >= sh.p) continue;
          const float v0 = fmaf(hy[4 * j + 2 * i], e, yacc[4 * j + 2 * i]);
          const float v1 =
              fmaf(hy[4 * j + 2 * i + 1], e, yacc[4 * j + 2 * i + 1]);
          if (pairs) {
            store_pair<Tout>(yp + p, v0, v1, true);
          } else {
            store_pair<Tout>(yp + p, v0, v1, false);
            if (p + 1 < sh.p) store_pair<Tout>(yp + p + 1, v1, v1, false);
          }
        }
      }
    }

    if (r == 0) {
      // carry: h^T <- exp(ca_T) h^T + sum_s (w_s B_s)^T x_s, the f32
      // factor w_s B[s][n] as three bf16 register A operands (rows n,
      // K = s) against x (MN-major), one k-step of 16 positions at a
      // time, each retired before the next is built: the fragments of one
      // step are all the registers the carry adds (a second step in
      // flight spilled)
      const float decay = expf((float)ca[T - 1]);
      float hacc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) hacc[i] = hf[i * 128] * decay;
      // B[s][n] for n = row + 8 i and s = col + c (+ multiples of 8)
      uint32_t bq[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          bq[i][c] = b_tile(s) + swz(col + c, row + 8 * i);
      fence_regs(hacc);
#pragma unroll
      for (int kq = 0; kq < 8; ++kq) {
        if (16 * kq >= T) break;
        uint32_t b[kTerms][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int step = 16 * kq + 8 * (q >> 1);
          const int s0 = step + col;
          uint32_t t3[kTerms];
          split3(ws[s0] * bf16_smem(bq[q & 1][0] + step * kRowBytes),
                 ws[s0 + 1] * bf16_smem(bq[q & 1][1] + step * kRowBytes), t3);
#pragma unroll
          for (int e = 0; e < kTerms; ++e) b[e][q] = t3[e];
        }
        wg_fence();
        const uint64_t dx = mnmajor(x_tile(s, hh), kq);
#pragma unroll
        for (int e = 0; e < kTerms; ++e) wgmma_rs(hacc, b[e], dx);
        wg_commit();
        wg_wait_all();
      }
      fence_regs(hacc);
      if (signal) mbar_arrive(empty(s));
      bar_sync(kRead(hh), 256);  // the other warpgroup is done with h
      if (k + 1 < sh.nchunks) {
#pragma unroll
        for (int i = 0; i < 32; ++i) hf[i * 128] = hacc[i];
        // h^T = hi + mid + lo into [n][p] tiles in the 128-byte swizzle
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int n = row + 8 * i;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint32_t at =
                n * kRowBytes + ((j ^ (n & 7)) << 4) + col * 2;
            uint32_t t3[kTerms];
            split3(hacc[4 * j + 2 * i], hacc[4 * j + 2 * i + 1], t3);
#pragma unroll
            for (int e = 0; e < kTerms; ++e)
              asm volatile("st.shared.b32 [%0], %1;"
                           ::"r"(h_tile(hh, e) + at), "r"(t3[e])
                           : "memory");
          }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        bar_arrive(kWritten(hh), 256);
      } else if (live) {  // the final state h [P, N] in f32
        float* ho = hout + ((long long)bi * sh.heads + head) * sh.p * sh.n;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int n = row + 8 * i, p = 8 * j + col + c;
              if (n < sh.n && p < sh.p)
                ho[p * sh.n + n] = hacc[4 * j + 2 * i + c];
            }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
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
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a bf16 operand with ``cols`` contiguous columns and
// ``n_outer`` (2 or 3) outer dimensions {seq, head, batch} or {seq, batch}
// given by extent and element stride; dimension 0 is the columns, the
// outer ones follow ordered by stride. Boxes are 64 columns x ``rows``
// positions (one chunk) with the 128-byte swizzle the wgmma descriptors
// name; columns past ``cols`` arrive as zeros.
int make_map(CUtensorMap* map, Perm* perm, const void* ptr, int cols,
             int rows, int n_outer, const long long* extent,
             const long long* stride) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  struct Dim {
    long long extent, stride;
    int which;  // 0 seq, 1 head, 2 batch
  } dims[3];
  for (int i = 0; i < n_outer; ++i)
    dims[i] = {extent[i], stride[i], n_outer == 3 ? i : 2 * i};
  for (int i = 1; i < n_outer; ++i)  // stable insertion sort by stride
    for (int j = i; j > 0 && dims[j].stride < dims[j - 1].stride; --j) {
      const Dim t = dims[j];
      dims[j] = dims[j - 1];
      dims[j - 1] = t;
    }
  cuuint64_t ext[4] = {(cuuint64_t)cols, 1, 1, 1};
  cuuint64_t str[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  *perm = Perm{0, 0, 0};
  for (int i = 0; i < n_outer; ++i) {
    ext[i + 1] = (cuuint64_t)dims[i].extent;
    str[i] = (cuuint64_t)dims[i].stride * sizeof(__nv_bfloat16);
    if (dims[i].which == 0) {
      box[i + 1] = (cuuint32_t)rows;
      perm->s = i + 1;
    } else if (dims[i].which == 1) {
      perm->h = i + 1;
    } else {
      perm->b = i + 1;
    }
  }
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 1 + n_outer,
      const_cast<void*>(ptr), ext, str, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename Tout>
int launch(const void* x, const void* b, const void* c, const float* dt,
           const float* da, void* y, float* hout, int batch, const Dims& d,
           const Strides& st, cudaStream_t stream) {
  CUtensorMap mx, mb, mc;
  Perm px, pb, pc;
  const long long x_ext[3] = {d.seqlen, d.heads, batch};
  const long long x_str[3] = {st.x_s, st.x_h, st.x_b};
  const long long bc_ext[2] = {d.seqlen, batch};
  const long long b_str[2] = {st.b_s, st.b_b};
  const long long c_str[2] = {st.c_s, st.c_b};
  int err = make_map(&mx, &px, x, d.p, d.chunk, 3, x_ext, x_str);
  if (!err) err = make_map(&mb, &pb, b, d.n, d.chunk, 2, bc_ext, b_str);
  if (!err) err = make_map(&mc, &pc, c, d.n, d.chunk, 2, bc_ext, c_str);
  if (err) return err;
  static bool ready = false;  // one per instantiation
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        mamba_ssd_scan_tc<Tout>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem::kAlloc);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const Shape sh{d.seqlen, d.heads, d.p, d.n, d.chunk, d.seqlen / d.chunk};
  const dim3 grid((d.heads + kHeads - 1) / kHeads, batch);
  mamba_ssd_scan_tc<Tout><<<grid, kThreads, Smem::kAlloc, stream>>>(
      mx, mb, mc, dt, da, static_cast<Tout*>(y), hout, sh, st, px, pb, pc);
  return 0;
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. x, b, c share in_dtype; dt and da
// are float32; y is written as out_dtype, contiguous [B, S, H, P]; hout is
// float32, contiguous [B, H, P, N]. Strides are in elements: (batch, seq,
// head) for x, dt and da, (batch, seq) for b and c; the last dimension of
// x, b and c is contiguous. seqlen % chunk == 0, chunk <= 128, p <= 64,
// n <= 64. bf16 (the tensor-core kernel) also needs 16-byte aligned x, b,
// c base addresses and their strides in multiples of 8 elements (the
// tensor maps' rule; the wrapper checks it). Returns cudaGetLastError()
// after the launch.
int mamba_scan_fwd(const void* x, const void* b, const void* c,
                   const void* dt, const void* da, void* y, void* hout,
                   int in_dtype, int out_dtype, int batch, int seqlen,
                   int heads, int p, int n, int chunk, int x_sb, int x_ss,
                   int x_sh, int b_sb, int b_ss, int c_sb, int c_ss,
                   int dt_sb, int dt_ss, int dt_sh, int da_sb, int da_ss,
                   int da_sh, void* stream) {
  if (batch <= 0 || heads <= 0 || p <= 0 || n <= 0 || chunk <= 0 ||
      seqlen <= 0 || seqlen % chunk != 0 || chunk > kMaxChunk || p > kMaxP ||
      n > kMaxN || heads > 65535 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const Dims d{seqlen, heads, p, n, chunk, round_up(chunk, 8), round_up(p, 8),
               round_up(n, 4)};
  const Strides st{x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss,
                   dt_sb, dt_ss, dt_sh, da_sb, da_ss, da_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* daf = static_cast<const float*>(da);
  float* hf = static_cast<float*>(hout);
  int err;
  if (in_dtype == 0 && out_dtype == 0) {
    err = launch<float>(x, b, c, dtf, daf, y, hf, batch, d, st, s);
  } else if (in_dtype == 0 && out_dtype == 1) {
    err = launch<__nv_bfloat16>(x, b, c, dtf, daf, y, hf, batch, d, st, s);
  } else if (in_dtype == 1 && out_dtype == 0) {
    err = tc::launch<float>(x, b, c, dtf, daf, y, hf, batch, d, st, s);
  } else if (in_dtype == 1 && out_dtype == 1) {
    err = tc::launch<__nv_bfloat16>(x, b, c, dtf, daf, y, hf, batch, d, st,
                                    s);
  } else {
    err = (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

const char* mamba_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
