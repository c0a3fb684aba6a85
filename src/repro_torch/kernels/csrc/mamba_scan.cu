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
// least time is the ~29 us of memory traffic. This first version does all
// products with f32 FMAs (no mma / wgmma yet), so it is bound by the SMs'
// FP32 pipes and shared-memory reads rather than by HBM; it is written to
// be right and deterministic first.
//
// Design:
// * One CTA of 256 threads per (head, batch); the chunk loop runs inside the
//   CTA, in order. That loop replaces the TPU kernel's sequential third grid
//   axis: h [P, N] stays in f32 shared memory across chunks and is written
//   to device memory once, at the end. The serve shape gives 448 CTAs.
// * Per chunk, x [T, P], B^T and C^T [N, T] (transposed so that a thread
//   reads 4 or 8 consecutive positions as float4s), dt and ca are staged in
//   shared memory as f32; the [T, T] score tile is built there too (stored
//   as [s][t]). At T = 128, P = N = 64 this is 178 KiB of dynamic shared
//   memory, allowed per launch with cudaFuncSetAttribute.
// * Each stage is register-tiled: scores 8 x 8 per thread, y 4 x 8, the h
//   update 4 x 4. Padding rows and columns (T, P, N rounded up to the tile)
//   are zero in shared memory and never stored, so T, P and N are taken at
//   run time (T <= 128, P <= 64, N <= 64; T need not be a power of two).
// * x, B, C, dt and da are read through (batch, seq, head) strides in
//   elements, so the model's split views of its conv output go in without a
//   copy; y [B, S, H, P] and h [B, H, P, N] are new contiguous tensors.
// * The cumulative sum and every dot product run in a fixed order, there
//   are no atomics and the launch configuration is fixed by the shapes:
//   reruns are bitwise identical.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;
constexpr int kMaxP = 64;
constexpr int kMaxN = 64;

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
         (size_t)d.tp * d.tp + (size_t)d.np * d.pp + 4 * (size_t)d.tp;
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
mamba_ssd_scan(const Tin* __restrict__ x, const Tin* __restrict__ bm,
               const Tin* __restrict__ cm, const float* __restrict__ dt,
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
  float* ca = hT + NP * PP;      // [TP]       cumulative log decay
  float* ea = ca + TP;           // [TP]       exp(ca_t)
  float* ws = ea + TP;           // [TP]       exp(ca_T - ca_s) dt_s
  float* dts = ws + TP;          // [TP]       dt_s

  const int tid = threadIdx.x;
  const int h = blockIdx.x, bi = blockIdx.y;
  const int nchunks = d.seqlen / T;

  // Padding stays zero for the whole run: staging writes valid entries only.
  const int total = (int)smem_floats(d);
  for (int e = tid; e < total; e += kThreads) smem[e] = 0.f;

  const Tin* xb = x + (long long)bi * st.x_b + (long long)h * st.x_h;
  const Tin* bb = bm + (long long)bi * st.b_b;
  const Tin* cb = cm + (long long)bi * st.c_b;
  const float* dtb = dt + (long long)bi * st.dt_b + (long long)h * st.dt_h;
  const float* dab = da + (long long)bi * st.da_b + (long long)h * st.da_h;

  for (int ch = 0; ch < nchunks; ++ch) {
    const int t0 = ch * T;
    __syncthreads();  // the previous chunk is consumed

    // 1. stage the chunk as f32
    for (int e = tid; e < T * P; e += kThreads) {
      const int t = e / P, p = e % P;
      xs[t * PP + p] = to_float(xb[(long long)(t0 + t) * st.x_s + p]);
    }
    for (int e = tid; e < T * N; e += kThreads) {
      const int t = e / N, n = e % N;
      bT[n * TP + t] = to_float(bb[(long long)(t0 + t) * st.b_s + n]);
      cT[n * TP + t] = to_float(cb[(long long)(t0 + t) * st.c_s + n]);
    }
    for (int t = tid; t < T; t += kThreads) {
      dts[t] = dtb[(long long)(t0 + t) * st.dt_s];
      ca[t] = dab[(long long)(t0 + t) * st.da_s];
    }
    __syncthreads();

    // 2. cumulative log decay, in order, then the per-step factors
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < T; ++t) {
        acc += ca[t];
        ca[t] = acc;
      }
    }
    __syncthreads();
    const float ca_last = ca[T - 1];
    for (int t = tid; t < T; t += kThreads) {
      ea[t] = expf(ca[t]);
      ws[t] = expf(ca_last - ca[t]) * dts[t];
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
                         ? acc[i][j] * (expf(ca[t] - ca[s]) * dts[s])
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
      const float decay = expf(ca_last);
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

template <typename Tin, typename Tout>
int launch(const void* x, const void* b, const void* c, const float* dt,
           const float* da, void* y, float* hout, int batch, const Dims& d,
           const Strides& st, cudaStream_t stream) {
  const size_t bytes = smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mamba_ssd_scan<Tin, Tout>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(d.heads, batch);
  mamba_ssd_scan<Tin, Tout><<<grid, kThreads, bytes, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(b),
      static_cast<const Tin*>(c), dt, da, static_cast<Tout*>(y), hout, d, st);
  return 0;
}

template <typename Tin>
int launch_out(int out_dtype, const void* x, const void* b, const void* c,
               const float* dt, const float* da, void* y, float* hout,
               int batch, const Dims& d, const Strides& st,
               cudaStream_t stream) {
  if (out_dtype == 0)
    return launch<Tin, float>(x, b, c, dt, da, y, hout, batch, d, st, stream);
  if (out_dtype == 1)
    return launch<Tin, __nv_bfloat16>(x, b, c, dt, da, y, hout, batch, d, st,
                                      stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. x, b, c share in_dtype; dt and da
// are float32; y is written as out_dtype, contiguous [B, S, H, P]; hout is
// float32, contiguous [B, H, P, N]. Strides are in elements: (batch, seq,
// head) for x, dt and da, (batch, seq) for b and c; the last dimension of
// x, b and c is contiguous. seqlen % chunk == 0, chunk <= 128, p <= 64,
// n <= 64. Returns cudaGetLastError() after the launch.
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
  if (in_dtype == 0) {
    err = launch_out<float>(out_dtype, x, b, c, dtf, daf, y, hf, batch, d, st,
                            s);
  } else if (in_dtype == 1) {
    err = launch_out<__nv_bfloat16>(out_dtype, x, b, c, dtf, daf, y, hf,
                                    batch, d, st, s);
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
