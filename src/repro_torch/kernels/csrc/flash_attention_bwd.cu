// Flash attention backward for Hopper (sm_90a), bound to Python through
// ctypes.
//
// The JAX package differentiates its jnp attention and has no backward
// kernel; this is the gradient of the port's forward kernels in
// csrc/flash_attention.cu (which replace the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention): causal, sliding
// window and GQA, positions from 0 on both sides, scale = D^-1/2.
//
// With S = scale q k^T (masked), P = softmax(S), o = P v and dO given:
//   dv = P^T dO,   dP = dO v^T,   dS = P o (dP - rowsum(dO o o)),
//   dq = scale dS k,   dk = scale dS^T q.
//
// What bounds it on the H100: at the training shapes the four products
// per tile pair (S, dP, and dq or dv/dk) make it compute-bound on the
// tensor cores (the least time is the FLOPs over 989 TFLOP/s); this first
// design runs them as f32 FMAs from shared memory, as K2's first forward did,
// and is far from that bound (a tensor-core design is later work).
//
// Two kernels, no atomics, launch configurations fixed by the shapes, so
// reruns are bitwise identical and no sum depends on scheduling:
// (a) flash_bwd_dq, one block per (64-row q tile, q head, batch): D_row =
//     rowsum(dO o o); a first sweep over the visible k tiles recomputes the
//     row max and sum (the logsumexp); a second sweep forms P = exp(S -
//     lse), dP and dS, and accumulates dq = scale dS k in registers. It
//     writes lse and D_row ([B, Hq, Sq] f32) to scratch.
// (b) flash_bwd_dkdv, one block per (64-row k tile, kv head, batch), loops
//     over the group's q heads and the q tiles that see the k tile, in a
//     fixed order, recomputing P from the stored lse and accumulating dv =
//     P^T dO and dk = scale dS^T q in registers.
// Tiles are f32 in shared memory with rows padded by one float (no bank
// conflicts on column walks); 256 threads, each owning a 4 x 4 block of
// the 64 x 64 score tile (rows ty + 16 i, columns tx + 16 j) and 4 x D/16
// of each accumulator. Operands are read through their (batch, seq, head)
// strides with a contiguous head dim, so the model's [B, S, H, D] views go
// in without copies, and dq, dk, dv are written through the strides given.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;             // q rows and k rows of a tile
constexpr int kPad = kTile + 1;       // padded row of a score tile
constexpr float kNegInf = -INFINITY;

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

// Element strides of one [B, S, H, D] operand (head dim contiguous).
struct Bsh {
  int b, s, h;
  __device__ __forceinline__ int64_t at(int bi, int si, int hi) const {
    return static_cast<int64_t>(bi) * b + static_cast<int64_t>(si) * s +
           static_cast<int64_t>(hi) * h;
  }
};

struct Shape {
  int hq, hkv, sq, skv, causal, window;
  float scale;
};

__device__ __forceinline__ bool visible(const Shape& sh, int qp, int kp) {
  if (kp >= sh.skv) return false;
  if (sh.causal && kp > qp) return false;
  if (sh.window && kp <= qp - sh.window) return false;
  return true;
}

// Rows [row0, row0 + 64) of one head of an operand into a padded f32 tile
// (rows past n are zero).
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, Bsh st,
                                          int bi, int hi, int row0, int n) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] =
        row < n ? to_float(src[st.at(bi, row, hi) + c]) : 0.f;
  }
}

// The thread's 4 x 4 block of A B^T for two padded [64, D] tiles.
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Reductions over the 16 lanes (tx) that share a row.
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// k tiles [lo, hi) that rows [q0, q0 + 64) can see.
__device__ __forceinline__ void k_range(const Shape& sh, int q0, int& lo,
                                        int& hi) {
  int kend = sh.skv;
  if (sh.causal) kend = min(kend, q0 + kTile);
  int kbeg = 0;
  if (sh.window) kbeg = max(0, q0 - sh.window + 1);
  lo = kbeg / kTile;
  hi = (kend + kTile - 1) / kTile;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const T* __restrict__ dout, T* __restrict__ dq,
             float* __restrict__ lse_out, float* __restrict__ drow_out,
             Shape sh, Bsh sq_, Bsh sk_, Bsh sv_, Bsh so_, Bsh sdo_,
             Bsh sdq_) {
  extern __shared__ float smem[];
  float* qs = smem;                           // [64][D+1]
  float* dos = qs + kTile * (D + 1);          // [64][D+1]
  float* ks = dos + kTile * (D + 1);          // [64][D+1]
  float* vs = ks + kTile * (D + 1);           // [64][D+1]
  float* dss = vs + kTile * (D + 1);          // [64][65]
  float* drow = dss + kTile * kPad;           // [64]

  const int q0 = blockIdx.x * kTile;
  const int hq = blockIdx.y, bi = blockIdx.z;
  const int hk = hq / (sh.hq / sh.hkv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_tile<D>(qs, q, sq_, bi, hq, q0, sh.sq);
  load_tile<D>(dos, dout, sdo_, bi, hq, q0, sh.sq);
  __syncthreads();
  // D_row = rowsum(dO o o): rows ty + 16 i, lanes tx over the head dim
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
    float acc = 0.f;
    if (row < sh.sq) {
      const T* orow = o + so_.at(bi, row, hq);
      for (int c = tx; c < D; c += 16)
        acc = fmaf(dos[r * (D + 1) + c], to_float(orow[c]), acc);
    }
    acc = half_sum(acc);
    if (tx == 0) drow[r] = acc;
  }

  int lo, hi;
  k_range(sh, q0, lo, hi);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = kNegInf; l[i] = 0.f; }

  // sweep 1: the logsumexp of each row
  for (int kt = lo; kt < hi; ++kt) {
    __syncthreads();
    load_tile<D>(ks, k, sk_, bi, hk, kt * kTile, sh.skv);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(qs, ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kt * kTile + tx + 16 * j;
        s[i][j] = visible(sh, qp, kp) ? s[i][j] * sh.scale : kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
      tmax = half_max(tmax);
      const float mn = fmaxf(m[i], tmax);
      float psum = 0.f;
      if (mn != kNegInf) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          psum += s[i][j] == kNegInf ? 0.f : expf(s[i][j] - mn);
      }
      psum = half_sum(psum);
      l[i] = (m[i] == kNegInf ? 0.f : l[i] * expf(m[i] - mn)) + psum;
      m[i] = mn;
    }
  }
  float lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse[i] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < sh.sq) {
      const int64_t idx =
          (static_cast<int64_t>(bi) * sh.hq + hq) * sh.sq + row;
      lse_out[idx] = lse[i];
      drow_out[idx] = drow[ty + 16 * i];
    }
  }

  // sweep 2: dq = scale dS k
  constexpr int NJ = D / 16;
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int kt = lo; kt < hi; ++kt) {
    __syncthreads();
    load_tile<D>(ks, k, sk_, bi, hk, kt * kTile, sh.skv);
    load_tile<D>(vs, v, sv_, bi, hk, kt * kTile, sh.skv);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(qs, ks, ty, tx, s);
    tile_dot<D>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kp = kt * kTile + c;
        const float p =
            visible(sh, qp, kp) ? expf(s[i][j] * sh.scale - lse[i]) : 0.f;
        dss[r * kPad + c] = p * (dp[i][j] - drow[r]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float kv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = ks[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dsv = dss[(ty + 16 * i) * kPad + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(dsv, kv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sh.sq) continue;
    T* out = dq + sdq_.at(bi, row, hq);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      out[tx + 16 * j] = from_float<T>(acc[i][j] * sh.scale);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               T* __restrict__ dk, T* __restrict__ dv,
               const float* __restrict__ lse_in,
               const float* __restrict__ drow_in, Shape sh, Bsh sq_,
               Bsh sk_, Bsh sv_, Bsh sdo_, Bsh sdk_, Bsh sdv_) {
  extern __shared__ float smem[];
  float* ks = smem;                           // [64][D+1]
  float* vs = ks + kTile * (D + 1);
  float* qs = vs + kTile * (D + 1);
  float* dos = qs + kTile * (D + 1);
  float* ps = dos + kTile * (D + 1);          // [64][65] P
  float* dss = ps + kTile * kPad;             // [64][65] dS
  float* lse_s = dss + kTile * kPad;          // [64]
  float* drow_s = lse_s + kTile;              // [64]

  const int k0 = blockIdx.x * kTile;
  const int hk = blockIdx.y, bi = blockIdx.z;
  const int group = sh.hq / sh.hkv;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_tile<D>(ks, k, sk_, bi, hk, k0, sh.skv);
  load_tile<D>(vs, v, sv_, bi, hk, k0, sh.skv);

  // q tiles that see keys [k0, k0 + 64)
  int qlo = 0, qhi = sh.sq;
  if (sh.causal) qlo = min(k0, sh.sq);
  if (sh.window) qhi = min(qhi, k0 + kTile - 1 + sh.window);
  const int tlo = qlo / kTile, thi = (qhi + kTile - 1) / kTile;

  constexpr int NJ = D / 16;
  float adk[4][NJ], adv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) { adk[i][j] = 0.f; adv[i][j] = 0.f; }

  for (int g = 0; g < group; ++g) {
    const int hq = hk * group + g;
    for (int qt = tlo; qt < thi; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_tile<D>(qs, q, sq_, bi, hq, q0, sh.sq);
      load_tile<D>(dos, dout, sdo_, bi, hq, q0, sh.sq);
      if (tid < kTile) {
        const int row = q0 + tid;
        const int64_t idx =
            (static_cast<int64_t>(bi) * sh.hq + hq) * sh.sq + row;
        lse_s[tid] = row < sh.sq ? lse_in[idx] : INFINITY;
        drow_s[tid] = row < sh.sq ? drow_in[idx] : 0.f;
      }
      __syncthreads();
      // the thread's block: q rows ty + 16 i, k columns tx + 16 j
      float s[4][4], dp[4][4];
      tile_dot<D>(qs, ks, ty, tx, s);
      tile_dot<D>(dos, vs, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, qp = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, kp = k0 + c;
          const bool vis = qp < sh.sq && visible(sh, qp, kp);
          const float p = vis ? expf(s[i][j] * sh.scale - lse_s[r]) : 0.f;
          ps[r * kPad + c] = p;
          dss[r * kPad + c] = p * (dp[i][j] - drow_s[r]);
        }
      }
      __syncthreads();
      // the thread's accumulators: k rows ty + 16 i, head dims tx + 16 j
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float qv[NJ], dov[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          qv[j] = qs[r * (D + 1) + tx + 16 * j];
          dov[j] = dos[r * (D + 1) + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = ty + 16 * i;
          const float pv = ps[r * kPad + c];
          const float dsv = dss[r * kPad + c];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            adv[i][j] = fmaf(pv, dov[j], adv[i][j]);
            adk[i][j] = fmaf(dsv, qv[j], adk[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= sh.skv) continue;
    T* okr = dk + sdk_.at(bi, row, hk);
    T* ovr = dv + sdv_.at(bi, row, hk);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      okr[tx + 16 * j] = from_float<T>(adk[i][j] * sh.scale);
      ovr[tx + 16 * j] = from_float<T>(adv[i][j]);
    }
  }
}

constexpr size_t dq_smem(int d) {
  return (4 * kTile * (d + 1) + kTile * kPad + kTile) * sizeof(float);
}
constexpr size_t dkdv_smem(int d) {
  return (4 * kTile * (d + 1) + 2 * kTile * kPad + 2 * kTile) *
         sizeof(float);
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* drow, int b, const Shape& sh, const Bsh* st,
           cudaStream_t stream) {
  const size_t s1 = dq_smem(D), s2 = dkdv_smem(D);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s1));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(flash_bwd_dkdv<D, T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(s2));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 g1((sh.sq + kTile - 1) / kTile, sh.hq, b);
  flash_bwd_dq<D, T><<<g1, kThreads, s1, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<T*>(dq), lse, drow, sh,
      st[0], st[1], st[2], st[3], st[4], st[5]);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 g2((sh.skv + kTile - 1) / kTile, sh.hkv, b);
  flash_bwd_dkdv<D, T><<<g2, kThreads, s2, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dk), static_cast<T*>(dv), lse, drow, sh, st[0], st[1],
      st[2], st[4], st[6], st[7]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               const void* o, const void* dout, void* dq, void* dk, void* dv,
               float* lse, float* drow, int b, const Shape& sh,
               const Bsh* st, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<32, T>(q, k, v, o, dout, dq, dk, dv, lse, drow, b, sh,
                           st, stream);
    case 64:
      return launch<64, T>(q, k, v, o, dout, dq, dk, dv, lse, drow, b, sh,
                           st, stream);
    case 112:
      return launch<112, T>(q, k, v, o, dout, dq, dk, dv, lse, drow, b, sh,
                            st, stream);
    case 128:
      return launch<128, T>(q, k, v, o, dout, dq, dk, dv, lse, drow, b, sh,
                            st, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, o, dout, dq: [B, Hq, Sq, D];
// k, v, dk, dv: [B, Hkv, Skv, D]; each given by its (batch, seq, head)
// element strides, head dim contiguous. scratch holds 2 * B * Hq * Sq
// floats (lse, then rowsum(dO o o)). Returns cudaGetLastError() after the
// launches (0 = success).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, void* dq, void* dk,
                        void* dv, void* scratch, int dtype, int b, int hq,
                        int hkv, int sq, int skv, int d, int q_sb, int q_ss,
                        int q_sh, int k_sb, int k_ss, int k_sh, int v_sb,
                        int v_ss, int v_sh, int o_sb, int o_ss, int o_sh,
                        int do_sb, int do_ss, int do_sh, int dq_sb,
                        int dq_ss, int dq_sh, int dk_sb, int dk_ss,
                        int dk_sh, int dv_sb, int dv_ss, int dv_sh,
                        int causal, int window, float scale, void* stream) {
  const Shape sh{hq, hkv, sq, skv, causal, window, scale};
  const Bsh st[8] = {{q_sb, q_ss, q_sh},    {k_sb, k_ss, k_sh},
                     {v_sb, v_ss, v_sh},    {o_sb, o_ss, o_sh},
                     {do_sb, do_ss, do_sh}, {dq_sb, dq_ss, dq_sh},
                     {dk_sb, dk_ss, dk_sh}, {dv_sb, dv_ss, dv_sh}};
  float* lse = static_cast<float*>(scratch);
  float* drow = lse + static_cast<int64_t>(b) * hq * sq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, o, dout, dq, dk, dv, lse, drow, b,
                             sh, st, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, dout, dq, dk, dv, lse,
                                     drow, b, sh, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
