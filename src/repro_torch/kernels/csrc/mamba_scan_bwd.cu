// Mamba2 SSD chunk scan backward for Hopper (sm_90a), bound to Python
// through ctypes.
//
// The JAX package differentiates its jnp model and has no backward kernel;
// this is the gradient of the port's forward kernel csrc/mamba_scan.cu
// (which replaces the Pallas TPU kernel repro/kernels/mamba_scan.py::
// mamba_chunk_scan), so that training on the card runs through hand-written
// kernels both ways.
//
// The forward, for one (batch, head) and chunk k of T steps, with
// ca = cumsum(da) inside the chunk, ca_T its last entry and h_k the state
// entering the chunk (h_0 = 0):
//   y_t     = sum_{s <= t} (C_t . B_s) e^{ca_t - ca_s} dt_s x_s + e^{ca_t} h_k C_t
//   h_{k+1} = e^{ca_T} h_k + sum_s e^{ca_T - ca_s} dt_s x_s B_s^T
// Given dy and G_{k+1}, the gradient of h_{k+1} (dh_final after the last
// chunk, or 0), with SE_ts = (C_t . B_s) e^{ca_t - ca_s} (s <= t) and
// K_ts = (dy_t . x_s) e^{ca_t - ca_s} dt_s (s <= t):
//   G_k    = e^{ca_T} G_{k+1} + sum_t e^{ca_t} dy_t C_t^T
//   dx_s   = dt_s (sum_t SE_ts dy_t + e^{ca_T - ca_s} G_{k+1} B_s)
//   dB_s   = sum_t K_ts C_t + dt_s e^{ca_T - ca_s} x_s^T G_{k+1}  (this head)
//   dC_t   = sum_s K_ts B_s + e^{ca_t} dy_t^T h_k                 (this head)
//   ddt_s  = col_s + e^{ca_T - ca_s} q_s,
//   with col_s = x_s . sum_t SE_ts dy_t and q_s = x_s^T G_{k+1} B_s;
//   dca_t  = row_t - dt_t col_t + e^{ca_t} r_t - dt_t e^{ca_T - ca_t} q_t
//            (+ e^{ca_T} <G_{k+1}, h_k> + sum_s dt_s e^{ca_T - ca_s} q_s at
//            t = T - 1), with row_t = C_t . sum_s K_ts B_s and
//            r_t = C_t . (dy_t^T h_k);
//   dda_u  = sum_{t >= u} dca_t (a reverse cumulative sum inside the chunk).
// row and col are the sums of W_ts = (C_t . B_s)(dy_t . x_s) e^{ca_t-ca_s}
// dt_s over s and over t, read off the products dC and dx need anyway.
//
// What bounds it on the H100: operations. At the zamba2-7b train shape (x
// [4, 512, 112, 64] bf16, B and C [4, 512, 64], N = 64, T = 128, dy f32) it
// moves ~122 MB (x, B, C, dt, da, dy read once, dx, dB, dC, ddt, dda
// written once: ~0.036 ms) against ~19 GFLOP of causal products in f32
// (~0.28 ms at 67 TFLOP/s).
//
// Design: three launches, every product as f32 FMAs on the FP32 pipes.
// * scan_bwd_states, one CTA of 256 threads per (head, batch, direction):
//   direction 0 walks the chunks forward and writes h_k (the state entering
//   chunk k), direction 1 walks them in reverse and writes G_{k+1} (the
//   gradient leaving chunk k), into float32 scratch [B, H, chunks, P, N].
//   Both are the forward's carry: state <- decay state + sum_t (w_t u_t)
//   v_t^T, with (u, v, w) = (x, B, e^{ca_T - ca_t} dt_t) or
//   (dy, C, e^{ca_t}); each thread keeps 4 x 4 entries of the state in
//   registers across the chunks. Recomputing h_k leaves the forward kernels
//   and their y untouched.
// * scan_bwd_chunks, one CTA of 256 threads per (chunk, head, batch): the
//   chunks are independent given h_k and G_{k+1}. x, dy, B and C of the
//   chunk are staged in shared memory as f32, with odd leading dimensions
//   (65, and 129 for the T x T tile), so every operand read is free of bank
//   conflicts: a thread owns rows ti + 16 r and columns tj + 16 c of each
//   product (8 x 8 of a T x T one, 8 x 4 of a T x 64 one), the 16 lanes of
//   a half-warp read 16 consecutive rows or columns, and sums over a
//   product's columns (q, col, row, r) finish with a fixed shuffle tree
//   inside the half-warp. The T x T tile holds SE, then K; products are
//   taken over the whole padded tile (zeros outside s <= t < T). ~218 KB of
//   dynamic shared memory, one CTA an SM.
// * scan_bwd_reduce sums the per-head dB and dC partials [B, H, S, N] over
//   the heads in order, in float64, and rounds once to B's dtype.
//
// Arithmetic, as the forward's: ca is a float64 cumulative sum (in order),
// every exponent a float64 difference rounded to f32 only as the argument
// of expf; q, col, row, r, dca and its reverse cumulative sum are float64
// (dca_t takes + and - terms of equal size). dx is written once in x's
// dtype, ddt and dda in f32. Launch configurations are fixed by the shapes
// and there are no atomics: reruns are bitwise identical.
//
// Inputs are read through their strides, as the forward reads them (x, dt,
// da, dy: (batch, seq, head); B, C: (batch, seq); the last dimension
// contiguous). Outputs are new contiguous tensors.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxT = 128, kMaxP = 64, kMaxN = 64;
constexpr int LT = kMaxT + 1;  // odd leading dimensions: no bank conflicts
constexpr int LP = kMaxP + 1;
constexpr int LN = kMaxN + 1;

struct Dims {
  int batch, seqlen, heads, p, n, chunk, nchunks;
};

struct Strides {  // in elements
  int x_b, x_s, x_h, b_b, b_s, c_b, c_s, dt_b, dt_s, dt_h, da_b, da_s, da_h,
      dy_b, dy_s, dy_h;
};

// dtype codes: 0 = float32, 1 = bfloat16
__device__ __forceinline__ float load(const void* p, int dtype, long long i) {
  return dtype ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
               : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, int dtype, long long i,
                                      float v) {
  if (dtype)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// acc[r][c] += sum_{k < k1} A[(ti + 16 r) AI + k AK] B[(tj + 16 c) BJ + k BK],
// in k order.
template <int MI, int NJ, int AI, int AK, int BJ, int BK>
__device__ __forceinline__ void mac(float (&acc)[MI][NJ], const float* A,
                                    const float* B, int k1, int ti, int tj) {
  const float* a0 = A + ti * AI;
  const float* b0 = B + tj * BJ;
  for (int k = 0; k < k1; ++k) {
    float a[MI], b[NJ];
#pragma unroll
    for (int r = 0; r < MI; ++r) a[r] = a0[16 * r * AI + k * AK];
#pragma unroll
    for (int c = 0; c < NJ; ++c) b[c] = b0[16 * c * BJ + k * BK];
#pragma unroll
    for (int r = 0; r < MI; ++r)
#pragma unroll
      for (int c = 0; c < NJ; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

template <int MI, int NJ>
__device__ __forceinline__ void zero(float (&acc)[MI][NJ]) {
#pragma unroll
  for (int r = 0; r < MI; ++r)
#pragma unroll
    for (int c = 0; c < NJ; ++c) acc[r][c] = 0.f;
}

// The sum over the 16 lanes of a half-warp, in a fixed tree (every lane
// gets it).
__device__ __forceinline__ double half_warp_sum(double v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stage rows [t0, t0 + T) of a [.., S, .., W] input as f32 rows of `ld`
// floats: dst[t * ld + w] for t < kMaxT, w < wmax, zero outside t < T,
// w < W.
__device__ __forceinline__ void stage(float* dst, int ld, int wmax,
                                      const void* src, int dtype,
                                      long long base, int row_stride, int T,
                                      int W) {
  for (int e = threadIdx.x; e < kMaxT * wmax; e += kThreads) {
    const int t = e / wmax, w = e % wmax;
    dst[t * ld + w] = (t < T && w < W)
                          ? load(src, dtype, base + (long long)t * row_stride +
                                                 w)
                          : 0.f;
  }
}

// ca = cumsum(da) over the chunk in float64, in order (the forward's).
__device__ __forceinline__ void chunk_cumsum(double* ca, const float* da,
                                             long long base, int stride,
                                             int T) {
  for (int t = threadIdx.x; t < T; t += kThreads)
    ca[t] = da[base + (long long)t * stride];
  __syncthreads();
  if (threadIdx.x == 0) {
    double acc = 0.0;
    for (int t = 0; t < T; ++t) {
      acc += ca[t];
      ca[t] = acc;
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------ state pass

constexpr size_t kStatesSmem =
    sizeof(float) * (size_t)(kMaxT * LP + kMaxT * LN + kMaxT) +
    sizeof(double) * kMaxT;

__global__ void __launch_bounds__(kThreads)
scan_bwd_states(const void* x, const void* bm, const void* cm,
                const float* dt, const float* da, const void* dy,
                const float* dh, float* hs, float* gs, int in_dtype,
                int dy_dtype, Dims d, Strides st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* ca = reinterpret_cast<double*>(smem_raw);
  float* u = reinterpret_cast<float*>(ca + kMaxT);  // [kMaxT][LP]
  float* v = u + kMaxT * LP;                        // [kMaxT][LN]
  float* w = v + kMaxT * LN;                        // [kMaxT]
  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const int h = blockIdx.x, bi = blockIdx.y, reverse = blockIdx.z;
  const int T = d.chunk, P = d.p, N = d.n;
  const long long bh = (long long)bi * d.heads + h;

  float acc[4][4], state[4][4];
  if (reverse && dh) {
    const float* g0 = dh + bh * P * N;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = ti + 16 * r, n = tj + 16 * c;
        state[r][c] = (p < P && n < N) ? g0[p * N + n] : 0.f;
      }
  } else {
    zero(state);
  }
  float* out = (reverse ? gs : hs) + bh * d.nchunks * P * N;

  for (int it = 0; it < d.nchunks; ++it) {
    const int k = reverse ? d.nchunks - 1 - it : it;
    const int t0 = k * T;
    __syncthreads();  // the previous chunk is consumed
    if (reverse) {
      stage(u, LP, kMaxP, dy, dy_dtype,
            (long long)bi * st.dy_b + (long long)t0 * st.dy_s +
                (long long)h * st.dy_h,
            st.dy_s, T, P);
      stage(v, LN, kMaxN, cm, in_dtype,
            (long long)bi * st.c_b + (long long)t0 * st.c_s, st.c_s, T, N);
    } else {
      stage(u, LP, kMaxP, x, in_dtype,
            (long long)bi * st.x_b + (long long)t0 * st.x_s +
                (long long)h * st.x_h,
            st.x_s, T, P);
      stage(v, LN, kMaxN, bm, in_dtype,
            (long long)bi * st.b_b + (long long)t0 * st.b_s, st.b_s, T, N);
    }
    chunk_cumsum(ca, da,
                 (long long)bi * st.da_b + (long long)t0 * st.da_s +
                     (long long)h * st.da_h,
                 st.da_s, T);
    const double ca_last = ca[T - 1];
    for (int t = tid; t < T; t += kThreads)
      w[t] = reverse ? expf((float)ca[t])
                     : expf((float)(ca_last - ca[t])) *
                           dt[(long long)bi * st.dt_b +
                              (long long)(t0 + t) * st.dt_s +
                              (long long)h * st.dt_h];

    // the state entering the step (h_k) or leaving it (G_{k+1})
    float* o = out + (long long)k * P * N;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = ti + 16 * r, n = tj + 16 * c;
        if (p < P && n < N) o[p * N + n] = state[r][c];
      }
    __syncthreads();

    // state[p][n] <- decay state[p][n] + sum_t (w_t u[t][p]) v[t][n]
    zero(acc);
    for (int t = 0; t < T; ++t) {
      const float wt = w[t];
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = u[t * LP + ti + 16 * r] * wt;
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = v[t * LN + tj + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    const float decay = expf((float)ca_last);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        state[r][c] = decay * state[r][c] + acc[r][c];
  }
}

// ------------------------------------------------------------ chunk pass

struct ChunkSmem {  // offsets in bytes
  static constexpr size_t kTile = 0;                                // [kMaxT][LT]
  static constexpr size_t kC = kTile + sizeof(float) * kMaxT * LT;  // [kMaxT][LN]
  static constexpr size_t kB = kC + sizeof(float) * kMaxT * LN;     // [kMaxT][LN]
  static constexpr size_t kX = kB + sizeof(float) * kMaxT * LN;     // [kMaxT][LP]
  static constexpr size_t kDy = kX + sizeof(float) * kMaxT * LP;    // [kMaxT][LP]
  static constexpr size_t kGH = kDy + sizeof(float) * kMaxT * LP;   // [kMaxP][LN]
  static constexpr size_t kVec = kGH + sizeof(float) * kMaxP * LN;  // 3 x [kMaxT]
  static constexpr size_t kCa = kVec + sizeof(float) * 3 * kMaxT;   // doubles:
  // ca, q, col, row, r, dca [kMaxT] each, then a reduction slot a warp
  static constexpr size_t kRed = kCa + sizeof(double) * 6 * kMaxT;
  static constexpr size_t kBytes = kRed + sizeof(double) * (kThreads / 32);
};

__global__ void __launch_bounds__(kThreads, 1)
scan_bwd_chunks(const void* x, const void* bm, const void* cm,
                const float* dt, const float* da, const void* dy,
                const float* hs, const float* gs, void* dx, float* dbp,
                float* dcp, float* ddt, float* dda, int in_dtype,
                int dy_dtype, Dims d, Strides st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tile = reinterpret_cast<float*>(smem_raw + ChunkSmem::kTile);
  float* cs = reinterpret_cast<float*>(smem_raw + ChunkSmem::kC);
  float* bs = reinterpret_cast<float*>(smem_raw + ChunkSmem::kB);
  float* xs = reinterpret_cast<float*>(smem_raw + ChunkSmem::kX);
  float* dys = reinterpret_cast<float*>(smem_raw + ChunkSmem::kDy);
  float* gh = reinterpret_cast<float*>(smem_raw + ChunkSmem::kGH);
  float* dts = reinterpret_cast<float*>(smem_raw + ChunkSmem::kVec);
  float* ea = dts + kMaxT;   // e^{ca_t}
  float* wse = ea + kMaxT;   // e^{ca_T - ca_t}
  double* ca = reinterpret_cast<double*>(smem_raw + ChunkSmem::kCa);
  double* qd = ca + kMaxT;
  double* cold = qd + kMaxT;
  double* rowd = cold + kMaxT;
  double* rd = rowd + kMaxT;
  double* dca = rd + kMaxT;
  double* red = reinterpret_cast<double*>(smem_raw + ChunkSmem::kRed);

  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const int k = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int T = d.chunk, P = d.p, N = d.n, t0 = k * T;
  const long long bh = (long long)bi * d.heads + h;
  const long long state_at = (bh * d.nchunks + k) * P * N;

  // 1. stage the chunk (f32, zero padded), G_{k+1}, dt and ca
  stage(xs, LP, kMaxP, x, in_dtype,
        (long long)bi * st.x_b + (long long)t0 * st.x_s +
            (long long)h * st.x_h,
        st.x_s, T, P);
  stage(dys, LP, kMaxP, dy, dy_dtype,
        (long long)bi * st.dy_b + (long long)t0 * st.dy_s +
            (long long)h * st.dy_h,
        st.dy_s, T, P);
  stage(bs, LN, kMaxN, bm, in_dtype,
        (long long)bi * st.b_b + (long long)t0 * st.b_s, st.b_s, T, N);
  stage(cs, LN, kMaxN, cm, in_dtype,
        (long long)bi * st.c_b + (long long)t0 * st.c_s, st.c_s, T, N);
  for (int e = tid; e < kMaxP * kMaxN; e += kThreads) {
    const int p = e / kMaxN, n = e % kMaxN;
    gh[p * LN + n] = (p < P && n < N) ? gs[state_at + p * N + n] : 0.f;
  }
  for (int t = tid; t < kMaxT; t += kThreads)
    dts[t] = t < T ? dt[(long long)bi * st.dt_b +
                        (long long)(t0 + t) * st.dt_s +
                        (long long)h * st.dt_h]
                   : 0.f;
  chunk_cumsum(ca, da,
               (long long)bi * st.da_b + (long long)t0 * st.da_s +
                   (long long)h * st.da_h,
               st.da_s, T);
  const double ca_last = ca[T - 1];
  for (int t = tid; t < kMaxT; t += kThreads) {
    ea[t] = t < T ? expf((float)ca[t]) : 0.f;
    wse[t] = t < T ? expf((float)(ca_last - ca[t])) : 0.f;
  }
  __syncthreads();

  // 2. tile[t][s] = SE_ts = (C_t . B_s) e^{ca_t - ca_s}, s <= t < T
  {
    float acc[8][8];
    zero(acc);
    mac<8, 8, LN, 1, LN, 1>(acc, cs, bs, N, ti, tj);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int t = ti + 16 * r;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int s = tj + 16 * c;
        tile[t * LT + s] =
            (s <= t && t < T) ? acc[r][c] * expf((float)(ca[t] - ca[s]))
                              : 0.f;
      }
    }
  }
  __syncthreads();

  // 3. dx_s = dt_s (sum_t SE_ts dy_t + e^{ca_T - ca_s} G B_s);
  //    col_s = x_s . sum_t SE_ts dy_t, q_s = x_s . G B_s
  {
    float acc1[8][4], acc2[8][4];
    zero(acc1);
    zero(acc2);
    mac<8, 4, 1, LT, 1, LP>(acc1, tile, dys, T, ti, tj);
    mac<8, 4, LN, 1, LN, 1>(acc2, bs, gh, N, ti, tj);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int s = ti + 16 * r;
      double col = 0.0, q = 0.0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = tj + 16 * c;
        const double xv = xs[s * LP + p];
        col += xv * (double)acc1[r][c];
        q += xv * (double)acc2[r][c];
        if (s < T && p < P)
          store(dx, in_dtype,
                (((long long)bi * d.seqlen + t0 + s) * d.heads + h) * P + p,
                dts[s] * (acc1[r][c] + wse[s] * acc2[r][c]));
      }
      col = half_warp_sum(col);
      q = half_warp_sum(q);
      if (tj == 0) {
        cold[s] = col;
        qd[s] = q;
      }
    }
  }
  __syncthreads();

  // 4. tile[t][s] = K_ts = (dy_t . x_s) e^{ca_t - ca_s} dt_s, s <= t < T
  {
    float acc[8][8];
    zero(acc);
    mac<8, 8, LP, 1, LP, 1>(acc, dys, xs, P, ti, tj);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int t = ti + 16 * r;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int s = tj + 16 * c;
        tile[t * LT + s] =
            (s <= t && t < T)
                ? acc[r][c] * expf((float)(ca[t] - ca[s])) * dts[s]
                : 0.f;
      }
    }
  }
  __syncthreads();

  // 5. dB_s (this head) = sum_t K_ts C_t + dt_s e^{ca_T - ca_s} x_s^T G;
  //    <G_{k+1}, h_k> beside it, in a fixed order
  {
    float acc1[8][4], acc2[8][4];
    zero(acc1);
    zero(acc2);
    mac<8, 4, 1, LT, 1, LN>(acc1, tile, cs, T, ti, tj);
    mac<8, 4, LP, 1, 1, LN>(acc2, xs, gh, P, ti, tj);
    float* out = dbp + (bh * d.seqlen + t0) * N;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int s = ti + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = tj + 16 * c;
        if (s < T && n < N)
          out[s * N + n] = acc1[r][c] + (dts[s] * wse[s]) * acc2[r][c];
      }
    }
    double part = 0.0;
    for (int e = tid; e < P * N; e += kThreads)
      part += (double)gh[(e / N) * LN + e % N] * (double)hs[state_at + e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (tid % 32 == 0) red[tid / 32] = part;
  }
  __syncthreads();

  // 6. h_k in place of G
  for (int e = tid; e < kMaxP * kMaxN; e += kThreads) {
    const int p = e / kMaxN, n = e % kMaxN;
    gh[p * LN + n] = (p < P && n < N) ? hs[state_at + p * N + n] : 0.f;
  }
  __syncthreads();

  // 7. dC_t (this head) = sum_s K_ts B_s + e^{ca_t} dy_t^T h_k;
  //    row_t = C_t . sum_s K_ts B_s, r_t = C_t . dy_t^T h_k
  {
    float acc1[8][4], acc2[8][4];
    zero(acc1);
    zero(acc2);
    mac<8, 4, LT, 1, 1, LN>(acc1, tile, bs, T, ti, tj);
    mac<8, 4, LP, 1, 1, LN>(acc2, dys, gh, P, ti, tj);
    float* out = dcp + (bh * d.seqlen + t0) * N;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int t = ti + 16 * r;
      double row = 0.0, rr = 0.0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = tj + 16 * c;
        const double cv = cs[t * LN + n];
        row += cv * (double)acc1[r][c];
        rr += cv * (double)acc2[r][c];
        if (t < T && n < N) out[t * N + n] = acc1[r][c] + ea[t] * acc2[r][c];
      }
      row = half_warp_sum(row);
      rr = half_warp_sum(rr);
      if (tj == 0) {
        rowd[t] = row;
        rd[t] = rr;
      }
    }
  }
  __syncthreads();

  // 8. ddt and dca per position, then dda = the reverse cumulative sum of
  //    dca, all in float64
  const long long vec = (long long)bi * d.seqlen * d.heads + h;
  for (int t = tid; t < T; t += kThreads) {
    const double dtv = dts[t], wv = wse[t];
    ddt[vec + (long long)(t0 + t) * d.heads] =
        (float)(cold[t] + wv * qd[t]);
    dca[t] = rowd[t] - dtv * cold[t] + (double)ea[t] * rd[t] -
             dtv * wv * qd[t];
  }
  __syncthreads();
  if (tid == 0) {
    double gh_dot = 0.0, carry = 0.0;
    for (int i = 0; i < kThreads / 32; ++i) gh_dot += red[i];
    for (int s = 0; s < T; ++s) carry += (double)dts[s] * wse[s] * qd[s];
    dca[T - 1] += (double)expf((float)ca_last) * gh_dot + carry;
    double acc = 0.0;
    for (int t = T - 1; t >= 0; --t) {
      acc += dca[t];
      dda[vec + (long long)(t0 + t) * d.heads] = (float)acc;
    }
  }
}

// ---------------------------------------------------------------- reduce

// out[b][s][n] = sum over heads, in order, of part[b][h][s][n] (float64),
// for dB (first B S N threads) and dC (the next B S N).
__global__ void __launch_bounds__(kThreads)
scan_bwd_reduce(const float* dbp, const float* dcp, void* db, void* dc,
                int dtype, Dims d) {
  const long long per = (long long)d.batch * d.seqlen * d.n;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= 2 * per) return;
  const bool is_c = e >= per;
  const long long i = is_c ? e - per : e;
  const long long sn = (long long)d.seqlen * d.n;
  const long long bi = i / sn, rest = i % sn;
  const float* part = (is_c ? dcp : dbp) + bi * d.heads * sn + rest;
  double acc = 0.0;
  for (int h = 0; h < d.heads; ++h) acc += part[(long long)h * sn];
  store(is_c ? dc : db, dtype, i, (float)acc);
}

long long scratch_floats(const Dims& d) {
  const long long bh = (long long)d.batch * d.heads;
  return 2 * bh * d.nchunks * d.p * d.n + 2 * bh * d.seqlen * d.n;
}

}  // namespace

extern "C" {

// Bytes of float32 scratch the backward needs: h_k and G_{k+1} [B, H,
// chunks, P, N] each, and the per-head dB and dC partials [B, H, S, N]
// each.
long long mamba_scan_bwd_scratch_bytes(int batch, int seqlen, int heads,
                                       int p, int n, int chunk) {
  if (chunk <= 0) return 0;
  const Dims d{batch, seqlen, heads, p, n, chunk, seqlen / chunk};
  return scratch_floats(d) * (long long)sizeof(float);
}

// dtype codes: 0 = float32, 1 = bfloat16. x, b, c share in_dtype; dy is
// in_dtype or float32 (dy_dtype); dt, da and dh (nullable: the final
// state's gradient, contiguous [B, H, P, N]) are float32. dx is written in
// in_dtype, contiguous [B, S, H, P]; db, dc in in_dtype, contiguous
// [B, S, N]; ddt and dda float32, contiguous [B, S, H]. Strides are in
// elements: (batch, seq, head) for x, dt, da and dy, (batch, seq) for b and
// c; every last dimension is contiguous. seqlen % chunk == 0, chunk <= 128,
// p <= 64, n <= 64. Returns cudaGetLastError() after the last launch.
int mamba_scan_bwd(const void* x, const void* b, const void* c,
                   const void* dt, const void* da, const void* dy,
                   const void* dh, void* dx, void* db, void* dc, void* ddt,
                   void* dda, void* scratch, int in_dtype, int dy_dtype,
                   int batch, int seqlen, int heads, int p, int n, int chunk,
                   int x_sb, int x_ss, int x_sh, int b_sb, int b_ss, int c_sb,
                   int c_ss, int dt_sb, int dt_ss, int dt_sh, int da_sb,
                   int da_ss, int da_sh, int dy_sb, int dy_ss, int dy_sh,
                   void* stream) {
  if (batch <= 0 || heads <= 0 || p <= 0 || n <= 0 || chunk <= 0 ||
      seqlen <= 0 || seqlen % chunk != 0 || chunk > kMaxT || p > kMaxP ||
      n > kMaxN || heads > 65535 || batch > 65535 ||
      seqlen / chunk > 65535 || in_dtype < 0 || in_dtype > 1 ||
      dy_dtype < 0 || dy_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const Dims d{batch, seqlen, heads, p, n, chunk, seqlen / chunk};
  const Strides st{x_sb,  x_ss,  x_sh,  b_sb,  b_ss,  c_sb,  c_ss,  dt_sb,
                   dt_ss, dt_sh, da_sb, da_ss, da_sh, dy_sb, dy_ss, dy_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* daf = static_cast<const float*>(da);
  const long long bh = (long long)batch * heads;
  float* hs = static_cast<float*>(scratch);
  float* gs = hs + bh * d.nchunks * p * n;
  float* dbp = gs + bh * d.nchunks * p * n;
  float* dcp = dbp + bh * seqlen * n;

  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_states, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kStatesSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(scan_bwd_chunks,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)ChunkSmem::kBytes);
  if (err != cudaSuccess) return (int)err;

  scan_bwd_states<<<dim3(heads, batch, 2), kThreads, kStatesSmem, s>>>(
      x, b, c, dtf, daf, dy, static_cast<const float*>(dh), hs, gs, in_dtype,
      dy_dtype, d, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_bwd_chunks<<<dim3(d.nchunks, heads, batch), kThreads,
                    ChunkSmem::kBytes, s>>>(
      x, b, c, dtf, daf, dy, hs, gs, dx, dbp, dcp, static_cast<float*>(ddt),
      static_cast<float*>(dda), in_dtype, dy_dtype, d, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = 2LL * batch * seqlen * n;
  scan_bwd_reduce<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads,
                    0, s>>>(dbp, dcp, db, dc, in_dtype, d);
  return (int)cudaGetLastError();
}

const char* mamba_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
