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
// What bounds it on the H100: bytes. At the zamba2-7b train shape (x
// [4, 512, 112, 64] bf16, B and C [4, 512, 64], N = 64, T = 128, dy f32) it
// moves ~122 MB (x, B, C, dt, da, dy read once, dx, dB, dC, ddt, dda
// written once: ~0.036 ms) against ~19 GFLOP of causal products (~0.019 ms
// at the bf16 tensor-core peak, ~0.28 ms on the FP32 pipes).
//
// Two routes, chosen by the input dtype; neither is a fallback for the
// other. Both are three launches: the chunk states, the chunks, then
// scan_bwd_reduce, which sums the per-head dB and dC partials [B, H, S, N]
// over the heads in order, in float64, and rounds once to B's dtype.
//
// bf16: on the tensor cores (tc::), every product a wgmma with f32
// accumulation.
// * Numerics. Each product whose operands are both bf16 (S = C B^T) is one
//   pass. Each f32 operand (dy, G_{k+1}, h_k, the masked tiles SE and K, the
//   weighted rows w_t u_t of the state pass) is split into two bf16 terms,
//   hi = bf16(v) and mid = bf16(v - hi); a product with one such operand
//   takes two passes, the two with two of them (SE^T dy and dy h_k) three:
//   hi hi, hi mid and mid hi into one f32 accumulator.
//   tests/test_torch_mamba_bwd.py emulates this arithmetic at the train
//   shape: it uses ~0.01 of the tolerance on ddt and dda (~0.17 on the bf16
//   outputs, their own rounding), and without the cross terms (hi hi only)
//   dx misses it (1.6x and 2.4x on the test's two draws).
// * scan_bwd_tc_states, one warpgroup per (chunk, direction, head, batch),
//   all chunks at once: the chunk-local sums of the state pass's carry,
//   sum_t (w_t u_t) v_t^T, with v (B or C) a 128-byte-swizzled bf16 tile
//   (MN-major B operand) and w_t u[t][p] (u = x or dy, staged in f32) the
//   two register A terms, M = p, K = t; and each chunk's decay e^{ca_T}.
// * scan_bwd_tc_chunks, one CTA of two warpgroups per (chunk, head, batch):
//   h_k and G_{k+1} folded from the chunk sums in the FMA state pass's
//   order (state <- decay_j state + sum_j in f32: chunk k reads the k sums
//   before it and the chunks - 1 - k after it), then x, B, C (cp.async),
//   the two terms of dy, G_{k+1} and h_k staged as swizzled bf16 tiles,
//   beside a table of the masked decays e^{ca_t - ca_s}, each computed
//   once for both passes (~188 KB, one CTA an SM). Warpgroup r (a
//   warp-uniform index: ptxas serialises wgmma behind a per-thread branch,
//   C7520) owns rows 64 r .. 64 r + 63 twice: as s in pass A (S^T = B C^T
//   and D^T = x dy^T on the causal blocks t >= 64 r, masked in registers
//   into SE^T and K^T, which are the register A operands of dx's SE^T dy
//   and dB's K^T C; dx and dB start from e^{ca_T - ca_s} B G^T and
//   dt_s e^{ca_T - ca_s} x G) and as t in pass B (S = C B^T and D = dy x^T
//   on s < 64 (r + 1), K as the A operand of dC's K B; dC starts from
//   e^{ca_t} dy h). Computing S and D in both orientations costs two cheap
//   products and keeps every masked tile in registers. col_s = sum_t SE_ts
//   D_ts and row_t = sum_s S_ts K_ts (f32 products), q_s = x_s . (B G^T)_s
//   and r_t = C_t . (dy h)_t are float64 sums of the accumulators. Blocks
//   of 32 columns, so a thread holds the two accumulators, one block's S
//   and D and their terms (214 registers, no spills). The masks' float64
//   work (the exponent's difference and its conversions), more than the
//   wgmma, is what the pass waits on: hence the table, and col and row
//   summing f32 products.
//
// f32: every product as f32 FMAs on the FP32 pipes (the reduced
// card-vs-CPU checks rest on full-f32 products).
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
//
// Arithmetic of both, as the forward's: ca is a float64 cumulative sum (in
// order; the bf16 kernels by a warp scan, as the forward's tensor-core
// kernel), every exponent a float64 difference rounded to f32 only as the
// argument of expf; q, col, row, r, dca and its reverse cumulative sum are
// float64 (dca_t takes + and - terms of equal size). dx is written once in
// x's dtype, ddt and dda in f32. Launch configurations are fixed by the
// shapes and there are no atomics: reruns are bitwise identical.
//
// Inputs are read through their strides, as the forward reads them (x, dt,
// da, dy: (batch, seq, head); B, C: (batch, seq); the last dimension
// contiguous). Outputs are new contiguous tensors.

#include "hopper_tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxT = 128, kMaxP = 64, kMaxN = 64;
constexpr int LT = kMaxT + 1;  // odd leading dimensions: no bank conflicts
constexpr int LP = kMaxP + 1;
constexpr int LN = kMaxN + 1;

struct Dims {
  int batch, seqlen, heads, p, n, chunk, nchunks;
};

struct ScanStrides {  // in elements
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

// Stage rows [t0, t0 + T) of an f32 [.., S, .., W] input as rows of `ld`
// floats: dst[t * ld + w] for t < kMaxT, w < wmax, zero outside t < T,
// w < W.
__device__ __forceinline__ void stage(float* dst, int ld, int wmax,
                                      const float* src, long long base,
                                      int row_stride, int T, int W) {
  for (int e = threadIdx.x; e < kMaxT * wmax; e += kThreads) {
    const int t = e / wmax, w = e % wmax;
    dst[t * ld + w] = (t < T && w < W)
                          ? src[base + (long long)t * row_stride + w]
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
scan_bwd_states(const float* x, const float* bm, const float* cm,
                const float* dt, const float* da, const float* dy,
                const float* dh, float* hs, float* gs, Dims d,
                ScanStrides st) {
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
      stage(u, LP, kMaxP, dy,
            (long long)bi * st.dy_b + (long long)t0 * st.dy_s +
                (long long)h * st.dy_h,
            st.dy_s, T, P);
      stage(v, LN, kMaxN, cm,
            (long long)bi * st.c_b + (long long)t0 * st.c_s, st.c_s, T, N);
    } else {
      stage(u, LP, kMaxP, x,
            (long long)bi * st.x_b + (long long)t0 * st.x_s +
                (long long)h * st.x_h,
            st.x_s, T, P);
      stage(v, LN, kMaxN, bm,
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
scan_bwd_chunks(const float* x, const float* bm, const float* cm,
                const float* dt, const float* da, const float* dy,
                const float* hs, const float* gs, float* dx, float* dbp,
                float* dcp, float* ddt, float* dda, Dims d, ScanStrides st) {
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
  stage(xs, LP, kMaxP, x,
        (long long)bi * st.x_b + (long long)t0 * st.x_s +
            (long long)h * st.x_h,
        st.x_s, T, P);
  stage(dys, LP, kMaxP, dy,
        (long long)bi * st.dy_b + (long long)t0 * st.dy_s +
            (long long)h * st.dy_h,
        st.dy_s, T, P);
  stage(bs, LN, kMaxN, bm,
        (long long)bi * st.b_b + (long long)t0 * st.b_s, st.b_s, T, N);
  stage(cs, LN, kMaxN, cm,
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
          dx[(((long long)bi * d.seqlen + t0 + s) * d.heads + h) * P + p] =
              dts[s] * (acc1[r][c] + wse[s] * acc2[r][c]);
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

// ------------------------------------------- bf16: the tensor-core kernels

namespace tc {

constexpr int kChunkThreads = 256;  // two warpgroups
constexpr int kStateThreads = 128;  // one warpgroup
constexpr int kTileBytes = 128 * kRowBytes;  // [128 rows][64] bf16
constexpr int kHalfBytes = 64 * kRowBytes;   // 64 rows of a tile
constexpr int kLU = 68;  // leading dim of the f32 staging: no bank conflicts
constexpr int kLE = 132;  // leading dim of the decay table: pass A reads
                          // it without bank conflicts

// The byte offset of 16-byte chunk ch (columns 8 ch .. 8 ch + 7) of row t
// in the 128-byte swizzle: chunk ch sits at ch ^ (t % 8).
__device__ __forceinline__ int swz_chunk(int t, int ch) {
  return t * kRowBytes + ((ch ^ (t & 7)) << 4);
}

// The pair of bf16 elements (t, n), (t, n + 1) of a swizzled tile (n even).
__device__ __forceinline__ void bf16_pair(uint32_t tile, int t, int n,
                                          float& v0, float& v1) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];"
               : "=r"(v)
               : "r"(tile + swz_chunk(t, n >> 3) + (n & 7) * 2));
  v0 = __uint_as_float(v << 16);
  v1 = __uint_as_float(v & 0xffff0000u);
}

// The two bf16 terms of a pair of f32 values v: hi = bf16(v) and
// mid = bf16(v - hi) (v - hi is exact in f32): hi + mid carries 16 of v's
// 24 significant bits. t[0] = hi, t[1] = mid.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t* t) {
  const float h0 = bf16_round(v0), h1 = bf16_round(v1);
  t[0] = pack_bf16(h0, h1);
  t[1] = pack_bf16(v0 - h0, v1 - h1);
}

__device__ __forceinline__ uint4 split_chunk(const float* v, int term) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t t2[2];
    split2(v[2 * k], v[2 * k + 1], t2);
    w[k] = t2[term];
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The warpgroup index, read through a shuffle from lane 0 so that the
// compiler sees a warp-uniform value: wgmma on a path that depends on a
// per-thread value is serialised by ptxas (C7520).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
}

// A 16-byte asynchronous copy into shared memory (bytes = 0: zeros).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile(
      "cp.async.commit_group;\n"
      "cp.async.wait_group 0;" ::
          : "memory");
}

// Rows [0, rows) of a bf16 operand (element (t, col) at src + t row_stride
// + col for t < T, col < W; zero elsewhere) into the 128-byte-swizzled tile
// at shared address tile (generic pointer gtile), by 16-byte cp.async where
// 8 columns lie inside W or outside it (the wrapper's layout rule keeps
// those copies aligned), else one element at a time. Complete with
// cp_async_wait_all().
__device__ __forceinline__ void load_tile(uint32_t tile, uint8_t* gtile,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int rows,
                                          int T, int W, int tid,
                                          int threads) {
  for (int e = tid; e < rows * 8; e += threads) {
    const int t = e >> 3, ch = e & 7;
    const bool in = t < T && 8 * ch < W;
    const __nv_bfloat16* p = src + (in ? t * row_stride + 8 * ch : 0);
    if (!in || 8 * ch + 8 <= W) {
      cp_async16(tile + swz_chunk(t, ch), p, in ? 16 : 0);
    } else {
      unsigned short h[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (int i = 0; i < W - 8 * ch; ++i)
        h[i] = reinterpret_cast<const unsigned short*>(p)[i];
      *reinterpret_cast<uint4*>(gtile + swz_chunk(t, ch)) =
          make_uint4(h[0] | (uint32_t)h[1] << 16, h[2] | (uint32_t)h[3] << 16,
                     h[4] | (uint32_t)h[5] << 16, h[6] | (uint32_t)h[7] << 16);
    }
  }
}

// Eight consecutive values of an f32 or bf16 array (dtype 1) from src[i]
// as f32, those at or past n as zeros: 16-byte loads where vec (the
// caller's alignment) and all eight are in, else one value at a time.
__device__ __forceinline__ void load8(const void* src, int dtype,
                                      long long i, int n, bool vec,
                                      float* v) {
  if (vec && n >= 8) {
    if (dtype) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(src) + i);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[2 * k] = __uint_as_float(w[k] << 16);
        v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      }
    } else {
      const float4* f = reinterpret_cast<const float4*>(
          static_cast<const float*>(src) + i);
      const float4 a = f[0], b = f[1];
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
      v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = k < n ? load(src, dtype, i + k) : 0.f;
  }
}

// ca = cumsum(da) over the chunk in float64 by warp 0 (the forward tensor-
// core kernel's scan): lane l sums t = 4 l .. 4 l + 3 in order, then a
// shuffle scan of the lane totals; positions past T add 0. ca is read
// after a __syncthreads().
__device__ __forceinline__ void warp_cumsum(double* ca, const float* da,
                                            long long base, int stride,
                                            int T) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  double v[4], run = 0.0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = 4 * lane + j;
    run += t < T ? (double)da[base + (long long)t * stride] : 0.0;
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
}

// ddt_t = col_t + e^{ca_T - ca_t} q_t and dca_t = row_t - dt_t col_t +
// e^{ca_t} r_t - dt_t e^{ca_T - ca_t} q_t per position (+ e^{ca_T} <G_{k+1},
// h_k> + sum_s dt_s e^{ca_T - ca_s} q_s at t = T - 1, <G, h> from the
// per-warp parts in red), then dda = the reverse cumulative sum of dca, all
// in float64: the FMA kernel's step 8 with warp 0's scans in place of one
// thread's loops (the carry as lane parts of 4 positions in order and a
// fixed xor tree; dda with lane l taking t = 4 l .. 4 l + 3 from the top,
// then a shuffle scan of the lane totals from lane 31 down). vec indexes
// the chunk's (batch, head) in the [B, S, H] outputs.
template <int kNT>
__device__ __forceinline__ void finish_chunk_warp(
    const double* ca, const double* qd, const double* cold,
    const double* rowd, const double* rd, double* dca, const float* dts,
    const float* ea, const float* wse, const double* red, int T, int t0,
    long long vec, int heads, float* ddt, float* dda) {
  for (int t = threadIdx.x; t < T; t += kNT) {
    const double dtv = dts[t], wv = wse[t];
    ddt[vec + (long long)(t0 + t) * heads] = (float)(cold[t] + wv * qd[t]);
    dca[t] = rowd[t] - dtv * cold[t] + (double)ea[t] * rd[t] -
             dtv * wv * qd[t];
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  double carry = 0.0, gh_dot = 0.0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s = 4 * lane + j;
    if (s < T) carry += (double)dts[s] * wse[s] * qd[s];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    carry += __shfl_xor_sync(0xffffffffu, carry, off);
  for (int i = 0; i < kNT / 32; ++i) gh_dot += red[i];
  double suffix[4], run = 0.0;
#pragma unroll
  for (int j = 3; j >= 0; --j) {
    const int t = 4 * lane + j;
    double v = t < T ? dca[t] : 0.0;
    if (t == T - 1) v += (double)expf((float)ca[T - 1]) * gh_dot + carry;
    run += v;
    suffix[j] = run;
  }
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const double u = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += u;
  }
  double excl = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) excl = 0.0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = 4 * lane + j;
    if (t < T) dda[vec + (long long)(t0 + t) * heads] = (float)(excl + suffix[j]);
  }
}

// Issue-and-wait of one batch of wgmma on accumulators a and b.
template <int N1, int N2>
__device__ __forceinline__ void wg_done(float (&a)[N1], float (&b)[N2]) {
  wg_commit();
  wg_wait_all();
  fence_regs(a);
  fence_regs(b);
}

// Shared memory of scan_bwd_tc_chunks, from a 1024-byte aligned base: the
// bf16 tiles x, B, C ([128 rows][64]), dy's two terms, G_{k+1}'s and h_k's
// two terms ([64 p rows][64 n], all 128-byte swizzled), then ca and the
// float64 per-position sums, dt, e^{ca_t}, e^{ca_T - ca_t}, the per-warp
// slots of <G, h> and the masked decays E[t][s] = e^{ca_t - ca_s} (s <= t
// < T, else 0) in f32 ([128][kLE]).
struct ChunkSmem {
  static constexpr int kX = 0, kB = kTileBytes, kC = 2 * kTileBytes;
  static constexpr int kDy = 3 * kTileBytes;         // hi, mid
  static constexpr int kG = 5 * kTileBytes;          // hi, mid
  static constexpr int kH = kG + 2 * kHalfBytes;     // hi, mid
  static constexpr int kCa = kH + 2 * kHalfBytes;    // ca, q, col, row, r,
  static constexpr int kVec = kCa + 6 * 128 * 8;     // dca; dt, ea, wse
  static constexpr int kRed = kVec + 3 * 128 * 4;
  static constexpr int kE = kRed + 8 * (kChunkThreads / 32);
  static constexpr int kBytes = kE + 128 * kLE * 4;
  static constexpr int kAlloc = kBytes + 1024;       // slack to align
};

// One CTA of two warpgroups per (chunk, head, batch). Warpgroup r owns rows
// 64 r .. 64 r + 63 of the chunk, as positions s in pass A and as
// positions t in pass B, and takes only the causal 32-column blocks:
// t >= 64 r in A (s <= t), s < 64 (r + 1) in B; the two passes balance
// the warpgroups (six blocks each at T = 128).
//
// Accumulator fragments (m64nN) of thread 32 w + lane of a warpgroup: rows
// 16 w + lane / 4 (+ 8 for i = 1), columns 8 j + 2 (lane % 4) + c, held in
// d[4 j + 2 i + c]; they are also the A-fragment layout of a following
// register-A wgmma (k-step kk covers j = 2 kk, 2 kk + 1).
__global__ void __launch_bounds__(kChunkThreads, 1)
scan_bwd_tc_chunks(const __nv_bfloat16* x, const __nv_bfloat16* bm,
                   const __nv_bfloat16* cm, const float* dt,
                   const float* da, const void* dy, const float* dh,
                   const float* dhs, const float* dgs, const float* decays,
                   __nv_bfloat16* dx, float* dbp, float* dcp, float* ddt,
                   float* dda, int dy_dtype, int dy_vec, int state_vec,
                   Dims d, ScanStrides st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gb = smem_raw + (base - raw);  // the same bytes, generic
  const uint32_t sx = base + ChunkSmem::kX, sb = base + ChunkSmem::kB,
                 sc = base + ChunkSmem::kC;
  const uint32_t sdy[2] = {base + ChunkSmem::kDy,
                           base + ChunkSmem::kDy + kTileBytes};
  const uint32_t sg[2] = {base + ChunkSmem::kG,
                          base + ChunkSmem::kG + kHalfBytes};
  const uint32_t sh[2] = {base + ChunkSmem::kH,
                          base + ChunkSmem::kH + kHalfBytes};
  double* ca = reinterpret_cast<double*>(gb + ChunkSmem::kCa);
  double* qd = ca + 128;
  double* cold = qd + 128;
  double* rowd = cold + 128;
  double* rd = rowd + 128;
  double* dca = rd + 128;
  float* dts = reinterpret_cast<float*>(gb + ChunkSmem::kVec);
  float* ea = dts + 128;   // e^{ca_t}
  float* wse = ea + 128;   // e^{ca_T - ca_t}
  double* red = reinterpret_cast<double*>(gb + ChunkSmem::kRed);
  float* etab = reinterpret_cast<float*>(gb + ChunkSmem::kE);

  const int tid = threadIdx.x;
  const int k = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int T = d.chunk, P = d.p, N = d.n, t0 = k * T;
  const long long bh = (long long)bi * d.heads + h;
  const long long per = (long long)P * N;

  // 1. stage the chunk: x, B, C as bf16 tiles (cp.async), dy, G_{k+1} and
  //    h_k as two bf16 terms each; h_k and G_{k+1} from the chunk-local
  //    sums of scan_bwd_tc_states in the order of the FMA state pass
  //    (state <- decay_j state + delta_j, h from chunk 0 up, G from dh
  //    down), <G_{k+1}, h_k> in float64 beside them
  load_tile(sx, gb + ChunkSmem::kX,
            x + (long long)bi * st.x_b + (long long)t0 * st.x_s +
                (long long)h * st.x_h,
            st.x_s, 128, T, P, tid, kChunkThreads);
  load_tile(sb, gb + ChunkSmem::kB,
            bm + (long long)bi * st.b_b + (long long)t0 * st.b_s, st.b_s,
            128, T, N, tid, kChunkThreads);
  load_tile(sc, gb + ChunkSmem::kC,
            cm + (long long)bi * st.c_b + (long long)t0 * st.c_s, st.c_s,
            128, T, N, tid, kChunkThreads);
  {
    const long long at = (long long)bi * st.dy_b + (long long)t0 * st.dy_s +
                         (long long)h * st.dy_h;
    float v[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = tid + r * kChunkThreads, t = e >> 3, ch = e & 7;
      load8(dy, dy_dtype, at + (long long)t * st.dy_s + 8 * ch,
            t < T ? P - 8 * ch : 0, dy_vec, v[r]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = tid + r * kChunkThreads, t = e >> 3, ch = e & 7;
#pragma unroll
      for (int term = 0; term < 2; ++term)
        *reinterpret_cast<uint4*>(gb + ChunkSmem::kDy + term * kTileBytes +
                                  swz_chunk(t, ch)) = split_chunk(v[r], term);
    }
  }
  double part = 0.0;
  {
    const float* dec = decays + bh * d.nchunks;
    const float* hsum = dhs + bh * d.nchunks * per;
    const float* gsum = dgs + bh * d.nchunks * per;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = tid + r * kChunkThreads, p = e >> 3, ch = e & 7;
      const int n_in = p < P ? N - 8 * ch : 0;
      const long long off = (long long)p * N + 8 * ch;
      float g[8], hv[8], delta[8];
      if (dh) {
        load8(dh + bh * per, 0, off, n_in, state_vec, g);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) g[i] = 0.f;
      }
      for (int j = d.nchunks - 1; j > k; --j) {
        load8(gsum + j * per, 0, off, n_in, state_vec, delta);
        const float dj = dec[j];
#pragma unroll
        for (int i = 0; i < 8; ++i) g[i] = dj * g[i] + delta[i];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) hv[i] = 0.f;
      for (int j = 0; j < k; ++j) {
        load8(hsum + j * per, 0, off, n_in, state_vec, delta);
        const float dj = dec[j];
#pragma unroll
        for (int i = 0; i < 8; ++i) hv[i] = dj * hv[i] + delta[i];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) part += (double)g[i] * (double)hv[i];
#pragma unroll
      for (int term = 0; term < 2; ++term) {
        *reinterpret_cast<uint4*>(gb + ChunkSmem::kG + term * kHalfBytes +
                                  swz_chunk(p, ch)) = split_chunk(g, term);
        *reinterpret_cast<uint4*>(gb + ChunkSmem::kH + term * kHalfBytes +
                                  swz_chunk(p, ch)) = split_chunk(hv, term);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (tid % 32 == 0) red[tid / 32] = part;
  for (int t = tid; t < 128; t += kChunkThreads)
    dts[t] = t < T ? dt[(long long)bi * st.dt_b + (long long)(t0 + t) * st.dt_s +
                        (long long)h * st.dt_h]
                   : 0.f;
  warp_cumsum(ca, da,
              (long long)bi * st.da_b + (long long)t0 * st.da_s +
                  (long long)h * st.da_h,
              st.da_s, T);
  __syncthreads();
  const double ca_last = ca[T - 1];
  for (int t = tid; t < 128; t += kChunkThreads) {
    ea[t] = t < T ? expf((float)ca[t]) : 0.f;
    wse[t] = t < T ? expf((float)(ca_last - ca[t])) : 0.f;
  }
  // each decay once for both passes (a float64 difference, rounded to f32
  // for expf), zero off the causal chunk, so the masks need no branch
  for (int e = tid; e < 128 * 128; e += kChunkThreads) {
    const int t = e >> 7, s = e & 127;
    etab[t * kLE + s] =
        (s <= t && t < T) ? expf((float)(ca[t] - ca[s])) : 0.f;
  }
  cp_async_wait_all();
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const int wg = warpgroup(), me = tid % 128;
  const int row = 16 * (me / 32) + (me % 32) / 4;  // rows row, row + 8
  const int col = 2 * (me % 4);                    // columns col, col + 1
  const int r0 = 64 * wg;                          // this warpgroup's rows
  const bool live = r0 < T;

  // 2. pass A, rows s: dx_s = dt_s (e^{ca_T - ca_s} (B G^T)_s +
  //    sum_t SE^T_st dy_t), dB_s (this head) = dt_s e^{ca_T - ca_s} (x G)_s
  //    + sum_t K^T_st C_t; q_s = x_s . (B G^T)_s and col_s = sum_t SE_ts
  //    (dy_t . x_s) in float64
  if (live) {
    float adx[32], adb[32];
    fence_regs(adx);
    fence_regs(adb);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        wgmma_qk(adx, kmajor(sb + r0 * kRowBytes, kk), kmajor(sg[e], kk),
                 kk > 0 || e > 0);
        wgmma_ss_mn(adb, kmajor(sx + r0 * kRowBytes, kk), mnmajor(sg[e], kk),
                    kk > 0 || e > 0);
      }
    wg_done(adx, adb);
    double q[2], cl[2] = {0.0, 0.0};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = r0 + row + 8 * i;
      q[i] = 0.0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x0, x1;
        bf16_pair(sx, s, 8 * j + col, x0, x1);
        q[i] += (double)x0 * (double)adx[4 * j + 2 * i] +
                (double)x1 * (double)adx[4 * j + 2 * i + 1];
      }
      const float w = wse[s], dw = dts[s] * wse[s];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          adx[4 * j + 2 * i + c] *= w;
          adb[4 * j + 2 * i + c] *= dw;
        }
    }
    for (int tq = 2 * wg; 32 * tq < T; ++tq) {  // columns t = 32 tq ..
      // S^T = B C^T and D^T = x dy^T on this block, both K-major
      float sacc[16], dacc[16];
      fence_regs(sacc);
      fence_regs(dacc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_qk32(sacc, kmajor(sb + r0 * kRowBytes, kk),
                   kmajor(sc + 32 * tq * kRowBytes, kk), kk > 0);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          wgmma_qk32(dacc, kmajor(sx + r0 * kRowBytes, kk),
                     kmajor(sdy[e] + 32 * tq * kRowBytes, kk),
                     kk > 0 || e > 0);
      }
      wg_done(sacc, dacc);
      // SE^T = S^T E and K^T = D^T E dt_s (zero off s <= t < T); col_s
      // sums the f32 products SE^T D^T in float64
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int s = r0 + row + 8 * i;
        const float dt_s = dts[s];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int t = 32 * tq + 8 * j + col + c, at = 4 * j + 2 * i + c;
            const float ex = etab[t * kLE + s];
            const float se = sacc[at] * ex;
            cl[i] += (double)(se * dacc[at]);
            sacc[at] = se;
            dacc[at] = dacc[at] * ex * dt_s;
          }
      }
      // their two terms as register A operands (K = t) against dy's terms
      // (hi hi, hi mid, mid hi) and C, both MN-major
      uint32_t sa[2][2][4], ka[2][2][4];
#pragma unroll
      for (int qq = 0; qq < 8; ++qq) {
        uint32_t t2[2];
        split2(sacc[2 * qq], sacc[2 * qq + 1], t2);
        sa[qq / 4][0][qq % 4] = t2[0];
        sa[qq / 4][1][qq % 4] = t2[1];
        split2(dacc[2 * qq], dacc[2 * qq + 1], t2);
        ka[qq / 4][0][qq % 4] = t2[0];
        ka[qq / 4][1][qq % 4] = t2[1];
      }
      fence_regs(adx);
      fence_regs(adb);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {  // rows past T are zero
        const int ks = 2 * tq + kk;
        wgmma_pv<64>(adx, sa[kk][0], mnmajor(sdy[0], ks));
        wgmma_pv<64>(adx, sa[kk][0], mnmajor(sdy[1], ks));
        wgmma_pv<64>(adx, sa[kk][1], mnmajor(sdy[0], ks));
        wgmma_pv<64>(adb, ka[kk][0], mnmajor(sc, ks));
        wgmma_pv<64>(adb, ka[kk][1], mnmajor(sc, ks));
      }
      wg_done(adx, adb);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = r0 + row + 8 * i;
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        q[i] += __shfl_xor_sync(0xffffffffu, q[i], off);
        cl[i] += __shfl_xor_sync(0xffffffffu, cl[i], off);
      }
      if (col == 0) {
        qd[s] = q[i];
        cold[s] = cl[i];
      }
      if (s >= T) continue;
      const float dt_s = dts[s];
      __nv_bfloat16* dxs =
          dx + (((long long)bi * d.seqlen + t0 + s) * d.heads + h) * P;
      float* dbs = dbp + (bh * d.seqlen + t0 + s) * N;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * j + col;  // and n for dB
        const float v0 = dt_s * adx[4 * j + 2 * i],
                    v1 = dt_s * adx[4 * j + 2 * i + 1];
        if (p + 1 < P && (P & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dxs + p) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (p < P) dxs[p] = __float2bfloat16_rn(v0);
          if (p + 1 < P) dxs[p + 1] = __float2bfloat16_rn(v1);
        }
        if (p < N) dbs[p] = adb[4 * j + 2 * i];
        if (p + 1 < N) dbs[p + 1] = adb[4 * j + 2 * i + 1];
      }
    }
  }

  // 3. pass B, rows t: dC_t (this head) = e^{ca_t} (dy_t h_k) + sum_s K_ts
  //    B_s; r_t = C_t . (dy_t h_k) and row_t = sum_s K_ts (C_t . B_s) in
  //    float64
  if (live) {
    float adc[32];
    fence_regs(adc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // dy h: hi hi, hi mid, mid hi
      wgmma_ss_mn(adc, kmajor(sdy[0] + r0 * kRowBytes, kk),
                  mnmajor(sh[0], kk), kk > 0);
      wgmma_ss_mn(adc, kmajor(sdy[0] + r0 * kRowBytes, kk),
                  mnmajor(sh[1], kk), 1);
      wgmma_ss_mn(adc, kmajor(sdy[1] + r0 * kRowBytes, kk),
                  mnmajor(sh[0], kk), 1);
    }
    wg_done(adc, adc);
    double rr[2], rw[2] = {0.0, 0.0};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = r0 + row + 8 * i;
      rr[i] = 0.0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float c0, c1;
        bf16_pair(sc, t, 8 * j + col, c0, c1);
        rr[i] += (double)c0 * (double)adc[4 * j + 2 * i] +
                 (double)c1 * (double)adc[4 * j + 2 * i + 1];
      }
      const float e = ea[t];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) adc[4 * j + 2 * i + c] *= e;
    }
    for (int sq = 0; sq < 2 * wg + 2 && 32 * sq < T; ++sq) {  // s = 32 sq ..
      // S = C B^T and D = dy x^T on this block, both K-major
      float sacc[16], dacc[16];
      fence_regs(sacc);
      fence_regs(dacc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_qk32(sacc, kmajor(sc + r0 * kRowBytes, kk),
                   kmajor(sb + 32 * sq * kRowBytes, kk), kk > 0);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          wgmma_qk32(dacc, kmajor(sdy[e] + r0 * kRowBytes, kk),
                     kmajor(sx + 32 * sq * kRowBytes, kk), kk > 0 || e > 0);
      }
      wg_done(sacc, dacc);
      // K = D E dt_s (zero off s <= t < T); row_t sums the f32 products
      // S K in float64
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = r0 + row + 8 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int s = 32 * sq + 8 * j + col + c, at = 4 * j + 2 * i + c;
            const float kv = dacc[at] * etab[t * kLE + s] * dts[s];
            rw[i] += (double)(sacc[at] * kv);
            dacc[at] = kv;
          }
      }
      uint32_t ka[2][2][4];
#pragma unroll
      for (int qq = 0; qq < 8; ++qq) {
        uint32_t t2[2];
        split2(dacc[2 * qq], dacc[2 * qq + 1], t2);
        ka[qq / 4][0][qq % 4] = t2[0];
        ka[qq / 4][1][qq % 4] = t2[1];
      }
      fence_regs(adc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {  // rows past T are zero
        wgmma_pv<64>(adc, ka[kk][0], mnmajor(sb, 2 * sq + kk));
        wgmma_pv<64>(adc, ka[kk][1], mnmajor(sb, 2 * sq + kk));
      }
      wg_done(adc, adc);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = r0 + row + 8 * i;
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        rr[i] += __shfl_xor_sync(0xffffffffu, rr[i], off);
        rw[i] += __shfl_xor_sync(0xffffffffu, rw[i], off);
      }
      if (col == 0) {
        rd[t] = rr[i];
        rowd[t] = rw[i];
      }
      if (t >= T) continue;
      float* dcs = dcp + (bh * d.seqlen + t0 + t) * N;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * j + col;
        if (n < N) dcs[n] = adc[4 * j + 2 * i];
        if (n + 1 < N) dcs[n + 1] = adc[4 * j + 2 * i + 1];
      }
    }
  }
  __syncthreads();

  // 4. ddt and dca per position, then dda = the reverse cumulative sum of
  //    dca, all in float64 (the FMA kernel's step 8, by warp scans)
  finish_chunk_warp<kChunkThreads>(ca, qd, cold, rowd, rd, dca, dts, ea, wse,
                                   red, T, t0,
                                   (long long)bi * d.seqlen * d.heads + h,
                                   d.heads, ddt, dda);
}

// Shared memory of scan_bwd_tc_states, from a 1024-byte aligned base: the
// bf16 tile v ([128 rows][64], 128-byte swizzled), u in f32 ([128][kLU]),
// ca in float64 and the weights w in f32.
struct StateSmem {
  static constexpr int kU = kTileBytes;
  static constexpr int kCa = kU + 128 * kLU * 4;
  static constexpr int kW = kCa + 128 * 8;
  static constexpr int kBytes = kW + 128 * 4;
  static constexpr int kAlloc = kBytes + 1024;
};

// One warpgroup per (chunk, direction, head, batch): the chunk-local sum
// delta[p][n] = sum_t (w_t u[t][p]) v[t][n] of the FMA state pass's carry,
// with (u, v, w) = (x, B, e^{ca_T - ca_t} dt_t) (direction 0, into dhs) or
// (dy, C, e^{ca_t}) (direction 1, into dgs), f32 [B, H, chunks, P, N]; the
// direction-0 CTA also writes the chunk's decay e^{ca_T} (f32 [B, H,
// chunks]). scan_bwd_tc_chunks folds them into h_k and G_{k+1} in the FMA
// pass's order, so every chunk runs in parallel here. The f32 factor
// w_t u[t][p] is two bf16 register A operands (M = p, K = t), v MN-major
// from shared memory.
__global__ void __launch_bounds__(kStateThreads)
scan_bwd_tc_states(const __nv_bfloat16* x, const __nv_bfloat16* bm,
                   const __nv_bfloat16* cm, const float* dt,
                   const float* da, const void* dy, float* dhs, float* dgs,
                   float* decays, int dy_dtype, int dy_vec, Dims d,
                   ScanStrides st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gb = smem_raw + (base - raw);
  float* u = reinterpret_cast<float*>(gb + StateSmem::kU);
  double* ca = reinterpret_cast<double*>(gb + StateSmem::kCa);
  float* w = reinterpret_cast<float*>(gb + StateSmem::kW);
  const int tid = threadIdx.x;
  const int row = 16 * (tid / 32) + (tid % 32) / 4, col = 2 * (tid % 4);
  const int k = blockIdx.x >> 1, reverse = blockIdx.x & 1;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int T = d.chunk, P = d.p, N = d.n, t0 = k * T;
  const long long bh = (long long)bi * d.heads + h;

  // v by cp.async; u staged in f32 (all of a thread's loads in flight)
  const void* usrc;
  int udtype;
  bool uvec;
  long long ubase, ustride;
  if (reverse) {
    load_tile(base, gb, cm + (long long)bi * st.c_b + (long long)t0 * st.c_s,
              st.c_s, 128, T, N, tid, kStateThreads);
    usrc = dy, udtype = dy_dtype, uvec = dy_vec;
    ubase = (long long)bi * st.dy_b + (long long)t0 * st.dy_s +
            (long long)h * st.dy_h;
    ustride = st.dy_s;
  } else {
    load_tile(base, gb, bm + (long long)bi * st.b_b + (long long)t0 * st.b_s,
              st.b_s, 128, T, N, tid, kStateThreads);
    usrc = x, udtype = 1, uvec = true;
    ubase = (long long)bi * st.x_b + (long long)t0 * st.x_s +
            (long long)h * st.x_h;
    ustride = st.x_s;
  }
  {
    float v[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int e = tid + r * kStateThreads, t = e >> 3, ch = e & 7;
      load8(usrc, udtype, ubase + (long long)t * ustride + 8 * ch,
            t < T ? P - 8 * ch : 0, uvec, v[r]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int e = tid + r * kStateThreads, t = e >> 3, ch = e & 7;
      float4* o = reinterpret_cast<float4*>(u + t * kLU + 8 * ch);
      o[0] = make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
      o[1] = make_float4(v[r][4], v[r][5], v[r][6], v[r][7]);
    }
  }
  warp_cumsum(ca, da,
              (long long)bi * st.da_b + (long long)t0 * st.da_s +
                  (long long)h * st.da_h,
              st.da_s, T);
  __syncthreads();
  const double ca_last = ca[T - 1];
  for (int t = tid; t < 128; t += kStateThreads)
    w[t] = t >= T ? 0.f
           : reverse
               ? expf((float)ca[t])
               : expf((float)(ca_last - ca[t])) *
                     dt[(long long)bi * st.dt_b +
                        (long long)(t0 + t) * st.dt_s +
                        (long long)h * st.dt_h];
  if (!reverse && tid == 0)
    decays[bh * d.nchunks + k] = expf((float)ca_last);
  cp_async_wait_all();
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  // delta = sum over the eight k-steps of 16 positions (rows past T are
  // zero; a branch between the wgmma would serialise them, C7520), all
  // issued before one wait
  uint32_t a[8][2][4];
#pragma unroll
  for (int kq = 0; kq < 8; ++kq)
#pragma unroll
    for (int slot = 0; slot < 4; ++slot) {
      const int p = row + 8 * (slot & 1);
      const int t = 16 * kq + col + 8 * (slot >> 1);
      uint32_t t2[2];
      split2(w[t] * u[t * kLU + p], w[t + 1] * u[(t + 1) * kLU + p], t2);
      a[kq][0][slot] = t2[0];
      a[kq][1][slot] = t2[1];
    }
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  fence_regs(acc);
  wg_fence();
#pragma unroll
  for (int kq = 0; kq < 8; ++kq) {
    wgmma_pv<64>(acc, a[kq][0], mnmajor(base, kq));
    wgmma_pv<64>(acc, a[kq][1], mnmajor(base, kq));
  }
  wg_commit();
  wg_wait_all();
  fence_regs(acc);
  float* o = (reverse ? dgs : dhs) + (bh * d.nchunks + k) * P * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int p = row + 8 * i, n = 8 * j + col + c;
        if (p < P && n < N) o[p * N + n] = acc[4 * j + 2 * i + c];
      }
}

int launch(const void* x, const void* b, const void* c, const float* dt,
           const float* da, const void* dy, const float* dh, void* dx,
           void* db, void* dc, float* ddt, float* dda, float* dhs,
           float* dgs, float* dbp, float* dcp, float* decays, int dy_dtype,
           const Dims& d, const ScanStrides& st, cudaStream_t s) {
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        scan_bwd_tc_states, cudaFuncAttributeMaxDynamicSharedMemorySize,
        StateSmem::kAlloc);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(scan_bwd_tc_chunks,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 ChunkSmem::kAlloc);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  // 16-byte loads of dy where its base and strides allow them, of dh and
  // the chunk sums where N is a multiple of 4 (and dh is aligned)
  const int step = dy_dtype ? 8 : 4;
  const int dy_vec = reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                     st.dy_b % step == 0 && st.dy_s % step == 0 &&
                     st.dy_h % step == 0;
  const int state_vec =
      d.n % 4 == 0 && (dh == nullptr || reinterpret_cast<uintptr_t>(dh) % 16 == 0);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* bb = static_cast<const __nv_bfloat16*>(b);
  const __nv_bfloat16* cb = static_cast<const __nv_bfloat16*>(c);
  scan_bwd_tc_states<<<dim3(2 * d.nchunks, d.heads, d.batch), kStateThreads,
                       StateSmem::kAlloc, s>>>(xb, bb, cb, dt, da, dy, dhs,
                                               dgs, decays, dy_dtype, dy_vec,
                                               d, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_bwd_tc_chunks<<<dim3(d.nchunks, d.heads, d.batch), kChunkThreads,
                       ChunkSmem::kAlloc, s>>>(
      xb, bb, cb, dt, da, dy, dh, dhs, dgs, decays,
      static_cast<__nv_bfloat16*>(dx), dbp, dcp, ddt, dda, dy_dtype, dy_vec,
      state_vec, d, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = 2LL * d.batch * d.seqlen * d.n;
  scan_bwd_reduce<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads,
                    0, s>>>(dbp, dcp, db, dc, 1, d);
  return (int)cudaGetLastError();
}

}  // namespace tc

long long scratch_floats(const Dims& d) {
  const long long bh = (long long)d.batch * d.heads;
  return 2 * bh * d.nchunks * d.p * d.n + 2 * bh * d.seqlen * d.n +
         bh * d.nchunks;
}

}  // namespace

extern "C" {

// Bytes of float32 scratch the backward needs: h_k and G_{k+1} (f32) or
// their chunk-local sums (bf16) [B, H, chunks, P, N] each, the per-head dB
// and dC partials [B, H, S, N] each, and the chunks' decays [B, H, chunks]
// (bf16).
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
// p <= 64, n <= 64. bf16 (the tensor-core kernels) also needs 16-byte
// aligned x, b, c base addresses and their strides in multiples of 8
// elements (the wrapper checks it). Returns cudaGetLastError() after the
// last launch.
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
      dy_dtype < 0 || dy_dtype > in_dtype)
    return (int)cudaErrorInvalidValue;
  const Dims d{batch, seqlen, heads, p, n, chunk, seqlen / chunk};
  const ScanStrides st{x_sb,  x_ss,  x_sh,  b_sb,  b_ss,  c_sb,
                       c_ss,  dt_sb, dt_ss, dt_sh, da_sb, da_ss,
                       da_sh, dy_sb, dy_ss, dy_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* daf = static_cast<const float*>(da);
  const long long bh = (long long)batch * heads;
  float* hs = static_cast<float*>(scratch);
  float* gs = hs + bh * d.nchunks * p * n;
  float* dbp = gs + bh * d.nchunks * p * n;
  float* dcp = dbp + bh * seqlen * n;
  if (in_dtype == 1)
    return tc::launch(x, b, c, dtf, daf, dy, static_cast<const float*>(dh),
                      dx, db, dc, static_cast<float*>(ddt),
                      static_cast<float*>(dda), hs, gs, dbp, dcp,
                      dcp + bh * seqlen * n, dy_dtype, d, st, s);

  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_states, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kStatesSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(scan_bwd_chunks,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)ChunkSmem::kBytes);
  if (err != cudaSuccess) return (int)err;

  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  const float* dyf = static_cast<const float*>(dy);
  scan_bwd_states<<<dim3(heads, batch, 2), kThreads, kStatesSmem, s>>>(
      xf, bf, cf, dtf, daf, dyf, static_cast<const float*>(dh), hs, gs, d,
      st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_bwd_chunks<<<dim3(d.nchunks, heads, batch), kThreads,
                    ChunkSmem::kBytes, s>>>(
      xf, bf, cf, dtf, daf, dyf, hs, gs, static_cast<float*>(dx), dbp, dcp,
      static_cast<float*>(ddt), static_cast<float*>(dda), d, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = 2LL * batch * seqlen * n;
  scan_bwd_reduce<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads,
                    0, s>>>(dbp, dcp, db, dc, 0, d);
  return (int)cudaGetLastError();
}

const char* mamba_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
