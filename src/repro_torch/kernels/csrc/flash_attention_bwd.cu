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
// What bounds it on the H100: at qwen3-8b's train shape ([4, 32, 512,
// 128], 8 KV heads, causal) the least time is 0.025 ms of memory traffic
// (q, k, v, o, dO read once; dq, dk, dv written once), with the five
// products the math needs (2.1e10 FLOP, 0.0217 ms at the bf16 tensor-core
// peak) close behind; the design below does seven (S and dP are formed in
// both the dq and the dk/dv kernel), so the products are its limit.
//
// Two routes, chosen by dtype; neither is a fallback for the other.
//
// bf16: three launches, no atomics, every sum in a fixed order.
// (0) flash_bwd_prep: L = lse log2(e) from the forward's logsumexp (the
//     forward writes it when asked) and D_row = rowsum(dO o o), per row in
//     [B, Hq, Sq rounded up to 64] f32 scratch, padded rows L = +inf and
//     D_row = 0 so that a tile past Sq contributes nothing. This replaces
//     the sweep that recomputed the logsumexp.
// (1) flash_bwd_dq_tc: the forward's structure (persistent grid, one CTA
//     an SM, a producer warp issuing TMA copies, two consumer warpgroups
//     of 64 q rows sharing each K/V tile). Per visible 64-key tile S = Q
//     K^T and dP = dO V^T with wgmma (all operands K-major in
//     128-byte-swizzled shared memory), P = 2^(S c - L) and dS = P (dP -
//     D_row) in f32 registers, dQ += dS K with dS in bf16 as the register A
//     operand and K read MN-major, as the forward feeds P and V.
// (2) flash_bwd_dkdv_tc: one 64-key tile of one KV head an item; its work
//     is the (q head of the GQA group, q tile that sees the keys) pairs,
//     heads outer, each pair's Q and dO tiles and its L and D_row vectors
//     arriving through a TMA ring. The two consumer warpgroups split the
//     work by output: warpgroup 0 forms S^T = K Q^T, P^T and dV += P^T dO;
//     warpgroup 1 forms dP^T = V dO^T, takes P^T in f32 from warpgroup 0
//     through a double-buffered shared-memory tile (an mbarrier each way),
//     forms dS^T and dK += dS^T Q. P^T and dS^T go to the products in bf16
//     from registers, dO and Q read MN-major. Each warpgroup stages its sum
//     in the tile of the item's K/V buffer that only it reads and stores it
//     with TMA.
// At D 64 (whisper-tiny) a warpgroup can hold dK and dV of its own keys
// beside S^T and dP^T, so rows that see every key (no causal limit, no
// window) go to flash_bwd_dkdv64_tc instead of (2): 128-key items, a
// 64-key tile a warpgroup, no P^T tile, the two warpgroups taking turns
// to issue their products; and where it fills the card better the dq
// kernel splits a row block's key tiles between its two warpgroups and
// adds the two dQ parts in a fixed order. Causal rows keep (2)'s 64-key
// items split by output, which balance the triangle better. At D 128 rows
// that see every key (the VLM's cross-attention) go to
// flash_bwd_dkdv128_tc and flash_bwd_dq128_tc, in that order, dq as a
// programmatic dependent launch that fills the SMs dk/dv's last round
// leaves idle (their notes below); causal and windowed D 128 rows keep
// (1) and (2).
// Rounding P and dS to bf16 before the products is this route's departure
// from the plain version, as the forward's bf16 P is; it stays within the
// bf16 tolerance (tests/test_torch_kernels.py emulates the arithmetic on
// the CPU at the train shapes; chip_smoke.py prints each case's share).
//
// Where the trouble was, and what the design does about it:
// * Registers. ptxas grants each of these 288-thread kernels' threads 168
//   registers (a first build asked for 224 and got 168). A warpgroup that
//   held both dK and dV (64 + 64 f32 a thread at D 128) with S^T and dP^T
//   (32 + 32) spilled 1 KB even with S^T and dP^T in two groups of 32
//   columns; hence the split by output above (each warpgroup 64 + 32 + 16,
//   163 registers at D 128, no spill). In dq, dQ (64) with S and dP of 64
//   keys spilled too, so at D > 64 S and dP are formed in two groups of 32
//   keys, each group's dQ product issued before the next group, and the
//   rows' L and D_row come with the Q tile into shared memory and are read
//   where they are used (held across the tile loop they spilled; reread
//   from global memory before the products, more so). Score accumulators are zeroed before each group
//   (its first k-step overwrites them) so no stale tile stays live across
//   the products, and the tiles' shared-memory addresses are made opaque
//   where a product is issued, so the descriptors of every k-step are not
//   hoisted into registers. The D 128 kernels for rows that see every key
//   lift the cap: dq with setmaxnreg and a producer warpgroup (a whole
//   warpgroup: the K3 kernel's hang came with a lone producer warp),
//   dk/dv with no producer warp at all.
//   chip_smoke.py prints the ptxas lines and fails on a spill.
// * ptxas C7513 (every wgmma serialised) came from a software pipeline of
//   the products in the forward; here each wgmma group is retired
//   (wait_group 0) before any of its registers is read.
// * Causal imbalance in dk/dv: key tile 0 sees every q tile, the last
//   tile one. The grid is persistent, items longest first, taken forwards
//   in even rounds and backwards in odd ones, as the forward's. Which CTA
//   takes an item does not change its arithmetic, so reruns are bitwise
//   identical.
// * Masks are applied only on tiles that cross the diagonal, the window's
//   edge, Skv or Sq.
//
// f32: the FMA kernels, which the reduced card-vs-CPU checks need for their
// full-f32 products (as the forward's f32 kernel):
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
// of each accumulator.
//
// Both routes read every operand through its (batch, seq, head) strides
// with a contiguous head dim, so the model's [B, S, H, D] views go in
// without copies, and write dq, dk, dv through the strides given.

#include <math.h>

#include "hopper_tc.cuh"  // TMA, mbarrier and wgmma helpers

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;             // q rows and k rows of a tile
constexpr int kPad = kTile + 1;       // padded row of a score tile
constexpr float kNegInf = -INFINITY;

__device__ __forceinline__ float to_float(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
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

int launch_f32(int d, const void* q, const void* k, const void* v,
               const void* o, const void* dout, void* dq, void* dk, void* dv,
               float* lse, float* drow, int b, const Shape& sh,
               const Bsh* st, cudaStream_t stream) {
  using T = float;
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

// ------------------------------------------- bf16: tensor-core kernels

namespace tc {

constexpr int kConsumers = 2;                    // consumer warpgroups
constexpr int kThreads = 128 * kConsumers + 32;  // and one producer warp
constexpr int kRows = 64;       // rows of a tile: q rows (dq), keys (dk/dv)
constexpr int kCols = 64;       // keys of a dq tile, q rows of a dk/dv tile
constexpr float kMasked = -1e30f;                // a masked raw score
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tiles {
  static constexpr int kBoxes = D > 64 ? 2 : 1;     // 64-column boxes
  static constexpr int kDP = kBox * kBoxes;         // D padded to the boxes
  static constexpr int kAcc = kDP / 2;              // floats per thread
  static constexpr int kTile = kBoxes * kBoxBytes;  // 64 rows of an operand
};

// The problem. sq_pad is the row stride of the prep kernel's L and D_row
// (sq rounded up to 64 rows).
struct Shape {
  int sq, skv, hq, hkv, batch, group, causal, window, sq_pad;
  int pair_heads;  // dq: consumers take heads 2p, 2p + 1 (1) or rows (0)
  int n_t, n_items;  // dq: q spans; dk/dv: key tiles; and the items
};

// Named barriers (0 is __syncthreads).
constexpr int kBarWg = 1;      // + wg: one consumer warpgroup
constexpr int kBarTurn = 3;    // + wg: this warpgroup may issue products
constexpr int kBarMerge = 5;   // dq, split item: warpgroup 1's dQ is staged
constexpr int kBarFree = 6;    // dq, split item: warpgroup 0 has read it

// ------------------------------------------------------------- prep

// L = lse log2(e) and D_row = rowsum(dO o o) of each (batch, head, row) in
// [B, Hq, sq_pad] f32 arrays; rows sq..sq_pad - 1 get L = +inf and D_row =
// 0, so a tile past sq contributes nothing. 16 lanes a row, one 16-byte
// chunk of o and dO each, summed by a fixed shuffle tree.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep(const __nv_bfloat16* __restrict__ o,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ lrow,
               float* __restrict__ drow, Shape sh, Strides so,
               Strides sdo) {
  constexpr int kLanes = 16, kChunks = D / 8;
  const int r = blockIdx.x * (256 / kLanes) + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int n_rows = sh.batch * sh.hq * sh.sq_pad;
  const int i = r % sh.sq_pad, bh = r / sh.sq_pad;
  const bool live = r < n_rows && i < sh.sq;
  float acc = 0.f;
  if (live && lane < kChunks) {
    const int b = bh / sh.hq, h = bh % sh.hq;
    const uint4 a = *reinterpret_cast<const uint4*>(
        o + (long long)b * so.b + (long long)i * so.s +
        (long long)h * so.h + 8 * lane);
    const uint4 c = *reinterpret_cast<const uint4*>(
        dout + (long long)b * sdo.b + (long long)i * sdo.s +
        (long long)h * sdo.h + 8 * lane);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fa = __bfloat1622float2(a2[e]);
      const float2 fc = __bfloat1622float2(c2[e]);
      acc = fmaf(fa.x, fc.x, acc);
      acc = fmaf(fa.y, fc.y, acc);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < n_rows && lane == 0) {
    drow[r] = acc;
    lrow[r] = live ? lse[(long long)bh * sh.sq + i] * kLog2e : INFINITY;
  }
}

// Score accumulators are zeroed before their group (its first k-step
// overwrites them anyway), so the previous tile's values are dead and hold
// no registers across the products that follow.
template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// Makes shared-memory addresses opaque where a product is issued, so the
// compiler forms its descriptors there and does not hoist the descriptors
// of every k-step of a loop-invariant tile into registers held across the
// loop (they cost more registers than the kernels have).
__device__ __forceinline__ void opaque(uint32_t& a, uint32_t& b) {
  asm volatile("" : "+r"(a), "+r"(b));
}

// S (+)= A B^T over D / 16 k-steps of 32 bytes along the swizzled rows of
// two K-major 64-row tiles, into a 64 x 64 accumulator (no commit).
template <int D>
__device__ __forceinline__ void mma_abt(float (&s)[32], uint32_t a,
                                        uint32_t b) {
  opaque(a, b);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_qk(s, sw128_desc(a + off, 16, kAtomBytes),
             sw128_desc(b + off, 16, kAtomBytes), kk > 0);
  }
}

// The same into a 64 x 32 accumulator: B's rows 32 h .. 32 h + 31.
template <int D>
__device__ __forceinline__ void mma_abt32(float (&s)[16], uint32_t a,
                                          uint32_t b, int h) {
  opaque(a, b);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_qk32(s, sw128_desc(a + off, 16, kAtomBytes),
               sw128_desc(b + off + h * 32 * kRowBytes, 16, kAtomBytes),
               kk > 0);
  }
}

// O += P B over K rows of B (16 a k-step, two swizzle atoms), P the bf16
// A fragments in pa (k-step kk in pa[4 kk .. 4 kk + 3]), B MN-major; the
// second 64-column box of B is the leading-dimension step (no commit).
template <int DP, int K = kCols>
__device__ __forceinline__ void mma_pb(float (&acc)[DP / 2],
                                       const uint32_t (&pa)[K / 4],
                                       uint32_t b) {
  uint32_t unused = 0;
  opaque(b, unused);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_pv<DP>(acc, pa + 4 * kk,
                 sw128_desc(b + kk * 2 * kAtomBytes, kBoxBytes, kAtomBytes));
}

// bf16 A fragments of an accumulator of N / 2 columns: k-step kk takes
// columns 16 kk .. 16 kk + 15 (j = 2 kk, 2 kk + 1).
template <int N>
__device__ __forceinline__ void pack_frags(const float (&x)[N],
                                           uint32_t (&out)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    out[4 * kk + 0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    out[4 * kk + 1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    out[4 * kk + 2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    out[4 * kk + 3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// An accumulator (times ``scale``) in bf16 into a 64-row tile in the TMA
// box layout with the 128-byte swizzle: 16-byte chunk k of row r at chunk
// k ^ (r % 8), so a warp's stores hit 32 distinct banks.
template <int DP>
__device__ __forceinline__ void stage_bf16(const float (&acc)[DP / 2],
                                           uint32_t tile, float scale,
                                           int row, int col) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const uint32_t at = tile + (j / 8) * kBoxBytes + rr * kRowBytes +
                          (((j % 8) ^ (rr % 8)) * 16) + col * 2;
      const uint32_t v = pack_bf16(acc[4 * j + 2 * r] * scale,
                                   acc[4 * j + 2 * r + 1] * scale);
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(at), "r"(v) : "memory");
    }
  }
}

// ------------------------------------------------------------- dq

template <int D>
struct DqCfg : Tiles<D> {
  using T = Tiles<D>;
  static constexpr int kStages = D > 64 ? 2 : 4;  // K/V ring depth
  // S and dP in two groups of 32 keys at D > 64: with the 64 floats of dQ
  // a thread, 64 + 64 would spill under the 168 registers ptxas grants
  // each of the 288 threads
  static constexpr int kSplit = D > 64 ? 2 : 1;
  static constexpr int kVec = 2 * kRows * 4;  // a consumer's L and D_row
  // Q and dO [2 buffers][kConsumers], then K and V [kStages], then the
  // L and D_row vectors [2 buffers][kConsumers]
  static constexpr int kTiles = 4 * kConsumers + 2 * kStages;
  // a full and an empty barrier for each Q/dO buffer and each stage
  static constexpr int kBars = 2 * (2 + kStages);
  // D 64: warpgroup 1's dQ of a split item, 32 floats a thread
  static constexpr int kMerge = D == 64 ? 32 * 128 * 4 : 0;
  static constexpr int kSmem = 1024 + T::kTile * kTiles +
                               2 * kConsumers * kVec + 8 * kBars + kMerge;
};

// An item of the dq kernel, as the forward's: each consumer warpgroup c
// takes 64 q rows of one head that read the same KV head (the same rows of
// q heads 2p and 2p + 1 when the GQA group is even, else rows q0 and
// q0 + 64 of one head); the longest causal rows first. A split item (D 64)
// is 64 rows of one head whose key tiles the two warpgroups share out.
struct DqItem {
  int q0, h, b, span;
  int kv_lo, n;  // first key and 64-key tiles any row may see
};

template <bool kKeySplit>
__device__ __forceinline__ DqItem dq_item(int w, const Shape& sh) {
  const int heads = sh.pair_heads ? sh.hq / 2 : sh.hq;
  const int per = heads * sh.batch;
  DqItem it;
  it.span = sh.pair_heads || kKeySplit ? kRows : kRows * kConsumers;
  it.q0 = (sh.n_t - 1 - w / per) * it.span;
  it.h = ((w % per) % heads) * (sh.pair_heads ? 2 : 1);
  it.b = (w % per) / heads;
  const int kv_hi = sh.causal ? min(sh.skv, it.q0 + it.span) : sh.skv;
  const int lo = sh.window > 0 ? max(0, it.q0 - sh.window + 1) : 0;
  it.kv_lo = (lo / kCols) * kCols;
  it.n = kv_hi > it.kv_lo ? (kv_hi - it.kv_lo + kCols - 1) / kCols : 0;
  return it;
}

// dq = scale dS K for 64-row q tiles. Warp-specialised like the forward:
// a producer warp issues every TMA copy (each consumer's Q and dO tiles and
// its rows' L and D_row, double-buffered across items; K and V through a
// ring of kStages), two consumer warpgroups share each K/V tile. For each visible key tile, in
// kSplit groups of keys: S = Q K^T and dP = dO V^T (wgmma, one group,
// retired before any read), P = 2^(S c - L) and dS = P (dP - D_row) in f32
// registers, dS rounded to bf16 as the register A operand of dQ += dS K
// (K read MN-major).
//
// kKeySplit (D 64, rows that see every key): an item is 64 rows of one
// head, warpgroup c takes its key tiles t with t % 2 == c, and warpgroup 1
// hands its dQ to warpgroup 0 through shared memory, which adds it to its
// own (dQ_even + dQ_odd) before the epilogue.
//
// Accumulator fragments of thread t = 32 w + lane of a warpgroup: rows
// 16 w + lane / 4 (+ 8 for i = 1) of its 64, columns 8 j + 2 (lane % 4) + c,
// held in d[4 j + 2 i + c].
template <int D, bool kKeySplit = false>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tdq, Shape sh, Perm pq,
                Perm pk, Perm pv, Perm pdo, Perm pdq,
                const float* __restrict__ lrow,
                const float* __restrict__ drow, float scale_log2,
                float scale) {
  using C = DqCfg<D>;
  constexpr int kTile = C::kTile, kStages = C::kStages;
  // S and dP in kSplit groups of kN keys, kS floats a thread each
  constexpr int kSplit = C::kSplit, kN = kCols / kSplit, kS = kN / 2;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t vecs = base + kTile * C::kTiles;
  const uint32_t bars = vecs + C::kVec * 2 * kConsumers;
  float* const mbuf =
      reinterpret_cast<float*>(smem + (bars + 8 * C::kBars - smem_u32(smem)));
  // a split item: both warpgroups read consumer 0's Q, dO, L and D_row
  constexpr bool split = kKeySplit;
  // Q of consumer c in buffer i, and its dO beside it
  auto q_tile = [&](int i, int c) {
    return base + kTile * (2 * ((i & 1) * kConsumers + c));
  };
  auto k_tile = [&](int st) {
    return base + kTile * (4 * kConsumers + 2 * st);
  };
  // the L and D_row of consumer c's rows in buffer i
  auto vec = [&](int i, int c) {
    return vecs + C::kVec * ((i & 1) * kConsumers + c);
  };
  auto qd_full = [&](int i) { return bars + 8 * (i & 1); };
  auto kv_full = [&](int st) { return bars + 8 * (2 + st); };
  constexpr int kEmpty = 8 * (2 + kStages);
  auto parity = [](int g) { return (uint32_t)((g / kStages) & 1); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int i = 0; i < C::kBars / 2; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + kEmpty + 8 * i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {  // the producer warp: one thread copies
    if (lane != 0) return;
    int g = 0;
    for (int i = 0; item_of_round(i) < sh.n_items; ++i) {
      const DqItem it = dq_item<kKeySplit>(item_of_round(i), sh);
      const int hk = it.h / sh.group;
      mbar_wait(qd_full(i) + kEmpty, ((i / 2) & 1) ^ 1);
      // a consumer whose rows start past sq has no tile to run and gets
      // no L and D_row (they would lie past its head's padded rows)
      const int n_q = split ? 1 : kConsumers;
      const int live =
          split ? 1 : sh.pair_heads || it.q0 + kRows < sh.sq ? 2 : 1;
      mbar_expect(qd_full(i), 2 * n_q * kTile + live * C::kVec);
      for (int c = 0; c < n_q; ++c) {
        const int q0 = sh.pair_heads ? it.q0 : it.q0 + kRows * c;
        const int h = sh.pair_heads ? it.h + c : it.h;
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load(q_tile(i, c) + x * kBoxBytes, &tq, qd_full(i), x * kBox,
                   q0, h, it.b, pq);
          tma_load(q_tile(i, c) + kTile + x * kBoxBytes, &tdo, qd_full(i),
                   x * kBox, q0, h, it.b, pdo);
        }
        if (c < live) {
          const long long at = ((long long)it.b * sh.hq + h) * sh.sq_pad + q0;
          bulk_load(vec(i, c), lrow + at, kRows * 4, qd_full(i));
          bulk_load(vec(i, c) + kRows * 4, drow + at, kRows * 4, qd_full(i));
        }
      }
      for (int t = 0; t < it.n; ++t, ++g) {
        const int st = g % kStages, t0 = it.kv_lo + t * kCols;
        mbar_wait(kv_full(st) + kEmpty, parity(g) ^ 1);
        mbar_expect(kv_full(st), 2 * kTile);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load(k_tile(st) + x * kBoxBytes, &tk, kv_full(st), x * kBox,
                   t0, hk, it.b, pk);
          tma_load(k_tile(st) + kTile + x * kBoxBytes, &tv, kv_full(st),
                   x * kBox, t0, hk, it.b, pv);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  float acc[C::kAcc];
  float s[kS], dp[kS];
  uint32_t pd[kN / 4];
  const int row = 16 * (warp % 4) + lane / 4;  // rows row, row + 8
  const int col = 2 * (lane % 4);              // columns col, col + 1 of 8
  const bool signal = tid % 128 == 0;
  auto release = [&](uint32_t full_bar) {
    if (signal) mbar_arrive(full_bar + kEmpty);
  };

  int g = 0;       // the CTA's K/V tiles consumed so far
  int handed = 0;  // split items warpgroup 1 has handed over
  for (int i = 0; item_of_round(i) < sh.n_items; ++i) {
    const DqItem item = dq_item<kKeySplit>(item_of_round(i), sh);
    const int qw = sh.pair_heads || split ? item.q0 : item.q0 + kRows * wg;
    const int hw = sh.pair_heads && !split ? item.h + wg : item.h;
    const int n = item.n;
    // the tiles that meet this warpgroup's rows: [first, first + n_act)
    const int lo = sh.window > 0 ? max(0, qw - sh.window + 1) : 0;
    const int hi = qw >= sh.sq ? 0 : sh.causal ? min(sh.skv, qw + kRows)
                                               : sh.skv;
    const int first = min(n, (lo - item.kv_lo) / kCols);
    const int last = min(n, (hi - item.kv_lo + kCols - 1) / kCols);
    const int n_act = max(0, last - first);
#pragma unroll
    for (int j = 0; j < C::kAcc; ++j) acc[j] = 0.f;
    mbar_wait(qd_full(i), (i / 2) & 1);
    const int cq = split ? 0 : wg;  // whose Q, dO, L and D_row
    const uint32_t qt = q_tile(i, cq), dot = qt + kTile;
    const float* lv = reinterpret_cast<const float*>(
        smem + (vec(i, cq) - smem_u32(smem)));

    for (int t = 0; t < first; ++t) {  // tiles without a row of ours
      mbar_wait(kv_full((g + t) % kStages), parity(g + t));
      release(kv_full((g + t) % kStages));
    }
    int gt = g + first;
    for (int t = 0; t < n_act; ++t, ++gt) {
      const int st = gt % kStages;
      if (split && ((first + t) & 1) != wg) {  // the other warpgroup's
        mbar_wait(kv_full(st), parity(gt));
        release(kv_full(st));
        continue;
      }
      const uint32_t kt = k_tile(st), vt = kt + kTile;
      const int t0 = item.kv_lo + (first + t) * kCols;
      const bool edge = t0 + kCols > sh.skv ||
                        (sh.causal && t0 + kCols - 1 > qw) ||
                        (sh.window > 0 && t0 <= qw + kRows - 1 - sh.window);
      mbar_wait(kv_full(st), parity(gt));
#pragma unroll
      for (int hf = 0; hf < kSplit; ++hf) {  // keys hf kN .. hf kN + kN - 1
        zero(s);
        zero(dp);
        wg_fence();
        if constexpr (kSplit == 1) {
          mma_abt<D>(s, qt, kt);
          mma_abt<D>(dp, dot, vt);
        } else {
          mma_abt32<D>(s, qt, kt, hf);
          mma_abt32<D>(dp, dot, vt, hf);
        }
        wg_commit();
        wg_wait_all();
        fence_regs(s);
        fence_regs(dp);
        // the rows' L and D_row from shared memory, read where they are
        // used (held across the loop, these four registers spilled)
        float lr[2], dr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          lr[r] = lv[row + 8 * r];
          dr[r] = lv[kRows + row + 8 * r];
        }
#pragma unroll
        for (int j = 0; j < kS / 4; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * j + 2 * r + c;
              float x = s[e];
              if (edge) {
                const int qi = qw + row + 8 * r;
                const int kj = t0 + hf * kN + 8 * j + col + c;
                bool keep = kj < sh.skv;
                if (sh.causal) keep = keep && kj <= qi;
                if (sh.window > 0) keep = keep && kj > qi - sh.window;
                if (!keep) x = kMasked;
              }
              const float p = ex2(fmaf(x, scale_log2, -lr[r]));
              dp[e] = p * (dp[e] - dr[r]);
            }
        // dQ += dS K over this group's keys (its dS fragments only: with
        // the other group's held as well, ptxas spilled at D 128)
        pack_frags(dp, pd);
        fence_regs(acc);
        wg_fence();
        mma_pb<C::kDP, kN>(acc, pd, kt + hf * kN / 16 * 2 * kAtomBytes);
        wg_commit();
        wg_wait_all();
        fence_regs(acc);
      }
      release(kv_full(st));
    }
    for (int t = first + n_act; t < n; ++t) {
      mbar_wait(kv_full((g + t) % kStages), parity(g + t));
      release(kv_full((g + t) % kStages));
    }
    g += n;

    if (split) {  // warpgroup 1 hands its dQ over; 0 adds it to its own
      const int t128 = tid % 128;
      if (wg == 1) {
        if (handed > 0) named_sync(kBarFree, 2 * 128);
#pragma unroll
        for (int j = 0; j < C::kAcc; ++j) mbuf[j * 128 + t128] = acc[j];
        named_arrive(kBarMerge, 2 * 128);
        ++handed;
        release(qd_full(i));  // warpgroup 0 stores dQ through this Q tile
        continue;
      }
      named_sync(kBarMerge, 2 * 128);
#pragma unroll
      for (int j = 0; j < C::kAcc; ++j) acc[j] += mbuf[j * 128 + t128];
      named_arrive(kBarFree, 2 * 128);
    }

    // epilogue: scale dQ into this warpgroup's Q tile (no longer read) and
    // store it with TMA, which drops rows past Sq and D 112's padding
    stage_bf16<C::kDP>(acc, qt, scale, row, col);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(kBarWg + wg, 128);
    if (signal) {
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x)
        tma_store(&tdq, qt + x * kBoxBytes, x * kBox, qw, hw, item.b, pdq);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      release(qd_full(i));  // the buffer may take the item after next's
    }
  }
  // balance the hand-over barrier: warpgroup 0 freed the last part too
  if (split && wg == 1 && handed > 0) named_sync(kBarFree, 2 * 128);
}

// ------------------------------------------------------------- dk, dv

template <int D>
struct KvCfg : Tiles<D> {
  using T = Tiles<D>;
  static constexpr int kStages = D > 64 ? 3 : 4;  // Q/dO ring depth
  static constexpr int kVec = 2 * kCols * 4;      // a stage's L and D_row
  static constexpr int kP = kRows * kCols * 4;    // one f32 P^T tile
  // K and V [2 buffers], then Q and dO [kStages]
  static constexpr int kTiles = 4 + 2 * kStages;
  // full and empty barriers: K/V buffers (2), stages, P^T buffers (2)
  static constexpr int kBars = 2 * (2 + kStages + 2);
  static constexpr int kSmem = 1024 + T::kTile * kTiles + 2 * kP +
                               kVec * kStages + 8 * kBars;
};

// An item of the dk/dv kernel: one 64-key tile of one KV head; its work is
// the (q head of the group, q tile that sees the keys) pairs, heads outer.
// Key tile 0 first (the most causal work).
struct KvItem {
  int k0, hk, b;
  int qt_lo, n_qt, n;  // first q tile, q tiles a head, pairs
};

__device__ __forceinline__ KvItem kv_item(int w, const Shape& sh) {
  const int per = sh.hkv * sh.batch;
  KvItem it;
  it.k0 = (w / per) * kRows;
  it.hk = (w % per) % sh.hkv;
  it.b = (w % per) / sh.hkv;
  const int q_lo = sh.causal ? min(it.k0, sh.sq) : 0;
  const int q_hi =
      sh.window > 0 ? min(sh.sq, it.k0 + kRows - 1 + sh.window) : sh.sq;
  it.qt_lo = q_lo / kCols;
  const int qt_hi = q_hi > q_lo ? (q_hi + kCols - 1) / kCols : it.qt_lo;
  it.n_qt = qt_hi - it.qt_lo;
  it.n = sh.group * it.n_qt;
  return it;
}

// dv = P^T dO and dk = scale dS^T q for 64-key tiles. A producer warp
// loads each item's K and V tiles (double-buffered across items) and,
// through a ring of kStages, each pair's Q and dO tiles (TMA) and its L
// and D_row vectors (a bulk copy of 256 bytes each). The two consumer
// warpgroups split the work by output, each holding one 64 x D
// accumulator: warpgroup 0 forms S^T = K Q^T, P^T = 2^(S^T c - L) (L of
// the columns from shared memory) and dV += P^T dO; warpgroup 1 forms
// dP^T = V dO^T, takes P^T in f32 from warpgroup 0 through a
// double-buffered shared-memory tile (each thread reads the floats its
// counterpart wrote), dS^T = P^T (dP^T - D_row) and dK += dS^T Q. P^T and
// dS^T are rounded to bf16 as register A operands; dO and Q are read
// MN-major. Each warpgroup then stages its sum in bf16 in the tile of the
// item's K/V buffer that only it read (dV in K's, dK in V's) and stores it
// with TMA.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_tc(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tdk,
                  const __grid_constant__ CUtensorMap tdv, Shape sh,
                  Perm pq, Perm pk, Perm pv, Perm pdo, Perm pdk, Perm pdv,
                  const float* __restrict__ lrow,
                  const float* __restrict__ drow, float scale_log2,
                  float scale) {
  using C = KvCfg<D>;
  constexpr int kTile = C::kTile, kStages = C::kStages;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  uint8_t* const base_g = smem + (base - smem_u32(smem));
  const uint32_t ptiles = base + kTile * C::kTiles;
  const uint32_t vecs = ptiles + 2 * C::kP;
  const uint32_t bars = vecs + C::kVec * kStages;
  // K of buffer i, V beside it
  auto k_tile = [&](int i) { return base + kTile * (2 * (i & 1)); };
  // Q of stage st, dO beside it
  auto q_tile = [&](int st) { return base + kTile * (4 + 2 * st); };
  auto kv_full = [&](int i) { return bars + 8 * (i & 1); };
  auto st_full = [&](int st) { return bars + 8 * (2 + st); };
  auto p_full = [&](int g) { return bars + 8 * (2 + kStages + (g & 1)); };
  constexpr int kEmpty = 8 * (4 + kStages);
  auto parity = [](int g) { return (uint32_t)((g / kStages) & 1); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int i = 0; i < 2 + kStages; ++i) {  // TMA fills, two readers
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + kEmpty + 8 * i, kConsumers);
    }
    for (int i = 2 + kStages; i < C::kBars / 2; ++i) {  // P^T: a warpgroup
      mbar_init(bars + 8 * i, 128);
      mbar_init(bars + kEmpty + 8 * i, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {  // the producer warp: one thread copies
    if (lane != 0) return;
    int g = 0;
    for (int i = 0; item_of_round(i) < sh.n_items; ++i) {
      const KvItem it = kv_item(item_of_round(i), sh);
      mbar_wait(kv_full(i) + kEmpty, ((i / 2) & 1) ^ 1);
      mbar_expect(kv_full(i), 2 * kTile);
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x) {
        tma_load(k_tile(i) + x * kBoxBytes, &tk, kv_full(i), x * kBox,
                 it.k0, it.hk, it.b, pk);
        tma_load(k_tile(i) + kTile + x * kBoxBytes, &tv, kv_full(i),
                 x * kBox, it.k0, it.hk, it.b, pv);
      }
      for (int p = 0; p < it.n; ++p, ++g) {
        const int st = g % kStages;
        const int h = it.hk * sh.group + p / it.n_qt;
        const int q0 = (it.qt_lo + p % it.n_qt) * kCols;
        mbar_wait(st_full(st) + kEmpty, parity(g) ^ 1);
        mbar_expect(st_full(st), 2 * kTile + C::kVec);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load(q_tile(st) + x * kBoxBytes, &tq, st_full(st), x * kBox,
                   q0, h, it.b, pq);
          tma_load(q_tile(st) + kTile + x * kBoxBytes, &tdo, st_full(st),
                   x * kBox, q0, h, it.b, pdo);
        }
        const long long at =
            ((long long)it.b * sh.hq + h) * sh.sq_pad + q0;
        bulk_load(vecs + C::kVec * st, lrow + at, kCols * 4, st_full(st));
        bulk_load(vecs + C::kVec * st + kCols * 4, drow + at, kCols * 4,
                  st_full(st));
      }
    }
    return;
  }

  const int wg = warp / 4, t128 = tid % 128;
  float acc[C::kAcc];  // dV (warpgroup 0) or dK (warpgroup 1)
  float s[32];         // S^T then P^T (0), or dP^T then dS^T (1)
  uint32_t pa[16];
  const int row = 16 * (warp % 4) + lane / 4;  // key rows row, row + 8
  const int col = 2 * (lane % 4);              // q columns col, col + 1 of 8
  const bool signal = t128 == 0;

  int g = 0;  // the CTA's pairs so far
  for (int i = 0; item_of_round(i) < sh.n_items; ++i) {
    const KvItem item = kv_item(item_of_round(i), sh);
#pragma unroll
    for (int j = 0; j < C::kAcc; ++j) acc[j] = 0.f;
    mbar_wait(kv_full(i), (i / 2) & 1);
    // warpgroup 0 reads K and stages dV there; warpgroup 1 V, and dK
    const uint32_t kv = k_tile(i) + wg * kTile;
    for (int p = 0; p < item.n; ++p, ++g) {
      const int st = g % kStages;
      const uint32_t qt = q_tile(st), dot = qt + kTile;
      const float* lv = reinterpret_cast<const float*>(
          base_g + (vecs + C::kVec * st - base));
      float* const pt = reinterpret_cast<float*>(
          base_g + (ptiles + C::kP * (g & 1) - base));
      const uint32_t pbar = p_full(g), pphase = (g >> 1) & 1;
      const int q0 = (item.qt_lo + p % item.n_qt) * kCols;
      mbar_wait(st_full(st), parity(g));
      // S^T = K Q^T (0) or dP^T = V dO^T (1)
      zero(s);
      wg_fence();
      mma_abt<D>(s, kv, wg == 0 ? qt : dot);
      wg_commit();
      wg_wait_all();
      fence_regs(s);
      if (wg == 0) {
        const bool edge =
            item.k0 + kRows > sh.skv || q0 + kCols > sh.sq ||
            (sh.causal && item.k0 + kRows - 1 > q0) ||
            (sh.window > 0 && item.k0 <= q0 + kCols - 1 - sh.window);
        mbar_wait(pbar + kEmpty, pphase ^ 1);  // pair g - 2's P^T is read
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(lv + 8 * j + col);
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * j + 2 * r + c;
              float x = s[e];
              if (edge) {
                const int kj = item.k0 + row + 8 * r;
                const int qi = q0 + 8 * j + col + c;
                bool keep = kj < sh.skv && qi < sh.sq;
                if (sh.causal) keep = keep && kj <= qi;
                if (sh.window > 0) keep = keep && kj > qi - sh.window;
                if (!keep) x = kMasked;
              }
              s[e] = ex2(fmaf(x, scale_log2, -(c ? l2.y : l2.x)));
              pt[e * 128 + t128] = s[e];
            }
        }
        mbar_arrive(pbar);
        pack_frags(s, pa);
      } else {
        mbar_wait(pbar, pphase);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(lv + kCols + 8 * j + col);
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * j + 2 * r + c;
              s[e] = pt[e * 128 + t128] * (s[e] - (c ? d2.y : d2.x));
            }
        }
        mbar_arrive(pbar + kEmpty);
        pack_frags(s, pa);
      }
      // dV += P^T dO (0) or dK += dS^T Q (1)
      fence_regs(acc);
      wg_fence();
      mma_pb<C::kDP>(acc, pa, wg == 0 ? dot : qt);
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
      if (signal) mbar_arrive(st_full(st) + kEmpty);
    }

    // epilogue: the sum in bf16 into the tile this warpgroup alone read,
    // stored with TMA (rows past Skv and D 112's padding dropped)
    stage_bf16<C::kDP>(acc, kv, wg == 0 ? 1.f : scale, row, col);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(kBarWg + wg, 128);
    if (signal) {
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x) {
        if (wg == 0)
          tma_store(&tdv, kv + x * kBoxBytes, x * kBox, item.k0, item.hk,
                    item.b, pdv);
        else
          tma_store(&tdk, kv + x * kBoxBytes, x * kBox, item.k0, item.hk,
                    item.b, pdk);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      mbar_arrive(kv_full(i) + kEmpty);  // the buffer may take K and V again
    }
  }
}

// ------------------------------------------------------------- dk, dv at D 64

// At D 64 a warpgroup holds dK and dV of its own keys (32 + 32 f32 a
// thread) beside S^T and dP^T (32 + 32), so the split by output and its
// P^T tile are not needed: an item is 128 keys of one KV head, warpgroup c
// owns keys k0 + 64 c .. k0 + 64 c + 63, and each Q/dO stage of the ring,
// with its L and D_row vectors, serves both warpgroups' keys. (Items of 64
// keys whose pairs the two warpgroups share out, 576 in 5 rounds at
// whisper-tiny's encoder against these 288 in 3, ran 10-15% faster but
// spilled under the 168 registers in every form tried.)
struct Kv64Cfg {
  static constexpr int kTile = kBoxBytes;  // 64 rows x 64 columns, 8 KB
  static constexpr int kKeys = kRows * kConsumers;  // keys of an item
  static constexpr int kStages = 6;                 // Q/dO ring depth
  static constexpr int kVec = 2 * kCols * 4;        // a stage's L and D_row
  // K and V of each warpgroup [2 buffers], then Q and dO [kStages]
  static constexpr int kTiles = 2 * 2 * kConsumers + 2 * kStages;
  // full and empty barriers: K/V buffers (2), stages
  static constexpr int kBars = 2 * (2 + kStages);
  static constexpr int kSmem =
      1024 + kTile * kTiles + kVec * kStages + 8 * kBars;
};

// An item of the D 64 dk/dv kernel: keys k0 .. k0 + 127 of one KV head;
// its work is the (q head of the group, q tile that sees any of the keys)
// pairs, heads outer.
__device__ __forceinline__ KvItem kv64_item(int w, const Shape& sh) {
  const int per = sh.hkv * sh.batch;
  KvItem it;
  it.k0 = (w / per) * Kv64Cfg::kKeys;
  it.hk = (w % per) % sh.hkv;
  it.b = (w % per) / sh.hkv;
  const int q_lo = sh.causal ? min(it.k0, sh.sq) : 0;
  const int q_hi = sh.window > 0
                       ? min(sh.sq, it.k0 + Kv64Cfg::kKeys - 1 + sh.window)
                       : sh.sq;
  it.qt_lo = q_lo / kCols;
  const int qt_hi = q_hi > q_lo ? (q_hi + kCols - 1) / kCols : it.qt_lo;
  it.n_qt = qt_hi - it.qt_lo;
  it.n = sh.group * it.n_qt;
  return it;
}

// dv = P^T dO and dk = scale dS^T q for 128-key items at D 64, for rows
// that see every key (the host sends causal and windowed rows to
// flash_bwd_dkdv_tc). A producer warp loads each item's two K and two V
// tiles (double-buffered across items) and, through a ring of kStages,
// each pair's Q and dO tiles (TMA) and its L and D_row vectors (a bulk
// copy of 256 bytes each). Each consumer warpgroup, for the pairs that
// meet its 64 keys: S^T = K Q^T and dP^T = V dO^T (one wgmma group,
// retired before any read), P^T = 2^(S^T c - L) and dS^T = P^T (dP^T -
// D_row) in f32 registers (L and D_row of the columns from shared
// memory), both rounded to bf16 as register A operands of dV += P^T dO
// and dK += dS^T Q (dO and Q read MN-major; one group, retired before the
// stage is released). The warpgroups take turns to issue their products
// (two named barriers), so that while one runs its exponentials the
// other's products run. Each warpgroup then stages dV in its K tile and
// dK in its V tile (only it read them) and stores them with TMA, which
// drops rows past Skv.
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv64_tc(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tdk,
                    const __grid_constant__ CUtensorMap tdv, Shape sh,
                    Perm pq, Perm pk, Perm pv, Perm pdo, Perm pdk, Perm pdv,
                    const float* __restrict__ lrow,
                    const float* __restrict__ drow, float scale_log2,
                    float scale) {
  using C = Kv64Cfg;
  constexpr int kTile = C::kTile, kStages = C::kStages;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  uint8_t* const base_g = smem + (base - smem_u32(smem));
  const uint32_t vecs = base + kTile * C::kTiles;
  const uint32_t bars = vecs + C::kVec * kStages;
  // K of warpgroup c in buffer i, its V beside it
  auto k_tile = [&](int i, int c) {
    return base + kTile * (2 * ((i & 1) * kConsumers + c));
  };
  // Q of stage st, dO beside it
  auto q_tile = [&](int st) {
    return base + kTile * (2 * 2 * kConsumers + 2 * st);
  };
  auto kv_full = [&](int i) { return bars + 8 * (i & 1); };
  auto st_full = [&](int st) { return bars + 8 * (2 + st); };
  constexpr int kEmpty = 8 * (2 + kStages);
  auto parity = [](int g) { return (uint32_t)((g / kStages) & 1); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int i = 0; i < C::kBars / 2; ++i) {  // TMA fills, two readers
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + kEmpty + 8 * i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {  // the producer warp: one thread copies
    if (lane != 0) return;
    int g = 0;
    for (int i = 0; item_of_round(i) < sh.n_items; ++i) {
      const KvItem it = kv64_item(item_of_round(i), sh);
      mbar_wait(kv_full(i) + kEmpty, ((i / 2) & 1) ^ 1);
      // a second tile wholly past Skv arrives as zeros and is not used
      mbar_expect(kv_full(i), 2 * kConsumers * kTile);
      for (int c = 0; c < kConsumers; ++c) {
        tma_load(k_tile(i, c), &tk, kv_full(i), 0, it.k0 + kRows * c,
                 it.hk, it.b, pk);
        tma_load(k_tile(i, c) + kTile, &tv, kv_full(i), 0,
                 it.k0 + kRows * c, it.hk, it.b, pv);
      }
      for (int p = 0; p < it.n; ++p, ++g) {
        const int st = g % kStages;
        const int h = it.hk * sh.group + p / it.n_qt;
        const int q0 = (it.qt_lo + p % it.n_qt) * kCols;
        mbar_wait(st_full(st) + kEmpty, parity(g) ^ 1);
        mbar_expect(st_full(st), 2 * kTile + C::kVec);
        tma_load(q_tile(st), &tq, st_full(st), 0, q0, h, it.b, pq);
        tma_load(q_tile(st) + kTile, &tdo, st_full(st), 0, q0, h, it.b,
                 pdo);
        const long long at =
            ((long long)it.b * sh.hq + h) * sh.sq_pad + q0;
        bulk_load(vecs + C::kVec * st, lrow + at, kCols * 4, st_full(st));
        bulk_load(vecs + C::kVec * st + kCols * 4, drow + at, kCols * 4,
                  st_full(st));
      }
    }
    return;
  }

  const int wg = warp / 4;
  float adk[32], adv[32];  // dK and dV of this warpgroup's keys
  float s[32], dp[32];     // S^T then P^T; dP^T then dS^T
  uint32_t pa[16], pd[16];
  const int row = 16 * (warp % 4) + lane / 4;  // key rows row, row + 8
  const int col = 2 * (lane % 4);              // q columns col, col + 1 of 8
  const bool signal = tid % 128 == 0;

  int g = 0;  // the CTA's pairs so far
  for (int i = 0; item_of_round(i) < sh.n_items; ++i) {
    const KvItem item = kv64_item(item_of_round(i), sh);
    const int kc = item.k0 + kRows * wg;  // this warpgroup's first key
    // the q rows that see any of its keys: [q_lo, q_hi)
    const int q_lo = sh.causal ? kc : 0;
    const int q_hi =
        kc >= sh.skv ? 0
        : sh.window > 0 ? min(sh.sq, kc + kRows - 1 + sh.window)
                        : sh.sq;
    zero(adk);
    zero(adv);
    mbar_wait(kv_full(i), (i / 2) & 1);
    const uint32_t kt = k_tile(i, wg), vt = kt + kTile;
    // the warpgroups take turns to issue their products, warpgroup 0
    // first, two turns a pair each (a pair without our keys too), so that
    // one warpgroup's exponentials run beside the other's products; the
    // last turn of warpgroup 1 hands nothing on
    int yields = 0;
    auto turn = [&]() { named_sync(kBarTurn + wg, 2 * 128); };
    auto yield_turn = [&]() {
      ++yields;
      if (wg == 0 || yields < 2 * item.n)
        named_arrive(kBarTurn + 1 - wg, 2 * 128);
    };
    if (wg == 1 && item.n > 0) named_arrive(kBarTurn, 2 * 128);
    for (int p = 0; p < item.n; ++p, ++g) {
      const int st = g % kStages;
      const int q0 = (item.qt_lo + p % item.n_qt) * kCols;
      mbar_wait(st_full(st), parity(g));
      if (q0 + kCols > q_lo && q0 < q_hi) {
        const uint32_t qt = q_tile(st), dot = qt + kTile;
        const float* lv = reinterpret_cast<const float*>(
            base_g + (vecs + C::kVec * st - base));
        // S^T = K Q^T and dP^T = V dO^T
        zero(s);
        zero(dp);
        turn();
        wg_fence();
        mma_abt<64>(s, kt, qt);
        mma_abt<64>(dp, vt, dot);
        wg_commit();
        yield_turn();
        wg_wait_all();
        fence_regs(s);
        fence_regs(dp);
        const bool edge =
            kc + kRows > sh.skv || q0 + kCols > sh.sq ||
            (sh.causal && kc + kRows - 1 > q0) ||
            (sh.window > 0 && kc <= q0 + kCols - 1 - sh.window);
        // P^T and dS^T, 16 columns (one k-step of the products) at a time
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * kk + jj;
            const float2 l2 =
                *reinterpret_cast<const float2*>(lv + 8 * j + col);
            const float2 d2 =
                *reinterpret_cast<const float2*>(lv + kCols + 8 * j + col);
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int e = 4 * j + 2 * r + c;
                float x = s[e];
                if (edge) {
                  const int kj = kc + row + 8 * r;
                  const int qi = q0 + 8 * j + col + c;
                  bool keep = kj < sh.skv && qi < sh.sq;
                  if (sh.causal) keep = keep && kj <= qi;
                  if (sh.window > 0) keep = keep && kj > qi - sh.window;
                  if (!keep) x = kMasked;
                }
                const float pr = ex2(fmaf(x, scale_log2, -(c ? l2.y : l2.x)));
                s[e] = pr;
                dp[e] = pr * (dp[e] - (c ? d2.y : d2.x));
              }
          }
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            pa[4 * kk + x] =
                pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
            pd[4 * kk + x] =
                pack_bf16(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
          }
        }
        // dV += P^T dO and dK += dS^T Q
        fence_regs(adv);
        fence_regs(adk);
        turn();
        wg_fence();
        mma_pb<64>(adv, pa, dot);
        mma_pb<64>(adk, pd, qt);
        wg_commit();
        yield_turn();
        wg_wait_all();
        fence_regs(adv);
        fence_regs(adk);
      } else {
        turn();
        yield_turn();
        turn();
        yield_turn();
      }
      if (signal) mbar_arrive(st_full(st) + kEmpty);
    }

    // epilogue: dV into this warpgroup's K tile and dK into its V tile (no
    // other reader), stored with TMA (rows past Skv dropped)
    stage_bf16<64>(adv, kt, 1.f, row, col);
    stage_bf16<64>(adk, vt, scale, row, col);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(kBarWg + wg, 128);
    if (signal) {
      if (kc < sh.skv) {
        tma_store(&tdv, kt, 0, kc, item.hk, item.b, pdv);
        tma_store(&tdk, vt, 0, kc, item.hk, item.b, pdk);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
      mbar_arrive(kv_full(i) + kEmpty);  // the buffer may take K and V again
    }
  }
}

// ------------------------------------------- D 128, rows that see every key

// At D 128 the 288-thread kernels above run under the 168 registers ptxas
// grants a thread of a CTA with a producer warp, which is what makes dq
// form S and dP in 32-key groups (m64n32k16 from shared memory: 192 bytes
// of operands a clock against the SM's 128, so at most 2/3 of the tensor
// rate) and dk/dv split its work by output (an f32 P^T tile through shared
// memory, 32 KB written and read a pair). Rows that see every key (no
// causal limit, no window) go to the two kernels below instead, whose
// consumer threads hold up to 232 and 255 registers.

// S (+)= A B^T over D / 16 k-steps, A a bf16 register fragment (k-step kk
// in a[4 kk .. 4 kk + 3]), B a K-major 64-row tile (no commit).
template <int D>
__device__ __forceinline__ void mma_rs_abt(float (&s)[32],
                                           const uint32_t (&a)[D / 4],
                                           uint32_t b) {
  uint32_t unused = 0;
  opaque(b, unused);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_rs_qk(s, a + 4 * kk,
                sw128_desc(b + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16,
                           kAtomBytes),
                kk > 0);
}

// The bf16 A fragments of a K-major 64 x 128 tile (two 64-column boxes,
// 128-byte swizzle), k-step kk (columns 16 kk ..) in out[4 kk .. 4 kk + 3]:
// the layout pack_frags gives an accumulator.
__device__ __forceinline__ void load_frags(uint32_t (&out)[32], uint32_t tile,
                                           int row, int col) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = row + 8 * (x & 1), c = 16 * kk + col + 8 * (x >> 1);
      const uint32_t at = tile + (c / 64) * kBoxBytes + r * kRowBytes +
                          ((((c % 64) / 8) ^ (r % 8)) * 16) + (c % 8) * 2;
      asm volatile("ld.shared.b32 %0, [%1];" : "=r"(out[4 * kk + x])
                   : "r"(at) : "memory");
    }
}

// ---------------------------------------------- dq, D 128, every key

// dq = scale dS K for rows that see every key at D 128 (the VLM's
// cross-attention: q [4, 32, 512, 128] over k/v [4, 8, 1,600, 128]).
// Items as flash_bwd_dq_tc's: 64 q rows for each consumer warpgroup that
// read one KV head (heads 2p and 2p + 1 when the GQA group is even, else
// rows q0 and q0 + 64 of one head), every 64-key tile of Skv; at the cross
// shape 512 items on 132 CTAs, 4 rounds (3.88 would do).
// * 384 threads: two consumer warpgroups and a producer warpgroup, whose
//   one elected thread issues every TMA copy as flash_bwd_dq_tc's
//   producer warp does. setmaxnreg moves registers from the producer
//   warpgroup (40 a thread) to the consumers (232 a thread; 168 each at
//   launch). It has to be a whole warpgroup: setmaxnreg is executed by
//   all four warps of one (.sync.aligned), and .inc waits for registers
//   that .dec has returned to the pool.
// * An item's Q rows arrive in a buffer of their own and stay in
//   registers as bf16 A fragments (32 a thread; the buffer is released
//   as soon as every consumer thread has its fragments); dO, L and D_row
//   in a double buffer. S = Q K^T is then an m64n64k16 product with only
//   K read from shared memory (64 bytes a clock), dP = dO V^T one with
//   both operands there (128), dQ += dS K an m64n128k16 product with dS
//   from registers and K read MN-major (64): with the ring's fills (32 KB
//   a tile for both warpgroups) ~104 of the SM's 128 bytes a clock at the
//   tensor peak.
// * K and V through a ring of kStages 64-key tiles that both warpgroups
//   read; per tile S and dP (one wgmma group, retired before any read), P
//   = 2^(S c - L) and dS = P (dP - D_row) in f32 registers, dS rounded to
//   bf16 as the A operand of dQ += dS K, keys in order (dQ summed over
//   64-key tiles in key order).
// * Registers a consumer thread: dQ 64, S 32, dP 32, Q 32, dS 16 (ptxas:
//   168 at launch, no spill; holding dO as well, 255 spilled 72 bytes).
//   Shared memory 199,776 bytes: Q, dO double-buffered, 3 K/V stages.
// * The epilogue scales dQ into the warpgroup's dO tile (no longer read)
//   and stores it with TMA (rows past Sq dropped).
constexpr int kThreads3 = 128 * (kConsumers + 1);  // and a producer warpgroup

struct Dq128Cfg {
  static constexpr int kTile = 2 * kBoxBytes;  // 64 rows x 128 columns
  static constexpr int kStages = 3;            // K/V ring depth
  static constexpr int kVec = 2 * kRows * 4;   // a warpgroup's L and D_row
  // Q of each warpgroup, dO [2 buffers][each warpgroup], K and V of each
  // stage
  static constexpr int kTiles = kConsumers + 2 * kConsumers + 2 * kStages;
  // full and empty barriers: the Q buffer, the dO buffers, each stage
  static constexpr int kBars = 2 * (1 + 2 + kStages);
  static constexpr int kSmem = 1024 + kTile * kTiles +
                               2 * kConsumers * kVec + 8 * kBars;
};

__global__ void __launch_bounds__(kThreads3, 1)
flash_bwd_dq128_tc(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tdq, Shape sh,
                   Perm pq, Perm pk, Perm pv, Perm pdo, Perm pdq,
                   const float* __restrict__ lrow,
                   const float* __restrict__ drow, float scale_log2,
                   float scale) {
  using C = Dq128Cfg;
  constexpr int kTile = C::kTile, kStages = C::kStages;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  uint8_t* const base_g = smem + (base - smem_u32(smem));
  // Q of warpgroup c; dO of warpgroup c in buffer i; K of stage st, V
  // beside it; the L and D_row of warpgroup c in buffer i
  auto q_tile = [&](int c) { return base + kTile * c; };
  auto do_tile = [&](int i, int c) {
    return base + kTile * (kConsumers + (i & 1) * kConsumers + c);
  };
  auto k_tile = [&](int st) {
    return base + kTile * (3 * kConsumers + 2 * st);
  };
  const uint32_t vecs = base + kTile * C::kTiles;
  auto vec = [&](int i, int c) {
    return vecs + C::kVec * ((i & 1) * kConsumers + c);
  };
  const uint32_t bars = vecs + 2 * kConsumers * C::kVec;
  const uint32_t q_full = bars;
  auto do_full = [&](int i) { return bars + 8 * (1 + (i & 1)); };
  auto kv_full = [&](int st) { return bars + 8 * (3 + st); };
  constexpr int kEmpty = 8 * (3 + kStages);
  auto parity = [](int g) { return (uint32_t)((g / kStages) & 1); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_full + kEmpty, 128 * kConsumers);  // each, once it has Q
    for (int i = 1; i < C::kBars / 2; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + kEmpty + 8 * i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {  // the producer warpgroup: one thread copies
    regs_dec<kProducerRegs>();
    if (warp != kConsumers * 4 || lane != 0) return;
    int g = 0;
    for (int i = 0; item_of_round_rev(i) < sh.n_items; ++i) {
      const DqItem it = dq_item<false>(item_of_round_rev(i), sh);
      const int hk = it.h / sh.group;
      // a warpgroup whose rows start past sq gets no L and D_row (they
      // would lie past its head's padded rows)
      const int live = sh.pair_heads || it.q0 + kRows < sh.sq ? 2 : 1;
      mbar_wait(q_full + kEmpty, (i & 1) ^ 1);
      mbar_wait(do_full(i) + kEmpty, ((i / 2) & 1) ^ 1);
      mbar_expect(q_full, kConsumers * kTile);
      mbar_expect(do_full(i), kConsumers * kTile + live * C::kVec);
      for (int c = 0; c < kConsumers; ++c) {
        const int q0 = sh.pair_heads ? it.q0 : it.q0 + kRows * c;
        const int h = sh.pair_heads ? it.h + c : it.h;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          tma_load(q_tile(c) + x * kBoxBytes, &tq, q_full, x * kBox, q0, h,
                   it.b, pq);
          tma_load(do_tile(i, c) + x * kBoxBytes, &tdo, do_full(i),
                   x * kBox, q0, h, it.b, pdo);
        }
        if (c < live) {
          const long long at = ((long long)it.b * sh.hq + h) * sh.sq_pad + q0;
          bulk_load(vec(i, c), lrow + at, kRows * 4, do_full(i));
          bulk_load(vec(i, c) + kRows * 4, drow + at, kRows * 4,
                    do_full(i));
        }
      }
      for (int t = 0; t < it.n; ++t, ++g) {
        const int st = g % kStages;
        mbar_wait(kv_full(st) + kEmpty, parity(g) ^ 1);
        mbar_expect(kv_full(st), 2 * kTile);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          tma_load(k_tile(st) + x * kBoxBytes, &tk, kv_full(st), x * kBox,
                   t * kCols, hk, it.b, pk);
          tma_load(k_tile(st) + kTile + x * kBoxBytes, &tv, kv_full(st),
                   x * kBox, t * kCols, hk, it.b, pv);
        }
      }
    }
    return;
  }
  regs_inc<kConsumerRegs>();

  const int wg = warp / 4;
  const bool signal = tid % 128 == 0;
  const int row = 16 * (warp % 4) + lane / 4;  // rows row, row + 8
  const int col = 2 * (lane % 4);              // columns col, col + 1 of 8
  float acc[64], s[32], dp[32];
  uint32_t qa[32], pd[16];

  int g = 0;  // the CTA's K/V tiles consumed so far
  for (int i = 0; item_of_round_rev(i) < sh.n_items; ++i) {
    const DqItem item = dq_item<false>(item_of_round_rev(i), sh);
    const int qw = sh.pair_heads ? item.q0 : item.q0 + kRows * wg;
    const int hw = sh.pair_heads ? item.h + wg : item.h;
    const bool live = qw < sh.sq;
    mbar_wait(q_full, i & 1);
    load_frags(qa, q_tile(wg), row, col);
    mbar_arrive(q_full + kEmpty);  // the buffer may take the next item's Q
    mbar_wait(do_full(i), (i / 2) & 1);
    const uint32_t dot = do_tile(i, wg);
    float lr[2], dr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* lv =
          reinterpret_cast<const float*>(base_g + (vec(i, wg) - base));
      lr[r] = live ? lv[row + 8 * r] : 0.f;
      dr[r] = live ? lv[kRows + row + 8 * r] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.f;

    for (int t = 0; t < item.n; ++t, ++g) {
      const int st = g % kStages;
      mbar_wait(kv_full(st), parity(g));
      if (live) {
        const uint32_t kt = k_tile(st), vt = kt + kTile;
        zero(s);
        zero(dp);
        wg_fence();
        mma_rs_abt<128>(s, qa, kt);
        mma_abt<128>(dp, dot, vt);
        wg_commit();
        wg_wait_all();
        fence_regs(s);
        fence_regs(dp);
        const int t0 = t * kCols;
        const bool edge = t0 + kCols > sh.skv;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * j + 2 * r + c;
              float x = s[e];
              if (edge && t0 + 8 * j + col + c >= sh.skv) x = kMasked;
              const float p = ex2(fmaf(x, scale_log2, -lr[r]));
              dp[e] = p * (dp[e] - dr[r]);
            }
        pack_frags(dp, pd);
        // dQ += dS K
        fence_regs(acc);
        wg_fence();
        mma_pb<128, kCols>(acc, pd, kt);
        wg_commit();
        wg_wait_all();
        fence_regs(acc);
      }
      if (signal) mbar_arrive(kv_full(st) + kEmpty);
    }

    // epilogue: dQ scaled into this warpgroup's dO tile (no longer read)
    // and stored with TMA, which drops rows past Sq
    stage_bf16<128>(acc, dot, scale, row, col);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(kBarWg + wg, 128);
    if (signal) {
      if (live) {
#pragma unroll
        for (int x = 0; x < 2; ++x)
          tma_store(&tdq, dot + x * kBoxBytes, x * kBox, qw, hw, item.b,
                    pdq);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
      mbar_arrive(do_full(i) + kEmpty);  // the buffer may take item i + 2's
    }
  }
  // launched as a dependent of flash_bwd_dkdv128_tc: end no sooner than it,
  // so that what follows on the stream sees dk and dv as well
  grid_dependency_wait();
}

// ------------------------------------------- dk, dv, D 128, every key

// dv = P^T dO and dk = scale dS^T q for rows that see every key at D 128.
// An item is one 64-key tile of one KV head (at the cross shape 25 tiles x
// 8 heads x batch 4 = 800 items on 132 CTAs: 7 rounds, 6.06 would do;
// 128-key items, 416 in 4 rounds, take 14% more item-time); its work is
// the (q head of the group, 64-row q tile) pairs, heads outer (32 at the
// cross shape), and the two warpgroups share them out: warpgroup c takes
// the pairs p with p % 2 == c.
// * 256 threads, no producer warp (up to 255 registers a thread): each
//   warpgroup's elected thread copies its own pairs' Q, dO, L and D_row
//   by TMA into its own two stages, the pair after next as soon as the
//   warpgroup is done with a pair, so neither warpgroup waits for the
//   other's progress to get its operands; warpgroup 0's thread also
//   copies each item's K and V (double-buffered, the next item's at the
//   start of this one).
// * Per pair a warpgroup forms S^T = K Q^T and dP^T = V dO^T (m64n64k16,
//   both operands from shared memory; one group, retired before any
//   read), P^T = 2^(S^T c - L) and dS^T = P^T (dP^T - D_row) in f32
//   registers, 16 columns at a time packed to bf16 as they are formed,
//   then dV += P^T dO and dK += dS^T Q (m64n128k16, dO and Q read
//   MN-major). No P^T crosses shared memory; 128 KB of operands and fills
//   a pair for 4 x 256 tensor clocks: ~125 of the SM's 128 bytes a clock
//   at the tensor cores' peak (the split by output moved ~190).
// * Registers a thread: dK 64 and dV 64 of its pairs, S^T 32, dP^T 32,
//   P^T and dS^T 16 + 16 (ptxas: 240, no spill). Shared memory 199,744
//   bytes: K/V double-buffered, two Q/dO stages a warpgroup.
// * The partial sums meet in a fixed order once the item's pairs are
//   done, through the item's K/V buffer (32 KB, no longer read):
//   warpgroup 0 writes its dK, warpgroup 1 adds it to its own and writes
//   its dV, warpgroup 0 adds that to its own; so dK = dK_odd + dK_even and
//   dV = dV_even + dV_odd, each part summed in pair order. Warpgroup 0
//   then stages dV in the K tile, warpgroup 1 dK (scaled) in the V tile,
//   each stored with TMA (rows past Skv dropped).
// * Each CTA, on starting its last item, lets the dq kernel (launched
//   after this one as its programmatic dependent) take the SMs it frees.
constexpr int kThreads2 = 128 * kConsumers;  // two warpgroups, no producer
constexpr int kBarEx = 7;  // dk/dv: +0..2, the hand-over of dK and dV

struct Kv128Cfg {
  static constexpr int kTile = 2 * kBoxBytes;  // 64 rows x 128 columns
  static constexpr int kStages = 2;            // Q/dO stages a warpgroup
  static constexpr int kVec = 2 * kCols * 4;   // a stage's L and D_row
  // K and V [2 buffers], then Q and dO [kConsumers][kStages]
  static constexpr int kTiles = 2 * 2 + 2 * kConsumers * kStages;
  // barriers: K/V buffers full and empty (2 + 2), each stage full
  static constexpr int kBars = 2 * 2 + kConsumers * kStages;
  static constexpr int kSmem = 1024 + kTile * kTiles +
                               kVec * kConsumers * kStages + 8 * kBars;
};

__global__ void __launch_bounds__(kThreads2, 1)
flash_bwd_dkdv128_tc(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tdk,
                     const __grid_constant__ CUtensorMap tdv, Shape sh,
                     Perm pq, Perm pk, Perm pv, Perm pdo, Perm pdk,
                     Perm pdv, const float* __restrict__ lrow,
                     const float* __restrict__ drow, float scale_log2,
                     float scale) {
  using C = Kv128Cfg;
  constexpr int kTile = C::kTile;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  uint8_t* const base_g = smem + (base - smem_u32(smem));
  const uint32_t vecs = base + kTile * C::kTiles;
  const uint32_t bars = vecs + C::kVec * kConsumers * C::kStages;
  // K of buffer i, V beside it; stage st (kStages a warpgroup, warpgroup
  // c's from c kStages): Q, dO beside it, its L and D_row
  auto k_tile = [&](int i) { return base + kTile * (2 * (i & 1)); };
  auto q_tile = [&](int st) { return base + kTile * (4 + 2 * st); };
  auto vec = [&](int st) { return vecs + C::kVec * st; };
  auto kv_full = [&](int i) { return bars + 8 * (i & 1); };
  auto kv_empty = [&](int i) { return bars + 8 * (2 + (i & 1)); };
  auto st_full = [&](int st) { return bars + 8 * (4 + st); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, t128 = tid % 128;
  const bool signal = t128 == 0;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {  // K/V: both warpgroups' stores release
      mbar_init(kv_full(i), 1);
      mbar_init(kv_empty(i), kConsumers);
    }
    for (int st = 0; st < kConsumers * C::kStages; ++st)
      mbar_init(st_full(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  // This warpgroup's copies of its own pairs (p % 2 == wg), in order: the
  // next is its pair ``np`` of the item of round ``ni``, its ``nj``-th
  // pair in all, into its stage nj % kStages (the stage of pair nj -
  // kStages, which this warpgroup has finished).
  int ni = 0, np = wg, nj = 0;
  auto issue_next = [&]() {
    while (item_of_round(ni) < sh.n_items) {
      const KvItem it = kv_item(item_of_round(ni), sh);
      if (np >= it.n) {
        ++ni;
        np = wg;
        continue;
      }
      const int st = wg * C::kStages + nj % C::kStages;
      const int h = it.hk * sh.group + np / it.n_qt;
      const int q0 = (it.qt_lo + np % it.n_qt) * kCols;
      mbar_expect(st_full(st), 2 * kTile + C::kVec);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        tma_load(q_tile(st) + x * kBoxBytes, &tq, st_full(st), x * kBox, q0,
                 h, it.b, pq);
        tma_load(q_tile(st) + kTile + x * kBoxBytes, &tdo, st_full(st),
                 x * kBox, q0, h, it.b, pdo);
      }
      const long long at = ((long long)it.b * sh.hq + h) * sh.sq_pad + q0;
      bulk_load(vec(st), lrow + at, kCols * 4, st_full(st));
      bulk_load(vec(st) + kCols * 4, drow + at, kCols * 4, st_full(st));
      np += kConsumers;
      ++nj;
      return;
    }
  };
  // K and V of the item of round i into buffer i % 2, once both
  // warpgroups' stores of item i - 2 have read it
  auto issue_kv = [&](int i) {
    if (item_of_round(i) >= sh.n_items) return;
    const KvItem it = kv_item(item_of_round(i), sh);
    mbar_wait(kv_empty(i), ((i / 2) & 1) ^ 1);
    mbar_expect(kv_full(i), 2 * kTile);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      tma_load(k_tile(i) + x * kBoxBytes, &tk, kv_full(i), x * kBox, it.k0,
               it.hk, it.b, pk);
      tma_load(k_tile(i) + kTile + x * kBoxBytes, &tv, kv_full(i),
               x * kBox, it.k0, it.hk, it.b, pv);
    }
  };
  if (signal) {
    if (wg == 0) issue_kv(0);
    for (int st = 0; st < C::kStages; ++st) issue_next();
  }

  const int row = 16 * (warp % 4) + lane / 4;  // key rows row, row + 8
  const int col = 2 * (lane % 4);              // q columns col, col + 1 of 8
  float adk[64], adv[64];  // dK and dV of this warpgroup's pairs
  float s[32], dp[32];     // S^T then P^T; dP^T then dS^T
  uint32_t pa[16], pd[16];

  int j = 0;  // this warpgroup's pairs so far
  for (int i = 0; item_of_round(i) < sh.n_items; ++i) {
    const KvItem item = kv_item(item_of_round(i), sh);
    zero(adk);
    zero(adv);
    // the CTA's last item: the dq kernel, launched after this one, may
    // take the SMs that this grid's last round leaves idle
    if (item_of_round(i + 1) >= sh.n_items) launch_dependents();
    if (signal && wg == 0) issue_kv(i + 1);
    mbar_wait(kv_full(i), (i / 2) & 1);
    const uint32_t kt = k_tile(i), vt = kt + kTile;
    const bool edge_k = item.k0 + kRows > sh.skv;
    for (int p = wg; p < item.n; p += kConsumers, ++j) {
      const int st = wg * C::kStages + j % C::kStages;
      mbar_wait(st_full(st), (j / C::kStages) & 1);
      const uint32_t qt = q_tile(st), dot = qt + kTile;
      const float* lv =
          reinterpret_cast<const float*>(base_g + (vec(st) - base));
      // S^T = K Q^T and dP^T = V dO^T
      zero(s);
      zero(dp);
      wg_fence();
      mma_abt<128>(s, kt, qt);
      mma_abt<128>(dp, vt, dot);
      wg_commit();
      wg_wait_all();
      fence_regs(s);
      fence_regs(dp);
      // P^T and dS^T, 16 columns (one k-step of the products) at a time;
      // q rows past Sq have L = +inf and D_row = 0 (P^T and dS^T 0)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int jc = 2 * kk + jj;
          const float2 l2 =
              *reinterpret_cast<const float2*>(lv + 8 * jc + col);
          const float2 d2 =
              *reinterpret_cast<const float2*>(lv + kCols + 8 * jc + col);
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * jc + 2 * r + c;
              float x = s[e];
              if (edge_k && item.k0 + row + 8 * r >= sh.skv) x = kMasked;
              const float pr = ex2(fmaf(x, scale_log2, -(c ? l2.y : l2.x)));
              s[e] = pr;
              dp[e] = pr * (dp[e] - (c ? d2.y : d2.x));
            }
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          pa[4 * kk + x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
          pd[4 * kk + x] =
              pack_bf16(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
        }
      }
      // dV += P^T dO and dK += dS^T Q
      fence_regs(adv);
      fence_regs(adk);
      wg_fence();
      mma_pb<128>(adv, pa, dot);
      mma_pb<128>(adk, pd, qt);
      wg_commit();
      wg_wait_all();
      fence_regs(adv);
      fence_regs(adk);
      // the stage is free (every thread's reads of it came before the
      // products it fed): it takes this warpgroup's pair after next
      if (signal) issue_next();
    }

    // the hand-over, through the item's K/V buffer (both warpgroups are
    // done reading it after the CTA barrier): each thread's floats at
    // y[(j / 4) 128 + t128], so a warpgroup's threads meet their
    // counterparts' elements
    float4* const y = reinterpret_cast<float4*>(base_g + (kt - base));
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int q = 0; q < 16; ++q)
        y[q * 128 + t128] = make_float4(adk[4 * q], adk[4 * q + 1],
                                        adk[4 * q + 2], adk[4 * q + 3]);
      named_arrive(kBarEx, kThreads2);       // dK_even is in the buffer
      named_sync(kBarEx + 1, kThreads2);     // dV_odd is in the buffer
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const float4 o = y[q * 128 + t128];
        adv[4 * q] += o.x;
        adv[4 * q + 1] += o.y;
        adv[4 * q + 2] += o.z;
        adv[4 * q + 3] += o.w;
      }
      named_arrive(kBarEx + 2, kThreads2);   // warpgroup 0 has read it
      named_sync(kBarWg, 128);               // before dV overwrites it
      stage_bf16<128>(adv, kt, 1.f, row, col);
    } else {
      named_sync(kBarEx, kThreads2);
#pragma unroll
      for (int q = 0; q < 16; ++q) {  // each thread rereads its own slots
        const float4 o = y[q * 128 + t128];
        adk[4 * q] += o.x;
        adk[4 * q + 1] += o.y;
        adk[4 * q + 2] += o.z;
        adk[4 * q + 3] += o.w;
        y[q * 128 + t128] = make_float4(adv[4 * q], adv[4 * q + 1],
                                        adv[4 * q + 2], adv[4 * q + 3]);
      }
      named_arrive(kBarEx + 1, kThreads2);
      named_sync(kBarEx + 2, kThreads2);
      stage_bf16<128>(adk, vt, scale, row, col);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(kBarWg + wg, 128);
    if (signal) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        if (wg == 0)
          tma_store(&tdv, kt + x * kBoxBytes, x * kBox, item.k0, item.hk,
                    item.b, pdv);
        else
          tma_store(&tdk, vt + x * kBoxBytes, x * kBox, item.k0, item.hk,
                    item.b, pdk);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      mbar_arrive(kv_empty(i));  // the buffer may take item i + 2's K, V
    }
  }
}

// ------------------------------------------------------------- host

template <typename Kernel>
int resident_ctas(Kernel kernel, int smem, int* out, int threads = kThreads) {
  if (*out) return 0;
  int dev, sms, per_sm;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *out = sms * per_sm;
  return 0;
}

// D 128, rows that see every key: flash_bwd_dkdv128_tc, then
// flash_bwd_dq128_tc as a programmatic dependent launch (both read only
// the prep kernel's L and D_row): dq's CTAs start on the SMs that
// dk/dv's last round leaves idle (at the cross shape 8 items on 132 SMs,
// a seventh of its time), its highest CTAs, which start last, holding
// the fewest items. m and pm: the maps of q, k, v, dO, dq, dk, dv.
int launch128(const CUtensorMap* m, const Perm* pm, const Shape& sh,
              const float* lrow, const float* drow, float scale,
              cudaStream_t stream) {
  static int resident_dq = 0, resident_kv = 0;
  int err = resident_ctas(flash_bwd_dq128_tc, Dq128Cfg::kSmem, &resident_dq,
                          kThreads3);
  if (!err)
    err = resident_ctas(flash_bwd_dkdv128_tc, Kv128Cfg::kSmem, &resident_kv,
                        kThreads2);
  if (err) return err;
  Shape kv_sh = sh;
  kv_sh.n_t = (sh.skv + kRows - 1) / kRows;
  kv_sh.n_items = kv_sh.n_t * sh.hkv * sh.batch;
  flash_bwd_dkdv128_tc<<<min(resident_kv, kv_sh.n_items), kThreads2,
                         Kv128Cfg::kSmem, stream>>>(
      m[0], m[1], m[2], m[3], m[5], m[6], kv_sh, pm[0], pm[1], pm[2], pm[3],
      pm[5], pm[6], lrow, drow, scale * kLog2e, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Shape dq_sh = sh;
  dq_sh.pair_heads = sh.group % 2 == 0 ? 1 : 0;
  const int span = dq_sh.pair_heads ? kRows : kRows * kConsumers;
  dq_sh.n_t = (sh.sq + span - 1) / span;
  dq_sh.n_items =
      dq_sh.n_t * (dq_sh.pair_heads ? sh.hq / 2 : sh.hq) * sh.batch;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(min(resident_dq, dq_sh.n_items));
  cfg.blockDim = dim3(kThreads3);
  cfg.dynamicSmemBytes = Dq128Cfg::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, flash_bwd_dq128_tc, m[0], m[1], m[2], m[3],
                         m[4], dq_sh, pm[0], pm[1], pm[2], pm[3], pm[4], lrow,
                         drow, scale * kLog2e, scale);
  return (int)e;
}

// The three launches of the bf16 backward: prep, dq, dk/dv. st: the
// (batch, seq, head) strides of q, k, v, o, dO, dq, dk, dv.
template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* lrow, float* drow, int batch, int hq, int hkv, int sq,
           int skv, int causal, int window, float scale, const Strides* st,
           cudaStream_t stream) {
  // maps of q, k, v, dO, dq, dk, dv
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  const int which[7] = {0, 1, 2, 4, 5, 6, 7};
  CUtensorMap m[7];
  Perm pm[7];
  for (int i = 0; i < 7; ++i) {
    const bool rows_q = which[i] == 0 || which[i] == 4 || which[i] == 5;
    const int err = make_map(&m[i], &pm[i], ptrs[i], D, rows_q ? sq : skv,
                             rows_q ? hq : hkv, batch, st[which[i]]);
    if (err) return err;
  }
  Shape sh{sq, skv, hq, hkv, batch, hq / hkv, causal, window,
           (sq + kCols - 1) / kCols * kCols, 0, 0, 0};
  const int n_rows = batch * hq * sh.sq_pad;
  flash_bwd_prep<D><<<(n_rows + 15) / 16, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, lrow, drow, sh, st[3],
      st[4]);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if constexpr (D == 128)
    if (!causal && !window) return launch128(m, pm, sh, lrow, drow, scale,
                                             stream);

  // D 64 without a causal limit or a window: flash_bwd_dkdv64_tc (128-key
  // items, a 64-key tile a warpgroup)
  bool kv64 = false;
  if constexpr (D == 64) kv64 = !causal && !window;
  static int resident_dq = 0, resident_kv = 0, resident_kv64 = 0,
             resident_dq_split = 0;
  int err = resident_ctas(flash_bwd_dq_tc<D>, DqCfg<D>::kSmem, &resident_dq);
  if (!err)
    err = resident_ctas(flash_bwd_dkdv_tc<D>, KvCfg<D>::kSmem, &resident_kv);
  if constexpr (D == 64) {
    if (!err)
      err = resident_ctas(flash_bwd_dkdv64_tc, Kv64Cfg::kSmem,
                          &resident_kv64);
    if (!err)
      err = resident_ctas(flash_bwd_dq_tc<64, true>, DqCfg<64>::kSmem,
                          &resident_dq_split);
  }
  if (err) return err;
  Shape dq_sh = sh;
  dq_sh.pair_heads = sh.group % 2 == 0 ? 1 : 0;
  bool dq_split = false;
  if constexpr (D == 64) {
    // rows that see every key split their key tiles between the two
    // warpgroups where rounds of half an item take fewer item-times on the
    // resident grid than rounds of whole ones (whisper-tiny's encoder: 576
    // items in 5 rounds against 288 in 3); the shape alone decides
    if (!causal && !window && !dq_sh.pair_heads && skv > kCols) {
      const long long whole =
          (long long)((sq + 2 * kRows - 1) / (2 * kRows)) * hq * batch;
      const long long half = (long long)((sq + kRows - 1) / kRows) * hq *
                             batch;
      dq_split = (half + resident_dq - 1) / resident_dq <
                 2 * ((whole + resident_dq - 1) / resident_dq);
    }
  }
  const int span = dq_sh.pair_heads || dq_split ? kRows : kRows * kConsumers;
  dq_sh.n_t = (sq + span - 1) / span;
  dq_sh.n_items = dq_sh.n_t * (dq_sh.pair_heads ? hq / 2 : hq) * batch;
  if (dq_split)
    flash_bwd_dq_tc<64, true><<<min(resident_dq_split, dq_sh.n_items),
                                kThreads, DqCfg<64>::kSmem, stream>>>(
        m[0], m[1], m[2], m[3], m[4], dq_sh, pm[0], pm[1], pm[2], pm[3],
        pm[4], lrow, drow, scale * kLog2e, scale);
  else
    flash_bwd_dq_tc<D><<<min(resident_dq, dq_sh.n_items), kThreads,
                         DqCfg<D>::kSmem, stream>>>(
        m[0], m[1], m[2], m[3], m[4], dq_sh, pm[0], pm[1], pm[2], pm[3],
        pm[4], lrow, drow, scale * kLog2e, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  Shape kv_sh = sh;
  if (kv64) {
    kv_sh.n_t = (skv + Kv64Cfg::kKeys - 1) / Kv64Cfg::kKeys;
    kv_sh.n_items = kv_sh.n_t * hkv * batch;
    flash_bwd_dkdv64_tc<<<min(resident_kv64, kv_sh.n_items), kThreads,
                          Kv64Cfg::kSmem, stream>>>(
        m[0], m[1], m[2], m[3], m[5], m[6], kv_sh, pm[0], pm[1], pm[2],
        pm[3], pm[5], pm[6], lrow, drow, scale * kLog2e, scale);
  } else {
    kv_sh.n_t = (skv + kRows - 1) / kRows;
    kv_sh.n_items = kv_sh.n_t * hkv * batch;
    flash_bwd_dkdv_tc<D><<<min(resident_kv, kv_sh.n_items), kThreads,
                           KvCfg<D>::kSmem, stream>>>(
        m[0], m[1], m[2], m[3], m[5], m[6], kv_sh, pm[0], pm[1], pm[2],
        pm[3], pm[5], pm[6], lrow, drow, scale * kLog2e, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace tc



}  // namespace

extern "C" {

// dtype: 0 = float32 (the FMA kernels), 1 = bfloat16 (the tensor-core
// kernels). q, o, dout, dq: [B, Hq, Sq, D]; k, v, dk, dv: [B, Hkv, Skv, D];
// each given by its (batch, seq, head) element strides, head dim
// contiguous. lse: the forward's natural-log logsumexp, f32 [B, Hq, Sq],
// read by the bf16 kernels (required there; the f32 kernels recompute
// theirs). scratch holds two f32 arrays of [B, Hq, Sq] rows (f32) or of
// [B, Hq, Sq rounded up to 64] rows (bf16). For
// bf16 the operands' base addresses are 16-byte aligned and their strides
// multiples of 8 elements (the tensor maps' rule; the wrapper checks it).
// Returns cudaGetLastError() after the launches (0 = success).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* dq, void* dk, void* dv, void* scratch,
                        int dtype, int b, int hq, int hkv, int sq, int skv,
                        int d, int q_sb, int q_ss, int q_sh, int k_sb,
                        int k_ss, int k_sh, int v_sb, int v_ss, int v_sh,
                        int o_sb, int o_ss, int o_sh, int do_sb, int do_ss,
                        int do_sh, int dq_sb, int dq_ss, int dq_sh,
                        int dk_sb, int dk_ss, int dk_sh, int dv_sb,
                        int dv_ss, int dv_sh, int causal, int window,
                        float scale, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || skv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Shape sh{hq, hkv, sq, skv, causal, window, scale};
    const Bsh st[8] = {{q_sb, q_ss, q_sh},    {k_sb, k_ss, k_sh},
                       {v_sb, v_ss, v_sh},    {o_sb, o_ss, o_sh},
                       {do_sb, do_ss, do_sh}, {dq_sb, dq_ss, dq_sh},
                       {dk_sb, dk_ss, dk_sh}, {dv_sb, dv_ss, dv_sh}};
    // the f32 kernels' own lse, then rowsum(dO o o)
    float* own_lse = static_cast<float*>(scratch);
    float* drow = own_lse + static_cast<int64_t>(b) * hq * sq;
    return launch_f32(d, q, k, v, o, dout, dq, dk, dv, own_lse, drow, b, sh,
                      st, s);
  }
  if (dtype != 1 || lse == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st[8] = {{q_sb, q_ss, q_sh},    {k_sb, k_ss, k_sh},
                         {v_sb, v_ss, v_sh},    {o_sb, o_ss, o_sh},
                         {do_sb, do_ss, do_sh}, {dq_sb, dq_ss, dq_sh},
                         {dk_sb, dk_ss, dk_sh}, {dv_sb, dv_ss, dv_sh}};
  // L = lse log2(e), then D_row, each [B, Hq, Sq rounded up to 64]
  const int sq_pad = (sq + tc::kCols - 1) / tc::kCols * tc::kCols;
  float* lrow = static_cast<float*>(scratch);
  float* drow = lrow + static_cast<int64_t>(b) * hq * sq_pad;
  const float* l = static_cast<const float*>(lse);
  switch (d) {
    case 32:
      return tc::launch<32>(q, k, v, o, dout, l, dq, dk, dv, lrow, drow, b,
                            hq, hkv, sq, skv, causal, window, scale, st, s);
    case 64:
      return tc::launch<64>(q, k, v, o, dout, l, dq, dk, dv, lrow, drow, b,
                            hq, hkv, sq, skv, causal, window, scale, st, s);
    case 112:  // zamba2's shared attention: padded to two 64-column boxes
      return tc::launch<112>(q, k, v, o, dout, l, dq, dk, dv, lrow, drow, b,
                             hq, hkv, sq, skv, causal, window, scale, st, s);
    case 128:
      return tc::launch<128>(q, k, v, o, dout, l, dq, dk, dv, lrow, drow, b,
                             hq, hkv, sq, skv, causal, window, scale, st, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
