// Causal / sliding-window / GQA flash attention forward for Hopper (sm_90a),
// bound to Python through ctypes.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention: online softmax with the
// running max m, the running sum l and the accumulator in f32, scale D^-1/2;
// masks k < Skv (ragged tail), causal k <= q and window k > q - window, with
// positions from 0 on both sides; query head h reads KV head h / group; the
// output is acc / max(l, 1e-30) in q's dtype.
//
// Two kernels, chosen by dtype; neither is a fallback for the other.
//
// bf16: flash_fwd_tc, on the tensor cores.
//   What bounds it on the H100: at the qwen3-8b prefill shape (q [4, 32, 512,
//   128], kv with 8 heads) the causal work is ~8.6 GFLOP against ~42 MB
//   moved, so the least time is the 12.5 us of memory traffic (8.7 us of
//   bf16 tensor-core work). In practice the copies of K/V tiles from L2 into
//   shared memory come first: each query tile re-reads its keys, 151 MB at
//   that shape for 64-row tiles. The design halves that and keeps the
//   copies, the two products and the softmax off each other's path.
//   Design:
//   * Items: 64 query rows for each of two consumer warpgroups that read
//     the same KV head — the same rows of q heads 2p and 2p + 1 when the
//     GQA group is even (qwen3-8b), else rows q0 and q0 + 64 of one head
//     (zamba2-7b) — so every K/V tile copied into shared memory serves 128
//     query rows. The KV loop runs over 64-key tiles from the first tile
//     the window can reach to the last key the causal limit allows; a
//     warpgroup skips the tiles outside its own rows' range (a wholly
//     masked tile changes no bit of the result), and only tiles that cross
//     the diagonal, the window's edge or Skv apply the mask.
//   * A persistent grid, one CTA an SM (288 threads, ~193 KB of shared
//     memory): the CTA takes one item a round, forwards in even rounds and
//     backwards in odd ones so that long and short causal items pair up.
//     Which CTA computes an item does not change its arithmetic.
//   * A producer warp issues every copy by TMA over a 4-D tensor map
//     (D, H, S, B) of each strided [B, S, H, D] operand, built on the host
//     with cuTensorMapEncodeTiled (taken from the driver through
//     cudaGetDriverEntryPoint, so the library needs no link to libcuda).
//     Boxes are 64 rows x 64 columns with the 128-byte swizzle that the
//     wgmma descriptors name; D 112's second box has columns 112..127
//     outside the tensor, which arrive as zeros, as do keys past Skv and
//     rows past Sq. Q is double-buffered across items and K and V go
//     through a 4-stage ring; each buffer has a full barrier (the copy's
//     bytes) and an empty one (one arrival from each consumer warpgroup),
//     so the warpgroups run on their own and the next item's Q and first
//     tiles arrive during this item's tail.
//   * S = Q K^T with wgmma.mma_async m64n64k16 (Q and the K tile both
//     K-major in shared memory, D / 16 k-steps), f32 accumulators in
//     registers. Row max and row sum are taken in f32, in a fixed tree over
//     a thread's 16 columns and across the 4 threads of a quad with xor
//     shuffles; p = 2^(s c - m c) with c = D^-1/2 log2(e), one FMA and one
//     ex2 an element.
//   * O += P V with wgmma m64nNk16, N = D padded to 64 or 128: P is
//     converted to bf16 in registers and fed as the register A operand (the
//     f32 accumulator layout of the first product is the A-fragment layout
//     of the second), V is read from shared memory MN-major (transposed B).
//     P in bf16 is this kernel's one departure from the TPU kernel's f32 p;
//     it stays within the bf16 tolerance the kernel is held to.
//   * The epilogue scales by 1 / max(l, 1e-30), writes bf16 into the
//     warpgroup's Q tile in the swizzled box layout and stores it with TMA,
//     which drops rows past Sq and D 112's padded columns. When asked (a
//     non-null lse), it also writes each row's natural-log logsumexp
//     m D^-1/2 + ln l for the backward kernels; o is the same either way.
//   * The two warpgroups overlap each other's softmax and products; within
//     one warpgroup the products wait for the softmax: a software pipeline
//     of the two products made ptxas serialise every wgmma (its C7513
//     "Potential Performance Loss" note, which chip_smoke.py would print).
//   At D 64 (whisper-tiny) rows that see every key go to flash_fwd64_tc
//   instead: the same items, producer and epilogue with 128-key tiles, and
//   the keys of long rows split between the two warpgroups where that
//   fills the card's SMs better (its notes below); causal and windowed
//   rows keep flash_fwd_tc<64>, whose 64-key tiles mask less. At D 128
//   (the VLM's cross-attention) rows that see every key go to
//   flash_fwd128_tc<false>: 128-key tiles too, with a producer warpgroup
//   whose registers setmaxnreg hands to the consumers (its notes below).
//   Causal rows of unpaired heads at D 128 and D 112 (codeqwen1.5-7b's and
//   zamba2-7b's MHA) go to flash_fwd128_tc<true>: the same kernel over
//   128-row items of one head, rows ascending round by round (its notes
//   below). Windowed rows and causal rows of paired GQA heads keep
//   flash_fwd_tc<128> (and <112>).
//
// f32: flash_fwd, f32 FMAs on the FP32 pipes (the reduced card-vs-CPU checks
//   hold the f32 kernel path to 1e-3 of the CPU path, which needs full-f32
//   products). Four threads own each query row and split the head dimension
//   in interleaved float4 chunks; partial dot products are summed with two
//   xor shuffles; 32-key K and V tiles are staged in shared memory. It
//   writes the logsumexp m + ln l when asked, as the bf16 kernel does.
//
// Both: q, k, v and o are addressed through explicit (batch, seq, head)
// strides, so the model's [B, S, H, D] tensors are read and written in
// place. No atomics, and each output element is computed by a fixed
// sequence of operations: reruns are bitwise identical.

#include <math.h>

#include "hopper_tc.cuh"  // TMA, mbarrier and wgmma helpers

namespace {

constexpr float kNegInf = -1e30f;

// ------------------------------------------------------- f32: FMA kernel

constexpr int kThreads = 256;
constexpr int kBlockM = 64;      // query rows per CTA
constexpr int kBlockN = 32;      // keys per staged tile
constexpr int kLanesPerRow = 4;  // threads sharing one query row

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ lse, int sq, int skv, int group, Strides qs,
          Strides ks, Strides vs, Strides os, int causal, int window,
          float scale) {
  constexpr int kChunks = D / 4;                 // float4 chunks per row
  constexpr int kMine = kChunks / kLanesPerRow;  // chunks per thread
  __shared__ float4 k_tile[kBlockN][kChunks];
  __shared__ float4 v_tile[kBlockN][kChunks];

  const int tid = threadIdx.x;
  const int r = tid / kLanesPerRow;  // query row within the tile
  const int c = tid % kLanesPerRow;  // owns chunks c, c + 4, c + 8, ...
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int qi = q0 + r;

  const T* qp = q + (long long)b * qs.b + (long long)h * qs.h;
  const T* kp = k + (long long)b * ks.b + (long long)hk * ks.h;
  const T* vp = v + (long long)b * vs.b + (long long)hk * vs.h;

  float4 qr[kMine], acc[kMine];
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    qr[i] = qi < sq ? load4(qp + (long long)qi * qs.s + 4 * (c + 4 * i))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf, l = 0.f;

  // Keys any row of this tile may see: [kv_lo, kv_hi).
  const int kv_hi = causal ? min(skv, q0 + kBlockM) : skv;
  int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_lo = (kv_lo / kBlockN) * kBlockN;

  for (int t0 = kv_lo; t0 < kv_hi; t0 += kBlockN) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kBlockN * kChunks; e += kThreads) {
      const int j = e / kChunks, cc = e % kChunks;
      const int kj = t0 + j;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (kj < skv) {
        kv4 = load4(kp + (long long)kj * ks.s + 4 * cc);
        vv4 = load4(vp + (long long)kj * vs.s + 4 * cc);
      }
      k_tile[j][cc] = kv4;
      v_tile[j][cc] = vv4;
    }
    __syncthreads();

    float s[kBlockN];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockN; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        const float4 kk = k_tile[j][c + 4 * i];
        part = fmaf(qr[i].x, kk.x, part);
        part = fmaf(qr[i].y, kk.y, part);
        part = fmaf(qr[i].z, kk.z, part);
        part = fmaf(qr[i].w, kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kj = t0 + j;
      bool keep = kj < skv;
      if (causal) keep = keep && kj <= qi;
      if (window > 0) keep = keep && kj > qi - window;
      s[j] = keep ? part * scale : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }

    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockN; ++j) {
      s[j] = expf(s[j] - m_new);
      p_sum += s[j];
    }
    l = l * corr + p_sum;
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      acc[i].x *= corr;
      acc[i].y *= corr;
      acc[i].z *= corr;
      acc[i].w *= corr;
    }
#pragma unroll
    for (int j = 0; j < kBlockN; ++j) {
      const float p = s[j];
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        const float4 vv = v_tile[j][c + 4 * i];
        acc[i].x = fmaf(p, vv.x, acc[i].x);
        acc[i].y = fmaf(p, vv.y, acc[i].y);
        acc[i].z = fmaf(p, vv.z, acc[i].z);
        acc[i].w = fmaf(p, vv.w, acc[i].w);
      }
    }
    m = m_new;
  }

  if (qi < sq) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = o + (long long)b * os.b + (long long)qi * os.s +
            (long long)h * os.h;
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const float4 a = acc[i];
      store4(op + 4 * (c + 4 * i),
             make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom));
    }
    if (lse != nullptr && c == 0)  // m holds scaled scores here
      lse[((long long)b * gridDim.y + h) * sq + qi] =
          l > 0.f ? m + logf(l) : INFINITY;
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, float* lse,
            int batch, int hq, int sq, int skv, int group, Strides qs,
            Strides ks, Strides vs, Strides os, int causal, int window,
            float scale, cudaStream_t stream) {
  const dim3 grid((sq + kBlockM - 1) / kBlockM, hq, batch);
  flash_fwd<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, skv, group, qs,
      ks, vs, os, causal, window, scale);
}

// ------------------------------------------- bf16: tensor-core kernel

namespace tc {

constexpr int kConsumers = 2;            // consumer warpgroups per CTA
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 32;  // and one producer warp
constexpr int kRows = 64;                // query rows per consumer (wgmma M)
constexpr int kBlockN = 64;              // keys per tile
constexpr int kStages = 4;               // K/V ring depth

template <int D>
struct Cfg {
  static constexpr int kBoxes = D > 64 ? 2 : 1;     // 64-column boxes
  static constexpr int kDP = kBox * kBoxes;         // D padded to the boxes
  static constexpr int kAcc = kDP / 2;              // O floats per thread
  static constexpr int kTile = kBoxes * kBoxBytes;  // 64 rows of Q, K or V
  // Q[2][kConsumers], K[kStages], V[kStages]
  static constexpr int kTiles = 2 * kConsumers + 2 * kStages;
  // a full and an empty barrier for each Q buffer and each ring stage
  static constexpr int kBars = 2 * (2 + 2 * kStages);
  // 1024 bytes of slack to align the tiles to a swizzle atom
  static constexpr int kSmem = 1024 + kTile * kTiles + 8 * kBars;
};

// The problem, and the work items of the persistent grid. An item gives
// each consumer warpgroup c 64 query rows of one head that read the same KV
// head: with GQA (an even group) the same rows of q heads 2p and 2p + 1,
// otherwise rows q0 and q0 + 64 of one head. Items run the longest causal
// rows first.
struct Shape {
  int sq, skv, hq, batch, group, causal, window;
  int pair_heads;  // 1: consumers take two heads; 0: two row blocks
  int n_qt, n_items;
};

struct Item {
  int q0, h, b;    // first row and head of consumer 0, batch
  int span;        // rows of the item: 64 (heads paired) or 128
  int kv_lo, n;    // first key and 64-key tiles any row may see
};

__device__ __forceinline__ Item item_at(int w, const Shape& sh) {
  const int heads = sh.pair_heads ? sh.hq / 2 : sh.hq;
  const int per = heads * sh.batch;
  Item it;
  it.span = sh.pair_heads ? kRows : kRows * kConsumers;
  it.q0 = (sh.n_qt - 1 - w / per) * it.span;
  it.h = ((w % per) % heads) * (sh.pair_heads ? 2 : 1);
  it.b = (w % per) / heads;
  // keys any row of the item may see: [kv_lo, kv_hi), in 64-key tiles
  const int kv_hi = sh.causal ? min(sh.skv, it.q0 + it.span) : sh.skv;
  const int lo = sh.window > 0 ? max(0, it.q0 - sh.window + 1) : 0;
  it.kv_lo = (lo / kBlockN) * kBlockN;
  it.n = kv_hi > it.kv_lo ? (kv_hi - it.kv_lo + kBlockN - 1) / kBlockN : 0;
  return it;
}

// Consumer c's first row and head within item ``it``.
__device__ __forceinline__ int rows_of(const Item& it, const Shape& sh,
                                       int c) {
  return sh.pair_heads ? it.q0 : it.q0 + kRows * c;
}
__device__ __forceinline__ int head_of(const Item& it, const Shape& sh,
                                       int c) {
  return sh.pair_heads ? it.h + c : it.h;
}

// Masks and the online softmax of one S tile (keys t0..t0+63) on the raw
// scores in s: p = 2^(s c - m c), c = D^-1/2 log2(e). Updates the running
// max m and sum l of the thread's two rows, sets the factor ``corr`` for
// the accumulator, and writes P as bf16 A fragments to ``pf`` (k-step kk
// covers the S columns of j = 2 kk and 2 kk + 1). Only a tile that crosses
// the causal diagonal, the window's edge or Skv is masked.
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], uint32_t (&pf)[16], float (&m_run)[2], float (&l_run)[2],
    float (&corr)[2], int t0, int q0, int row, int col, int skv, int causal,
    int window, float scale_log2) {
  const bool edge = t0 + kBlockN > skv ||
                    (causal && t0 + kBlockN - 1 > q0) ||
                    (window > 0 && t0 <= q0 + kRows - 1 - window);
  if (edge) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = q0 + row + 8 * i, kj = t0 + 8 * j + col + c;
          bool keep = kj < skv;
          if (causal) keep = keep && kj <= qi;
          if (window > 0) keep = keep && kj > qi - window;
          if (!keep) s[4 * j + 2 * i + c] = kNegInf;
        }
  }
  float neg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx[8];  // a pairwise tree over the thread's 16 columns
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mx[j] = fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]);
#pragma unroll
    for (int w = 4; w >= 1; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) mx[j] = fmaxf(mx[j], mx[j + w]);
    float m = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float m_new = fmaxf(m_run[i], m);
    corr[i] = ex2((m_run[i] - m_new) * scale_log2);
    // a row that has seen no visible key yet: every p is 0 (2^(-1e30 c)),
    // not 2^(s c - m c) with two roundings of -1e30 c that need not cancel
    neg[i] = m_new == kNegInf ? 0.f : -m_new * scale_log2;
    m_run[i] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float ps[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float& x0 = s[4 * j + 2 * i];
      float& x1 = s[4 * j + 2 * i + 1];
      x0 = ex2(fmaf(x0, scale_log2, neg[i]));
      x1 = ex2(fmaf(x1, scale_log2, neg[i]));
      ps[j] = x0 + x1;
    }
#pragma unroll
    for (int w = 4; w >= 1; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) ps[j] += ps[j + w];
    l_run[i] = l_run[i] * corr[i] + ps[0];
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pf[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pf[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pf[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pf[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// S = Q K^T over D / 16 k-steps of 32 bytes along the swizzled rows of the
// Q tile and a K tile, issued and committed as one group (not waited for).
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_tile,
                                         uint32_t k_tile) {
  fence_regs(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_qk(s, sw128_desc(q_tile + off, 16, kAtomBytes),
             sw128_desc(k_tile + off, 16, kAtomBytes), kk > 0);
  }
  wg_commit();
}

// O += P V: 16 keys (two swizzle atoms of rows) a k-step; the second
// 64-column box of V is the leading-dimension step. Issued and committed.
template <int DP>
__device__ __forceinline__ void issue_pv(float (&acc)[DP / 2],
                                         const uint32_t (&pa)[16],
                                         uint32_t v_tile) {
  fence_regs(acc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk)
    wgmma_pv<DP>(acc, pa + 4 * kk,
                 sw128_desc(v_tile + kk * 2 * kAtomBytes, kBoxBytes,
                            kAtomBytes));
  wg_commit();
}

// A persistent grid of G CTAs, as many as fit the card at once: CTA c takes
// one item a round (item_of_round), so the loads of an item's Q and first
// tiles overlap the previous item's products and epilogue. Which CTA
// computes an item does not change its arithmetic, so the result does not
// depend on G.
//
// Warp-specialised: one producer warp issues every TMA copy; two consumer
// warpgroups, 64 query rows each, share each K/V tile. Every buffer has a
// full barrier (the copy's bytes) and an empty one (one arrival from each
// consumer warpgroup once it is done with it), so the two warpgroups run
// on their own and the producer keeps kStages tiles in flight.
//
// Accumulator fragments (S and O) of thread t = 32 w + lane of a
// warpgroup: rows 16 w + lane / 4 (+ 8 for i = 1) of its 64, columns
// 8 j + 2 (lane % 4) + c, held in d[4 j + 2 i + c].
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap to, Shape sh, Perm pq,
             Perm pk, Perm pv, Perm po, float scale_log2, float* lse,
             float scale) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t bars = base + C::kTile * C::kTiles;
  auto q_tile = [&](int i, int c) {
    return base + C::kTile * ((i & 1) * kConsumers + c);
  };
  auto k_tile = [&](int st) {
    return base + C::kTile * (2 * kConsumers + st);
  };
  auto v_tile = [&](int st) {
    return base + C::kTile * (2 * kConsumers + kStages + st);
  };
  // barriers: full then empty, for Q[2], K[kStages], V[kStages]
  auto q_full = [&](int i) { return bars + 8 * (i & 1); };
  auto k_full = [&](int st) { return bars + 8 * (2 + st); };
  auto v_full = [&](int st) { return bars + 8 * (2 + kStages + st); };
  constexpr int kEmpty = 8 * (2 + 2 * kStages);
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
      const Item it = item_at(item_of_round(i), sh);
      const int hk = it.h / sh.group;
      // the n-th refill of a buffer waits for the n-th release (a fresh
      // barrier's "previous phase" counts as done)
      mbar_wait(q_full(i) + kEmpty, ((i / 2) & 1) ^ 1);
      mbar_expect(q_full(i), kConsumers * C::kTile);
      for (int c = 0; c < kConsumers; ++c)
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load(q_tile(i, c) + x * kBoxBytes, &tq, q_full(i), x * kBox,
                   rows_of(it, sh, c), head_of(it, sh, c), it.b, pq);
      for (int t = 0; t < it.n; ++t, ++g) {
        const int st = g % kStages, t0 = it.kv_lo + t * kBlockN;
        mbar_wait(k_full(st) + kEmpty, parity(g) ^ 1);
        mbar_expect(k_full(st), C::kTile);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load(k_tile(st) + x * kBoxBytes, &tk, k_full(st), x * kBox, t0,
                   hk, it.b, pk);
        mbar_wait(v_full(st) + kEmpty, parity(g) ^ 1);
        mbar_expect(v_full(st), C::kTile);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load(v_tile(st) + x * kBoxBytes, &tv, v_full(st), x * kBox, t0,
                   hk, it.b, pv);
      }
    }
    return;
  }

  // a consumer warpgroup: rows kRows * wg .. of each item
  const int wg = warp / 4;
  float acc[C::kAcc];
  float s[32];
  float m_run[2], l_run[2], corr[2];
  uint32_t pa[16];
  const int row = 16 * (warp % 4) + lane / 4;  // rows row, row + 8
  const int col = 2 * (lane % 4);              // columns col, col + 1 of 8
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  // One thread of the warpgroup releases a buffer once the warpgroup's
  // products that read it are done (a wgmma is one operation of the whole
  // warpgroup, so its completion in this thread's warp covers all four).
  const bool signal = tid % 128 == 0;
  auto release = [&](uint32_t full_bar) {
    if (signal) mbar_arrive(full_bar + kEmpty);
  };
  // a tile this warpgroup has no row for: wait for it, then release it
  auto pass = [&](int g) {
    const int st = g % kStages;
    mbar_wait(k_full(st), parity(g));
    release(k_full(st));
    mbar_wait(v_full(st), parity(g));
    release(v_full(st));
  };

  int g = 0;  // the CTA's K/V tiles consumed so far
  for (int i = 0; item_of_round(i) < sh.n_items; ++i) {
    const Item item = item_at(item_of_round(i), sh);
    const int qw = rows_of(item, sh, wg), hw = head_of(item, sh, wg);
    const int n = item.n;
    // the tiles that meet this warpgroup's rows: [first, first + n_act)
    const int lo = sh.window > 0 ? max(0, qw - sh.window + 1) : 0;
    const int hi = qw >= sh.sq ? 0 : sh.causal ? min(sh.skv, qw + kRows)
                                               : sh.skv;
    const int first = min(n, (lo - item.kv_lo) / kBlockN);
    const int last = min(n, (hi - item.kv_lo + kBlockN - 1) / kBlockN);
    const int n_act = max(0, last - first);
#pragma unroll
    for (int j = 0; j < C::kAcc; ++j) acc[j] = 0.f;
    m_run[0] = m_run[1] = kNegInf;
    l_run[0] = l_run[1] = 0.f;
    mbar_wait(q_full(i), (i / 2) & 1);
    const uint32_t qt = q_tile(i, wg);

    for (int t = 0; t < first; ++t) pass(g + t);
    int gt = g + first;  // the global index of the next active tile
    for (int t = 0; t < n_act; ++t, ++gt) {
      mbar_wait(k_full(gt % kStages), parity(gt));
      issue_qk<D>(s, qt, k_tile(gt % kStages));
      wg_wait_all();
      fence_regs(s);
      release(k_full(gt % kStages));
      softmax_tile(s, pa, m_run, l_run, corr,
                   item.kv_lo + (first + t) * kBlockN, qw, row, col,
                   sh.skv, sh.causal, sh.window, scale_log2);
#pragma unroll
      for (int j = 0; j < C::kDP / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[4 * j + 2 * r] *= corr[r];
          acc[4 * j + 2 * r + 1] *= corr[r];
        }
      }
      mbar_wait(v_full(gt % kStages), parity(gt));
      issue_pv<C::kDP>(acc, pa, v_tile(gt % kStages));
      wg_wait_all();
      fence_regs(acc);
      release(v_full(gt % kStages));
    }
    for (int t = first + n_act; t < n; ++t) pass(g + t);
    g += n;

    // epilogue: O / l in bf16 into this warpgroup's Q tile (no longer
    // read), in the TMA box layout with the 128-byte swizzle (16-byte
    // chunk k of row r at chunk k ^ (r % 8): the warp's stores hit 32
    // distinct banks), then one thread stores the boxes with TMA, which
    // drops rows past Sq and D 112's padded columns
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int rr = row + 8 * r;
      // the row's natural-log logsumexp for the backward, when asked (m
      // is the raw-score max)
      if (lse != nullptr && lane % 4 == 0 && qw + rr < sh.sq)
        lse[((long long)item.b * sh.hq + hw) * sh.sq + qw + rr] =
            l > 0.f ? fmaf(m_run[r], scale, logf(l)) : INFINITY;
#pragma unroll
      for (int j = 0; j < C::kDP / 8; ++j) {
        const uint32_t at = qt + (j / 8) * kBoxBytes + rr * kRowBytes +
                            (((j % 8) ^ (rr % 8)) * 16) + col * 2;
        const uint32_t v = pack_bf16(acc[4 * j + 2 * r] * inv,
                                     acc[4 * j + 2 * r + 1] * inv);
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(at), "r"(v)
                     : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    if (signal) {
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x)
        tma_store(&to, qt + x * kBoxBytes, x * kBox, qw, hw, item.b, po);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      release(q_full(i));  // the tile may take the item after next's Q
    }
  }
}

// ------------------------------------------------ bf16 at D 64: 128 keys

// At D 64 a key tile's softmax weighs as much as its two products (a
// 64 x 64 score tile: 4,096 exponentials a warpgroup, 256 clocks of the
// SM's 16 a clock, against 2 x 64^3 multiply-adds, 256 clocks at the bf16
// peak), and what a tile costs beyond its arithmetic (the row max and its
// two shuffles, the factor, rescaling O, the barrier waits, the wgmma
// issue and its latency) is paid per tile. flash_fwd64_tc keeps
// flash_fwd_tc's items, producer, ring and epilogue but takes 128 keys a
// tile: S = Q K^T is one m64n128k16 product a k-step (K's two 64-row
// boxes adjacent in shared memory form one 128-row operand), the softmax
// runs over the row's 32 columns a thread at once, and O += P V takes 8
// k-steps of 16 keys. 64 + 32 + 32 floats a thread (S, P's fragments,
// O) fit beside the addresses under the 168 registers of 288 threads.
//
// Long non-causal rows where the card's 132 SMs quantise the items badly
// (the host's choice, kSplit): an item is 64 rows of one head,
// warpgroup c takes the key tiles t with t % 2 == c, and warpgroup 1
// hands its (m, l, O) to warpgroup 0 through shared memory, which merges
// them in a fixed order (m = max(m0, m1), each part scaled by
// 2^((m_c - m) c)) before the epilogue. At whisper-tiny's encoder (24
// heads x 1,500 rows) that is 576 items of half the work in 5 rounds
// instead of 288 in 3.
constexpr int kKeys64 = 128;  // keys of a D 64 tile

struct Cfg64 {
  static constexpr int kQTile = kBoxBytes;       // 64 rows of Q, 8 KB
  static constexpr int kKvTile = 2 * kBoxBytes;  // 128 keys of K or V
  static constexpr int kStages = 4;              // K/V ring depth
  // barriers: full then empty, for Q[2], K[kStages], V[kStages]
  static constexpr int kBars = 2 * (2 + 2 * kStages);
  // warpgroup 1's part of a split item: m[2], l[2], O[32] a thread
  static constexpr int kMerge = 36 * 128 * 4;
  static constexpr int kSmem = 1024 + 2 * kConsumers * kQTile +
                               2 * kStages * kKvTile + kMerge + 8 * kBars;
};

// Named barriers of a split item's hand-over (1 and 2 are the epilogue's).
constexpr int kBarMerge = 3;  // warpgroup 1's part is in shared memory
constexpr int kBarFree = 4;   // warpgroup 0 has read it

#define FA_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// S[64 x 128] (+)= Q[64 x 16] K[128 x 16]^T, both K-major in shared
// memory.
__device__ __forceinline__ void wgmma_qk128(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1, 0, 0;\n"
      "}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32), FA_D8(40),
        FA_D8(48), FA_D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef FA_D8

// An item of flash_fwd64_tc: item_at's rows and heads (64 rows of one head
// when split); every row sees all Skv keys, in 128-key tiles.
template <bool kSplit>
__device__ __forceinline__ Item item64_at(int w, const Shape& sh) {
  const int heads = sh.pair_heads ? sh.hq / 2 : sh.hq;
  const int per = heads * sh.batch;
  Item it;
  it.span = sh.pair_heads || kSplit ? kRows : kRows * kConsumers;
  it.q0 = (sh.n_qt - 1 - w / per) * it.span;
  it.h = ((w % per) % heads) * (sh.pair_heads ? 2 : 1);
  it.b = (w % per) / heads;
  it.n = (sh.skv + kKeys64 - 1) / kKeys64;
  return it;
}

// x[0] = the max (kMax) or the sum of x[0..15] by a pairwise tree, its
// levels written out so that x stays in registers.
template <bool kMax>
__device__ __forceinline__ void tree16(float (&x)[16]) {
  auto op = [](float a, float b) { return kMax ? fmaxf(a, b) : a + b; };
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = op(x[j], x[j + 8]);
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = op(x[j], x[j + 4]);
#pragma unroll
  for (int j = 0; j < 2; ++j) x[j] = op(x[j], x[j + 2]);
  x[0] = op(x[0], x[1]);
}

// softmax_tile over a 128-key tile (keys t0..t0+127): keys past Skv
// masked and, with kCausal, keys past each row (rows qw + row and qw + row
// + 8 of the warpgroup's first row qw) on a tile that crosses the
// diagonal; the same online update, the row max over the thread's 32
// columns by a pairwise tree, P's bf16 A fragments for 8 k-steps (k-step
// kk: columns of j = 2 kk and 2 kk + 1).
template <bool kCausal = false>
__device__ __forceinline__ void softmax_tile128(
    float (&s)[64], uint32_t (&pf)[32], float (&m_run)[2], float (&l_run)[2],
    float (&corr)[2], int t0, int col, int skv, float scale_log2, int qw = 0,
    int row = 0) {
  if constexpr (kCausal) {
    if (t0 + kKeys64 > skv || t0 + kKeys64 - 1 > qw) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kj = t0 + 8 * j + col + c;
            if (kj >= skv || kj > qw + row + 8 * i)
              s[4 * j + 2 * i + c] = kNegInf;
          }
    }
  } else if (t0 + kKeys64 > skv) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (t0 + 8 * j + col + c >= skv)
          s[4 * j + c] = s[4 * j + 2 + c] = kNegInf;
  }
  float neg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      mx[j] = fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]);
    tree16<true>(mx);
    float m = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float m_new = fmaxf(m_run[i], m);
    corr[i] = ex2((m_run[i] - m_new) * scale_log2);
    neg[i] = m_new == kNegInf ? 0.f : -m_new * scale_log2;
    m_run[i] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float ps[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float& x0 = s[4 * j + 2 * i];
      float& x1 = s[4 * j + 2 * i + 1];
      x0 = ex2(fmaf(x0, scale_log2, neg[i]));
      x1 = ex2(fmaf(x1, scale_log2, neg[i]));
      ps[j] = x0 + x1;
    }
    tree16<false>(ps);
    l_run[i] = l_run[i] * corr[i] + ps[0];
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pf[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pf[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pf[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pf[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd64_tc(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap to, Shape sh, Perm pq,
               Perm pk, Perm pv, Perm po, float scale_log2, float* lse,
               float scale) {
  using C = Cfg64;
  constexpr int kSt = C::kStages;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t kv_base = base + 2 * kConsumers * C::kQTile;
  const uint32_t merge = kv_base + 2 * kSt * C::kKvTile;
  const uint32_t bars = merge + C::kMerge;
  float* const mbuf =
      reinterpret_cast<float*>(smem + (merge - smem_u32(smem)));
  auto q_tile = [&](int i, int c) {
    return base + C::kQTile * ((i & 1) * kConsumers + c);
  };
  auto k_tile = [&](int st) { return kv_base + C::kKvTile * st; };
  auto v_tile = [&](int st) { return kv_base + C::kKvTile * (kSt + st); };
  auto q_full = [&](int i) { return bars + 8 * (i & 1); };
  auto k_full = [&](int st) { return bars + 8 * (2 + st); };
  auto v_full = [&](int st) { return bars + 8 * (2 + kSt + st); };
  constexpr int kEmpty = 8 * (2 + 2 * kSt);
  auto parity = [](int g) { return (uint32_t)((g / kSt) & 1); };

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
      const Item it = item64_at<kSplit>(item_of_round(i), sh);
      const int hk = it.h / sh.group;
      const int n_q = kSplit ? 1 : kConsumers;  // a split item's one Q
      mbar_wait(q_full(i) + kEmpty, ((i / 2) & 1) ^ 1);
      mbar_expect(q_full(i), n_q * C::kQTile);
      for (int c = 0; c < n_q; ++c)
        tma_load(q_tile(i, c), &tq, q_full(i), 0, rows_of(it, sh, c),
                 head_of(it, sh, c), it.b, pq);
      for (int t = 0; t < it.n; ++t, ++g) {
        const int st = g % kSt, t0 = t * kKeys64;
        // a second box wholly past Skv arrives as zeros
        mbar_wait(k_full(st) + kEmpty, parity(g) ^ 1);
        mbar_expect(k_full(st), C::kKvTile);
        for (int x = 0; x < 2; ++x)
          tma_load(k_tile(st) + x * kBoxBytes, &tk, k_full(st), 0,
                   t0 + kBox * x, hk, it.b, pk);
        mbar_wait(v_full(st) + kEmpty, parity(g) ^ 1);
        mbar_expect(v_full(st), C::kKvTile);
        for (int x = 0; x < 2; ++x)
          tma_load(v_tile(st) + x * kBoxBytes, &tv, v_full(st), 0,
                   t0 + kBox * x, hk, it.b, pv);
      }
    }
    return;
  }

  const int wg = warp / 4, t128 = tid % 128;
  float acc[32];
  float s[64];
  float m_run[2], l_run[2], corr[2];
  uint32_t pa[32];
  const int row = 16 * (warp % 4) + lane / 4;  // rows row, row + 8
  const int col = 2 * (lane % 4);              // columns col, col + 1 of 8
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  const bool signal = t128 == 0;
  auto release = [&](uint32_t full_bar) {
    if (signal) mbar_arrive(full_bar + kEmpty);
  };
  auto pass = [&](int g) {
    const int st = g % kSt;
    mbar_wait(k_full(st), parity(g));
    release(k_full(st));
    mbar_wait(v_full(st), parity(g));
    release(v_full(st));
  };

  int g = 0;       // the CTA's K/V tiles consumed so far
  int handed = 0;  // split items warpgroup 1 has handed over
  for (int i = 0; item_of_round(i) < sh.n_items; ++i) {
    const Item item = item64_at<kSplit>(item_of_round(i), sh);
    const int qw = kSplit ? item.q0 : rows_of(item, sh, wg);
    const int hw = kSplit ? item.h : head_of(item, sh, wg);
    const int n = item.n;
    const int last = qw >= sh.sq ? 0 : n;  // no tile if rows start past Sq
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.f;
    m_run[0] = m_run[1] = kNegInf;
    l_run[0] = l_run[1] = 0.f;
    mbar_wait(q_full(i), (i / 2) & 1);
    const uint32_t qt = q_tile(i, kSplit ? 0 : wg);

    // this warpgroup's tiles: tb, tb + step, ... below last (in a split
    // item the other warpgroup's tiles lie between them)
    const int step = kSplit ? 2 : 1;
    const int tb = kSplit ? wg : 0;
    int t = 0;
    for (; t < min(tb, n); ++t) pass(g + t);
    for (t = tb; t < last; t += step) {
      if (kSplit && t > tb) pass(g + t - 1);
      const int gt = g + t, st = gt % kSt;
      mbar_wait(k_full(st), parity(gt));
      // S = Q K^T over the tile's 128 keys
      fence_regs(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_qk128(s, sw128_desc(qt + kk * 32, 16, kAtomBytes),
                    sw128_desc(k_tile(st) + kk * 32, 16, kAtomBytes),
                    kk > 0);
      wg_commit();
      wg_wait_all();
      fence_regs(s);
      release(k_full(st));
      softmax_tile128(s, pa, m_run, l_run, corr, t * kKeys64, col, sh.skv,
                      scale_log2);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[4 * j + 2 * r] *= corr[r];
          acc[4 * j + 2 * r + 1] *= corr[r];
        }
      // O += P V: 16 keys (two swizzle atoms of V's rows) a k-step
      mbar_wait(v_full(st), parity(gt));
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys64 / 16; ++kk)
        wgmma_pv<64>(acc, pa + 4 * kk,
                     sw128_desc(v_tile(st) + kk * 2 * kAtomBytes, kBoxBytes,
                                kAtomBytes));
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
      release(v_full(st));
    }
    if (tb < last) t = tb + (last - 1 - tb) / step * step + 1;
    for (; t < n; ++t) pass(g + t);
    g += n;

    if (kSplit) {  // warpgroup 1 hands (m, l, O) over; 0 merges
      if (wg == 1) {
        if (handed > 0) named_sync(kBarFree, 2 * 128);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mbuf[r * 128 + t128] = m_run[r];
          mbuf[(2 + r) * 128 + t128] = l_run[r];
        }
#pragma unroll
        for (int j = 0; j < 32; ++j) mbuf[(4 + j) * 128 + t128] = acc[j];
        named_arrive(kBarMerge, 2 * 128);
        ++handed;
        release(q_full(i));  // warpgroup 0 stores O through this Q tile
        continue;
      }
      named_sync(kBarMerge, 2 * 128);
      float a0[2], a1[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = mbuf[r * 128 + t128];
        const float m = fmaxf(m_run[r], m1);
        a0[r] = ex2((m_run[r] - m) * scale_log2);
        a1[r] = ex2((m1 - m) * scale_log2);
        l_run[r] = l_run[r] * a0[r] + mbuf[(2 + r) * 128 + t128] * a1[r];
        m_run[r] = m;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * r + c;
            acc[e] = acc[e] * a0[r] + mbuf[(4 + e) * 128 + t128] * a1[r];
          }
      named_arrive(kBarFree, 2 * 128);
    }

    // epilogue, as flash_fwd_tc's: O / l in bf16 into the Q tile, stored
    // with TMA (rows past Sq dropped); the row's logsumexp when asked
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int rr = row + 8 * r;
      if (lse != nullptr && lane % 4 == 0 && qw + rr < sh.sq)
        lse[((long long)item.b * sh.hq + hw) * sh.sq + qw + rr] =
            l > 0.f ? fmaf(m_run[r], scale, logf(l)) : INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t at =
            qt + rr * kRowBytes + (((j % 8) ^ (rr % 8)) * 16) + col * 2;
        const uint32_t v = pack_bf16(acc[4 * j + 2 * r] * inv,
                                     acc[4 * j + 2 * r + 1] * inv);
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(at), "r"(v)
                     : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    if (signal) {
      tma_store(&to, qt, 0, qw, hw, item.b, po);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      release(q_full(i));  // the tile may take the item after next's Q
    }
  }
  // balance the hand-over barrier: warpgroup 0 freed the last part too
  if (kSplit && wg == 1 && handed > 0) named_sync(kBarFree, 2 * 128);
}

// ------------------------------------------------ bf16 at D 128: 128 keys

// At D 128 flash_fwd_tc runs under the 168 registers ptxas grants a thread
// of a 288-thread CTA, which holds it to 64-key tiles: S is eight
// m64n64k16 products a tile with both operands from shared memory (128
// bytes a clock, all the SM has), and every tile pays the row max, the
// factor, O's rescaling and the barrier waits for 64 keys. Rows that see
// every key (no causal limit, no window; the VLM's cross-attention, q
// [4, 32, 512, 128] over k/v [4, 8, 1,600, 128]) go to flash_fwd128_tc
// instead:
// * 384 threads: two consumer warpgroups and a producer warpgroup, whose
//   one elected thread issues every TMA copy as flash_fwd_tc's producer
//   warp does. setmaxnreg moves registers from the producer warpgroup (40
//   a thread) to the consumers (232 a thread; 168 each at launch). It has
//   to be a whole warpgroup: setmaxnreg is executed by all four warps of
//   one (.sync.aligned), and .inc waits for registers that .dec has
//   returned to the pool.
// * flash_fwd_tc's items (64 rows a warpgroup of heads 2p and 2p + 1 when
//   the group is even, else rows q0 and q0 + 64 of one head; at the cross
//   shape 512 items on 132 CTAs, 4 rounds) over 128-key tiles (13 at
//   Skv 1,600, the last one half past Skv, masked).
// * S = Q K^T is eight m64n128k16 products a tile (K's two 64-key boxes of
//   each 64-column half adjacent in shared memory form one 128-row
//   operand: 6 KB of operands per 64 clocks), the softmax of
//   softmax_tile128 (P packed to bf16 as it is formed), O += P V eight
//   m64n128k16 products with P from registers and V read MN-major (4 KB
//   per 64 clocks): with the fills (64 KB a tile for both warpgroups) ~96
//   of the SM's 128 bytes of shared memory a clock at the tensor peak.
// * Registers a consumer thread: S 64, O 64, P 32, m, l and the factors 6
//   (ptxas: 168 at launch, no spill).
// * A ring of two K and V stages (64 KB each); Q double-buffered across
//   items (197,728 bytes of shared memory); the epilogue as flash_fwd_tc's
//   (O / l into the Q tile, TMA store, the logsumexp when asked).
//
// Causal rows of unpaired heads (an odd group, no window: codeqwen1.5-7b's
// MHA, q and k/v [4, 32, 512, 128], and zamba2-7b's at D 112, whose maps
// pad it to 128 columns of zeros as flash_fwd_tc<112>'s do) go to
// flash_fwd128_tc<true>. There flash_fwd_tc<128> lost to three things:
// its items (rows q0 and q0 + 64 of one head over 64-key tiles) left
// warpgroup 0 waiting out each item's last tile, 20 tile-steps on the
// busiest CTA, 4 of them half idle; its items ran longest first, so round
// 0 read all 33.5 MB of K/V from memory at once; and 168 registers held
// it to 64-key tiles. The causal variant, the same code otherwise:
// * Items: rows q0 .. q0 + 127 of one (batch, head) over its keys [0,
//   min(Skv, q0 + 128)) in 128-key tiles, 1-4 at Sq 512; both warpgroups
//   see every tile of an item, and only its last tile (the diagonal, or
//   the one that ends past Skv) is masked: warpgroup 0's second half of it
//   wholly. 512 items at codeqwen's shape.
// * Rounds: item w is row block w / chains of chain (batch, head) w %
//   chains, and CTA c takes items c, c + G, c + 2 G, ...: round r runs row
//   block r of (nearly) every chain, so each round reads Q and one new
//   128-key tile of each head from memory and the tiles before it from L2.
//   4 rounds; the busiest CTA takes 10 tiles (9.7 on average, 20 the
//   parent's 64-key steps).
// * L2: the K/V loads ask to keep their lines (evict_last: later rounds
//   read them again), Q's loads and O's stores to lose theirs first (each
//   touched once).
// * Registers, ring, shared memory per clock and epilogue as above (ptxas:
//   168 at launch, no spill).
constexpr int kThreads3 = kConsumerThreads + 128;  // and a producer warpgroup

// The items of flash_fwd128_tc<kCausal> and the one a CTA takes in round
// r. Rows that see every key: item64_at's, by item_of_round. Causal rows
// of unpaired heads: item w is rows q0 = 128 (w / chains) .. q0 + 127 of
// chain (batch, head) w % chains over its keys [0, min(Skv, q0 + 128)),
// and CTA c takes items c, c + G, c + 2 G, ... (G CTAs).
template <bool kCausal>
__device__ __forceinline__ Item item128_at(int w, const Shape& sh) {
  if constexpr (!kCausal) {
    return item64_at<false>(w, sh);
  } else {
    const int chains = sh.hq * sh.batch;
    Item it;
    it.span = kRows * kConsumers;
    it.q0 = w / chains * it.span;
    it.h = w % chains % sh.hq;
    it.b = w % chains / sh.hq;
    it.kv_lo = 0;
    it.n = (min(sh.skv, it.q0 + it.span) + kKeys64 - 1) / kKeys64;
    return it;
  }
}

template <bool kCausal>
__device__ __forceinline__ int item128_of_round(int r) {
  if constexpr (kCausal)
    return r * gridDim.x + blockIdx.x;
  else
    return item_of_round(r);
}

struct Cfg128 {
  static constexpr int kQTile = 2 * kBoxBytes;   // 64 rows x 128 columns
  static constexpr int kKvTile = 4 * kBoxBytes;  // 128 keys of K or V
  static constexpr int kStages = 2;              // K/V ring depth
  // barriers: full then empty, for Q[2], K[kStages], V[kStages]
  static constexpr int kBars = 2 * (2 + 2 * kStages);
  static constexpr int kSmem = 1024 + 2 * kConsumers * kQTile +
                               2 * kStages * kKvTile + 8 * kBars;
};

template <bool kCausal>
__global__ void __launch_bounds__(kThreads3, 1)
flash_fwd128_tc(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap to, Shape sh, Perm pq,
                Perm pk, Perm pv, Perm po, float scale_log2, float* lse,
                float scale) {
  using C = Cfg128;
  constexpr int kSt = C::kStages;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t kv_base = base + 2 * kConsumers * C::kQTile;
  const uint32_t bars = kv_base + 2 * kSt * C::kKvTile;
  auto q_tile = [&](int i, int c) {
    return base + C::kQTile * ((i & 1) * kConsumers + c);
  };
  // K: box (column half x, key half h) at 2 x + h, so each column half's
  // 128 keys are one operand; V: box (h, x) at 2 h + x, so a 16-key k-step
  // reads both column halves a box apart
  auto k_tile = [&](int st) { return kv_base + C::kKvTile * st; };
  auto v_tile = [&](int st) { return kv_base + C::kKvTile * (kSt + st); };
  auto q_full = [&](int i) { return bars + 8 * (i & 1); };
  auto k_full = [&](int st) { return bars + 8 * (2 + st); };
  auto v_full = [&](int st) { return bars + 8 * (2 + kSt + st); };
  constexpr int kEmpty = 8 * (2 + 2 * kSt);
  auto parity = [](int g) { return (uint32_t)((g / kSt) & 1); };

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

  if (warp >= kConsumers * 4) {  // the producer warpgroup: one thread copies
    regs_dec<kProducerRegs>();
    if (warp != kConsumers * 4 || lane != 0) return;
    // causal rows: later rounds re-read each head's K/V tiles from L2 and
    // Q is read once, so K/V's lines are kept past others and Q's go first
    uint64_t keep = 0, drop = 0;
    if constexpr (kCausal) {
      keep = policy_evict_last();
      drop = policy_evict_first();
    }
    auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar,
                    int col, int s, int h, int b, Perm p, uint64_t policy) {
      if constexpr (kCausal)
        tma_load_hint(dst, map, bar, col, s, h, b, p, policy);
      else
        tma_load(dst, map, bar, col, s, h, b, p);
    };
    int g = 0;
    for (int i = 0; item128_of_round<kCausal>(i) < sh.n_items; ++i) {
      const Item it = item128_at<kCausal>(item128_of_round<kCausal>(i), sh);
      const int hk = it.h / sh.group;
      mbar_wait(q_full(i) + kEmpty, ((i / 2) & 1) ^ 1);
      mbar_expect(q_full(i), kConsumers * C::kQTile);
      for (int c = 0; c < kConsumers; ++c)
#pragma unroll
        for (int x = 0; x < 2; ++x)
          load(q_tile(i, c) + x * kBoxBytes, &tq, q_full(i), x * kBox,
               rows_of(it, sh, c), head_of(it, sh, c), it.b, pq, drop);
      for (int t = 0; t < it.n; ++t, ++g) {
        const int st = g % kSt, t0 = t * kKeys64;
        // a second key box wholly past Skv arrives as zeros
        mbar_wait(k_full(st) + kEmpty, parity(g) ^ 1);
        mbar_expect(k_full(st), C::kKvTile);
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            load(k_tile(st) + (2 * x + h) * kBoxBytes, &tk, k_full(st),
                 x * kBox, t0 + kBox * h, hk, it.b, pk, keep);
        mbar_wait(v_full(st) + kEmpty, parity(g) ^ 1);
        mbar_expect(v_full(st), C::kKvTile);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int x = 0; x < 2; ++x)
            load(v_tile(st) + (2 * h + x) * kBoxBytes, &tv, v_full(st),
                 x * kBox, t0 + kBox * h, hk, it.b, pv, keep);
      }
    }
    return;
  }
  regs_inc<kConsumerRegs>();

  const int wg = warp / 4;
  const bool signal = tid % 128 == 0;
  float acc[64];
  float s[64];
  float m_run[2], l_run[2], corr[2];
  uint32_t pa[32];
  const int row = 16 * (warp % 4) + lane / 4;  // rows row, row + 8
  const int col = 2 * (lane % 4);              // columns col, col + 1 of 8
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  auto release = [&](uint32_t full_bar) {
    if (signal) mbar_arrive(full_bar + kEmpty);
  };

  int g = 0;  // the CTA's K/V tiles consumed so far
  for (int i = 0; item128_of_round<kCausal>(i) < sh.n_items; ++i) {
    const Item item =
        item128_at<kCausal>(item128_of_round<kCausal>(i), sh);
    const int qw = rows_of(item, sh, wg), hw = head_of(item, sh, wg);
    const bool live = qw < sh.sq;  // no tile if the rows start past Sq
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.f;
    m_run[0] = m_run[1] = kNegInf;
    l_run[0] = l_run[1] = 0.f;
    mbar_wait(q_full(i), (i / 2) & 1);
    const uint32_t qt = q_tile(i, wg);

    for (int t = 0; t < item.n; ++t, ++g) {
      const int st = g % kSt;
      mbar_wait(k_full(st), parity(g));
      if (live) {
        // S = Q K^T over the tile's 128 keys: k-step kk reads 16 columns
        // of Q's and K's column half kk / 4
        fence_regs(s);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_qk128(
              s,
              sw128_desc(qt + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16,
                         kAtomBytes),
              sw128_desc(k_tile(st) + (kk / 4) * 2 * kBoxBytes +
                             (kk % 4) * 32,
                         16, kAtomBytes),
              kk > 0);
        wg_commit();
        wg_wait_all();
        fence_regs(s);
      }
      release(k_full(st));
      if (live) {
        softmax_tile128<kCausal>(s, pa, m_run, l_run, corr, t * kKeys64,
                                 col, sh.skv, scale_log2, qw, row);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            acc[4 * j + 2 * r] *= corr[r];
            acc[4 * j + 2 * r + 1] *= corr[r];
          }
      }
      mbar_wait(v_full(st), parity(g));
      if (live) {
        // O += P V: 16 keys (two swizzle atoms of V's rows) a k-step; the
        // second column half is a box further on
        fence_regs(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kKeys64 / 16; ++kk)
          wgmma_pv<128>(acc, pa + 4 * kk,
                        sw128_desc(v_tile(st) + (kk / 4) * 2 * kBoxBytes +
                                       (kk % 4) * 2 * kAtomBytes,
                                   kBoxBytes, kAtomBytes));
        wg_commit();
        wg_wait_all();
        fence_regs(acc);
      }
      release(v_full(st));
    }

    // epilogue, as flash_fwd_tc's: O / l in bf16 into the Q tile, stored
    // with TMA (rows past Sq dropped); the row's logsumexp when asked
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int rr = row + 8 * r;
      if (lse != nullptr && lane % 4 == 0 && qw + rr < sh.sq)
        lse[((long long)item.b * sh.hq + hw) * sh.sq + qw + rr] =
            l > 0.f ? fmaf(m_run[r], scale, logf(l)) : INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t at = qt + (j / 8) * kBoxBytes + rr * kRowBytes +
                            (((j % 8) ^ (rr % 8)) * 16) + col * 2;
        const uint32_t v = pack_bf16(acc[4 * j + 2 * r] * inv,
                                     acc[4 * j + 2 * r + 1] * inv);
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(at), "r"(v)
                     : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1 + wg, 128);
    if (signal) {
#pragma unroll
      for (int x = 0; x < 2; ++x)
        if constexpr (kCausal)  // written once: its lines go first
          tma_store_hint(&to, qt + x * kBoxBytes, x * kBox, qw, hw, item.b,
                         po, policy_evict_first());
        else
          tma_store(&to, qt + x * kBoxBytes, x * kBox, qw, hw, item.b, po);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      release(q_full(i));  // the tile may take the item after next's Q
    }
  }
}

// The grid: as many CTAs of ``kernel`` as are resident on the card at once
// (all of L1 as shared memory).
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

// D 64: flash_fwd64_tc. Long non-causal rows of unpaired heads split
// their keys between the two warpgroups where that takes fewer item-times
// on the resident grid (rounds of half an item against rounds of a whole
// one); the choice depends on the shape alone, so reruns are bitwise.
int launch64(const void* q, const void* k, const void* v, void* o,
             float* lse, int batch, int hq, int hkv, int sq, int skv,
             Strides qs, Strides ks, Strides vs, Strides os, float scale,
             cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  Perm pq, pk, pv, po;
  int err = make_map(&tq, &pq, q, 64, sq, hq, batch, qs);
  if (!err) err = make_map(&tk, &pk, k, 64, skv, hkv, batch, ks);
  if (!err) err = make_map(&tv, &pv, v, 64, skv, hkv, batch, vs);
  if (!err) err = make_map(&to, &po, o, 64, sq, hq, batch, os);
  static int resident = 0, resident_split = 0;
  if (!err)
    err = resident_ctas(flash_fwd64_tc<false>, Cfg64::kSmem, &resident);
  if (!err)
    err = resident_ctas(flash_fwd64_tc<true>, Cfg64::kSmem, &resident_split);
  if (err) return err;
  Shape sh{sq, skv, hq, batch, hq / hkv, 0, 0,
           (hq / hkv) % 2 == 0 ? 1 : 0, 0, 0};
  bool split = false;
  if (!sh.pair_heads && skv > kKeys64) {
    const long long whole = (long long)((sq + 2 * kRows - 1) / (2 * kRows)) *
                            hq * batch;
    const long long half = (long long)((sq + kRows - 1) / kRows) * hq * batch;
    split = (half + resident - 1) / resident <
            2 * ((whole + resident - 1) / resident);
  }
  const int span = sh.pair_heads || split ? kRows : kRows * kConsumers;
  sh.n_qt = (sq + span - 1) / span;
  sh.n_items = sh.n_qt * (sh.pair_heads ? hq / 2 : hq) * batch;
  const float scale_log2 = scale * 1.4426950408889634f;
  if (split)
    flash_fwd64_tc<true><<<min(resident_split, sh.n_items), kThreads,
                           Cfg64::kSmem, stream>>>(
        tq, tk, tv, to, sh, pq, pk, pv, po, scale_log2, lse, scale);
  else
    flash_fwd64_tc<false><<<min(resident, sh.n_items), kThreads,
                            Cfg64::kSmem, stream>>>(
        tq, tk, tv, to, sh, pq, pk, pv, po, scale_log2, lse, scale);
  return 0;
}

// D 128 (or D 112, padded to it as flash_fwd_tc<112> pads), rows that see
// every key or causal rows of unpaired heads: flash_fwd128_tc.
int launch128(int d, const void* q, const void* k, const void* v, void* o,
              float* lse, int batch, int hq, int hkv, int sq, int skv,
              Strides qs, Strides ks, Strides vs, Strides os, int causal,
              float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  Perm pq, pk, pv, po;
  int err = make_map(&tq, &pq, q, d, sq, hq, batch, qs);
  if (!err) err = make_map(&tk, &pk, k, d, skv, hkv, batch, ks);
  if (!err) err = make_map(&tv, &pv, v, d, skv, hkv, batch, vs);
  if (!err) err = make_map(&to, &po, o, d, sq, hq, batch, os);
  static int resident = 0, resident_causal = 0;
  if (!err)
    err = resident_ctas(flash_fwd128_tc<false>, Cfg128::kSmem, &resident,
                        kThreads3);
  if (!err)
    err = resident_ctas(flash_fwd128_tc<true>, Cfg128::kSmem,
                        &resident_causal, kThreads3);
  if (err) return err;
  Shape sh{sq, skv, hq, batch, hq / hkv, causal, 0,
           (hq / hkv) % 2 == 0 ? 1 : 0, 0, 0};
  if (causal && sh.pair_heads) return (int)cudaErrorInvalidValue;
  const int span = sh.pair_heads ? kRows : kRows * kConsumers;
  sh.n_qt = (sq + span - 1) / span;
  sh.n_items = sh.n_qt * (sh.pair_heads ? hq / 2 : hq) * batch;
  const float scale_log2 = scale * 1.4426950408889634f;
  if (causal)
    flash_fwd128_tc<true><<<min(resident_causal, sh.n_items), kThreads3,
                            Cfg128::kSmem, stream>>>(
        tq, tk, tv, to, sh, pq, pk, pv, po, scale_log2, lse, scale);
  else
    flash_fwd128_tc<false><<<min(resident, sh.n_items), kThreads3,
                             Cfg128::kSmem, stream>>>(
        tq, tk, tv, to, sh, pq, pk, pv, po, scale_log2, lse, scale);
  return 0;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int hq, int hkv, int sq, int skv, Strides qs,
           Strides ks, Strides vs, Strides os, int causal, int window,
           float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv, to;
  Perm pq, pk, pv, po;
  int err = make_map(&tq, &pq, q, D, sq, hq, batch, qs);
  if (!err) err = make_map(&tk, &pk, k, D, skv, hkv, batch, ks);
  if (!err) err = make_map(&tv, &pv, v, D, skv, hkv, batch, vs);
  if (!err) err = make_map(&to, &po, o, D, sq, hq, batch, os);
  if (err) return err;
  // the grid: as many CTAs as are resident on the card at once
  static int resident = 0;
  if (resident == 0) {
    int dev, sms, per_sm;
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmem);
    if (e == cudaSuccess)  // all of L1 as shared memory
      e = cudaFuncSetAttribute(flash_fwd_tc<D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, flash_fwd_tc<D>, kThreads, C::kSmem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
  }
  Shape sh{sq, skv, hq, batch, hq / hkv, causal, window,
           (hq / hkv) % 2 == 0 ? 1 : 0, 0, 0};
  const int span = sh.pair_heads ? kRows : kRows * kConsumers;
  sh.n_qt = (sq + span - 1) / span;
  sh.n_items = sh.n_qt * (sh.pair_heads ? hq / 2 : hq) * batch;
  flash_fwd_tc<D><<<min(resident, sh.n_items), kThreads, C::kSmem, stream>>>(
      tq, tk, tv, to, sh, pq, pk, pv, po, scale * 1.4426950408889634f, lse,
      scale);
  return 0;
}

}  // namespace tc

int launch_f32(int d, const void* q, const void* k, const void* v, void* o,
               float* lse, int batch, int hq, int sq, int skv, int group,
               Strides qs, Strides ks, Strides vs, Strides os, int causal,
               int window, float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      launch<float, 32>(q, k, v, o, lse, batch, hq, sq, skv, group, qs, ks,
                        vs, os, causal, window, scale, stream);
      return 0;
    case 64:
      launch<float, 64>(q, k, v, o, lse, batch, hq, sq, skv, group, qs, ks,
                        vs, os, causal, window, scale, stream);
      return 0;
    case 112:  // zamba2's shared attention: 28 float4 chunks, 7 a lane
      launch<float, 112>(q, k, v, o, lse, batch, hq, sq, skv, group, qs, ks,
                         vs, os, causal, window, scale, stream);
      return 0;
    case 128:
      launch<float, 128>(q, k, v, o, lse, batch, hq, sq, skv, group, qs, ks,
                         vs, os, causal, window, scale, stream);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int launch_bf16(int d, const void* q, const void* k, const void* v, void* o,
                float* lse, int batch, int hq, int hkv, int sq, int skv,
                Strides qs, Strides ks, Strides vs, Strides os, int causal,
                int window, float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return tc::launch<32>(q, k, v, o, lse, batch, hq, hkv, sq, skv, qs, ks,
                            vs, os, causal, window, scale, stream);
    case 64:  // whisper-tiny's width: 128-key tiles for rows that see
              // every key; causal and windowed rows keep 64-key tiles,
              // which mask less
      if (causal || window)
        return tc::launch<64>(q, k, v, o, lse, batch, hq, hkv, sq, skv, qs,
                              ks, vs, os, causal, window, scale, stream);
      return tc::launch64(q, k, v, o, lse, batch, hq, hkv, sq, skv, qs, ks,
                          vs, os, scale, stream);
    case 112:  // zamba2's shared attention: padded to two 64-column boxes;
               // causal rows of unpaired heads as at D 128
      if (causal && !window && (hq / hkv) % 2)
        return tc::launch128(112, q, k, v, o, lse, batch, hq, hkv, sq, skv,
                             qs, ks, vs, os, 1, scale, stream);
      return tc::launch<112>(q, k, v, o, lse, batch, hq, hkv, sq, skv, qs,
                             ks, vs, os, causal, window, scale, stream);
    case 128:  // 128-key tiles (flash_fwd128_tc) for rows that see every
               // key and for causal rows of unpaired heads (codeqwen's
               // MHA); windowed rows and causal GQA pairs keep 64-key
               // tiles (flash_fwd_tc<128>)
      if (!window && (!causal || (hq / hkv) % 2))
        return tc::launch128(128, q, k, v, o, lse, batch, hq, hkv, sq, skv,
                             qs, ks, vs, os, causal, scale, stream);
      return tc::launch<128>(q, k, v, o, lse, batch, hq, hkv, sq, skv, qs,
                             ks, vs, os, causal, window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (tensor-core kernel); d in
// {32, 64, 112, 128}. Strides are in elements, ordered (batch, seq, head)
// for each of q, k, v, o; the last dimension is contiguous. For bf16 the
// q, k, v base addresses are 16-byte aligned and their strides multiples
// of 8 elements (the tensor maps' rule; the wrapper checks it). lse, when
// not null, receives the natural-log logsumexp of each row's scaled, masked
// scores as f32 [batch, hq, sq] (+inf for a row that sees no key); o is the
// same with or without it. Returns cudaGetLastError() after the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, int dtype, int batch, int hq, int hkv,
                        int sq, int skv, int d, int q_sb, int q_ss, int q_sh,
                        int k_sb, int k_ss, int k_sh, int v_sb, int v_ss,
                        int v_sh, int o_sb, int o_ss, int o_sh, int causal,
                        int window, float scale, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 ||
      skv <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  int err;
  if (dtype == 0) {
    err = launch_f32(d, q, k, v, o, l, batch, hq, sq, skv, hq / hkv, qs, ks,
                     vs, os, causal, window, scale, s);
  } else if (dtype == 1) {
    err = launch_bf16(d, q, k, v, o, l, batch, hq, hkv, sq, skv, qs, ks, vs,
                      os, causal, window, scale, s);
  } else {
    err = (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
