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
// What bounds it on the H100: at the qwen3-8b prefill shape (S = 512,
// D = 128) the causal work is ~8.6 GFLOP against ~42 MB moved, so the least
// time is the 12.5 us of memory traffic; the tensor-core time is below it.
// This first version computes both products with f32 FMAs on the SMs' FP32
// pipes (no mma / wgmma yet), so it runs far above that bound; it is written
// to be right and deterministic first.
//
// Design:
// * One CTA of 256 threads per (batch, q head, 64-row query tile); four
//   threads own each query row and split the head dimension between them in
//   interleaved float4 chunks (thread c owns chunks c, c + 4, ...), so their
//   shared-memory reads fall in distinct banks. Each thread keeps its slice
//   of q and of the f32 accumulator in registers; the four partial dot
//   products are summed with two xor shuffles, which gives all four threads
//   the same score bit for bit.
// * The KV loop runs over 32-key tiles from the first tile the window can
//   reach to the last key the causal limit allows, instead of testing every
//   tile; K and V tiles are staged in shared memory as f32 (32 KB at D = 128).
// * q, k, v and o are addressed through explicit (batch, seq, head) strides,
//   so the model's [B, S, H, D] tensors are read and written in place.
// * Query tiles are scheduled last-first so the longest causal rows start
//   first. No atomics, a launch configuration fixed by (dtype, D): reruns are
//   bitwise identical.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockM = 64;      // query rows per CTA
constexpr int kBlockN = 32;      // keys per staged tile
constexpr int kLanesPerRow = 4;  // threads sharing one query row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned int*>(&a);
  raw.y = *reinterpret_cast<unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

struct Strides {
  int b, s, h;  // elements between batches, positions, heads
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int sq, int skv,
          int group, Strides qs, Strides ks, Strides vs, Strides os,
          int causal, int window, float scale) {
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
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, int batch,
            int hq, int sq, int skv, int group, Strides qs, Strides ks,
            Strides vs, Strides os, int causal, int window, float scale,
            cudaStream_t stream) {
  const dim3 grid((sq + kBlockM - 1) / kBlockM, hq, batch);
  flash_fwd<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, group, qs, ks,
      vs, os, causal, window, scale);
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             int batch, int hq, int sq, int skv, int group, Strides qs,
             Strides ks, Strides vs, Strides os, int causal, int window,
             float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      launch<T, 32>(q, k, v, o, batch, hq, sq, skv, group, qs, ks, vs, os,
                    causal, window, scale, stream);
      return 0;
    case 64:
      launch<T, 64>(q, k, v, o, batch, hq, sq, skv, group, qs, ks, vs, os,
                    causal, window, scale, stream);
      return 0;
    case 112:  // zamba2's shared attention: 28 float4 chunks, 7 a lane
      launch<T, 112>(q, k, v, o, batch, hq, sq, skv, group, qs, ks, vs, os,
                     causal, window, scale, stream);
      return 0;
    case 128:
      launch<T, 128>(q, k, v, o, batch, hq, sq, skv, group, qs, ks, vs, os,
                     causal, window, scale, stream);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; d in {32, 64, 112, 128}. Strides are in
// elements, ordered (batch, seq, head) for each of q, k, v, o; the last
// dimension is contiguous. Returns cudaGetLastError() after the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int batch, int hq, int hkv, int sq,
                        int skv, int d, int q_sb, int q_ss, int q_sh,
                        int k_sb, int k_ss, int k_sh, int v_sb, int v_ss,
                        int v_sh, int o_sb, int o_ss, int o_sh, int causal,
                        int window, float scale, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 ||
      skv <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  const int group = hq / hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = launch_d<float>(d, q, k, v, o, batch, hq, sq, skv, group, qs, ks,
                          vs, os, causal, window, scale, s);
  } else if (dtype == 1) {
    err = launch_d<__nv_bfloat16>(d, q, k, v, o, batch, hq, sq, skv, group,
                                  qs, ks, vs, os, causal, window, scale, s);
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
