// RMSNorm of a few long bf16 rows, each row split over a thread-block
// cluster of C CTAs: a design probe for the decode norms (4 rows of 3584 to
// 7168), built and timed by tools/k1_check.py --cluster against the shipped
// kernel, which gives each row one CTA (src/repro_torch/kernels/csrc/
// rmsnorm.cu). The port does not use it.
//
// Each CTA of a row's cluster loads its slice of x and w (CPT 16-byte chunks
// a thread, all issued before the reduction), sums its squares (warp
// shuffles, then its warps in order) and publishes the sum in shared
// memory. After a cluster barrier every CTA reads the C partial sums through
// distributed shared memory in rank order, so all of them get the same
// total; a second barrier keeps each CTA's shared memory alive until the
// others have read it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void load8(const bf16* p, float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ void store8(bf16* p, const float (&in)[8]) {
  uint4 raw;
  bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Row r is CTAs C r .. C r + C - 1 (one cluster); TPB * CPT * 8 * C == d.
template <int C, int TPB, int CPT>
__global__ void __launch_bounds__(TPB)
    rmsnorm_cluster(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    bf16* __restrict__ y, int d, float eps) {
  __shared__ float warp_part[TPB / 32];
  __shared__ float cta_part;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / C, tid = threadIdx.x;
  const bf16* xr = x + (long long)row * d;
  bf16* yr = y + (long long)row * d;

  float v[CPT][8], g[CPT][8];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = (rank * CPT + k) * TPB + tid;
    load8(xr + 8 * c, v[k]);
    load8(w + 8 * c, g[k]);
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < CPT; ++k)
#pragma unroll
    for (int i = 0; i < 8; ++i) ss = fmaf(v[k][i], v[k][i], ss);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (tid % 32 == 0) warp_part[tid / 32] = ss;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int i = 0; i < TPB / 32; ++i) t += warp_part[i];
    cta_part = t;
  }
  cluster.sync();
  float total = 0.f;
#pragma unroll
  for (int q = 0; q < C; ++q) total += *cluster.map_shared_rank(&cta_part, q);
  cluster.sync();
  const float inv = rsqrtf(total / (float)d + eps);
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = (rank * CPT + k) * TPB + tid;
#pragma unroll
    for (int i = 0; i < 8; ++i) v[k][i] = v[k][i] * inv * g[k][i];
    store8(yr + 8 * c, v[k]);
  }
}

template <int C, int TPB, int CPT>
cudaError_t launch(const bf16* x, const bf16* w, bf16* y, int rows, int d, float eps,
            cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows * C);
  cfg.blockDim = dim3(TPB);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, rmsnorm_cluster<C, TPB, CPT>, x, w, y, d,
                            eps);
}

}  // namespace

extern "C" {

// x, w, y contiguous bf16 with 16-byte aligned bases; (d, cluster) one of
// (4096, 2 | 4 | 8), (7168, 2 | 4), (3584, 2). Returns cudaGetLastError().
int rmsnorm_cluster_fwd(const void* x, const void* w, void* y, int rows,
                        int d, int cluster, float eps, void* stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* yb = static_cast<bf16*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d == 4096 && cluster == 2)
    err = launch<2, 128, 2>(xb, wb, yb, rows, d, eps, s);
  else if (d == 4096 && cluster == 4)
    err = launch<4, 64, 2>(xb, wb, yb, rows, d, eps, s);
  else if (d == 4096 && cluster == 8)
    err = launch<8, 64, 1>(xb, wb, yb, rows, d, eps, s);
  else if (d == 7168 && cluster == 2)
    err = launch<2, 224, 2>(xb, wb, yb, rows, d, eps, s);
  else if (d == 7168 && cluster == 4)
    err = launch<4, 224, 1>(xb, wb, yb, rows, d, eps, s);
  else if (d == 3584 && cluster == 2)
    err = launch<2, 224, 1>(xb, wb, yb, rows, d, eps, s);
  else
    return (int)cudaErrorInvalidValue;
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // extern "C"
