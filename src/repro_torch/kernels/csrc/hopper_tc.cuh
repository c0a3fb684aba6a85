// Hopper (sm_90a) building blocks shared by the tensor-core kernels:
// flash_fwd*_tc (flash_attention.cu), flash_bwd_*_tc (flash_attention_bwd.cu)
// and scan_bwd_tc_* (mamba_scan_bwd.cu).
//
// * mbarriers: init, arrive, arrive with an expected byte count, and a
//   parity wait; named barriers (sync and arrive); setmaxnreg; the item
//   of a persistent CTA's round; programmatic dependent launch;
// * TMA: 4-D tensor-map loads and stores of one 64 x 64 box of a strided
//   bf16 [B, S, H, D] operand (either with or without an L2 eviction
//   policy), and 1-D bulk loads of contiguous bytes, each load completing
//   on an mbarrier; the tensor maps are encoded on the host with
//   cuTensorMapEncodeTiled, taken from the driver through
//   cudaGetDriverEntryPoint (no link to libcuda);
// * wgmma: descriptors of 128-byte-swizzled shared-memory operands (and of
//   one k-step of a K-major or an MN-major 64-wide tile), the
//   fence / commit / wait trio, S (+)= A B^T with both operands K-major in
//   shared memory (m64n64k16 and m64n32k16), the same with A a bf16
//   register fragment (m64n64k16), D (+)= A B with A K-major and B
//   MN-major in shared memory (m64n64k16), and O += P V with P a bf16
//   register A fragment and V MN-major in shared memory (m64n64k16 and
//   m64n128k16).
//
// Included once by each kernel source (each is its own library).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; no libcuda link)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

struct Strides {
  int b, s, h;  // elements between batches, positions, heads
};

namespace tc {

constexpr int kBox = 64;                 // TMA box: 64 rows x 64 columns
constexpr int kBoxBytes = kBox * kBox * 2;
constexpr int kRowBytes = kBox * 2;      // one swizzled 128-byte row
constexpr int kAtomBytes = 8 * kRowBytes;  // 8 rows: one swizzle atom

// Which dimension (1..3) of a tensor map holds seq, head and batch: the
// host orders them by stride.
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

// A barrier over ``threads`` threads (a multiple of 32) of the CTA.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Arrive at named barrier ``id`` of ``threads`` threads without waiting.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// setmaxnreg: one whole warpgroup (all four warps execute it) gives
// registers back to the CTA's pool (dec) or takes them from it (inc, which
// waits until the pool holds them); N registers a thread afterwards. The
// split of a 384-thread CTA (168 a thread at launch): a producer
// warpgroup at kProducerRegs, two consumer warpgroups at kConsumerRegs
// (128 x 40 + 256 x 232 = 384 x 168).
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// The item of a persistent CTA's round r: rounds of G items (G CTAs),
// taken forwards in even rounds and backwards in odd ones, so long and
// short items pair up. Which CTA computes an item does not change its
// arithmetic.
__device__ __forceinline__ int item_of_round(int r) {
  const int g = gridDim.x, c = blockIdx.x;
  return r * g + ((r & 1) ? g - 1 - c : c);
}

// item_of_round with the directions swapped (backwards in even rounds):
// the last round's items go to the lowest CTAs, so the highest, which a
// launch that waits for free SMs starts last, have the fewest.
__device__ __forceinline__ int item_of_round_rev(int r) {
  const int g = gridDim.x, c = blockIdx.x;
  return r * g + ((r & 1) ? c : g - 1 - c);
}

// Programmatic dependent launch: the grid launched after this one with
// cudaLaunchAttributeProgrammaticStreamSerialization may start once every
// CTA of this grid has signalled (or exited).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Waits until the grids this one was launched as a dependent of have
// completed and their writes are visible.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The coordinate of tensor-map dimension d (1..3) for (seq, head, batch).
__device__ __forceinline__ int coord(const Perm& p, int d, int s, int h,
                                     int b) {
  return p.s == d ? s : p.h == d ? h : b;
}

// One box of a 4-D tensor map into shared memory, completing on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int s, int h,
                                         int b, Perm p) {
  const int c1 = coord(p, 1, s, h, b), c2 = coord(p, 2, s, h, b),
            c3 = coord(p, 3, s, h, b);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// tma_load with an L2 eviction policy (a handle from policy_evict_*).
__device__ __forceinline__ void tma_load_hint(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int col, int s,
                                              int h, int b, Perm p,
                                              uint64_t policy) {
  const int c1 = coord(p, 1, s, h, b), c2 = coord(p, 2, s, h, b),
            c3 = coord(p, 3, s, h, b);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4, %5, %6}], [%2], %7;"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
      "r"(c1), "r"(c2), "r"(c3), "l"(policy)
      : "memory");
}

// L2 policies for tma_load_hint and tma_store_hint: lines kept past
// others (evict_last), or given up first (evict_first).
__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

// ``bytes`` contiguous bytes (16-byte aligned, a multiple of 16) into
// shared memory, completing on ``bar``.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// One box from shared memory to a 4-D tensor map, in the current bulk
// group; rows and columns outside the tensor are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int col, int s,
                                          int h, int b, Perm p) {
  const int c1 = coord(p, 1, s, h, b), c2 = coord(p, 2, s, h, b),
            c3 = coord(p, 3, s, h, b);
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// tma_store with an L2 eviction policy (a handle from policy_evict_*).
__device__ __forceinline__ void tma_store_hint(const CUtensorMap* map,
                                               uint32_t src, int col, int s,
                                               int h, int b, Perm p,
                                               uint64_t policy) {
  const int c1 = coord(p, 1, s, h, b), c2 = coord(p, 2, s, h, b),
            c3 = coord(p, 3, s, h, b);
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3, %4, %5}], [%1], %6;"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(col), "r"(c1),
      "r"(c2), "r"(c3), "l"(policy)
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

// A K-major operand (rows along M or N, K along the swizzled rows): k-step
// kk starts 32 bytes further along the rows.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 32, 16, kAtomBytes);
}

// An MN-major operand (rows along K, 64 columns along M or N): k-step kk
// starts 16 rows (two swizzle atoms) further down.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 2 * kAtomBytes, kBoxBytes, kAtomBytes);
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

#define FA_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// S[64 x 64] (+)= A[64 x 16] B[64 x 16]^T: A a bf16 register fragment
// (the accumulator layout, as pack_frags makes it), B K-major in shared
// memory.
__device__ __forceinline__ void wgmma_rs_qk(float (&d)[32], const uint32_t* a,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// S[64 x 64] (+)= Q[64 x 16] K[64 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// S[64 x 32] (+)= A[64 x 16] B[32 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_qk32(float (&d)[16], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : FA_D8(0), FA_D8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A K-major, B MN-major (transposed),
// both in shared memory.
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// O[64 x N] += P[64 x 16] V[16 x N]: P in registers (bf16 A fragment), V
// MN-major in shared memory (transposed B).
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32],
                                             const uint32_t* a,
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
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64],
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32), FA_D8(40),
        FA_D8(48), FA_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef FA_D8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// v rounded to the nearest bf16, as a float.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// The tensor map of a bf16 [B, S, H, D] operand given its (batch, seq,
// head) element strides: dimension 0 is D (contiguous), dimensions 1..3 are
// seq, head and batch ordered by stride; boxes of 64 columns x 64 positions.
int make_map(CUtensorMap* map, Perm* perm, const void* ptr, int d, int n_s,
             int n_h, int n_b, Strides st) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  struct Dim {
    long long extent, stride;
    int which;  // 0 seq, 1 head, 2 batch
  } dims[3] = {{n_s, st.s, 0}, {n_h, st.h, 1}, {n_b, st.b, 2}};
  for (int i = 1; i < 3; ++i)  // stable insertion sort by stride
    for (int j = i; j > 0 && dims[j].stride < dims[j - 1].stride; --j) {
      const Dim t = dims[j];
      dims[j] = dims[j - 1];
      dims[j - 1] = t;
    }
  cuuint64_t extent[4] = {(cuuint64_t)d, 0, 0, 0};
  cuuint64_t stride[3];
  cuuint32_t box[4] = {kBox, 1, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    extent[i + 1] = (cuuint64_t)dims[i].extent;
    stride[i] = (cuuint64_t)dims[i].stride * sizeof(__nv_bfloat16);
    if (dims[i].which == 0) {
      box[i + 1] = kBox;
      perm->s = i + 1;
    } else if (dims[i].which == 1) {
      perm->h = i + 1;
    } else {
      perm->b = i + 1;
    }
  }
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
      extent, stride, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace
