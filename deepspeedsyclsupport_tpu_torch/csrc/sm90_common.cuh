// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels:
// csrc/flash_attention.cu (flash_fwd_sm90_kernel, flash_dq_sm90_kernel,
// flash_dkv_sm90_kernel) and csrc/paged_attention.cu
// (paged_prefill_sm90_kernel). One copy of each part:
//   mbarriers      mbar_init / mbar_expect_tx / mbar_arrive / mbar_wait
//   TMA            tma_load (rank-4 box into shared memory, completion
//                  counted in bytes on an mbarrier); encode_tiled, the driver's
//                  cuTensorMapEncodeTiled looked up through the runtime
//   wgmma          sw128_desc (shared-memory descriptor, 128-byte swizzle),
//                  wg_fence / wg_commit / wg_wait_all, fence_regs,
//                  wgmma_ss (A and B from shared memory, both K-major) and
//                  wgmma_rs (A from registers, B MN-major), m64 x n{64,128}
//                  x k16 in bf16 or fp16 with float32 accumulators
//   registers      pack2 / unpack2 (two floats as a pair of T and back),
//                  pack_split (an accumulator fragment as two register A
//                  operands of T, hi and lo, for a product to ~16 bits)
// Everything here is inlined into its caller; a source that includes this
// header and uses none of it compiles to the same code as before.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder comes from
                   // cudaGetDriverEntryPoint: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}
// One box of the tensor map at coordinates (d, head, seq, batch) into
// shared memory; completion counts bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operands: rows
// 128 bytes apart, 8-row groups `sbo` = 1024 apart (lbo unused). MN-major
// (V): k rows 128 bytes apart, 8-row groups `sbo` = 1024 apart, the next 64
// MN columns (the next chunk) `lbo` apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
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
// Registers an asynchronous wgmma wrote: no read moves above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define DSST_ACC32_STR \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
  "}"
#define DSST_ACC32_OPS(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define DSST_ACC64_STR \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
  "}"
#define DSST_ACC64_OPS(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
// d (+)= A B, A and B from shared memory (descriptors a, b), both K-major;
// `acc` = 0 overwrites d.
#define DSST_WGMMA_SS(N, ACC, TY, IA, IB, IS)                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"              \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " " \
               ACC##_STR ", %" IA ", %" IB ", p, 1, 1, 0, 0;\n}\n"           \
               : ACC##_OPS(d) : "l"(a), "l"(b), "r"(acc))
// d += A B, A from registers (four pairs of T), B MN-major in shared memory.
#define DSST_WGMMA_RS(N, ACC, TY, IA, IB, IS)                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"              \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " " \
               ACC##_STR ", {%" IA "}, %" IB ", p, 1, 1, 1;\n}\n"            \
               : ACC##_OPS(d)                                                 \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <typename T, int N>   // N = 64 or 128 columns
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int acc) {
  constexpr bool kHalf = std::is_same<T, __half>::value;
  if constexpr (N == 128) {
    if constexpr (kHalf) DSST_WGMMA_SS("128", DSST_ACC64, "f16", "64", "65", "66");
    else DSST_WGMMA_SS("128", DSST_ACC64, "bf16", "64", "65", "66");
  } else {
    if constexpr (kHalf) DSST_WGMMA_SS("64", DSST_ACC32, "f16", "32", "33", "34");
    else DSST_WGMMA_SS("64", DSST_ACC32, "bf16", "32", "33", "34");
  }
}
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  constexpr bool kHalf = std::is_same<T, __half>::value;
  if constexpr (N == 128) {
    if constexpr (kHalf)
      DSST_WGMMA_RS("128", DSST_ACC64, "f16", "64, %65, %66, %67", "68", "69");
    else
      DSST_WGMMA_RS("128", DSST_ACC64, "bf16", "64, %65, %66, %67", "68", "69");
  } else {
    if constexpr (kHalf)
      DSST_WGMMA_RS("64", DSST_ACC32, "f16", "32, %33, %34, %35", "36", "37");
    else
      DSST_WGMMA_RS("64", DSST_ACC32, "bf16", "32, %33, %34, %35", "36", "37");
  }
}

// Two floats as a pair of T in one register, lo in the low half.
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo,
                                                               float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(
    float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo,
                                                             float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A pair of T in one register back to floats (lo half first).
template <typename T> __device__ __forceinline__ float2 unpack2(uint32_t v);
template <> __device__ __forceinline__ float2 unpack2<__nv_bfloat16>(
    uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xFFFF0000u));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(uint32_t v) {
  return __half22float2(*reinterpret_cast<__half2*>(&v));
}

// An accumulator fragment as two register A operands of T, hi = T(x) and lo
// = T(x - hi): a product with hi and one with lo into the same float32
// accumulator multiply x to ~16 significant bits (T's 8 or 11 twice) where
// hi alone keeps 8 or 11.
template <typename T, int N>
__device__ __forceinline__ void pack_split(uint32_t (&hi)[N / 8][4],
                                           uint32_t (&lo)[N / 8][4],
                                           const float (&x)[N]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * kk + 2 * r], b = x[8 * kk + 2 * r + 1];
      hi[kk][r] = pack2<T>(a, b);
      const float2 h = unpack2<T>(hi[kk][r]);
      lo[kk][r] = pack2<T>(a - h.x, b - h.y);
    }
}

// cuTensorMapEncodeTiled, looked up through the runtime's
// cudaGetDriverEntryPoint: the library links no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

}  // namespace
