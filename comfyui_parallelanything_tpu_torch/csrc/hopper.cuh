// Hopper (sm_90a) building blocks in inline PTX: mbarriers, TMA tensor loads and
// stores, wgmma shared-memory descriptors and products (bf16/f16 and TF32), register
// reallocation.
// Header-only; every function is a thin wrapper over one or two PTX instructions.
#pragma once

#include <cuda.h>  // CUtensorMap (types only: the library does not link libcuda)
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and other threads.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic the phase must wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Blocks until the barrier's phase of parity `parity` has completed. A wait that
// spins 2^26 times (seconds; a real wait here lasts microseconds) traps, so a broken
// pipeline fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  uint32_t tries = 0;
  do {
    if (++tries == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// 4-D tiled load of one box into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 4-D tiled store of one box from shared memory; elements outside the tensor are skipped.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later async-proxy
// (TMA, wgmma) reads of them.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// Register reallocation between warpgroups
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor for a tile stored with the 128-byte swizzle (as
// TMA's CU_TENSOR_MAP_SWIZZLE_128B writes it): start address, leading and stride
// byte offsets (all in 16-byte units), layout type 1 = 128B swizzle.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t smem_addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = 0;
  d |= (uint64_t)((smem_addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers across
// the asynchronous wgmma boundaries (fence, wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define PA_F8(b) \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]), \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

#define PA_REGS_16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

#define PA_REGS_32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

#define PA_REGS_64                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "   \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

#define PA_REGS_96                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "     \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "      \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "      \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "      \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "      \
  "%87, %88, %89, %90, %91, %92, %93, %94, %95}"

#define PA_REGS_128                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "     \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "      \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "      \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "      \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "      \
  "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "        \
  "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "       \
  "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// D(64×128, f32) = A(64×16) · B(16×128) + (scale_d ? D : 0), A and B from shared
// memory, both K-major.
#define PA_WGMMA_SS_N128(TY)                                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                   \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " PA_REGS_64       \
               ", %64, %65, p, 1, 1, 0, 0;\n}\n"                                              \
               : PA_F8(0), PA_F8(8), PA_F8(16), PA_F8(24), PA_F8(32), PA_F8(40), PA_F8(48),   \
                 PA_F8(56)                                                                    \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d))

// D(64×64, f32) = A(64×16) · B(16×64) + (scale_d ? D : 0), A and B from shared
// memory, both K-major.
#define PA_WGMMA_SS_N64(TY)                                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                   \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " PA_REGS_32        \
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                              \
               : PA_F8(0), PA_F8(8), PA_F8(16), PA_F8(24)                                     \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d))

// D(64×256, f32) += A(64×16, registers) · B(16×256, shared memory, MN-major).
#define PA_WGMMA_RS_N256(TY)                                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                                  \
               "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " " PA_REGS_128      \
               ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                           \
               : PA_F8(0), PA_F8(8), PA_F8(16), PA_F8(24), PA_F8(32), PA_F8(40), PA_F8(48),   \
                 PA_F8(56), PA_F8(64), PA_F8(72), PA_F8(80), PA_F8(88), PA_F8(96),            \
                 PA_F8(104), PA_F8(112), PA_F8(120)                                           \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

// D(64×192, f32) += A(64×16, registers) · B(16×192, shared memory, MN-major).
#define PA_WGMMA_RS_N192(TY)                                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"                                  \
               "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY " " PA_REGS_96       \
               ", {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"                               \
               : PA_F8(0), PA_F8(8), PA_F8(16), PA_F8(24), PA_F8(32), PA_F8(40), PA_F8(48),   \
                 PA_F8(56), PA_F8(64), PA_F8(72), PA_F8(80), PA_F8(88)                        \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

// D(64×128, f32) += A(64×16, registers) · B(16×128, shared memory, MN-major).
#define PA_WGMMA_RS_N128(TY)                                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                   \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " PA_REGS_64       \
               ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                \
               : PA_F8(0), PA_F8(8), PA_F8(16), PA_F8(24), PA_F8(32), PA_F8(40), PA_F8(48),   \
                 PA_F8(56)                                                                    \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

// D(64×64, f32) += A(64×16, registers) · B(16×64, shared memory, MN-major).
#define PA_WGMMA_RS_N64(TY)                                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                   \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " PA_REGS_32        \
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                \
               : PA_F8(0), PA_F8(8), PA_F8(16), PA_F8(24)                                     \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

// kBf16 selects bf16 (true) or f16 (false) inputs; accumulation is f32 either way.
template <bool kBf16>
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  if constexpr (kBf16) {
    PA_WGMMA_SS_N128("bf16");
  } else {
    PA_WGMMA_SS_N128("f16");
  }
}

template <bool kBf16>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  if constexpr (kBf16) {
    PA_WGMMA_SS_N64("bf16");
  } else {
    PA_WGMMA_SS_N64("f16");
  }
}

template <bool kBf16, int N>
__device__ __forceinline__ void wgmma_rs_m64k16(float (&d)[N / 2], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  static_assert(N == 64 || N == 128 || N == 192 || N == 256,
                "wgmma_rs_m64k16 takes N = 64, 128, 192 or 256");
  if constexpr (N == 256) {
    if constexpr (kBf16) {
      PA_WGMMA_RS_N256("bf16");
    } else {
      PA_WGMMA_RS_N256("f16");
    }
  } else if constexpr (N == 192) {
    if constexpr (kBf16) {
      PA_WGMMA_RS_N192("bf16");
    } else {
      PA_WGMMA_RS_N192("f16");
    }
  } else if constexpr (N == 128) {
    if constexpr (kBf16) {
      PA_WGMMA_RS_N128("bf16");
    } else {
      PA_WGMMA_RS_N128("f16");
    }
  } else {
    if constexpr (kBf16) {
      PA_WGMMA_RS_N64("bf16");
    } else {
      PA_WGMMA_RS_N64("f16");
    }
  }
}

// ---------------------------------------------------------------------------
// TF32: wgmma m64nNk8 (N = 32 or 64) with f32 accumulation, for float32 data split
// into TF32 high and low parts. TF32 wgmma has no transpose: both shared-memory
// operands are K-major.
// ---------------------------------------------------------------------------

// D(64×64, f32) = A(64×8) · B(8×64) + (scale_d ? D : 0), A and B from shared memory,
// both K-major.
__device__ __forceinline__ void wgmma_ss_m64n64k8_tf32(float (&d)[32], uint64_t desc_a,
                                                       uint64_t desc_b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " PA_REGS_32
               ", %32, %33, p, 1, 1;\n}\n"
               : PA_F8(0), PA_F8(8), PA_F8(16), PA_F8(24)
               : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64×32, f32) = A(64×8) · B(8×32) + (scale_d ? D : 0), as above.
__device__ __forceinline__ void wgmma_ss_m64n32k8_tf32(float (&d)[16], uint64_t desc_a,
                                                       uint64_t desc_b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " PA_REGS_16
               ", %16, %17, p, 1, 1;\n}\n"
               : PA_F8(0), PA_F8(8)
               : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64×64, f32) += A(64×8, registers) · B(8×64, shared memory, K-major).
__device__ __forceinline__ void wgmma_rs_m64n64k8_tf32(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t desc_b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " PA_REGS_32
               ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
               : PA_F8(0), PA_F8(8), PA_F8(16), PA_F8(24)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D(64×32, f32) += A(64×8, registers) · B(8×32, shared memory, K-major).
__device__ __forceinline__ void wgmma_rs_m64n32k8_tf32(float (&d)[16], const uint32_t (&a)[4],
                                                       uint64_t desc_b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " PA_REGS_16
               ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
               : PA_F8(0), PA_F8(8)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef PA_WGMMA_RS_N64
#undef PA_WGMMA_RS_N128
#undef PA_WGMMA_RS_N192
#undef PA_WGMMA_RS_N256
#undef PA_WGMMA_SS_N64
#undef PA_WGMMA_SS_N128
#undef PA_REGS_128
#undef PA_REGS_96
#undef PA_REGS_64
#undef PA_REGS_32
#undef PA_REGS_16
#undef PA_F8

}  // namespace hopper
