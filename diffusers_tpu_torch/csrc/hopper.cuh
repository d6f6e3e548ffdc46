// Hopper (sm_90a) building blocks shared by the port's hand-written kernels:
// TMA tensor maps (encoded on the host) and loads, mbarriers, wgmma shared-
// memory descriptors, fences and instructions, and `setmaxnreg`.
//
// Shared-memory layout convention: every tile that TMA writes and wgmma
// reads is a stack of 128-byte rows in 128-byte swizzle
// (CU_TENSOR_MAP_SWIZZLE_128B, which is the wgmma descriptor's layout type 1):
// 8 rows form a 1,024-byte swizzle atom, so each tile's base is 1,024-byte
// aligned. A matrix whose contiguous dimension is longer than 128 bytes is
// stored as several such stacks ("chunks"), one per 128 bytes of it.
//
// The driver's `cuTensorMapEncodeTiled` is reached through the runtime's
// driver entry point, so a library built from these sources links only
// against the CUDA runtime.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

// ------------------------------------------------------------------ host

// cuTensorMapEncodeTiled, looked up once.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr)
               : nullptr;
  }();
  return fn;
}

// A tiled tensor map of `rank` dimensions, innermost first: `dims` in
// elements, `strides` in bytes for dimensions 1..rank-1, `box` in elements
// (box[0] * element size must be 128 bytes: one swizzle row). Elements
// outside `dims` read as zeros. Returns false if the driver refuses it.
inline bool encode_tensor_map(CUtensorMap* map, CUtensorMapDataType dtype, int rank, const void* ptr,
                              const uint64_t* dims, const uint64_t* strides, const uint32_t* box) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return false;
  uint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult res = fn(map, dtype, rank, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current device,
// once per device (bit d of `*configured`).
template <typename Kernel>
inline cudaError_t raise_smem_limit(Kernel kernel, int bytes, uint64_t* configured) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (*configured >> device & 1)) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *configured |= 1ull << device;
  return err;
}

// Streaming multiprocessors of the current device (the grid of a persistent
// kernel), looked up once per device.
inline int sm_count() {
  static int counts[64] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64) return 1;
  if (counts[device] == 0) cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device);
  return counts[device] > 0 ? counts[device] : 1;
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers (phase parity: a wait on parity p returns once the barrier's
// phase p has completed)
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA loads into shared memory, completing on `bar` (transaction bytes)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// register budget of a warpgroup (all four warps execute it)
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// wgmma ordering: fence before the first wgmma that reads registers written
// since, commit the issued wgmmas as a group, wait until at most N groups
// are in flight
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across a
// wgmma fence or wait
template <typename R, int N>
__device__ __forceinline__ void fence_regs(R (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same<R, float>::value) {
      asm volatile("" : "+f"(r[i])::"memory");
    } else {
      asm volatile("" : "+r"(r[i])::"memory");
    }
  }
}

// wgmma shared-memory matrix descriptor for the 128-byte swizzle (layout
// type 1). `sbo`: bytes between 8-row groups of the strided dimension (1,024
// for stacked 128-byte rows). `lbo`: for an MN-major operand, bytes between
// the 64-element (128-byte) chunks of its contiguous dimension; unused for a
// K-major one. A K-major operand's k-th 32-byte step inside the swizzle row
// starts at base + 32 k.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The wgmma wrappers below share their operand lists through these macros:
// HOPPER_ACCn(c, d) lists accumulator registers d[0] .. d[n-1] with the
// constraint c; HOPPER_REGSn the matching "%0, .., %n-1" of the instruction.
#define HOPPER_ACC8(c, d, i) \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define HOPPER_ACC32(c, d, i) HOPPER_ACC8(c, d, i), HOPPER_ACC8(c, d, i + 8), HOPPER_ACC8(c, d, i + 16), \
  HOPPER_ACC8(c, d, i + 24)
#define HOPPER_ACC64(c, d, i) HOPPER_ACC32(c, d, i), HOPPER_ACC32(c, d, i + 32)
#define HOPPER_ACC128(c, d) HOPPER_ACC64(c, d, 0), HOPPER_ACC64(c, d, 64)
#define HOPPER_REGS32                                                                                   \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
  "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define HOPPER_REGS64                                                                                      \
  HOPPER_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, " \
  "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define HOPPER_REGS128                                                                                     \
  HOPPER_REGS64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, " \
  "%81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, " \
  "%101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, " \
  "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
// expands BODY(type) with the PTX name of the 16-bit type T: "bf16" or "f16"
#define HOPPER_BY_TYPE(T, BODY)                            \
  if constexpr (std::is_same<T, __nv_bfloat16>::value) { \
    BODY("bf16");                                          \
  } else {                                                 \
    BODY("f16");                                           \
  }

// D[64 x 128] (f32) (+)= A[64 x 16] . B[16 x 128], A and B K-major in shared memory.
template <typename T>
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
#define HOPPER_SS_M64N128K16(TY)                                                                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                             \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" HOPPER_REGS64 "}, %64, %65, " \
               "p, 1, 1, 0, 0;\n}\n"                                                                     \
               : HOPPER_ACC64("+f", d, 0)                                                                \
               : "l"(desc_a), "l"(desc_b), "r"(accumulate))
  HOPPER_BY_TYPE(T, HOPPER_SS_M64N128K16)
#undef HOPPER_SS_M64N128K16
}

// D[64 x 64] (f32) (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared memory.
template <typename T>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
#define HOPPER_SS_M64N64K16(TY)                                                                          \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                             \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" HOPPER_REGS32 "}, %32, %33, " \
               "p, 1, 1, 0, 0;\n}\n"                                                                     \
               : HOPPER_ACC32("+f", d, 0)                                                                \
               : "l"(desc_a), "l"(desc_b), "r"(accumulate))
  HOPPER_BY_TYPE(T, HOPPER_SS_M64N64K16)
#undef HOPPER_SS_M64N64K16
}

// D[64 x 64] (f32) += A[64 x 16] . B[16 x 64], A in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B MN-major (transposed) in shared memory.
template <typename T>
__device__ __forceinline__ void wgmma_rs_m64n64k16_tb(float (&d)[32], const uint32_t* a, uint64_t desc_b) {
#define HOPPER_RS_M64N64K16(TY)                                                                           \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                              \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" HOPPER_REGS32 "}, "            \
               "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                              \
               : HOPPER_ACC32("+f", d, 0)                                                                 \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))
  HOPPER_BY_TYPE(T, HOPPER_RS_M64N64K16)
#undef HOPPER_RS_M64N64K16
}

// D[64 x 128] (f32) += A[64 x 16] . B[16 x 128], A in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B MN-major (transposed) in shared memory.
template <typename T>
__device__ __forceinline__ void wgmma_rs_m64n128k16_tb(float (&d)[64], const uint32_t* a, uint64_t desc_b) {
#define HOPPER_RS_M64N128K16(TY)                                                                          \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                              \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" HOPPER_REGS64 "}, "           \
               "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                              \
               : HOPPER_ACC64("+f", d, 0)                                                                 \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))
  HOPPER_BY_TYPE(T, HOPPER_RS_M64N128K16)
#undef HOPPER_RS_M64N128K16
}

// D[64 x 128] (s32) += A[64 x 32] . B[32 x 128], s8, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_m64n128k32_s8(int (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" HOPPER_REGS64 "}, %64, %65, p;\n}\n"
               : HOPPER_ACC64("+r", d, 0)
               : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D[64 x 256] (s32) += A[64 x 32] . B[32 x 256], s8, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_m64n256k32_s8(int (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" HOPPER_REGS128 "}, %128, %129, p;\n}\n"
               : HOPPER_ACC128("+r", d)
               : "l"(desc_a), "l"(desc_b), "r"(1));
}

}  // namespace hopper
