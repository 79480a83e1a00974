// Bulk asynchronous copies from global to shared memory (cp.async.bulk,
// the TMA's linear mode) completed on an mbarrier, for sm_90.  Shared by
// the kernels that stage their inputs in a ring of shared-memory slots
// (lattice2d.cu, lattice3d.cu).  A slot's barrier takes one arrival, that
// of the thread which issues the slot's copies: it announces their bytes
// with mbar_expect, then issues them with bulk_copy; the block waits on
// the barrier's phase parity with mbar_wait.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The barrier's one arrival, expecting ``bytes`` of copies to complete on it.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One bulk copy of ``bytes`` (a multiple of 16, both ends 16-aligned) from
// global to shared memory, completing on ``bar``.
__device__ __forceinline__ void bulk_copy(float* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace
