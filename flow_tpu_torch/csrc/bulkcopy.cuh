// Hopper's bulk copy (cp.async.bulk, the Tensor Memory Accelerator without a
// tensor map) and the shared-memory barrier (mbarrier) that reports its
// completion, as small device functions over inline PTX (sm_90).
//
// A block initialises one barrier for one arrival, one thread arrives on it
// with the byte count the copies will deliver (expect_tx), the copies are
// issued (each completes its bytes on the barrier), and every thread that
// reads the copied data waits on the barrier's phase 0. Addresses and sizes
// of a copy are multiples of 16 bytes; the transaction count must equal the
// bytes copied, or the phase never completes.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: the barrier expects `count` arrivals. The fence makes the
// initialisation visible to the async proxy that completes the copies; a
// __syncthreads() must follow before other threads use the barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on the barrier and add `bytes` to the transactions it waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Spin until the barrier's phase `parity` has completed. A phase that has
// not completed after 2^24 tries (each of which may suspend the thread for
// a while) cannot complete: a transaction count that does not match the
// bytes copied. The block then traps, which fails the launch, instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to this block's shared memory; completion counts on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
