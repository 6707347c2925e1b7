// Helpers shared by the port's kernels (hpf.cu, prune.cu).
//
// Float arithmetic under the reference's subnormal rule.  XLA on the CPU,
// which runs every parity test of the JAX package, executes with DAZ and
// FTZ on (a TPU flushes as well): a subnormal input reads as a zero of its
// sign, and a subnormal result becomes one (ops/ftz.py).  The HPF and the
// prune envelopes decay into that range over minutes of digital silence,
// so their kernels use the .ftz forms, written out here in PTX so that the
// rule does not depend on nvcc's -ftz flag.
#pragma once

#include <stdint.h>

namespace audfp {

__device__ __forceinline__ float sub_ftz(float a, float b) {
  float r;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float mul_ftz(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  float r;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(a), "f"(b), "f"(c));
  return r;
}

__device__ __forceinline__ float max_ftz(float a, float b) {
  float r;
  asm("max.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// all ones where a > b, else zero (one instruction: a bit mask builds
// from it with one logic op)
__device__ __forceinline__ uint32_t gt_ftz_mask(float a, float b) {
  uint32_t r;
  asm("set.gt.ftz.u32.f32 %0, %1, %2;" : "=r"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ bool ge_ftz(float a, float b) {
  uint32_t r;
  asm("{\n .reg .pred p;\n setp.ge.ftz.f32 p, %1, %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(r)
      : "f"(a), "f"(b));
  return r != 0;
}

// ---- shared memory, mbarriers and the TMA unit ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// a barrier whose phase completes after `count` arrivals (and the bytes
// of any expect_tx)
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// after the mbar_inits of a thread, before any copy reports to them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// generic-proxy accesses of shared memory, ordered before the async
// proxy's (a TMA copy's) accesses that follow
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

}  // namespace audfp
