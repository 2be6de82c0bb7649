// Asynchronous copies into shared memory, as K2 and K8 use them: 4-byte
// cp.async (sm_80+) for gathers whose source is not contiguous, and the
// Hopper bulk copy (cp.async.bulk, the TMA's 1-D form) completing on an
// mbarrier for contiguous spans.  Each helper is one PTX instruction or
// a wait loop around one.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One 4-byte element, global -> shared, asynchronously.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Wait for every cp.async this thread issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile(
      "cp.async.commit_group;\n\t"
      "cp.async.wait_group 0;" ::
          : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (the
// bulk copies that complete on them).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival (release: this thread's earlier shared-memory writes are
// seen by the threads that wait for the phase).
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also expects `bytes` more from bulk copies before the
// phase completes.
__device__ __forceinline__ void mbar_arrive_expect(unsigned long long* bar,
                                                   unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed (acquire).
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// Order this thread's earlier generic-proxy accesses to shared memory
// before its later async-proxy ones (a bulk copy into a buffer it wrote).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A contiguous span of `bytes` (a multiple of 16; both addresses 16-byte
// aligned), global -> shared, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A named barrier over the first `threads` threads of the CTA.
__device__ __forceinline__ void bar_sync(unsigned id, unsigned threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// (head, body, tail) of a span of n 4-byte elements that starts `g`
// elements past a 16-byte boundary: `head` elements up to the first
// boundary, `body` (a multiple of 4) in 16-byte units, `tail` after
// (tests/test_torch_k2k8_plan.py models it).
struct Span {
  int head, body, tail;
};
__device__ __forceinline__ Span span_split(long long g, int n) {
  Span s;
  const int h = (int)((4 - (g & 3)) & 3);
  s.head = h < n ? h : n;
  s.body = (n - s.head) & ~3;
  s.tail = n - s.head - s.body;
  return s;
}
