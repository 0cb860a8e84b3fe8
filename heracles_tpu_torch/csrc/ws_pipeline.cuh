// The hand-off between warps of one block that sht_analysis.cu's
// warp-specialised group body (ws_group_body) uses: a producer warp fills
// a stage of shared memory and a consumer warp reads it, each stage
// guarded by two mbarriers, "full" (the producer's lanes arrive when the
// stage is written) and "empty" (the consumers' lanes arrive when it is
// read), and named barriers that let the producers or the consumers meet
// among themselves without holding up the other role.
//
// The phases follow the usual pipeline: a stage's n-th use (n = 0, 1, ...)
// waits on "full" for parity n % 2 in the consumer and on "empty" for
// parity (n + 1) % 2 in the producer, so the producer's first wait on each
// stage passes at once.  An arrive releases, and a wait acquires, the
// block's shared memory: what a lane wrote before it arrived is what a
// lane that waited reads.

#pragma once

#include <cuda_runtime.h>

namespace ws {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One thread sets up a barrier that completes a phase after ``count``
// arrivals; the block meets (__syncthreads) before any lane uses it.
__device__ __forceinline__ void bar_init(unsigned long long* bar,
                                         unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Spins until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void wait(unsigned long long* bar,
                                     unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done = 0;
  do {
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

// The ``nthreads`` threads (whole warps) that name barrier ``id`` (1..15;
// 0 is __syncthreads') meet; shared-memory writes before it are seen after
// it by every one of them.
__device__ __forceinline__ void named_sync(unsigned id, unsigned nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

// An asynchronous copy of 8 bytes from global to shared memory, in the
// thread's current group of copies; wait_copies() waits for all of the
// thread's groups, whose bytes the thread then reads.
__device__ __forceinline__ void copy8_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A warpgroup's registers a thread, moved between the roles of a block
// (setmaxnreg): every warp of the warpgroup runs it, and the kernel's role
// branches never meet again.
template <int kRegs>
__device__ __forceinline__ void release_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void claim_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// A stage's place in a ring of kStages: its index and the parity of its
// use, for a running count of the stages a warp has taken.
template <int kStages>
struct Slot {
  int stage;
  unsigned parity;
  __device__ __forceinline__ explicit Slot(int n)
      : stage(n % kStages), parity(unsigned(n / kStages) & 1u) {}
};

}  // namespace ws
