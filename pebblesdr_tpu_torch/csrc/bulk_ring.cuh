// Hopper (sm_90) bulk copies, and a ring of stages in shared memory fed by
// them.
//
// One thread hands the copy engine a contiguous byte range
// (cp.async.bulk), or a box of a 2D tensor map (cp.async.bulk.tensor,
// load_2d); an mbarrier in shared memory counts the bytes that have
// landed, and the consumers wait on its phase parity.  Bulk stores go the
// other way, from shared memory to device memory (a byte range, or a box
// of a 2D tensor map, store_2d), tracked by bulk groups.
//
// Rules (the helpers assume them, the callers keep them):
//   * every bulk copy's addresses and size are multiples of 16 bytes
//     (kBulkAlign), a tensor-map box lands 128-byte aligned; a stage's size stays below 2^20 bytes (kMaxTxBytes,
//     the mbarrier's transaction count per phase);
//   * fence_async_smem() before a bulk store reads shared memory (its data
//     may have been written through the generic proxy);
//   * store_wait_read<N>() before a stage that a bulk store still reads is
//     refilled or the block exits.
//
// The PTX lives in the primitives below and nowhere else.  A build that
// defines BULK_RING_PRIMITIVES to a header of its own takes the primitives
// from there instead (the same names and signatures): a CPU emulation
// implements them as memcpy plus a flag (load_2d: copy the box's rows that
// lie inside the tensor, zero the rest; store_2d: write the box's rows
// that lie inside the tensor, refuse a corner outside it).

#pragma once

#include <stdint.h>

namespace bulk {

constexpr uint32_t kBulkAlign = 16;
constexpr uint32_t kMaxTxBytes = (1u << 20) - 1;

#ifndef BULK_RING_PRIMITIVES

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarrier expecting `count` arrivals per phase (one thread; then
// fence_mbar_init() and a __syncthreads() before any other thread uses it).
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival, and `bytes` more to land before the phase completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// True once the phase of parity `parity` has completed.
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Device memory -> shared memory; the landed bytes complete on `bar`.
__device__ __forceinline__ void load(void* dst, const void* src,
                                     uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One box of a 2D tensor map (a CUtensorMap in the kernel's parameters,
// __grid_constant__) whose corner is column x, row y -> shared memory
// (128-byte aligned); the whole box's bytes complete on `bar`, the parts
// outside the tensor landing as zeros.
__device__ __forceinline__ void load_2d(void* dst, const void* map, int x,
                                        int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x),
         "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// Shared memory (128-byte aligned) -> one box of a 2D tensor map (a
// CUtensorMap in the kernel's parameters, __grid_constant__) whose corner
// is column x, row y, in the current bulk group.  The corner must lie
// inside the tensor (a negative row faults on the H100, where a load
// zero-fills); rows past the end are not written.
__device__ __forceinline__ void store_2d(const void* map, int x, int y,
                                         const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%1, %2}], [%3];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
         "r"(smem_u32(src))
      : "memory");
}

// Shared memory -> device memory, in the current bulk group.
__device__ __forceinline__ void store(void* dst, const void* src,
                                      uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until at most N committed store groups still read shared memory.
template <int N>
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(N) : "memory");
}

// Orders the generic proxy's shared-memory writes before the async proxy's
// reads (a bulk store).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

#else
#include BULK_RING_PRIMITIVES
#endif

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// A ring of `stages` stages of `stage_bytes` each, one full barrier per
// stage.  Item i (the i-th range a block streams) goes to stage i % stages
// in that stage's (i / stages)-th phase.  One thread calls init() and
// issue(); every consumer calls wait(i) before reading item i and frees
// the stage (a __syncthreads(), or a bulk store's wait_read) before item
// i + stages is issued into it.
struct Ring {
  uint64_t* full;          // [stages] barriers, 8-byte aligned
  unsigned char* buf;      // [stages][stage_bytes], 16-byte aligned
  uint32_t stage_bytes;
  int stages;

  __device__ void init() const {
    for (int s = 0; s < stages; ++s) mbar_init(full + s, 1);
    fence_mbar_init();
  }
  __device__ unsigned char* stage(int i) const {
    return buf + (size_t)(i % stages) * stage_bytes;
  }
  // item i's bytes (a multiple of 16, at most stage_bytes) from src
  __device__ void issue(int i, const void* src, uint32_t bytes) const {
    uint64_t* bar = full + i % stages;
    mbar_arrive_expect_tx(bar, bytes);
    load(stage(i), src, bytes, bar);
  }
  __device__ void wait(int i) const {
    mbar_wait(full + i % stages, (uint32_t)(i / stages) & 1u);
  }
};

}  // namespace bulk
