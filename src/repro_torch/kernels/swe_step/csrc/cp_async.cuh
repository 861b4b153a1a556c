// Ampere-and-later asynchronous copies (cp.async, 16 bytes a thread, global
// -> shared through L2 only) for the swe_step kernel.  Inline PTX only.
#pragma once

#include <cstdint>

namespace cp_async {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global `src` to shared `dst`, both 16-byte aligned
__device__ __forceinline__ void copy16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

// closes this thread's copies issued since the last commit into one group
__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace cp_async
