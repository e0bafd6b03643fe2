// Pieces shared by the bf16 flash bodies (the labs' wmma bodies
// csrc/flash_fwd.cuh and csrc/flash_bwd.cuh, and the wgmma bodies): the
// element type, the stride triple and the cp.async copies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

// Where a tensor lies: element (b, h, row, d) sits at
// b * Strides::b + h * Strides::h + row * Strides::row + d.
struct Strides {
  long long b, h, row;
};

// one 16-byte copy from device memory to shared memory, in flight until
// cp_async_wait_all
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace
