// Pieces shared by the bf16 flash bodies (csrc/flash_fwd_sm90.cuh,
// csrc/flash_bwd_sm90.cuh and their wide and float32 kin): the element type
// and the stride triple.
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

}  // namespace
