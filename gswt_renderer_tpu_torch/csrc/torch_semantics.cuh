// PyTorch's elementwise semantics on the card, shared by the kernels that
// repeat a plain PyTorch path bit for bit (project.cu, binning.cu) or round
// as it does (raster.cu, micro_raster.cu). A fix here reaches them all;
// ops/kernels.py rebuilds every source when this header changes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// x / c for a Python number c, as ATen divides on the card: x times the
// float reciprocal of c
__device__ __forceinline__ float divc(float x, float c) {
  return x * (1.0f / c);
}

// torch.clamp: NaN stays NaN; min then max as std::max / std::min
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  if (v != v) return v;
  v = v < lo ? lo : v;
  return hi < v ? hi : v;
}

__device__ __forceinline__ float clamp_min(float v, float lo) {
  if (v != v) return v;
  return v < lo ? lo : v;
}

// x.to(torch.bfloat16).to(torch.float32): round to nearest even; a NaN
// stays a NaN (its payload may differ from PyTorch's)
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

}  // namespace
