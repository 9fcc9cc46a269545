// Float operations rounded one at a time, shared by the kernels whose
// results must equal their plain PyTorch versions bit for bit.
//
// On the card the _rn intrinsics forbid nvcc's FMA contraction, so a * b + c
// is rounded twice, as PyTorch's separate tensor ops round it.  Compiled as
// host C++ (the CPU tests, g++ -ffp-contract=off) they are the plain
// operators.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float rn_mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

__device__ __forceinline__ float rn_add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

__device__ __forceinline__ float rn_sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

__device__ __forceinline__ float rn_div(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}
