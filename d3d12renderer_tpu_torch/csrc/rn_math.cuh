// Float operations rounded one at a time, shared by the kernels whose
// results must equal their plain PyTorch versions bit for bit; and the
// block's dynamic shared memory.
//
// On the card the _rn intrinsics forbid nvcc's FMA contraction, so a * b + c
// is rounded twice, as PyTorch's separate tensor ops round it.  Compiled as
// host C++ (the CPU tests, g++ -ffp-contract=off) they are the plain
// operators.
#pragma once

#include <cuda_runtime.h>

// `float* name`: the block's dynamic shared memory, 16-byte aligned.  Host
// builds of the kernel sources define it as a buffer of their own.
#ifndef DYNAMIC_SHARED
#define DYNAMIC_SHARED(name)                  \
  extern __shared__ float4 name##_storage[]; \
  float* name = reinterpret_cast<float*>(name##_storage)
#endif

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
