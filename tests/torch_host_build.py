"""Builds a CUDA kernel source of `d3d12renderer_tpu_torch/csrc` as host
C++ for the CPU tests: g++ with -ffp-contract=off (no FMA contraction, so
each operation rounds as the plain PyTorch version's does), the CUDA
qualifiers and runtime stubbed, and a harness that runs the kernel body
once per block with one thread.  A kernel's dynamic shared memory
(`DYNAMIC_SHARED` of csrc/rn_math.cuh) is `host_dynamic_shared`, which
the harness sizes; the streaming loads and stores (`__ldcs` / `__stcs`)
are plain ones; `__syncwarp` does nothing (a team is one lane), a
warp vote returns the one lane's predicate and a ballot its one bit; the
solver kernels' bulk copies copy at once when not compiled for the card."""

import ctypes
import shutil
import subprocess

import pytest

from d3d12renderer_tpu_torch import cuda_build

STUB_RUNTIME = """\
#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static dim3 blockIdx(0), blockDim(1), threadIdx(0), gridDim(1);
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0 };
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcs(const T* p) { return *p; }
template <class T> inline void __stcs(T* p, T v) { *p = v; }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline unsigned __float_as_uint(float f) { unsigned i; memcpy(&i, &f, 4); return i; }
inline float __uint_as_float(unsigned i) { float f; memcpy(&f, &i, 4); return f; }
template <class T> inline T __ldcg(const T* p) { return *p; }
inline int atomicAdd(int* p, int v) { int o = *p; *p += v; return o; }
inline unsigned long long atomicMax(unsigned long long* p,
                                    unsigned long long v) {
  unsigned long long o = *p; if (v > o) *p = v; return o;
}
inline void __threadfence() {}
inline int atomicOr(int* p, int v) { int o = *p; *p |= v; return o; }
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  unsigned long long o = *p; *p += v; return o;
}
inline void __syncthreads() {}
inline int __syncthreads_or(int p) { return p; }
inline int __syncthreads_and(int p) { return p; }
inline int __syncthreads_count(int p) { return p; }
inline float __shfl_xor_sync(unsigned, float v, int) { return v; }
inline void __syncwarp(unsigned = 0xffffffffu) {}
inline bool __any_sync(unsigned, bool p) { return p; }
inline unsigned __ballot_sync(unsigned, bool p) { return p ? 1u : 0u; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
static std::vector<float> host_dynamic_shared;
#define DYNAMIC_SHARED(name) float* name = host_dynamic_shared.data()
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr {
  cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97
};
inline cudaError_t cudaSetDevice(int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaLaunchKernel(const void*, dim3, dim3, void**, size_t,
                                    cudaStream_t) { return 0; }
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) {
  return 0;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? 132 : 232448;
  return 0;
}
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, const void*, int, size_t) {
  *n = 0;
  return 0;
}
"""


def build_host(tmp_path_factory, name, harness, symbols):
    """A csrc kernel source built as host C++ (g++ -ffp-contract=off), the
    CUDA qualifiers and runtime stubbed; `symbols` get int restypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source as host code")
    d = tmp_path_factory.mktemp(name)
    (d / "cuda_runtime.h").write_text(STUB_RUNTIME)
    (d / "harness.cpp").write_text(harness)
    lib = d / f"lib{name}.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", f"-I{d}", f"-I{cuda_build.CSRC_DIR}",
                    str(d / "harness.cpp"), "-o", str(lib)],
                   check=True, capture_output=True, text=True)
    host = ctypes.CDLL(str(lib))
    for sym in symbols:
        getattr(host, sym).restype = ctypes.c_int
    return host
