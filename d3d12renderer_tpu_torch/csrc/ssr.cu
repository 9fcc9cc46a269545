// The screen-space reflections' march (render/post.py `ssr`): one thread per
// pixel walks the linear-depth min-pyramid from its reflected ray's start,
// hierarchical-Z style, for at most `steps` steps, and writes where it hit.
//
// It replaces the march loop of `ssr_march_plain` (ops/ssr.py), 64 steps of
// about 45 tensor operations each over the whole half-res image (about
// 2,900 launches a frame, or as many nodes of a CUDA graph): here a pixel's
// state (t, mip level, found) lives in registers for the whole march, and a
// pixel stops at its hit (its state cannot change after it).  Each step reads
// one pyramid texel, so the kernel is bound by the pyramid's reads from L2
// (a half-res 960 x 540 frame's pyramid is 2.8 MB) and by its ~40 rounded
// operations a step; the bytes it must move are its 7 inputs and 2 outputs
// a pixel (36 bytes) and the pyramid once.
//
// Every operation is rounded on its own (rn_math.cuh) in the plain loop's
// order, the comparisons and the integer steps as PyTorch's, minimum and
// maximum propagating NaN as torch.minimum / torch.maximum do, so the
// kernel returns the plain loop's bits.  Launched through cudaLaunchKernel
// so that g++ can compile this file as host C++ for the CPU tests.

#include <cuda_runtime.h>

#include "rn_math.cuh"

constexpr int SSR_THREADS = 256;
constexpr int SSR_MAX_MIPS = 8;

// The argument block (ops/ssr.py `SsrArgs`).
struct SsrArgs {
  const float* x0;      // (n,) the ray's start in pixels
  const float* y0;
  const float* dx;      // (n,) its end minus its start
  const float* dy;
  const float* k0;      // (n,) 1 / depth at its start
  const float* dk;      // (n,) 1 / depth at its end minus k0
  const float* t_max;   // (n,) where it leaves the image, in [0, 1]
  const float* pyramid; // every level of the min-pyramid, row-major, flat
  float* t_hit;         // (n,) out: the march parameter of the hit, 0 if none
  int* found;           // (n,) out: 1 where it hit
  long long n;
  int steps;
  int mips;
  float thickness;
  int pad_;
  int offsets[SSR_MAX_MIPS];
  int widths[SSR_MAX_MIPS];
  int heights[SSR_MAX_MIPS];
};

namespace {

__device__ __forceinline__ bool nan_f(float a) { return a != a; }

// torch.minimum / torch.maximum: NaN if either is NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (nan_f(a) || nan_f(b)) ? a + b : (a < b ? a : b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (nan_f(a) || nan_f(b)) ? a + b : (a > b ? a : b);
}

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// torch.div(a, b, rounding_mode="floor") of int32 with b > 0.
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

struct Ray {
  float x0, y0, dx, dy, k0, dk, t_max, sx, sy;
};

// `cell_exit_t`: the march parameter where the ray leaves its level-`mip`
// cell at parameter t.
__device__ __forceinline__ float cell_exit(const Ray& r, float t, int mip) {
  const float size = (float)(1 << mip);
  const float x = rn_add(r.x0, rn_mul(t, r.dx));
  const float y = rn_add(r.y0, rn_mul(t, r.dy));
  const float bx = rn_add(rn_mul(rn_add(floorf(rn_div(x, size)), r.sx > 0.0f ? 1.0f : 0.0f), size),
                          rn_mul(r.sx, 0.01f));
  const float by = rn_add(rn_mul(rn_add(floorf(rn_div(y, size)), r.sy > 0.0f ? 1.0f : 0.0f), size),
                          rn_mul(r.sy, 0.01f));
  const float inf = __uint_as_float(0x7f800000u);
  const float tx = fabsf(r.dx) > 1e-6f ? rn_div(rn_sub(bx, r.x0), r.dx) : inf;
  const float ty = fabsf(r.dy) > 1e-6f ? rn_div(rn_sub(by, r.y0), r.dy) : inf;
  return min_nan(tx, ty);
}

// `z_at`: the ray's depth at parameter t.
__device__ __forceinline__ float z_at(const Ray& r, float t) {
  return rn_div(1.0f, clamp_min(rn_add(r.k0, rn_mul(t, r.dk)), 1e-8f));
}

}  // namespace

// One pixel's march (the kernel's thread; the CPU tests call it per pixel).
__device__ void ssr_march_pixel(const SsrArgs& A, long long i) {
  Ray r;
  r.x0 = A.x0[i];
  r.y0 = A.y0[i];
  r.dx = A.dx[i];
  r.dy = A.dy[i];
  r.k0 = A.k0[i];
  r.dk = A.dk[i];
  r.t_max = A.t_max[i];
  r.sx = r.dx >= 0.0f ? 1.0f : -1.0f;
  r.sy = r.dy >= 0.0f ? 1.0f : -1.0f;
  int mip = 0;
  float t = min_nan(cell_exit(r, 0.0f, 0), r.t_max);
  float t_hit = 0.0f;
  bool found = false;
  for (int s = 0; s < A.steps && !found; ++s) {
    const float t_exit = min_nan(cell_exit(r, t, mip), r.t_max);
    const float x = rn_add(r.x0, rn_mul(t, r.dx));
    const float y = rn_add(r.y0, rn_mul(t, r.dy));
    const int size_i = 1 << mip;
    const int mw = A.widths[mip], mh = A.heights[mip];
    int cx = floor_div((int)x, size_i);
    cx = cx < 0 ? 0 : cx;
    cx = cx < mw - 1 ? cx : mw - 1;
    int cy = floor_div((int)y, size_i);
    cy = cy < 0 ? 0 : cy;
    cy = cy < mh - 1 ? cy : mh - 1;
    const float zmin = A.pyramid[(long long)(A.offsets[mip] + cy * mw + cx)];
    const float z_a = z_at(r, t), z_b = z_at(r, t_exit);
    const float z_far = max_nan(z_a, z_b);
    const bool in_front = z_far < rn_add(zmin, 0.01f);
    const bool hit_now = mip == 0 && !in_front && z_far >= zmin &&
                         min_nan(z_a, z_b) <= rn_add(zmin, A.thickness);
    const bool advance = in_front || (mip == 0 && !hit_now);
    if (hit_now) {
      t_hit = t;
      found = true;
    } else if (advance) {
      t = t_exit;
      mip = mip + 1 < A.mips - 1 ? mip + 1 : A.mips - 1;
    } else {
      mip = mip - 1 > 0 ? mip - 1 : 0;
    }
  }
  A.t_hit[i] = t_hit;
  A.found[i] = found ? 1 : 0;
}

__global__ void __launch_bounds__(SSR_THREADS) ssr_march_kernel(const SsrArgs A) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < A.n) ssr_march_pixel(A, i);
}

extern "C" int ssr_args_size() { return (int)sizeof(SsrArgs); }

extern "C" int ssr_max_mips() { return SSR_MAX_MIPS; }

// Launches on `stream`; returns cudaGetLastError() after the launch (0 =
// ok), -1 for a pyramid of more than SSR_MAX_MIPS levels.
extern "C" int ssr_march_launch(const SsrArgs* args, int device, void* stream) {
  if (args->mips < 1 || args->mips > SSR_MAX_MIPS) return -1;
  if (args->n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const SsrArgs a = *args;
  void* params[] = {(void*)&a};
  const unsigned blocks = (unsigned)((a.n + SSR_THREADS - 1) / SSR_THREADS);
  err = cudaLaunchKernel((const void*)ssr_march_kernel, dim3(blocks), dim3(SSR_THREADS), params, 0,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
