// The frame's image kernels: the separable gaussian blur and the filmic
// tonemap.
//
// * gaussian_blur replaces the JAX package's Pallas kernel
//   d3d12renderer_tpu/ops/pallas_kernels.py:122 `_blur_kernel`, and computes
//   render/post.py `gaussian_blur`'s function (`_sep_conv`): a 1-D filter of
//   2r+1 taps down the columns, then the same filter along the rows, each
//   edge-clamped, each output summed from zero in tap order.  The TPU kernel
//   held a whole channel image in VMEM and rolled it; here one block makes a
//   32x32 output tile of one channel: the column pass for the tile's rows and
//   its 2r halo columns into shared memory (8 KB), then the row pass from
//   there, so the intermediate never goes to device memory.  Bound by bytes
//   on the H100: H W C floats read and written once (1080p RGB: 50 MB, 0.015
//   ms at 3.35 TB/s); the 2 (2r+1) operations per output are 0.002 ms.
// * tonemap replaces `_tonemap_kernel` (pallas_kernels.py:57): exposure,
//   the Uncharted-2 curve normalised by its value at the linear white, a
//   clamp to [0, 1], and with `srgb` the encode of that kernel,
//   1.055 exp(log(max(x, 1e-7)) / 2.4) - 0.055 above 0.0031308, else 12.92 x.
//   Elementwise, bound by bytes (1080p RGB: 50 MB, 0.015 ms).
//
// Every operation is rounded on its own (rn_math.cuh) in the plain versions'
// order (ops/image.py), so both kernels return the plain versions' bits;
// the sRGB encode calls expf / logf, which may differ from PyTorch's by an
// ulp.  Launched through cudaLaunchKernel so that g++ can compile this file
// as host C++ for the CPU tests (one thread per block).

#include <cuda_runtime.h>

#include "rn_math.cuh"

constexpr int BLUR_TILE = 32;
constexpr int BLUR_MAX_RADIUS = 16;
constexpr int BLUR_MAX_TAPS = 2 * BLUR_MAX_RADIUS + 1;
constexpr int BLUR_THREADS = 256;
constexpr int TONEMAP_THREADS = 256;
// The float32 nearest 1 / 2.4 (not 1.0f / 2.4f, which rounds twice).
constexpr float INV_GAMMA = 0.4166666666666667f;

// One blur launch: src and dst (height, width, channels) contiguous float32.
struct BlurArgs {
  const float* src;
  float* dst;
  int height;
  int width;
  int channels;
  int radius;                  // <= BLUR_MAX_RADIUS
  float taps[BLUR_MAX_TAPS];   // 2 radius + 1 used
  int pad_;
};

// One tonemap launch over n floats.  The constants are float32 values
// computed by the wrapper: scale = 2^exposure, cb = C B, de = D E,
// df = D F, ef = E / F, white = the curve at the linear white.
struct TonemapArgs {
  const float* src;
  float* dst;
  long long n;
  float scale, a, b, cb, de, df, ef, white;
  int srgb;
  int pad_;
};

namespace {

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(BLUR_THREADS) gaussian_blur(const BlurArgs A) {
  __shared__ float inter[BLUR_TILE * (BLUR_TILE + 2 * BLUR_MAX_RADIUS)];
  const int x0 = blockIdx.x * BLUR_TILE, y0 = blockIdx.y * BLUR_TILE;
  const int c = blockIdx.z, C = A.channels, r = A.radius, k = 2 * r + 1;
  const int span = BLUR_TILE + 2 * r;
  // Column pass: rows y0.. of the tile, columns x0 - r .. x0 + 31 + r
  // (clamped: the row pass's edge clamp reads the clamped column).
  for (int i = threadIdx.x; i < BLUR_TILE * span; i += blockDim.x) {
    const int yy = i / span, xs = i % span, y = y0 + yy;
    if (y >= A.height) continue;
    const int x = clampi(x0 - r + xs, 0, A.width - 1);
    float acc = 0.0f;
    for (int t = 0; t < k; ++t) {
      const int ys = clampi(y + t - r, 0, A.height - 1);
      acc = rn_add(acc, rn_mul(A.taps[t], A.src[((size_t)ys * A.width + x) * C + c]));
    }
    inter[yy * span + xs] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BLUR_TILE * BLUR_TILE; i += blockDim.x) {
    const int yy = i / BLUR_TILE, xx = i % BLUR_TILE;
    const int y = y0 + yy, x = x0 + xx;
    if (y >= A.height || x >= A.width) continue;
    float acc = 0.0f;
    for (int t = 0; t < k; ++t) acc = rn_add(acc, rn_mul(A.taps[t], inter[yy * span + xx + t]));
    A.dst[((size_t)y * A.width + x) * C + c] = acc;
  }
}

__global__ void __launch_bounds__(TONEMAP_THREADS) tonemap(const TonemapArgs A) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < A.n;
       i += stride) {
    float v = rn_mul(A.src[i], A.scale);
    v = v < 0.0f ? 0.0f : v;                  // NaN stays NaN, as torch.clamp
    const float num = rn_add(rn_mul(v, rn_add(rn_mul(A.a, v), A.cb)), A.de);
    const float den = rn_add(rn_mul(v, rn_add(rn_mul(A.a, v), A.b)), A.df);
    float y = rn_div(rn_sub(rn_div(num, den), A.ef), A.white);
    y = y < 0.0f ? 0.0f : (y > 1.0f ? 1.0f : y);
    if (A.srgb) {
      const float g = logf(y < 1e-7f ? 1e-7f : y);
      y = y <= 0.0031308f ? rn_mul(y, 12.92f)
                          : rn_sub(rn_mul(1.055f, expf(rn_mul(g, INV_GAMMA))), 0.055f);
    }
    A.dst[i] = y;
  }
}

cudaError_t launch(const void* kernel, dim3 grid, dim3 block, const void* args,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  void* params[] = {const_cast<void*>(args)};
  err = cudaLaunchKernel(kernel, grid, block, params, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int blur_args_size() { return (int)sizeof(BlurArgs); }

extern "C" int tonemap_args_size() { return (int)sizeof(TonemapArgs); }

extern "C" int blur_max_radius() { return BLUR_MAX_RADIUS; }

// Both launch on `stream` and return cudaGetLastError() after the launch
// (0 = ok); -1 for a radius outside [0, BLUR_MAX_RADIUS].
extern "C" int gaussian_blur_launch(const BlurArgs* args, int device, void* stream) {
  if (args->radius < 0 || args->radius > BLUR_MAX_RADIUS) return -1;
  if (args->height == 0 || args->width == 0 || args->channels == 0) return 0;
  const BlurArgs a = *args;
  const dim3 grid((a.width + BLUR_TILE - 1) / BLUR_TILE,
                  (a.height + BLUR_TILE - 1) / BLUR_TILE, a.channels);
  return (int)launch((const void*)gaussian_blur, grid, dim3(BLUR_THREADS), &a,
                     device, stream);
}

extern "C" int tonemap_launch(const TonemapArgs* args, int device, void* stream) {
  if (args->n == 0) return 0;
  const TonemapArgs a = *args;
  long long blocks = (a.n + TONEMAP_THREADS - 1) / TONEMAP_THREADS;
  if (blocks > 65535) blocks = 65535;
  return (int)launch((const void*)tonemap, dim3((unsigned)blocks),
                     dim3(TONEMAP_THREADS), &a, device, stream);
}
