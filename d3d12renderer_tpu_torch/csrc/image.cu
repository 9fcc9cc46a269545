// The frame's image kernels: the separable gaussian blur and the filmic
// tonemap.
//
// * gaussian_blur replaces the JAX package's Pallas kernel
//   d3d12renderer_tpu/ops/pallas_kernels.py:122 `_blur_kernel`, and computes
//   render/post.py `gaussian_blur`'s function (`_sep_conv`): a 1-D filter of
//   2r+1 taps down the columns, then the same filter along the rows, each
//   edge-clamped, each output summed from zero in tap order.  The TPU kernel
//   held a whole channel image in VMEM and rolled it; here one block makes an
//   output tile of BLUR_TILE_W x BLUR_TILE_H pixels with all their channels
//   (an image of more channels than a block's shared memory holds goes in
//   slices of channels, one per grid.z).  It stages the tile's input rows
//   and its r-halo, clamped at the edges, in shared memory with asynchronous
//   copies (cp.async: every copy of a thread in flight at once; a warp's
//   lanes on neighbouring floats), runs the column pass from there into a
//   second shared buffer, and the row pass from that into rows of 64 C
//   contiguous output floats.  The intermediate never goes to device
//   memory.  One instance per radius and for C = 1 and 3 (any other C reads
//   it at run time), so the taps and the shared-memory strides are
//   constants.  Bound by bytes on the H100: H W C floats read
//   and written once (1080p RGB: 50 MB, 0.015 ms at 3.35 TB/s); the halo
//   re-reads (1.7x the tile's input at 64 x 16 and r = 4) come from L2.  Its
//   instructions (the 2 (2r+1) rounded operations per output, their loads,
//   the staging) take about as long at the SMs' issue rate.  Images of 0.1
//   MB and less (the small bloom levels) are bound by the launch's latency.
// * tonemap replaces `_tonemap_kernel` (pallas_kernels.py:57): exposure,
//   the Uncharted-2 curve normalised by its value at the linear white, a
//   clamp to [0, 1], and with `srgb` the encode of that kernel,
//   1.055 exp(log(max(x, 1e-7)) / 2.4) - 0.055 above 0.0031308, else 12.92 x.
//   Elementwise, bound by bytes (1080p RGB: 50 MB, 0.015 ms at 3.35 TB/s;
//   its ~14 operations per float take ~0.01 ms at the issue rate).  The
//   TPU kernel streamed (8, 128) tiles through VMEM; here the floats go as
//   16-byte vectors (a warp's lanes on neighbouring vectors), with floats
//   before the first 16-byte boundary and after the last whole vector done
//   one at a time (all of them where src and dst sit at different offsets
//   from a boundary).  One resident wave of blocks (the SM count times the
//   blocks an SM holds) walks the vectors TONEMAP_VECTORS at a time per
//   thread, every load of a round issued before its first store, so that
//   enough bytes are in flight to cover the memory's latency; every thread
//   then has the same work to within one vector.  Each byte is touched
//   once, so the loads and stores are marked evict-first (__ldcs /
//   __stcs), and `srgb` is a template parameter.
//
// Every operation is rounded on its own (rn_math.cuh) in the plain versions'
// order (ops/image.py), so both kernels return the plain versions' bits;
// the sRGB encode calls expf / logf, which may differ from PyTorch's by an
// ulp.  Launched through cudaLaunchKernel so that g++ can compile this file
// as host C++ for the CPU tests (one thread per block).

#include <cuda_runtime.h>

#include "rn_math.cuh"

constexpr int BLUR_TILE_W = 64;      // output pixels per tile row
constexpr int BLUR_TILE_H = 16;      // output rows per tile
constexpr int BLUR_MAX_RADIUS = 16;
constexpr int BLUR_MAX_TAPS = 2 * BLUR_MAX_RADIUS + 1;
constexpr int BLUR_THREADS_X = 32;
constexpr int BLUR_THREADS_Y = 8;
constexpr int TONEMAP_THREADS = 256;
constexpr int TONEMAP_VECTORS = 4;   // float4 loads in flight per thread
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
// df = D F, ef = E / F, white = the curve at the linear white; srgb picks
// the kernel's instance.
struct TonemapArgs {
  const float* src;
  float* dst;
  long long n;
  float scale, a, b, cb, de, df, ef, white;
  int srgb;
  int pad_;
};

// How a blur launches: the grid (tiles across, tiles down, channel slices)
// and the dynamic shared memory of a block, which holds `group` channels
// of a tile.
struct BlurPlan {
  int group;
  int grid_x;
  int grid_y;
  int grid_z;
  int shared_bytes;
};

namespace {

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Copies one float from device to shared memory without passing it through
// a register (cp.async), so that a thread has all its copies in flight at
// once; host builds copy at once.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
#else
  *dst = *src;
#endif
}

// Waits for this thread's copy_async copies.
__device__ __forceinline__ void copy_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
#endif
}

// sum_t A.taps[t] x[t stride] over the 2R+1 taps, from zero in tap order.
template <int R>
__device__ __forceinline__ float blur_taps(const BlurArgs& A, const float* x, int stride) {
  float acc = 0.0f;
#pragma unroll
  for (int t = 0; t <= 2 * R; ++t) acc = rn_add(acc, rn_mul(A.taps[t], x[t * stride]));
  return acc;
}

// One instance per radius R and channel count C (1 and 3, the frame's,
// with every channel in one block; 0 for any other count, read from A, a
// slice of ceil(C / gridDim.z) channels per block): the taps unrolled, each
// a kernel parameter at a fixed offset, and with C known the shared-memory
// strides too.
template <int R, int C>
__global__ void __launch_bounds__(BLUR_THREADS_X * BLUR_THREADS_Y)
gaussian_blur(const BlurArgs A) {
  DYNAMIC_SHARED(src);
  const int stride = C > 0 ? C : A.channels, W = A.width, H = A.height;
  const int group = C > 0 ? C : (stride + gridDim.z - 1) / gridDim.z;
  const int c0 = C > 0 ? 0 : blockIdx.z * group;
  const int ch = C > 0 ? C : (stride - c0 < group ? stride - c0 : group);
  if (ch <= 0) return;
  const int x0 = blockIdx.x * BLUR_TILE_W, y0 = blockIdx.y * BLUR_TILE_H;
  const int span = (BLUR_TILE_W + 2 * R) * ch;   // floats of a staged row
  float* inter = src + (BLUR_TILE_H + 2 * R) * span;
  // Input rows y0 - R .. y0 + BLUR_TILE_H - 1 + R, pixels x0 - R .. x0 +
  // BLUR_TILE_W - 1 + R, clamped (the row pass's edge clamp reads the
  // column pass at the clamped column); a warp's lanes on neighbouring
  // pixels.
  for (int row = threadIdx.y; row < BLUR_TILE_H + 2 * R; row += blockDim.y) {
    const float* line = A.src + (size_t)clampi(y0 - R + row, 0, H - 1) * W * stride + c0;
    for (int xs = threadIdx.x; xs < BLUR_TILE_W + 2 * R; xs += blockDim.x) {
      const float* from = line + clampi(x0 - R + xs, 0, W - 1) * stride;
      for (int c = 0; c < ch; ++c) copy_async(src + row * span + xs * ch + c, from + c);
    }
  }
  copy_async_wait();
  __syncthreads();
  const int rows = H - y0 < BLUR_TILE_H ? H - y0 : BLUR_TILE_H;
  for (int row = threadIdx.y; row < rows; row += blockDim.y)
    for (int e = threadIdx.x; e < span; e += blockDim.x)
      inter[row * span + e] = blur_taps<R>(A, src + row * span + e, span);
  __syncthreads();
  // Each output row: the tile's pixels times ch floats, contiguous in
  // device memory when the block has every channel.
  const int outs = (W - x0 < BLUR_TILE_W ? W - x0 : BLUR_TILE_W) * ch;
  for (int row = threadIdx.y; row < rows; row += blockDim.y) {
    float* out = A.dst + ((size_t)(y0 + row) * W + x0) * stride + c0;
    for (int o = threadIdx.x; o < outs; o += blockDim.x)
      out[ch == stride ? o : o / ch * stride + o % ch] =
          blur_taps<R>(A, inter + row * span + o, ch);
  }
}

using BlurKernel = void (*)(const BlurArgs);

// The instance for radius r (0 <= r <= BLUR_MAX_RADIUS) and a block of
// `group` of the image's c channels.
template <int R = 0>
BlurKernel blur_kernel(int r, int c, int group) {
  if constexpr (R > BLUR_MAX_RADIUS) {
    return nullptr;
  } else {
    if (r != R) return blur_kernel<R + 1>(r, c, group);
    if (group == c && c == 1) return gaussian_blur<R, 1>;
    if (group == c && c == 3) return gaussian_blur<R, 3>;
    return gaussian_blur<R, 0>;
  }
}

// One float in the plain version's operation order.
template <bool SRGB>
__device__ __forceinline__ float tonemap_one(const TonemapArgs& A, float x) {
  float v = rn_mul(x, A.scale);
  v = v < 0.0f ? 0.0f : v;                    // NaN stays NaN, as torch.clamp
  const float num = rn_add(rn_mul(v, rn_add(rn_mul(A.a, v), A.cb)), A.de);
  const float den = rn_add(rn_mul(v, rn_add(rn_mul(A.a, v), A.b)), A.df);
  float y = rn_div(rn_sub(rn_div(num, den), A.ef), A.white);
  y = y < 0.0f ? 0.0f : (y > 1.0f ? 1.0f : y);
  if (SRGB) {
    const float g = logf(y < 1e-7f ? 1e-7f : y);
    y = y <= 0.0031308f ? rn_mul(y, 12.92f)
                        : rn_sub(rn_mul(1.055f, expf(rn_mul(g, INV_GAMMA))), 0.055f);
  }
  return y;
}

// How a launch splits its n floats: `head` floats before src's first
// 16-byte boundary (all n where dst sits at another offset from one), then
// `vectors` float4, then `tail` floats.
struct TonemapSplit {
  long long head, vectors, tail;
};

__device__ __host__ __forceinline__ TonemapSplit tonemap_split(const TonemapArgs& A) {
  const unsigned long long s = reinterpret_cast<unsigned long long>(A.src);
  const unsigned long long d = reinterpret_cast<unsigned long long>(A.dst);
  long long head = ((s ^ d) & 15) ? A.n : (long long)((16 - (s & 15)) & 15) / 4;
  if (head > A.n) head = A.n;
  const long long vectors = (A.n - head) / 4;
  return {head, vectors, A.n - head - 4 * vectors};
}

template <bool SRGB>
__global__ void __launch_bounds__(TONEMAP_THREADS) tonemap(const TonemapArgs A) {
  const TonemapSplit split = tonemap_split(A);
  const long long thread = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long threads = (long long)gridDim.x * blockDim.x;
  const float4* src = reinterpret_cast<const float4*>(A.src + split.head);
  float4* dst = reinterpret_cast<float4*>(A.dst + split.head);
  for (long long base = thread; base < split.vectors; base += TONEMAP_VECTORS * threads) {
    float4 v[TONEMAP_VECTORS];
#pragma unroll
    for (int k = 0; k < TONEMAP_VECTORS; ++k)
      if (base + k * threads < split.vectors) v[k] = __ldcs(src + base + k * threads);
#pragma unroll
    for (int k = 0; k < TONEMAP_VECTORS; ++k) {
      if (base + k * threads >= split.vectors) break;
      float4 y;
      y.x = tonemap_one<SRGB>(A, v[k].x);
      y.y = tonemap_one<SRGB>(A, v[k].y);
      y.z = tonemap_one<SRGB>(A, v[k].z);
      y.w = tonemap_one<SRGB>(A, v[k].w);
      __stcs(dst + base + k * threads, y);
    }
  }
  // The head and tail floats, one per thread.
  const long long tail0 = split.head + 4 * split.vectors;
  for (long long j = thread; j < split.head + split.tail; j += threads) {
    const long long i = j < split.head ? j : tail0 + (j - split.head);
    A.dst[i] = tonemap_one<SRGB>(A, A.src[i]);
  }
}

using TonemapKernel = void (*)(const TonemapArgs);

TonemapKernel tonemap_kernel(int srgb) { return srgb ? tonemap<true> : tonemap<false>; }

// The blocks of a tonemap launch: enough for one vector round of every
// thread (or one float each where all go one at a time), at most
// `resident` (the blocks the card holds at once).
long long tonemap_blocks(const TonemapArgs& a, long long resident) {
  const TonemapSplit split = tonemap_split(a);
  long long work = (split.vectors + TONEMAP_VECTORS - 1) / TONEMAP_VECTORS;
  if (work < split.head + split.tail) work = split.head + split.tail;
  const long long blocks = (work + TONEMAP_THREADS - 1) / TONEMAP_THREADS;
  return blocks < resident ? blocks : resident;
}

// The blocks of a tonemap instance that `device` holds at once: its SM
// count times the blocks an SM holds, queried once per device and instance.
cudaError_t tonemap_resident(int device, int srgb, long long* resident) {
  static int cache[2][64] = {};   // 0: not queried yet
  int* slot = device >= 0 && device < 64 ? &cache[srgb != 0][device] : nullptr;
  if (slot != nullptr && *slot > 0) {
    *resident = *slot;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)tonemap_kernel(srgb),
                                                        TONEMAP_THREADS, 0);
  if (err != cudaSuccess) return err;
  *resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (slot != nullptr) *slot = (int)*resident;
  return cudaSuccess;
}

// The plan of a blur on a card whose blocks may have `shared_limit` bytes
// of shared memory: as many channels per block as fit, split evenly over
// the fewest slices; -1 when not even one channel of a tile fits.
int blur_plan(const BlurArgs& a, int shared_limit, BlurPlan* p) {
  const long long per_channel =
      4LL * (2 * BLUR_TILE_H + 2 * a.radius) * (BLUR_TILE_W + 2 * a.radius);
  const long long fit = shared_limit / per_channel;
  if (fit < 1) return -1;
  const int slices = (int)((a.channels + fit - 1) / fit);
  const int group = (a.channels + slices - 1) / slices;
  *p = {group, (a.width + BLUR_TILE_W - 1) / BLUR_TILE_W,
        (a.height + BLUR_TILE_H - 1) / BLUR_TILE_H, slices, (int)(per_channel * group)};
  return 0;
}

cudaError_t launch(const void* kernel, dim3 grid, dim3 block, void** params, int shared_bytes,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (shared_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return err;
  }
  err = cudaLaunchKernel(kernel, grid, block, params, shared_bytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int blur_args_size() { return (int)sizeof(BlurArgs); }

extern "C" int tonemap_args_size() { return (int)sizeof(TonemapArgs); }

extern "C" int blur_max_radius() { return BLUR_MAX_RADIUS; }

// Both launch on `stream` and return cudaGetLastError() after the launch
// (0 = ok); the blur -1 for a radius outside [0, BLUR_MAX_RADIUS] or when
// not even one channel of a tile fits in a block's shared memory.
extern "C" int gaussian_blur_launch(const BlurArgs* args, int device, void* stream) {
  if (args->radius < 0 || args->radius > BLUR_MAX_RADIUS) return -1;
  if (args->height == 0 || args->width == 0 || args->channels == 0) return 0;
  int limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  BlurPlan plan;
  if (blur_plan(*args, limit, &plan) != 0) return -1;
  const BlurArgs a = *args;
  void* params[] = {(void*)&a};
  return (int)launch((const void*)blur_kernel(a.radius, a.channels, plan.group),
                     dim3(plan.grid_x, plan.grid_y, plan.grid_z), dim3(BLUR_THREADS_X, BLUR_THREADS_Y),
                     params, plan.shared_bytes, device, stream);
}

extern "C" int tonemap_launch(const TonemapArgs* args, int device, void* stream) {
  if (args->n == 0) return 0;
  const TonemapArgs a = *args;
  long long resident = 0;
  const cudaError_t err = tonemap_resident(device, a.srgb, &resident);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {(void*)&a};
  return (int)launch((const void*)tonemap_kernel(a.srgb), dim3((unsigned)tonemap_blocks(a, resident)),
                     dim3(TONEMAP_THREADS), params, 0, device, stream);
}
