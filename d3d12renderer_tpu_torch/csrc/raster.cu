// The tile rasterizer's kernel: primary visibility of a pinhole camera by
// 2D-homogeneous edge functions, one block per 64x32-pixel screen tile.
//
// Replaces the JAX package's Pallas kernel
// d3d12renderer_tpu/ops/raster_pallas.py:329 `_raster_kernel` on its pair
// path (`rasterize_pairs`, binning="tri").  What it computes is the same:
// per pixel p = (x + jitter_x, y + jitter_y, 1) and per triangle of its tile,
// the edge values e_i = E_i . p and the depth attribute q = Q . p (q = 1/view
// depth); the triangle covers the pixel in front of the camera when
// e0, e1, e2 >= 0 and 0 < q < inf; the pixel keeps the largest such q, and
// writes q, the triangle's id and its perspective-correct barycentrics
// u = e1 / q, v = e2 / q.
//
// What the TPU needed and this does not: 128-triangle visits gathered into
// lane-aligned tables, an MXU matmul per visit, a packed max key that drops
// q's low mantissa bits, lane-replicated outputs and SMEM slab loops.  Here a
// tile's (tile, triangle) pairs are one contiguous run of the sorted pair list
// (binning in ops/raster.py, in PyTorch); the block walks that run in order,
// staging RASTER_STAGE plane rows at a time in shared memory, and each thread
// keeps its pixels' best hit in registers.  A candidate wins only with a
// strictly larger q, so among equal q the first pair in the run wins.
//
// Bounds on the H100: the plane test is 4 two-term dots (16 operations) and 6
// compares per (pair, pixel), so at P pairs a frame does P x 2048 x 22
// operations over 67 TFLOP/s (PERF.md's kernel table, row 5, gives the
// atrium's pair count and bound at 1080p); it reads 48 bytes per pair and
// writes 16 bytes per pixel (0.01 ms at 1080p).  The
// kernel is bound by operations; this first version does every pair of a
// tile for every pixel (no early-out once a tile is covered nearer).
//
// Every operation is rounded on its own (rn_math.cuh) in the plain version's
// order, e = (ex * px + ey * py) + ew, so the kernel returns the same bits.
// It launches through cudaLaunchKernel so that g++ can compile this file as
// host C++ for the CPU tests, which run one thread per block.

#include <cfloat>

#include <cuda_runtime.h>

#include "rn_math.cuh"

constexpr int RASTER_TILE_X = 64;
constexpr int RASTER_TILE_Y = 32;
constexpr int RASTER_PX = RASTER_TILE_X * RASTER_TILE_Y;
constexpr int RASTER_PLANE_COLS = 12;  // e0, e1, e2, q rows of (x, y, w)
constexpr int RASTER_THREADS = 256;
constexpr int RASTER_STAGE = 128;      // plane rows staged per step (6 KB)

// One launch.  Device pointers of contiguous tensors.
struct RasterArgs {
  const float* planes;    // (T, RASTER_PLANE_COLS)
  const int* pair_tri;    // (P,) triangle of each pair, sorted by tile
  const int* seg;         // (n_tiles + 1,) tile t's pairs: [seg[t], seg[t+1])
  const float* jitter;    // (2,) sub-pixel sample offset
  float* q_out;           // (rows * row_pixels,) row-major, 0 on a miss
  int* tri_out;           // -1 on a miss
  float* u_out;           // 0 on a miss
  float* v_out;
  int ntx;                // tiles per row
  int n_tiles;
  int row_pixels;         // image width (a multiple of RASTER_TILE_X)
  int pad_;
};

namespace {

__device__ __forceinline__ float edge(float ex, float ey, float ew, float px,
                                      float py) {
  return rn_add(rn_add(rn_mul(ex, px), rn_mul(ey, py)), ew);
}

// PPT pixels per thread: RASTER_PX / RASTER_THREADS on the card, all of a
// tile's pixels for the one-thread blocks of the host tests.
template <int PPT>
__global__ void __launch_bounds__(RASTER_PX / PPT) raster_tiles(const RasterArgs A) {
  __shared__ float s_plane[RASTER_STAGE * RASTER_PLANE_COLS];
  __shared__ int s_tri[RASTER_STAGE];
  const int tile = blockIdx.x;
  const int tx0 = (tile % A.ntx) * RASTER_TILE_X;
  const int ty0 = (tile / A.ntx) * RASTER_TILE_Y;
  const float jx = A.jitter[0], jy = A.jitter[1];
  float px[PPT], py[PPT], best_q[PPT], best_e1[PPT], best_e2[PPT];
  int best_tri[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int r = threadIdx.x + j * blockDim.x;
    px[j] = rn_add((float)(tx0 + r % RASTER_TILE_X), jx);
    py[j] = rn_add((float)(ty0 + r / RASTER_TILE_X), jy);
    best_q[j] = 0.0f;
    best_e1[j] = best_e2[j] = 0.0f;
    best_tri[j] = -1;
  }
  const int begin = A.seg[tile], end = A.seg[tile + 1];
  for (int base = begin; base < end; base += RASTER_STAGE) {
    const int n = end - base < RASTER_STAGE ? end - base : RASTER_STAGE;
    __syncthreads();                                   // last stage consumed
    for (int i = threadIdx.x; i < n * RASTER_PLANE_COLS; i += blockDim.x)
      s_plane[i] = A.planes[(size_t)A.pair_tri[base + i / RASTER_PLANE_COLS] *
                                RASTER_PLANE_COLS + i % RASTER_PLANE_COLS];
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_tri[i] = A.pair_tri[base + i];
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float* p = s_plane + k * RASTER_PLANE_COLS;
      const int tri = s_tri[k];
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const float e0 = edge(p[0], p[1], p[2], px[j], py[j]);
        const float e1 = edge(p[3], p[4], p[5], px[j], py[j]);
        const float e2 = edge(p[6], p[7], p[8], px[j], py[j]);
        const float q = edge(p[9], p[10], p[11], px[j], py[j]);
        // NaN planes (degenerate and padding triangles) fail every compare.
        if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && q > 0.0f && q <= FLT_MAX &&
            q > best_q[j]) {
          best_q[j] = q;
          best_e1[j] = e1;
          best_e2[j] = e2;
          best_tri[j] = tri;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int r = threadIdx.x + j * blockDim.x;
    const size_t o = (size_t)(ty0 + r / RASTER_TILE_X) * A.row_pixels + tx0 +
                     r % RASTER_TILE_X;
    const bool hit = best_tri[j] >= 0;
    const float qs = best_q[j] < 1e-30f ? 1e-30f : best_q[j];
    A.q_out[o] = best_q[j];
    A.tri_out[o] = best_tri[j];
    A.u_out[o] = hit ? rn_div(best_e1[j], qs) : 0.0f;
    A.v_out[o] = hit ? rn_div(best_e2[j], qs) : 0.0f;
  }
}

}  // namespace

extern "C" int raster_args_size() { return (int)sizeof(RasterArgs); }

// Launches one block per tile on `stream`; returns cudaGetLastError() after
// the launch (0 = ok).
extern "C" int raster_launch(const RasterArgs* args, int device, void* stream) {
  if (args->n_tiles == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const RasterArgs a = *args;
  void* params[] = {(void*)&a};
  err = cudaLaunchKernel((const void*)raster_tiles<RASTER_PX / RASTER_THREADS>,
                         dim3(a.n_tiles), dim3(RASTER_THREADS), params, 0,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
