// The tile rasterizer's kernels: primary visibility of a pinhole camera by
// 2D-homogeneous edge functions over 64x32-pixel screen tiles.
// `raster_tiles` (below) is the pair path, one block per row band of a
// tile; `raster_groups` (at the end of the file) the group path with its
// early-out, one block per tile.
//
// Replaces the JAX package's Pallas kernel
// d3d12renderer_tpu/ops/raster_pallas.py:329 `_raster_kernel`, on its pair
// path (`rasterize_pairs`, binning="tri") and on its group path
// (`rasterize`, binning="group" and the occlusion feedback).  What it computes is the same:
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
// The cull plays the part of JAX's early-out (raster_pallas.py:415-418), on
// another bound.  JAX skips a 128-pair visit when every pixel already holds
// a q above the visit's bound, the largest q at its triangles' vertices; but
// the float32 planes of sub-pixel triangles cover samples outside them with
// any q, so that bound does not hold (PERF.md §6).  Here, at each stage,
// the block takes the least best q of its pixels (a warp-shuffle minimum in
// the barrier that opens the stage) and, while staging each row, the largest
// q its plane gives at any sample of the band: q = (qx px + qy py) + qw,
// each operation rounded, is monotone in px and in py, so that largest is
// the plane at one corner sample, picked by the signs of qx and qy, and it
// is exact.  A pair whose largest q is at most the least best q cannot win
// a pixel (a win needs a strictly larger q) and is culled.  The pairs keep
// their front-to-back order, so the near ones raise the least best q early;
// the result is that of the walk without culling, bit for bit.
//
// A tile is split into RASTER_BANDS row bands, one block per band, each
// walking the tile's whole run and culling against its own pixels: the
// heaviest tiles (thousands of pairs) spread over more SMs, and a band
// covered near the camera culls more than the whole tile would.  Two bands
// were the fastest of 1, 2 and 4 on the H100 (PERF.md §6).
//
// Bounds on the H100: the plane test is 4 two-term dots (16 operations) and 6
// compares per (pair, pixel), so at P (pair, band) tests a frame does P x
// (2048 / RASTER_BANDS) x 22 operations over 67 TFLOP/s; it reads 48 bytes
// per pair and writes 16 bytes per pixel.  With P the tests any exact cull
// must run, the two bounds are close on the atrium at 1080p (PERF.md's
// kernel table, row 5).
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
constexpr int RASTER_PPT = 8;          // pixels per thread on the card
constexpr int RASTER_STAGE = 128;      // plane rows staged per step (6 KB)
constexpr int RASTER_BANDS = 2;        // blocks per tile, one per row band
constexpr int RASTER_BAND_PX = RASTER_PX / RASTER_BANDS;
static_assert(RASTER_BAND_PX % (RASTER_PPT * 32) == 0,
              "a band is whole warps of RASTER_PPT pixels a thread");

// One launch.  Device pointers of contiguous tensors.
struct RasterArgs {
  const float* planes;      // (T, RASTER_PLANE_COLS), 16-byte aligned
  const int* pair_tri;      // (P,) triangle of each pair, sorted by tile
  const int* seg;           // (n_tiles + 1,) tile t's pairs: [seg[t], seg[t+1])
  const float* jitter;      // (2,) sub-pixel sample offset
  float* q_out;             // (rows * row_pixels,) row-major, 0 on a miss
  int* tri_out;             // -1 on a miss
  float* u_out;             // 0 on a miss
  float* v_out;
  unsigned long long* stats;  // null, or (2,) += pairs tested, pairs culled
  int ntx;                  // tiles per row
  int n_tiles;
  int row_pixels;           // image width (a multiple of RASTER_TILE_X)
};

namespace {

__device__ __forceinline__ float edge(float ex, float ey, float ew, float px,
                                      float py) {
  return rn_add(rn_add(rn_mul(ex, px), rn_mul(ey, py)), ew);
}

// The least of a warp's values (every lane of the warp takes part).
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// PPT pixels per thread: RASTER_PPT on the card, all of a band's pixels for
// the one-thread blocks of the host tests.
template <int PPT>
__global__ void __launch_bounds__(RASTER_BAND_PX / PPT) raster_tiles(const RasterArgs A) {
  __shared__ float4 s_plane[RASTER_STAGE * 3];
  __shared__ int s_tri[RASTER_STAGE];
  __shared__ bool s_keep[RASTER_STAGE];
  __shared__ float s_warp_min[RASTER_BAND_PX / RASTER_PPT / 32];
  const int tile = blockIdx.x / RASTER_BANDS, band = blockIdx.x % RASTER_BANDS;
  const int tx0 = (tile % A.ntx) * RASTER_TILE_X;
  const int ty0 = (tile / A.ntx) * RASTER_TILE_Y;
  constexpr int rows = RASTER_TILE_Y / RASTER_BANDS;    // the band's pixel rows
  const int r0 = band * rows * RASTER_TILE_X;           // the band's first pixel
  const float jx = A.jitter[0], jy = A.jitter[1];
  float px[PPT], py[PPT], best_q[PPT], best_e1[PPT], best_e2[PPT];
  int best_tri[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int r = r0 + threadIdx.x + j * blockDim.x;
    px[j] = rn_add((float)(tx0 + r % RASTER_TILE_X), jx);
    py[j] = rn_add((float)(ty0 + r / RASTER_TILE_X), jy);
    best_q[j] = 0.0f;
    best_e1[j] = best_e2[j] = 0.0f;
    best_tri[j] = -1;
  }
  // The band's first and last sample column and row, as the pixels have them.
  const float x_lo = rn_add((float)tx0, jx);
  const float x_hi = rn_add((float)(tx0 + RASTER_TILE_X - 1), jx);
  const float y_lo = rn_add((float)(ty0 + band * rows), jy);
  const float y_hi = rn_add((float)(ty0 + band * rows + rows - 1), jy);
  const float4* planes = reinterpret_cast<const float4*>(A.planes);
  const int begin = A.seg[tile], end = A.seg[tile + 1];
  int culled = 0;
  for (int base = begin; base < end; base += RASTER_STAGE) {
    const int n = end - base < RASTER_STAGE ? end - base : RASTER_STAGE;
    float least = best_q[0];
#pragma unroll
    for (int j = 1; j < PPT; ++j) least = fminf(least, best_q[j]);
    least = warp_min(least);
    if (threadIdx.x % 32 == 0) s_warp_min[threadIdx.x / 32] = least;
    __syncthreads();                                   // last stage consumed
    least = s_warp_min[0];
    for (int w = 1; w < (int)(blockDim.x + 31) / 32; ++w) least = fminf(least, s_warp_min[w]);
    // Stage the rows; cull each pair whose q, at any sample of the band, is
    // at most the band's least best q: it cannot win a pixel.
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int tri = A.pair_tri[base + i];
      const float4* row = planes + (size_t)tri * 3;
      const float4 a = row[0], b = row[1], c = row[2];
      s_plane[3 * i] = a;
      s_plane[3 * i + 1] = b;
      s_plane[3 * i + 2] = c;
      s_tri[i] = tri;
      s_keep[i] = !(edge(c.y, c.z, c.w, c.y >= 0.0f ? x_hi : x_lo,
                         c.z >= 0.0f ? y_hi : y_lo) <= least);
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      if (!s_keep[k]) {
        ++culled;
        continue;
      }
      const float* p = reinterpret_cast<const float*>(s_plane + 3 * k);
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
  if (A.stats != nullptr && threadIdx.x == 0) {
    atomicAdd(A.stats, (unsigned long long)(end - begin - culled));
    atomicAdd(A.stats + 1, (unsigned long long)culled);
  }
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int r = r0 + threadIdx.x + j * blockDim.x;
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

// Launches RASTER_BANDS blocks per tile on `stream`; returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int raster_launch(const RasterArgs* args, int device, void* stream) {
  if (args->n_tiles == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const RasterArgs a = *args;
  void* params[] = {(void*)&a};
  err = cudaLaunchKernel((const void*)raster_tiles<RASTER_PPT>,
                         dim3(a.n_tiles * RASTER_BANDS),
                         dim3(RASTER_BAND_PX / RASTER_PPT), params, 0,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The group path: kernel #5's port on JAX's `rasterize` (binning="group",
// raster_pallas.py:733, `_raster_kernel` over group visits, `:329`).
//
// The planes are read in groups of RASTER_GROUP consecutive rows (the BVH's
// leaf order; padding rows are NaN).  Each tile's visits are (tile, group)
// pairs sorted front to back by the group's quantised bound (visit_plan in
// ops/raster.py, as JAX sorts its visit words); the block of a tile walks
// them in order.  Before each visit it takes the least q of the tile's
// pixels (warp shuffles, then the warps' minima in shared memory) and skips
// the visit unless that least q is below the visit's bound: JAX's early-out
// (raster_pallas.py:415-418), on an exact bound (`visit_bounds` in
// ops/raster.py: each plane's q at the tile's corner sample, as the pair
// path's cull), where JAX's bound from the vertices' q does not hold for
// the float32 planes of small triangles.
// Otherwise the group's 128 plane rows are staged in shared memory, with
// each row's tile range (the tiles the pair path bins the triangle to), and
// each thread tests in order the rows whose range holds the tile against
// its pixels, a candidate replacing the pixel's best only with a strictly
// larger q: the first of equal q in the visit order wins (JAX's packed key
// drops q's low 7 bits instead).  JAX tests all 128 rows, and the float32
// plane of a sub-pixel triangle then wins pixels far outside its rect; with
// the ranges a tile tests the pair path's triangles, so the frame is the
// pair path's wherever the winner is unique.
//
// One block per tile (the early-out reads the whole tile's least q, so a
// tile is not split into bands here); the launch covers the tiles of
// `tiles`, so the repair phase of the occlusion feedback runs only its
// dirty tiles, writing their pixels over the first phase's.
//
// Bound on the H100: 4 two-term dots and 6 compares per (triangle, pixel)
// of the tile's triangles in every visit that runs, 2048 pixels a
// triangle, over 67 TFLOP/s; it reads 6.5 KB of planes and ranges a visit
// and writes 8 bytes a pixel.  The visits that run are the bound's count
// (PERF.md's kernel table, row 5).

constexpr int RASTER_GROUP = 128;

struct RasterGroupArgs {
  const float* planes;      // (groups * RASTER_GROUP, RASTER_PLANE_COLS)
  const int* tri_tiles;     // (groups * RASTER_GROUP, 4) tx0, ty0, tx1, ty1
  const int* tiles;         // (n_blocks,) the tile of each block
  const int* seg;           // (n_blocks + 1,) block b's visits [seg[b], seg[b+1])
  const int* group;         // (V,) each visit's group, front to back per tile
  const float* bound;       // (V,) the largest q each visit can give
  const float* jitter;      // (2,) sub-pixel sample offset
  float* q_out;             // (rows * row_pixels,) row-major, 0 on a miss
  int* tri_out;             // -1 on a miss
  unsigned long long* stats;  // null, or (2,) += visits run, visits skipped
  int ntx;
  int n_blocks;
  int row_pixels;
};

namespace {

template <int PPT>
__global__ void __launch_bounds__(RASTER_PX / PPT) raster_groups(const RasterGroupArgs A) {
  __shared__ float4 s_plane[RASTER_GROUP * 3];
  __shared__ bool s_keep[RASTER_GROUP];
  // Double-buffered by the visit's parity: a warp may write the next
  // visit's minimum while another still reads this one's.
  __shared__ float s_warp_min[2][RASTER_PX / RASTER_PPT / 32];
  const int tile = A.tiles[blockIdx.x];
  const int tx = tile % A.ntx, ty = tile / A.ntx;
  const int tx0 = tx * RASTER_TILE_X;
  const int ty0 = ty * RASTER_TILE_Y;
  const float jx = A.jitter[0], jy = A.jitter[1];
  float px[PPT], py[PPT], best_q[PPT];
  int best_tri[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int r = threadIdx.x + j * blockDim.x;
    px[j] = rn_add((float)(tx0 + r % RASTER_TILE_X), jx);
    py[j] = rn_add((float)(ty0 + r / RASTER_TILE_X), jy);
    best_q[j] = 0.0f;
    best_tri[j] = -1;
  }
  const float4* planes = reinterpret_cast<const float4*>(A.planes);
  const int begin = A.seg[blockIdx.x], end = A.seg[blockIdx.x + 1];
  const int warps = (int)(blockDim.x + 31) / 32;
  int run = 0;
  for (int v = begin; v < end; ++v) {
    float least = best_q[0];
#pragma unroll
    for (int j = 1; j < PPT; ++j) least = fminf(least, best_q[j]);
    least = warp_min(least);
    const int slot = (v - begin) & 1;
    if (threadIdx.x % 32 == 0) s_warp_min[slot][threadIdx.x / 32] = least;
    __syncthreads();                     // also: the last visit's rows consumed
    least = s_warp_min[slot][0];
    for (int w = 1; w < warps; ++w) least = fminf(least, s_warp_min[slot][w]);
    if (!(least < A.bound[v])) continue;   // the same for the whole block
    ++run;
    const int g = A.group[v];
    const float4* rows = planes + (size_t)g * RASTER_GROUP * 3;
    for (int i = threadIdx.x; i < RASTER_GROUP * 3; i += blockDim.x) s_plane[i] = rows[i];
    for (int i = threadIdx.x; i < RASTER_GROUP; i += blockDim.x) {
      const int* r = A.tri_tiles + ((size_t)g * RASTER_GROUP + i) * 4;
      s_keep[i] = r[0] <= tx && tx <= r[2] && r[1] <= ty && ty <= r[3];
    }
    __syncthreads();
    for (int k = 0; k < RASTER_GROUP; ++k) {
      if (!s_keep[k]) continue;           // the same for the whole block
      const float* p = reinterpret_cast<const float*>(s_plane + 3 * k);
      const int tri = g * RASTER_GROUP + k;
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
          best_tri[j] = tri;
        }
      }
    }
  }
  if (A.stats != nullptr && threadIdx.x == 0) {
    atomicAdd(A.stats, (unsigned long long)run);
    atomicAdd(A.stats + 1, (unsigned long long)(end - begin - run));
  }
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int r = threadIdx.x + j * blockDim.x;
    const size_t o = (size_t)(ty0 + r / RASTER_TILE_X) * A.row_pixels + tx0 +
                     r % RASTER_TILE_X;
    A.q_out[o] = best_q[j];
    A.tri_out[o] = best_tri[j];
  }
}

}  // namespace

extern "C" int raster_group_args_size() { return (int)sizeof(RasterGroupArgs); }

// Launches one block per entry of `tiles` on `stream`; returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int raster_groups_launch(const RasterGroupArgs* args, int device,
                                    void* stream) {
  if (args->n_blocks == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const RasterGroupArgs a = *args;
  void* params[] = {(void*)&a};
  err = cudaLaunchKernel((const void*)raster_groups<RASTER_PPT>,
                         dim3(a.n_blocks), dim3(RASTER_PX / RASTER_PPT), params,
                         0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
