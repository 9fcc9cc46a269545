// The tile rasterizer's kernels: primary visibility of a pinhole camera by
// 2D-homogeneous edge functions over 64x32-pixel screen tiles.
// `raster_tiles` (below) is the pair path, one block per row band of a
// tile; `raster_groups` (at the end of the file) the group path with its
// early-out, also one block per row band.
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
// ops/raster.py, as JAX sorts its visit words); a visit tests, in row
// order, the group's triangles that the pair path bins to the tile (each
// row's tile range), a candidate replacing the pixel's best only with a
// strictly larger q: the first of equal q in the visit order wins (JAX's
// packed key drops q's low 7 bits instead).  JAX tests all 128 rows, and
// the float32 plane of a sub-pixel triangle then wins pixels far outside
// its rect; with the ranges a tile tests the pair path's triangles.
//
// The work is uneven: most tiles hold a few visits, the character crowd's
// tiles up to ~200, and one block walking such a tile set the kernel's
// time (PERF.md's kernel table, row 5).  So:
// * A tile is split into RASTER_GROUP_BANDS row bands, one block per band,
//   each walking the tile's visits and deciding on its own pixels: a heavy
//   tile spreads over more SMs, and a band covered near the camera skips
//   what the whole tile would still run.
// * The early-out (JAX's, raster_pallas.py:415-418) skips a visit unless
//   the band's least best q is below the visit's exact bound (`visit_bounds`
//   in ops/raster.py: the largest q the visit's triangles give any sample
//   of the tile); JAX's bound from the vertices' q does not hold for the
//   float32 planes of small triangles.
// * A visit that runs culls each row whose plane gives no larger q than
//   the band's least best q at any sample of the band: q = (qx px + qy py)
//   + qw, each operation rounded, is monotone in px and in py, so its
//   largest is the plane at one corner sample, picked by the signs of qx
//   and qy (the pair kernel's cull).  The rows kept are compacted, in
//   order, into a list that the test loop walks.
// * A visit that runs stages its group's 128 plane rows (6 KB) and tile
//   ranges (2 KB) in shared memory, every thread loading its share; the
//   other blocks on the SM hide the load (bulk copies into a second
//   buffer while the block tests the first were no faster).
// * A tile of more than `chunk` visits is split into chunks of `chunk`
//   visits, each walked by its own blocks from best q 0; the chunks'
//   winners meet in a 64-bit atomicMax of (q's bits, ~(visit * 128 +
//   row)): q > 0 orders as its bits, and among equal q the first in visit
//   order wins, as in one walk.  The tile's last block writes its pixels.
// * Blocks launch longest chunk first (`items`, sorted on the device), so
//   the long walks start while the short ones fill the rest of the card.
// A culled or skipped test cannot win a pixel (a win needs a strictly
// larger q), so the result is that of testing every binned row of every
// visit, bit for bit; only the counters show the difference.  Eight bands
// of 128 threads (2 pixels a thread) and chunks of 64 visits were the
// fastest of those measured on the H100; a second cull of each row over a
// warp's own pixels cost more than it saved (PERF.md's kernel table, row 5).
//
// The launch covers the tiles of `tiles`, so the repair phase of the
// occlusion feedback runs only its dirty tiles, writing their pixels over
// the first phase's.
//
// Bound on the H100: 4 two-term dots and 6 compares per (row, pixel) of
// the (visit, band, row)s that any exact cull of a row per band must test
// (`group_rows_needed` in ops/raster.py), 256 pixels a band, over 67
// TFLOP/s; it reads 6.5 KB of planes and ranges a visit and writes 8 bytes
// a pixel (PERF.md's kernel table, row 5).

constexpr int RASTER_GROUP = 128;
constexpr int RASTER_GROUP_BANDS = 8;     // blocks per tile, one per row band
constexpr int RASTER_GROUP_THREADS = 128;  // threads per block on the card
constexpr int RASTER_GROUP_BAND_PX = RASTER_PX / RASTER_GROUP_BANDS;
constexpr int RASTER_GROUP_PPT = RASTER_GROUP_BAND_PX / RASTER_GROUP_THREADS;
constexpr int RASTER_GROUP_WARPS = RASTER_GROUP_THREADS / 32;
static_assert(RASTER_GROUP_BAND_PX == RASTER_GROUP_THREADS * RASTER_GROUP_PPT &&
                  RASTER_GROUP_THREADS % 64 == 0,
              "a band is whole pairs of warps, RASTER_GROUP_PPT rows a pair");

struct RasterGroupArgs {
  const float* planes;      // (groups * RASTER_GROUP, RASTER_PLANE_COLS), 16-byte aligned
  const int* tri_tiles;     // (groups * RASTER_GROUP, 4) tx0, ty0, tx1, ty1, 16-byte aligned
  const int* tiles;         // (n_launch,) the launched tiles
  const int* seg;           // (n_launch + 1,) tile tiles[s]'s visits [seg[s], seg[s+1])
  const int* items;         // (n_items, 4) slot s (-1: none), visits [begin, end),
                            // split tile k (-1: the tile's only chunk); longest first
  const int* group;         // (V,) each visit's group, front to back per tile
  const float* bound;       // (V,) the largest q each visit can give
  const float* jitter;      // (2,) sub-pixel sample offset
  float* q_out;             // (rows * row_pixels,) row-major, 0 on a miss
  int* tri_out;             // -1 on a miss
  unsigned long long* keys;  // (splits * RASTER_PX,) zeros: split tile k's merge
  int* tickets;             // (splits,) zeros: split tile k's blocks done
  unsigned long long* stats;  // null, or (4,) += per band: visits run, visits
                              // skipped, rows tested, rows culled
  int ntx;
  int n_items;
  int chunk;                // a tile of more visits is split into chunks of this many
  int row_pixels;
};

namespace {

// One visit's group, staged in shared memory.
struct GroupStage {
  float4 plane[RASTER_GROUP * 3];  // the rows' planes
  int4 range[RASTER_GROUP];        // the rows' tile ranges
};

// Thread threadIdx.x's pixel j of its band, as an index into the band's
// rows of RASTER_TILE_X pixels.
template <int PPT>
__device__ __forceinline__ int band_pixel(int j) {
  return PPT == RASTER_GROUP_BAND_PX
             ? j
             : (int)((threadIdx.x / 64) * PPT + j) * RASTER_TILE_X + threadIdx.x % 64;
}

// PPT pixels per thread: RASTER_GROUP_PPT on the card (each pair of warps
// takes PPT whole pixel rows of the band, so a warp's pixels are a 32 x PPT
// rectangle), all of a band's pixels for the one-thread blocks of the host
// tests.
template <int PPT>
__global__ void __launch_bounds__(RASTER_GROUP_BAND_PX / PPT) raster_groups(const RasterGroupArgs A) {
  __shared__ GroupStage s;
  __shared__ unsigned char s_row[RASTER_GROUP];  // the rows to test, in order
  __shared__ int s_kept[RASTER_GROUP_WARPS];
  __shared__ float s_warp_min[RASTER_GROUP_WARPS];
  __shared__ int s_last;
  const int* item = A.items + 4 * (blockIdx.x / RASTER_GROUP_BANDS);
  const int slot = item[0];
  if (slot < 0) return;
  const int band = blockIdx.x % RASTER_GROUP_BANDS;
  const int tile = A.tiles[slot];
  const int tx = tile % A.ntx, ty = tile / A.ntx;
  const int tx0 = tx * RASTER_TILE_X;
  constexpr int rows = RASTER_TILE_Y / RASTER_GROUP_BANDS;  // the band's pixel rows
  const int y0 = ty * RASTER_TILE_Y + band * rows;
  const float jx = A.jitter[0], jy = A.jitter[1];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = (int)(blockDim.x + 31) / 32;
  float px[PPT], py[PPT], best_q[PPT];
  int best_rank[PPT];  // the winner's visit * RASTER_GROUP + row, -1 for none
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int r = band_pixel<PPT>(j);
    px[j] = rn_add((float)(tx0 + r % RASTER_TILE_X), jx);
    py[j] = rn_add((float)(y0 + r / RASTER_TILE_X), jy);
    best_q[j] = 0.0f;
    best_rank[j] = -1;
  }
  // The band's first and last sample column and row, as the pixels have them.
  const float x_lo = rn_add((float)tx0, jx);
  const float x_hi = rn_add((float)(tx0 + RASTER_TILE_X - 1), jx);
  const float y_lo = rn_add((float)y0, jy);
  const float y_hi = rn_add((float)(y0 + rows - 1), jy);
  const int begin = item[1], end = item[2];
  int run = 0, tested = 0, culled = 0;
  for (int cur = begin;; ++cur) {
    float least = best_q[0];
#pragma unroll
    for (int j = 1; j < PPT; ++j) least = fminf(least, best_q[j]);
    least = warp_min(least);
    if (lane == 0) s_warp_min[warp] = least;
    __syncthreads();                     // also: the last visit's rows consumed
    least = s_warp_min[0];
    for (int w = 1; w < warps; ++w) least = fminf(least, s_warp_min[w]);
    while (cur < end && !(least < __ldg(A.bound + cur))) ++cur;  // skipped
    if (cur >= end) break;
    ++run;
    const size_t g = (size_t)__ldg(A.group + cur) * RASTER_GROUP;
    const float4* plane = reinterpret_cast<const float4*>(A.planes + g * RASTER_PLANE_COLS);
    const int4* range = reinterpret_cast<const int4*>(A.tri_tiles + g * 4);
    for (int i = threadIdx.x; i < RASTER_GROUP * 3; i += blockDim.x) s.plane[i] = __ldg(plane + i);
    for (int i = threadIdx.x; i < RASTER_GROUP; i += blockDim.x) s.range[i] = __ldg(range + i);
    __syncthreads();
    // The rows binned to the tile whose q exceeds the band's least best q
    // somewhere in the band, compacted in order into s_row.
    int n = 0;
    for (int i0 = 0; i0 < RASTER_GROUP; i0 += blockDim.x) {
      const int i = i0 + (int)threadIdx.x;
      bool binned = false, keep = false;
      if (i < RASTER_GROUP) {
        const int4 r = s.range[i];
        binned = r.x <= tx && tx <= r.z && r.y <= ty && ty <= r.w;
        const float4 c = s.plane[3 * i + 2];
        keep = binned && !(edge(c.y, c.z, c.w, c.y >= 0.0f ? x_hi : x_lo,
                                c.z >= 0.0f ? y_hi : y_lo) <= least);
      }
      const unsigned vote = __ballot_sync(0xffffffffu, keep);
      const int kept = __popc(vote);
      const int in_tile = __popc(__ballot_sync(0xffffffffu, binned));
      if (lane == 0) {
        s_kept[warp] = kept;
        culled += in_tile - kept;
      }
      __syncthreads();
      int at = n;
      for (int w = 0; w < warp; ++w) at += s_kept[w];
      if (keep) s_row[at + __popc(vote & ((1u << lane) - 1u))] = (unsigned char)i;
      for (int w = 0; w < warps; ++w) n += s_kept[w];
      __syncthreads();
    }
    tested += n;
    const int rank = cur * RASTER_GROUP;
    for (int t = 0; t < n; ++t) {
      const int i = s_row[t];
      const float* p = reinterpret_cast<const float*>(s.plane + 3 * i);
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
          best_rank[j] = rank + i;
        }
      }
    }
  }
  if (A.stats != nullptr) {
    if (threadIdx.x == 0) {
      atomicAdd(A.stats, (unsigned long long)run);
      atomicAdd(A.stats + 1, (unsigned long long)(end - begin - run));
      atomicAdd(A.stats + 2, (unsigned long long)tested);
    }
    if (lane == 0 && culled) atomicAdd(A.stats + 3, (unsigned long long)culled);
  }
  const int split = item[3];
  if (split < 0) {  // the tile's only chunk: write its pixels
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int r = band_pixel<PPT>(j);
      const int rank = best_rank[j];
      const size_t o = (size_t)(y0 + r / RASTER_TILE_X) * A.row_pixels + tx0 + r % RASTER_TILE_X;
      A.q_out[o] = best_q[j];
      A.tri_out[o] = rank < 0 ? -1 : __ldg(A.group + rank / RASTER_GROUP) * RASTER_GROUP + rank % RASTER_GROUP;
    }
    return;
  }
  // A split tile: each chunk's winners meet in a 64-bit maximum of (q's
  // bits, ~rank); q > 0 orders as its bits, and among equal q the least
  // rank, the first in visit order, wins.  The tile's last block to finish
  // writes its pixels.
  unsigned long long* keys = A.keys + (size_t)split * RASTER_PX;
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int r = band_pixel<PPT>(j);
    if (best_rank[j] >= 0)
      atomicMax(keys + band * rows * RASTER_TILE_X + r,
                (unsigned long long)__float_as_uint(best_q[j]) << 32 | ~(unsigned)best_rank[j]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int visits = A.seg[slot + 1] - A.seg[slot];
    s_last = atomicAdd(A.tickets + split, 1) ==
             (visits + A.chunk - 1) / A.chunk * RASTER_GROUP_BANDS - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int ty0 = ty * RASTER_TILE_Y;
  for (int r = threadIdx.x; r < RASTER_PX; r += blockDim.x) {
    const unsigned long long key = __ldcg(keys + r);
    const unsigned rank = ~(unsigned)key;
    const size_t o = (size_t)(ty0 + r / RASTER_TILE_X) * A.row_pixels + tx0 + r % RASTER_TILE_X;
    A.q_out[o] = __uint_as_float((unsigned)(key >> 32));
    A.tri_out[o] = key == 0 ? -1 : __ldg(A.group + rank / RASTER_GROUP) * RASTER_GROUP + rank % RASTER_GROUP;
  }
}

}  // namespace

extern "C" int raster_group_args_size() { return (int)sizeof(RasterGroupArgs); }

// Launches RASTER_GROUP_BANDS blocks per entry of `items` on `stream`;
// returns cudaGetLastError() after the launch (0 = ok).
extern "C" int raster_groups_launch(const RasterGroupArgs* args, int device,
                                    void* stream) {
  if (args->n_items == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const RasterGroupArgs a = *args;
  void* params[] = {(void*)&a};
  err = cudaLaunchKernel((const void*)raster_groups<RASTER_GROUP_PPT>,
                         dim3(a.n_items * RASTER_GROUP_BANDS),
                         dim3(RASTER_GROUP_THREADS), params, 0,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
