// The two ray kernels of the path tracer: closest-hit (and any-hit) queries
// over the dense plane table, one thread per ray, with the plane test of
// ray_plane.cuh.
//
// * ray_closest_hit_bvh replaces the JAX package's cluster-culled Pallas
//   kernel (d3d12renderer_tpu/ops/ray_trace_pallas.py:333 `_culled_kernel`,
//   via `closest_hit_pallas_culled`).  On the TPU, rays travel in 1024-ray
//   blocks against 1024-triangle chunks that survive a per-block cluster-AABB
//   cull, front to back, with lane-replicated outputs and scalar-prefetched
//   visit words: all of that exists because a TPU core has no per-lane
//   control flow.  A Hopper thread has it, so each ray walks the BVH itself:
//   DFS pre-order nodes (left child i+1, right child node_miss[i+1]), near
//   child first, the far one on a per-thread stack with its entry distance,
//   boxes pruned against the ray's current best t as render/bvh.py
//   `_ray_aabb` does.  Leaves run the plane test on their table rows.
//   Node boxes are padded (ops/ray_trace.py `node_table`) so the walk finds
//   every row the brute-force test accepts.  A stack overflow sets
//   RAY_ERR_STACK in the error word, which the wrapper raises on; no subtree
//   is ever dropped quietly.
// * ray_closest_hit_brute replaces the brute-force Pallas kernel
//   (ray_trace_pallas.py:157 `_kernel`, via `closest_hit_pallas`): every ray
//   against every row.  A block stages tiles of RAY_BRUTE_TILE rows through
//   shared memory (12 KB) and each thread tests its ray against the tile.
//
// Bounds on the H100: the plane test is 42 float operations (6 three-term
// dots, the quotient, u, v and the accept terms); the brute kernel runs it
// on every (ray, row) pair and reads its ray once, so at R rays x T rows it
// is bound by operations (R T 42 / 67 TFLOP/s fp32).  The BVH kernel does the plane test
// only on the rows of the leaves it reaches (~log T boxes and a few leaves
// per ray) and is bound, at best, by reading its rays and writing its
// results; in this first version it is latency-bound on dependent node loads
// (one thread per ray, no wide nodes, no ray reordering inside the kernel).
//
// Both launch through cudaLaunchKernel (not <<<>>>), so that g++ can compile
// this file as host C++ for the CPU tests.

#include <cuda_runtime.h>

#include "ray_plane.cuh"

namespace {

// Adds this thread's plane-test and box-test counts to A.stats (when the
// caller asked for them: the bounds in chip_smoke.py count the work).
__device__ __forceinline__ void add_stats(const RayArgs& A, int tests, int boxes) {
  if (A.stats != nullptr) {
    atomicAdd(A.stats, (unsigned long long)tests);
    atomicAdd(A.stats + 1, (unsigned long long)boxes);
  }
}

__device__ __forceinline__ Ray load_ray(const RayArgs& A, int r) {
  Ray ray;
  ray.ox = A.origin[3 * r];
  ray.oy = A.origin[3 * r + 1];
  ray.oz = A.origin[3 * r + 2];
  ray.dx = A.direction[3 * r];
  ray.dy = A.direction[3 * r + 1];
  ray.dz = A.direction[3 * r + 2];
  return ray;
}

__device__ __forceinline__ float safe_inv(float d) {
  // As render/bvh.py: |d| < 1e-12 becomes +-1e-12, so the slabs stay finite.
  return 1.0f / (fabsf(d) < 1e-12f ? (d >= 0.0f ? 1e-12f : -1e-12f) : d);
}

// Slab test of a node box (a = lo.xyz hi.x, b = hi.yz + links).  Sets the
// entry distance; hit when the interval meets [0, t_best].
__device__ __forceinline__ bool box_hit(float4 a, float4 b, const Ray& r,
                                        float ix, float iy, float iz,
                                        float t_best, float& t_near) {
  const float x0 = (a.x - r.ox) * ix, x1 = (a.w - r.ox) * ix;
  const float y0 = (a.y - r.oy) * iy, y1 = (b.x - r.oy) * iy;
  const float z0 = (a.z - r.oz) * iz, z1 = (b.y - r.oz) * iz;
  t_near = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1));
  const float t_far = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
  return t_far >= fmaxf(t_near, 0.0f) && t_near <= t_best;
}

__device__ __forceinline__ void node_load(const RayArgs& A, int i, float4& a,
                                          float4& b) {
  const float4* p = reinterpret_cast<const float4*>(A.nodes) + 2 * i;
  a = p[0];
  b = p[1];
}

__global__ void __launch_bounds__(RAY_BVH_THREADS)
ray_closest_hit_bvh(const RayArgs A) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= A.num_rays) return;
  const Ray ray = load_ray(A, r);
  float t_best = A.t_max[r];
  int tri_best = -1;
  // No row can pass t - 1e-4 >= 0 and t_best - t >= 0: dead rays (t_max 0)
  // and NaN t_max skip the walk.
  if (!(t_best >= 1e-4f) || A.num_nodes == 0) {
    A.t_out[r] = t_best;
    A.tri_out[r] = -1;
    return;
  }
  const float ix = safe_inv(ray.dx), iy = safe_inv(ray.dy), iz = safe_inv(ray.dz);
  const float4* planes = reinterpret_cast<const float4*>(A.planes);

  int stack_node[RAY_MAX_STACK];
  float stack_t[RAY_MAX_STACK];
  int sp = 0, tests = 0, boxes = 1;
  float4 a, b;
  float t_near;
  node_load(A, 0, a, b);
  int node = box_hit(a, b, ray, ix, iy, iz, t_best, t_near) ? 0 : -1;
  bool done = false;
  while (node >= 0 && !done) {
    node_load(A, node, a, b);
    const int link = __float_as_int(b.z), count = __float_as_int(b.w);
    int next = -1;
    if (count > 0) {                                   // leaf: rows [link, link + count)
      tests += count;
      for (int k = link; k < link + count; ++k) {
        const float4* row = planes + k * (RAY_PLANE_COLS / 4);
        float t;
        if (ray_plane_test(ray, row[0], row[1], row[2], t_best, t) &&
            ray_better(t, k, t_best, tri_best)) {
          t_best = t;
          tri_best = k;
          if (A.any_hit) {
            done = true;
            break;
          }
        }
      }
    } else {                                           // inner: children node+1, link
      float4 la, lb, ra, rb;
      float tl, tr;
      node_load(A, node + 1, la, lb);
      node_load(A, link, ra, rb);
      const bool hl = box_hit(la, lb, ray, ix, iy, iz, t_best, tl);
      const bool hr = box_hit(ra, rb, ray, ix, iy, iz, t_best, tr);
      boxes += 2;
      if (hl && hr) {
        const bool left_near = tl <= tr;
        if (sp >= A.stack_limit) {
          atomicOr(A.error, RAY_ERR_STACK);
          break;
        }
        stack_node[sp] = left_near ? link : node + 1;
        stack_t[sp] = left_near ? tr : tl;
        ++sp;
        next = left_near ? node + 1 : link;
      } else if (hl) {
        next = node + 1;
      } else if (hr) {
        next = link;
      }
    }
    // Pop the nearest pending subtree that can still beat t_best.
    while (next < 0 && sp > 0) {
      --sp;
      if (stack_t[sp] <= t_best) next = stack_node[sp];
    }
    node = next;
  }
  A.t_out[r] = t_best;
  A.tri_out[r] = tri_best;
  add_stats(A, tests, boxes);
}

__global__ void __launch_bounds__(RAY_BRUTE_THREADS)
ray_closest_hit_brute(const RayArgs A) {
  __shared__ float4 tile[RAY_BRUTE_TILE * 3];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < A.num_rays;
  Ray ray = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float t_best = 0.0f;
  int tri_best = -1;
  if (live) {
    ray = load_ray(A, r);
    t_best = A.t_max[r];
  }
  bool done = !live || !(t_best >= 1e-4f);
  int tests = 0;
  const float4* planes = reinterpret_cast<const float4*>(A.planes);
  for (int base = 0; base < A.num_tris; base += RAY_BRUTE_TILE) {
    const int n = A.num_tris - base < RAY_BRUTE_TILE ? A.num_tris - base : RAY_BRUTE_TILE;
    for (int k = threadIdx.x; k < 3 * n; k += blockDim.x)
      tile[k] = planes[(base + k / 3) * (RAY_PLANE_COLS / 4) + k % 3];
    __syncthreads();
    if (!done) {
      tests += n;
      for (int j = 0; j < n; ++j) {
        float t;
        if (ray_plane_test(ray, tile[3 * j], tile[3 * j + 1], tile[3 * j + 2], t_best, t) &&
            ray_better(t, base + j, t_best, tri_best)) {
          t_best = t;
          tri_best = base + j;
          if (A.any_hit) {
            done = true;
            break;
          }
        }
      }
    }
    // The barrier before the next tile load; the block stops once every
    // ray in it is done (any-hit mode).
    if (!__syncthreads_or(!done)) break;
  }
  if (live) {
    A.t_out[r] = t_best;
    A.tri_out[r] = tri_best;
    add_stats(A, tests, 0);
  }
}

int launch(const void* kernel, const RayArgs* args, int threads, int device,
           void* stream) {
  if (args->stack_limit < 1 || args->stack_limit > RAY_MAX_STACK) return -1;
  if (args->num_rays == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const RayArgs a = *args;
  void* params[] = {(void*)&a};
  const dim3 blocks((a.num_rays + threads - 1) / threads), block(threads);
  err = cudaLaunchKernel(kernel, blocks, block, params, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ray_args_size() { return (int)sizeof(RayArgs); }

extern "C" int ray_max_stack() { return RAY_MAX_STACK; }

// Both launch on `stream` and return cudaGetLastError() after the launch
// (0 = ok), or -1 for a stack limit outside [1, RAY_MAX_STACK].
extern "C" int ray_closest_hit_bvh_launch(const RayArgs* args, int device, void* stream) {
  return launch((const void*)ray_closest_hit_bvh, args, RAY_BVH_THREADS, device, stream);
}

extern "C" int ray_closest_hit_brute_launch(const RayArgs* args, int device, void* stream) {
  return launch((const void*)ray_closest_hit_brute, args, RAY_BRUTE_THREADS, device, stream);
}
