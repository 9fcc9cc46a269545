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
//   against every row, for tables of at most 1024 rows on the path tracer.
//   One thread per ray; a block stages such a table whole in shared memory
//   (48 bytes a row).  Where all the block's rays start at one point (a
//   pinhole camera's wavefront) the block computes each row's origin terms
//   (o.n, o.e1p + e1_off, o.e2p + e2_off) once, saving 17 of the ~60
//   instructions of each pair.  The test is branch-free, and a warp whose
//   rays are all done skips the rows.
//
// Bounds on the H100: the plane test is 42 float operations (6 three-term
// dots, the quotient, u, v and the accept terms); the brute kernel runs it
// on every (ray, row) pair and reads its ray once, so at R rays x T rows it
// is bound by operations (R T 42 / 67 TFLOP/s fp32), or R T 24 + T 18 where
// all rays share one origin (o.n, n_off - o.n and the two origin terms
// once per row).  Every operation is rounded on its own, so none contracts
// into an FMA: each is an instruction, the division about ten, and the
// kernel is bound by the SMs' issue rate (132 SMs x 4 warp-instructions a
// cycle).
// The BVH kernel does the plane test
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

// The brute-force kernel's dynamic shared memory at T rows: the rows (three
// float4 each) and, for a table of one chunk, their origin terms (one).
int ray_brute_shared_bytes(int num_tris) {
  const int row = (int)sizeof(float4);
  return num_tris <= RAY_BRUTE_CHUNK ? 4 * num_tris * row : 3 * RAY_BRUTE_CHUNK * row;
}

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

// Stages rows [base, base + n) of the plane table (their three float4) in
// shared memory, cooperatively.
__device__ __forceinline__ void stage_rows(const RayArgs& A, float4* rows, int base,
                                           int n) {
  const float4* planes = reinterpret_cast<const float4*>(A.planes);
  for (int k = threadIdx.x; k < 3 * n; k += blockDim.x)
    rows[k] = planes[(base + k / 3) * (RAY_PLANE_COLS / 4) + k % 3];
}

// One ray against the n rows staged at `row`, the first of them row `base`
// of the table.  With SHARED_ORIGIN every ray of the block starts at `ray`'s
// origin and `term` holds each row's origin terms (o.n, ou, ov), computed
// once for the block by the same operations.  A warp whose rays are all
// done (dead, or any-hit rays that have hit) skips the rows; the lanes of a
// warp otherwise run every row together, so the votes are full-warp.
// Returns whether the ray is done.
template <bool SHARED_ORIGIN>
__device__ __forceinline__ bool brute_rows(const float4* row, const float4* term, int base,
                                           int n, const Ray& ray, bool any_hit,
                                           float& t_best, int& tri_best, bool done) {
  if (!__any_sync(0xffffffffu, !done)) return done;
  for (int k = base; k < base + n; ++k, row += 3, ++term) {
    const float4 pn = row[0], pu = row[1], pv = row[2];
    float4 o_terms;
    if (SHARED_ORIGIN) {
      o_terms = *term;
    } else {
      o_terms = {ray_dot(ray.ox, ray.oy, ray.oz, pn.x, pn.y, pn.z),
                 ray_origin_term(ray, pu), ray_origin_term(ray, pv), 0.0f};
    }
    const float dn = ray_dot(ray.dx, ray.dy, ray.dz, pn.x, pn.y, pn.z);
    const float num = rn_sub(pn.w, o_terms.x);
    float t;
    const bool wins =
        !done & ray_plane_wins(ray, pu, pv, o_terms.y, o_terms.z, num, dn, t_best, t);
    t_best = wins ? t : t_best;
    tri_best = wins ? k : tri_best;
    if (any_hit) {
      done = done | wins;
      if (!__any_sync(0xffffffffu, !done)) break;
    }
  }
  return done;
}

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_int(a) == __float_as_int(b);
}

// One thread per ray.  A table of at most RAY_BRUTE_CHUNK rows is staged
// whole, and where all the block's rays start at one point (a pinhole
// camera's wavefront) each row's origin terms are computed once for them;
// a larger table is staged chunk by chunk, with a barrier around every
// chunk and the block stopping once all its rays are done.
__global__ void __launch_bounds__(RAY_BRUTE_THREADS)
ray_closest_hit_brute(const RayArgs A) {
  DYNAMIC_SHARED(smem);
  float4* rows = reinterpret_cast<float4*>(smem);
  const int r0 = blockIdx.x * blockDim.x, r = r0 + threadIdx.x;
  const bool live = r < A.num_rays;
  Ray ray = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float t_best = 0.0f;
  int tri_best = -1;
  if (live) {
    ray = load_ray(A, r);
    t_best = A.t_max[r];
  }
  // No row can pass t - 1e-4 >= 0 and t_best - t >= 0 for dead rays
  // (t_max < 1e-4) and NaN t_max.
  bool done = !live || !(t_best >= 1e-4f);
  int tests = 0;
  if (A.num_tris <= RAY_BRUTE_CHUNK) {
    if (!done) tests = A.num_tris;
    stage_rows(A, rows, 0, A.num_tris);
    float4* terms = rows + 3 * A.num_tris;
    const Ray first = load_ray(A, r0);
    const bool shared = __syncthreads_and(
        !live || (same_bits(ray.ox, first.ox) && same_bits(ray.oy, first.oy) &&
                  same_bits(ray.oz, first.oz)));
    if (shared) {
      for (int j = threadIdx.x; j < A.num_tris; j += blockDim.x) {
        const float4 pn = rows[3 * j];
        terms[j] = {ray_dot(first.ox, first.oy, first.oz, pn.x, pn.y, pn.z),
                    ray_origin_term(first, rows[3 * j + 1]),
                    ray_origin_term(first, rows[3 * j + 2]), 0.0f};
      }
      __syncthreads();
      brute_rows<true>(rows, terms, 0, A.num_tris, ray, A.any_hit != 0, t_best, tri_best,
                       done);
    } else {
      brute_rows<false>(rows, terms, 0, A.num_tris, ray, A.any_hit != 0, t_best, tri_best,
                        done);
    }
  } else {
    for (int base = 0; base < A.num_tris; base += RAY_BRUTE_CHUNK) {
      const int n = A.num_tris - base < RAY_BRUTE_CHUNK ? A.num_tris - base : RAY_BRUTE_CHUNK;
      stage_rows(A, rows, base, n);
      __syncthreads();
      if (!done) tests += n;
      done = brute_rows<false>(rows, rows, base, n, ray, A.any_hit != 0, t_best, tri_best,
                               done);
      // The barrier before the next chunk is staged; the block stops once
      // every ray in it is done (any-hit mode).
      if (!__syncthreads_or(!done)) break;
    }
  }
  if (live) {
    A.t_out[r] = t_best;
    A.tri_out[r] = tri_best;
  }
  add_stats(A, tests, 0);
}

cudaError_t launch_bvh(const RayArgs& a, cudaStream_t stream) {
  void* params[] = {(void*)&a};
  const dim3 blocks((a.num_rays + RAY_BVH_THREADS - 1) / RAY_BVH_THREADS);
  return cudaLaunchKernel((const void*)ray_closest_hit_bvh, blocks, dim3(RAY_BVH_THREADS),
                          params, 0, stream);
}

// One block per RAY_BRUTE_THREADS rays, with shared memory for the rows of
// a one-chunk table and their origin terms, or for one chunk of rows.
cudaError_t launch_brute(const RayArgs& a, cudaStream_t stream) {
  const void* kernel = (const void*)ray_closest_hit_brute;
  const int bytes = ray_brute_shared_bytes(a.num_tris);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  void* params[] = {(void*)&a};
  const dim3 blocks((a.num_rays + RAY_BRUTE_THREADS - 1) / RAY_BRUTE_THREADS);
  return cudaLaunchKernel(kernel, blocks, dim3(RAY_BRUTE_THREADS), params, bytes, stream);
}

int launch(bool brute, const RayArgs* args, int device, void* stream) {
  if (args->stack_limit < 1 || args->stack_limit > RAY_MAX_STACK) return -1;
  if (args->num_rays == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = brute ? launch_brute(*args, (cudaStream_t)stream)
              : launch_bvh(*args, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ray_args_size() { return (int)sizeof(RayArgs); }

extern "C" int ray_max_stack() { return RAY_MAX_STACK; }

// Both launch on `stream` and return cudaGetLastError() after the launch
// (0 = ok), or -1 for a stack limit outside [1, RAY_MAX_STACK].
extern "C" int ray_closest_hit_bvh_launch(const RayArgs* args, int device, void* stream) {
  return launch(false, args, device, stream);
}

extern "C" int ray_closest_hit_brute_launch(const RayArgs* args, int device, void* stream) {
  return launch(true, args, device, stream);
}
