// The ray-triangle plane test and the argument block shared by both ray
// kernels of csrc/ray_trace.cu.
//
// The test is the plane form of the JAX package's Pallas kernels
// (d3d12renderer_tpu/ops/ray_trace_pallas.py `_best_in_chunk`): each
// triangle is one row of the dense plane table (render/bvh.py `build_dense`)
//
//   [n.x n.y n.z n_off | e1p.x e1p.y e1p.z e1_off | e2p.x e2p.y e2p.z e2_off | valid 0 0 0]
//
//   t = (n_off - o.n) / (d.n)
//   u = (o.e1p + e1_off) + t (d.e1p),   v = (o.e2p + e2_off) + t (d.e2p)
//
// accepted when u >= 0, v >= 0, 1 - (u + v) >= 0, t - 1e-4 >= 0 and
// t_best - t >= 0.  NaN (all-zero padding rows give 0/0, degenerate
// triangles too) and +-inf fail a compare and reject, with no guards.
//
// Every product, sum and the quotient is rounded on its own (rn_math.cuh),
// in the order written above, so the kernels compute the same bits as the
// plain PyTorch version of ops/ray_trace.py, which runs each operation as its
// own tensor op.
//
// The constants and the RayArgs layout are mirrored by ops/ray_trace.py (a
// CPU test holds the two together).
#pragma once

#include <cuda_runtime.h>

#include "rn_math.cuh"

constexpr int RAY_PLANE_COLS = 16;   // floats per plane-table row
constexpr int RAY_NODE_COLS = 8;     // floats per node-table row
constexpr int RAY_MAX_STACK = 64;    // traversal stack entries per thread
constexpr int RAY_BVH_THREADS = 128;
constexpr int RAY_BRUTE_THREADS = 256;
// A brute-force block holds a table of at most this many rows whole in
// shared memory (with the rows' origin terms, 64 bytes a row), and a larger
// one in chunks of this many rows (48 bytes a row).
constexpr int RAY_BRUTE_CHUNK = 1024;
constexpr int RAY_ERR_STACK = 1;     // error bit: a traversal stack overflowed

// One launch.  Pointers are device pointers of contiguous float32 / int32
// tensors; `nodes` is read by the BVH kernel only.
struct RayArgs {
  const float* origin;     // (R, 3)
  const float* direction;  // (R, 3)
  const float* t_max;      // (R,)
  const float* planes;     // (T, RAY_PLANE_COLS), 16-byte aligned
  const float* nodes;      // (N, RAY_NODE_COLS), 16-byte aligned
  float* t_out;            // (R,) closest accepted t, t_max on a miss
  int* tri_out;            // (R,) its plane-table row, -1 on a miss
  int* error;              // (1,) RAY_ERR_* bits, zeroed by the caller
  unsigned long long* stats;  // null, or (2,) += plane tests, box tests
  int num_rays;
  int num_tris;
  int num_nodes;
  int any_hit;             // 1: stop each ray at its first accepted hit
  int stack_limit;         // <= RAY_MAX_STACK
  int pad_;
};

// (a.x * b.x + a.y * b.y) + a.z * b.z
__device__ __forceinline__ float ray_dot(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  return rn_add(rn_add(rn_mul(ax, bx), rn_mul(ay, by)), rn_mul(az, bz));
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// u's or v's origin term of a row: o.e1p + e1_off (p = the row's second
// float4) or o.e2p + e2_off (its third).
__device__ __forceinline__ float ray_origin_term(const Ray& r, float4 p) {
  return rn_add(ray_dot(r.ox, r.oy, r.oz, p.x, p.y, p.z), p.w);
}

// Whether the hit at t of a ray on a row's plane lies in the triangle and
// in front of the ray: u, v >= 0, 1 - (u + v) >= 0 and t - 1e-4 >= 0; ou
// and ov are the row's origin terms (ray_origin_term of pu and pv, the
// row's second and third float4).  Branch-free.
__device__ __forceinline__ bool ray_plane_inside(const Ray& r, float4 pu, float4 pv, float ou,
                                                 float ov, float t) {
  const float u = rn_add(ou, rn_mul(t, ray_dot(r.dx, r.dy, r.dz, pu.x, pu.y, pu.z)));
  const float v = rn_add(ov, rn_mul(t, ray_dot(r.dx, r.dy, r.dz, pv.x, pv.y, pv.z)));
  return (u >= 0.0f) & (v >= 0.0f) & (rn_sub(1.0f, rn_add(u, v)) >= 0.0f) &
         (rn_sub(t, 1e-4f) >= 0.0f);
}

// The plane test of one ray against one table row (pn, pu, pv = the row's
// first three float4).  Returns true and sets t when the row is accepted
// against t_best.
__device__ __forceinline__ bool ray_plane_test(const Ray& r, float4 pn,
                                               float4 pu, float4 pv,
                                               float t_best, float& t) {
  const float on = ray_dot(r.ox, r.oy, r.oz, pn.x, pn.y, pn.z);
  const float dn = ray_dot(r.dx, r.dy, r.dz, pn.x, pn.y, pn.z);
  t = rn_div(rn_sub(pn.w, on), dn);
  return ray_plane_inside(r, pu, pv, ray_origin_term(r, pu), ray_origin_term(r, pv), t) &&
         rn_sub(t_best, t) >= 0.0f;
}

// The brute-force kernel's test of a row k against (t_best, tri_best) with
// tri_best < k (rows visited in ascending order), from num = n_off - o.n,
// dn = d.n and the row's origin terms: ray_plane_test's acceptance and
// ray_better's preference.  There a tie in t never wins, and t < t_best
// holds exactly when rn(t_best - t) >= 0 and ray_better do (a finite
// difference of two distinct floats does not round to zero; inf - inf and
// NaN compare false), so the two fold into t < t_best.  Branch-free.
__device__ __forceinline__ bool ray_plane_wins(const Ray& r, float4 pu, float4 pv, float ou,
                                               float ov, float num, float dn, float t_best,
                                               float& t) {
  t = rn_div(num, dn);
  return ray_plane_inside(r, pu, pv, ou, ov, t) & (t < t_best);
}

// Closest-hit order: nearer t first, the lower row on an exact tie.  The
// initial (t_max, -1) is never beaten by a hit at t == t_max.
__device__ __forceinline__ bool ray_better(float t, int tri, float t_best,
                                           int tri_best) {
  return t < t_best || (t == t_best && tri < tri_best);
}
