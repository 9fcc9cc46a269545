// Whole-loop colored sequential-impulse solver for Hopper (sm_90a).
//
// Replaces the TPU kernel `_build_kernel` of
// d3d12renderer_tpu/physics/solver_pallas.py (reached through
// `make_colored_solver`): `iterations` Gauss-Seidel sweeps over the joint
// tables in JOINT_SOLVE_ORDER (distance, ball, fixed, hinge, cone-twist),
// then over the contact rows color by color, with accumulated impulses kept
// across the sweeps and zero at the start.  Output: the solved (vel1,
// omega1), (B, S, 3) float32.
//
// Design (right before fast):
//   * One thread per scene, 128 threads per block, ceil(B / 128) blocks.
//   * Each thread walks its scene's rows strictly in order: table by table,
//     color by color, row by row within a color (the color-permuted order of
//     the wrapper's `_TableMeta.perm`); `solve_scene` in solver_rows.cuh.
//   * The scene's body velocities (S <= MAX_SLOTS slots of v and w) and its
//     accumulated impulses live in the thread's local memory.  Only dynamic
//     bodies are written back after a row, as the reference's
//     `_scatter_rows_ref` does.
//   * Per-scene prep comes in one float buffer laid out [plane][row][scene],
//     scene innermost, so a warp reads 32 neighbouring floats per field.  The
//     field offsets are the constants of solver_rows.cuh; the wrapper
//     (physics/solver_cuda.py) packs the buffer with the same offsets.
//
// What bounds it on this card: each iteration re-reads the scene's whole prep
// (about 2k floats, 8 KB, per scene; 33 MB at B = 4096) from L2, and each row
// is a long dependent chain of gathers and branches over a few dozen floats.
// There is no tile math, so wgmma and TMA do not apply.  Later speed work is
// about occupancy and keeping prep in registers or shared memory.
//
// nvcc contracts a*b+c into FMA; the plain PyTorch version rounds each
// product, so the two agree to float rounding, not bit for bit.

#include <cuda_runtime.h>

#include "solver_rows.cuh"

namespace {

constexpr int MAX_SLOTS = 32;
constexpr int MAX_IMPULSES = 256;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS) colored_solver_kernel(
    const float* __restrict__ vel_in, const float* __restrict__ omega_in,
    float* __restrict__ vel_out, float* __restrict__ omega_out,
    const float* __restrict__ prep, const int* __restrict__ tables, int num_tables,
    const int* __restrict__ colors, const int* __restrict__ body_a,
    const int* __restrict__ body_b, const int* __restrict__ dynamic,
    int num_slots, int num_impulses, int batch, int iterations) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= batch) return;

  V3 v[MAX_SLOTS], w[MAX_SLOTS];
  float imp[MAX_IMPULSES];
  for (int i = 0; i < num_slots; ++i) {
    const float* vi = vel_in + ((size_t)s * num_slots + i) * 3;
    const float* wi = omega_in + ((size_t)s * num_slots + i) * 3;
    v[i] = {vi[0], vi[1], vi[2]};
    w[i] = {wi[0], wi[1], wi[2]};
  }
  for (int i = 0; i < num_impulses; ++i) imp[i] = 0.0f;

  solve_scene(v, w, imp, prep, tables, num_tables, colors, body_a, body_b, dynamic, batch, s,
              iterations);

  for (int i = 0; i < num_slots; ++i) {
    float* vo = vel_out + ((size_t)s * num_slots + i) * 3;
    float* wo = omega_out + ((size_t)s * num_slots + i) * 3;
    vo[0] = v[i].x;
    vo[1] = v[i].y;
    vo[2] = v[i].z;
    wo[0] = w[i].x;
    wo[1] = w[i].y;
    wo[2] = w[i].z;
  }
}

}  // namespace

extern "C" int colored_solver_max_slots() { return MAX_SLOTS; }

extern "C" int colored_solver_max_impulses() { return MAX_IMPULSES; }

// Launches on `stream`; returns cudaGetLastError() after the launch (0 = ok),
// or -1 when the scene exceeds the per-thread arrays.
extern "C" int colored_solver_launch(const float* vel_in, const float* omega_in, float* vel_out,
                                     float* omega_out, const float* prep, const int* tables,
                                     int num_tables, const int* colors, const int* body_a,
                                     const int* body_b, const int* dynamic, int num_slots,
                                     int num_impulses, int batch, int iterations, int device,
                                     void* stream) {
  if (num_slots > MAX_SLOTS || num_impulses > MAX_IMPULSES) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (batch + THREADS - 1) / THREADS;
  colored_solver_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      vel_in, omega_in, vel_out, omega_out, prep, tables, num_tables, colors, body_a, body_b,
      dynamic, num_slots, num_impulses, batch, iterations);
  return (int)cudaGetLastError();
}
