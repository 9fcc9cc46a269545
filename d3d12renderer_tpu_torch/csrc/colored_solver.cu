// Whole-loop colored sequential-impulse solver for Hopper (sm_90a).
//
// Replaces the TPU kernel `_build_kernel` of
// d3d12renderer_tpu/physics/solver_pallas.py (reached through
// `make_colored_solver`): `iterations` Gauss-Seidel sweeps over the joint
// tables in JOINT_SOLVE_ORDER (distance, ball, fixed, hinge, cone-twist,
// slider), then over the contact rows color by color, with accumulated
// impulses kept across the sweeps and zero at the start.  The contact rows
// are one table in the builder's global color order: plane rows, then
// collider-pair rows, whose A body is dynamic.  Output: the solved (vel1,
// omega1), (B, S, 3) float32.
//
// Design:
//   * A team of W lanes per scene (W = 8, 16 or 32, a template parameter),
//     one warp per block holding 32 / W teams; `solve_scene` in
//     solver_rows.cuh.  The lanes of a team solve the rows of one color at
//     the same time (they touch disjoint dynamic bodies); the warp meets
//     at a __syncwarp after each color.
//   * The prep comes in one float buffer laid out [scene][plane], each
//     scene's planes contiguous and padded to 16 bytes; within a scene a
//     table's planes are [row][field] with an odd row stride
//     (physics/solver_cuda.py packs it with the field offsets of
//     solver_rows.cuh).  Each team copies its scene's
//     prep into its slice of shared memory once, with one bulk asynchronous
//     copy (cp.async.bulk, completing on an mbarrier), while the other lanes
//     load the body velocities and zero the impulses there.
//   * The 30 sweeps then read and write shared memory only: body v and w
//     (S slots), the prep and the accumulated impulses.  Only dynamic bodies
//     are written back after a row, as the reference's `_scatter_rows_ref`.
//
// What bounds it on this card: latency.  A team walks a chain of dependent
// color steps, 30 iterations of one step per color (10 for the ragdoll: 1
// hinge, 5 cone-twist, 4 contact colors), each a row solve of a few dozen
// dependent shared-memory loads and flops; and shared memory per scene
// (about 9.6 KB for the ragdoll) holds 20 scenes on an SM, so B = 4096
// runs in two rounds.  The time hardly moves from one warp per SM to 20
// scenes per SM (PERF.md).  There is no tile math, so wgmma does not
// apply; the prep is read from device memory once (34 MB at B = 4096,
// ~10 us at 3.35 TB/s).  The team width 8 (solver_cuda.TEAM_WIDTH) was the
// fastest of 8, 16 and 32 on the card.  The self-colliding ragdoll has 42
// color steps per iteration and 59 KB of shared memory per scene: four
// teams do not fit one block, so the wrapper takes the narrowest wider
// width that fits (16: two scenes per block).
//
// nvcc contracts a*b+c into FMA; the plain PyTorch version rounds each
// product, so the two agree to float rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "solver_rows.cuh"

namespace {

// Floats at the head of a team's slice for its mbarrier (8 bytes), keeping
// the prep after it 16-byte aligned.
constexpr int BARRIER_FLOATS = 4;

// One team's shared floats: the barrier, the prep (`prep_stride` floats, a
// multiple of 4), v and w of `num_slots` slots, the impulses.  The wrapper
// mirrors this (a CPU test holds the two together).
__host__ __device__ inline int colored_team_floats(int num_slots, int prep_stride, int num_impulses,
                                                   int W) {
  return team_floats(BARRIER_FLOATS + prep_stride + 6 * num_slots + num_impulses, W);
}

// Copies `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// device memory into shared memory with one bulk asynchronous copy that
// completes on `bar`.  Called by one lane; every lane then waits with
// `wait_bulk_copy`.  A host build copies at once.
__device__ __forceinline__ void start_bulk_copy(float* dst, const float* src, int bytes, uint64_t* bar) {
#ifdef __CUDA_ARCH__
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(b), "r"(1) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(d),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
#else
  (void)bar;
  memcpy(dst, src, bytes);
#endif
}

// Waits for phase 0 of `bar`, initialised by `start_bulk_copy` before the
// team's last barrier.
__device__ __forceinline__ void wait_bulk_copy(uint64_t* bar) {
#ifdef __CUDA_ARCH__
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b)
        : "memory");
  }
#else
  (void)bar;
#endif
}

template <int W>
__global__ void __launch_bounds__(WARP) colored_solver_kernel(
    const float* __restrict__ vel_in, const float* __restrict__ omega_in,
    float* __restrict__ vel_out, float* __restrict__ omega_out,
    const float* __restrict__ prep, int prep_stride, const int* __restrict__ tables,
    int num_tables, const int* __restrict__ colors, const int* __restrict__ body_a,
    const int* __restrict__ body_b, const int* __restrict__ dynamic, int num_slots,
    int num_impulses, int batch, int iterations) {
  DYNAMIC_SHARED(smem);
  const Team team = make_team<W>(batch);
  float* base = smem + (size_t)team.index * colored_team_floats(num_slots, prep_stride, num_impulses, W);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base);
  float* p = base + BARRIER_FLOATS;
  V3* v = reinterpret_cast<V3*>(p + prep_stride);
  V3* w = v + num_slots;
  float* imp = reinterpret_cast<float*>(w + num_slots);
  const size_t s = team.scene;

  if (team.active && team.lane == 0)
    start_bulk_copy(p, prep + s * prep_stride, prep_stride * (int)sizeof(float), bar);
  if (team.active) {
    for (int i = team.lane; i < num_slots; i += W) {
      const float* vi = vel_in + (s * num_slots + i) * 3;
      const float* wi = omega_in + (s * num_slots + i) * 3;
      v[i] = {__ldg(vi), __ldg(vi + 1), __ldg(vi + 2)};
      w[i] = {__ldg(wi), __ldg(wi + 1), __ldg(wi + 2)};
    }
    for (int i = team.lane; i < num_impulses; i += W) imp[i] = 0.0f;
  }
  team.sync();
  if (team.active) wait_bulk_copy(bar);

  solve_scene<W>(team, v, w, imp, p, tables, num_tables, colors, body_a, body_b, dynamic, iterations);

  if (team.active) {
    for (int i = team.lane; i < num_slots; i += W) {
      float* vo = vel_out + (s * num_slots + i) * 3;
      float* wo = omega_out + (s * num_slots + i) * 3;
      vo[0] = v[i].x;
      vo[1] = v[i].y;
      vo[2] = v[i].z;
      wo[0] = w[i].x;
      wo[1] = w[i].y;
      wo[2] = w[i].z;
    }
  }
}

template <int W>
int launch(const float* vel_in, const float* omega_in, float* vel_out, float* omega_out,
           const float* prep, int prep_stride, const int* tables, int num_tables, const int* colors,
           const int* body_a, const int* body_b, const int* dynamic, int num_slots, int num_impulses,
           int batch, int iterations, cudaStream_t stream) {
  const int bytes = (WARP / W) * colored_team_floats(num_slots, prep_stride, num_impulses, W) * 4;
  const void* kernel = (const void*)colored_solver_kernel<W>;
  cudaError_t err = cudaSuccess;
  if (bytes > DEFAULT_SHARED_BYTES) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  void* params[] = {&vel_in, &omega_in, &vel_out, &omega_out, &prep, &prep_stride, &tables,
                    &num_tables, &colors, &body_a, &body_b, &dynamic, &num_slots, &num_impulses,
                    &batch, &iterations};
  const dim3 blocks((batch + WARP / W - 1) / (WARP / W)), threads(WARP);
  err = cudaLaunchKernel(kernel, blocks, threads, params, bytes, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The shared memory one block of `device` may use, in bytes.
extern "C" int solver_shared_limit(int device) {
  int limit = 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return -1;
  return limit;
}

// Blocks of the team width `team` resident on one SM at `bytes` of dynamic
// shared memory per block, or a negative CUDA error.
extern "C" int colored_solver_blocks_per_sm(int team, int bytes) {
  const void* kernel = team == 8    ? (const void*)colored_solver_kernel<8>
                       : team == 16 ? (const void*)colored_solver_kernel<16>
                                    : (const void*)colored_solver_kernel<32>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, WARP, bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Launches on `stream`; returns cudaGetLastError() after the launch (0 = ok),
// or -1 for a team width other than 8, 16 or 32.  `prep` is (B,
// prep_stride) with prep_stride a multiple of 4 and the buffer 16-byte
// aligned.
extern "C" int colored_solver_launch(const float* vel_in, const float* omega_in, float* vel_out,
                                     float* omega_out, const float* prep, int prep_stride,
                                     const int* tables, int num_tables, const int* colors,
                                     const int* body_a, const int* body_b, const int* dynamic,
                                     int num_slots, int num_impulses, int batch, int iterations,
                                     int team, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (team) {
    case 8:
      return launch<8>(vel_in, omega_in, vel_out, omega_out, prep, prep_stride, tables, num_tables, colors,
                       body_a, body_b, dynamic, num_slots, num_impulses, batch, iterations, st);
    case 16:
      return launch<16>(vel_in, omega_in, vel_out, omega_out, prep, prep_stride, tables, num_tables, colors,
                        body_a, body_b, dynamic, num_slots, num_impulses, batch, iterations, st);
    case 32:
      return launch<32>(vel_in, omega_in, vel_out, omega_out, prep, prep_stride, tables, num_tables, colors,
                        body_a, body_b, dynamic, num_slots, num_impulses, batch, iterations, st);
    default:
      return -1;
  }
}
