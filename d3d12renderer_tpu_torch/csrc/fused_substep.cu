// Fused whole-substep kernel for Hopper (sm_90a): one physics substep of every
// scene, and optionally the locomotion env's post stage, in one launch.
//
// Replaces the TPU kernel `_build_kernel` of
// d3d12renderer_tpu/physics/substep_pallas.py (reached through
// `make_kernel_runner` / `make_fused_substep`) together with the post stage of
// d3d12renderer_tpu/learning/loco_env.py (`_build_post_stage`).  Per scene:
//   1. forces: gravity, external force plus the global force field, the world
//      inverse inertia R I^-1 R^T from the pre-step rotation, damping;
//   2. plane narrowphase on the pre-integration poses (sphere: 1 point,
//      capsule: 2 endpoints, box: the 4 deepest of 8 corners by iterated
//      first-index argmax) and contact prep against the static world side;
//   3. joint prep (distance, ball, fixed, hinge, cone-twist) with the runtime
//      motor overrides;
//   4. the `iterations`-long sequential-impulse solve (`solve_scene`,
//      solver_rows.cuh), exactly as the colored solver walks it;
//   5. semi-implicit Euler;
//   6. with `extras`: the 14x6 sample points, the imitation reward and fall
//      factor, done = head height < 1, the obs, and the reset of done scenes
//      to the standing pose and its obs.
//
// Design:
//   * A team of W lanes per scene (W = 8, 16 or 32, a template parameter),
//     one warp per block holding 32 / W teams; teams past the end of the
//     batch skip the work but keep to every barrier.  Table-driven: the
//     archetype comes in as small constant arrays (bodies, rows in the
//     colored solver's packed order, tables and colors), packed by
//     physics/substep_cuda.py; no source is generated per archetype.
//   * Everything of a scene lives in the team's slice of the block's dynamic
//     shared memory: body pos, rot, v, w and world inverse inertia (N bodies
//     and the world slot), every row's prep in the colored solver's
//     per-scene layout ([row][field] per table) and the accumulated impulses.
//     Nothing goes through device memory but the inputs and outputs.
//   * The lanes work in parallel, the warp meeting at a __syncwarp between
//     stages: step 1 and step 5 one body per lane, steps 2-3 one row
//     per lane (table by table, so lanes of one kind run together), step 4
//     the team solve of solver_rows.cuh (`solve_scene`, shared with the
//     colored solver), step 6 one part per lane, then the sums, obs and
//     reward on the team's first lane.
//   * Transcendentals are the true atan2f / acosf / expf.  The 32-byte stack
//     frame ptxas reports is sinf / cosf's reduction of large arguments (the
//     swing motor axis of the cone-twist prep); no body or impulse state
//     lives in local memory.
//
// What bounds it on this card: latency.  The solve is a chain of dependent
// color steps, 30 iterations of one step per color (10 for the ragdoll: 1
// hinge, 5 cone-twist, 4 contact colors), each a row solve of a few dozen
// dependent shared-memory loads and flops; and shared memory per scene
// (about 10.5 KB for the ragdoll) holds 20 scenes on an SM, so B = 4096
// runs in two rounds.  The solve is ~80% of a launch, the post stage ~5%
// (PERF.md).  There is no tile math, so wgmma and TMA do not apply.  The
// team width 8 (solver_cuda.TEAM_WIDTH) was the fastest of 8, 16 and 32.
//
// nvcc contracts a*b+c into FMA and the plain PyTorch version rounds every
// product; the prep also takes other op orders than the plain version, so
// the two agree to float rounding, not bit for bit.

#include <cuda_runtime.h>

#include "solver_rows.cuh"

// Everything one launch reads and writes.  Mirrored field for field by the
// ctypes Structure `FusedArgs` of physics/substep_cuda.py.  Outside the
// anonymous namespace: the extern "C" entry point takes it.
struct FusedArgs {
  const float* pos_in;     // (B, N, 3)
  const float* rot_in;     // (B, N, 4)
  const float* vel_in;     // (B, N, 3)
  const float* omega_in;   // (B, N, 3)
  const float* force_in;   // (B, N, 3)
  const float* torque_in;  // (B, N, 3)
  float* pos_out;
  float* rot_out;
  float* vel_out;
  float* omega_out;
  float* force_out;        // zeros, as the step clears the accumulators
  float* torque_out;
  const float* ovr;        // (B, ovr_cols) runtime motor targets
  float* extras;           // (B, n_extra) post-stage output, or null
  const float* body_f;     // (N + 1, BODY_F)
  const float* row_f;      // (rows, ROW_F) in packed order
  const int* row_i;        // (rows, ROW_I)
  const int* tables;       // (num_tables, TABLE_INTS)
  const int* colors;       // (colors, 2) row bounds
  const int* body_a;       // (rows,)
  const int* body_b;
  const int* dynamic;      // (N + 1,)
  const float* post_f;     // post-stage constants, or null
  const int* post_i;
  int num_tables;
  int num_bodies;
  int num_impulses;
  int planes;              // prep floats per scene
  int ovr_cols;
  int n_extra;
  int batch;
  int iterations;
  float dt;
  float ball_bias;         // BALL_BETA / dt
  float hinge_rot_bias;    // HINGE_ROTATION_BETA / dt
  float hinge_limit_bias;  // HINGE_LIMIT_BETA / dt
  float twist_limit_bias;  // TWIST_LIMIT_BETA / dt
  float distance_bias;     // DISTANCE_BETA / dt
  float fixed_rot_bias;    // 2 * SLIDER_BETA / dt
  float gff_x;
  float gff_y;
  float gff_z;
};

namespace {

constexpr float PI = 3.14159265358979323846f;
constexpr float GRAVITY = -9.81f;
constexpr float CONTACT_SLOP = 0.001f;
constexpr float BAUMGARTE_SCALE = 0.1f;
constexpr float SWING_MOTOR_GAIN = 0.2f;
constexpr float MOTOR_POSITION = 1.0f;

constexpr int SHAPE_SPHERE = 0;
constexpr int SHAPE_CAPSULE = 1;

// ---- archetype constants (physics/substep_cuda.py packs them) -------------
// Per body slot (N + 1 rows, the static world body last).
constexpr int B_INV_MASS = 0;
constexpr int B_INV_INERTIA = 1;
constexpr int B_GRAVITY_FACTOR = 10;
constexpr int B_LINEAR_DAMPING = 11;
constexpr int B_ANGULAR_DAMPING = 12;
constexpr int B_LOCAL_COG = 13;
constexpr int BODY_F = 16;
// Per packed joint row.
constexpr int K_ANCHOR_A = 0;
constexpr int K_ANCHOR_B = 3;
constexpr int K_AXIS_A = 6;
constexpr int K_AXIS_B = 9;
constexpr int K_TANGENT_A = 12;
constexpr int K_BITANGENT_A = 15;
constexpr int K_TANGENT_B = 18;
constexpr int K_INIT_INV_ROT = 21;
constexpr int K_LENGTH = 25;
constexpr int K_MIN_LIMIT = 26;
constexpr int K_MAX_LIMIT = 27;
constexpr int K_MOTOR_TYPE = 28;
constexpr int K_MOTOR_TARGET = 29;
constexpr int K_MAX_TORQUE = 30;
constexpr int K_SWING_LIMIT = 31;
constexpr int K_TWIST_LIMIT = 32;
constexpr int K_SWING_MOTOR_TYPE = 33;
constexpr int K_SWING_TARGET = 34;
constexpr int K_SWING_AXIS_ANGLE = 35;
constexpr int K_MAX_SWING_TORQUE = 36;
constexpr int K_TWIST_MOTOR_TYPE = 37;
constexpr int K_TWIST_TARGET = 38;
constexpr int K_MAX_TWIST_TORQUE = 39;
// Per packed contact (plane) row.
constexpr int P_SIZE = 0;
constexpr int P_LOCAL_POS = 3;
constexpr int P_LOCAL_ROT = 6;
constexpr int P_NORMAL = 10;
constexpr int P_OFFSET = 13;
constexpr int P_FRICTION = 14;
constexpr int P_RESTITUTION = 15;
constexpr int ROW_F = 40;
// Per packed row, ints.  Joints: active, then the override column of each
// runtime motor target (-1: the constant).  Contacts: valid, shape type.
constexpr int R_ACTIVE = 0;
constexpr int R_OVR_MOTOR_TARGET = 1;
constexpr int R_OVR_TWIST_TARGET = 2;
constexpr int R_OVR_SWING_TARGET = 3;
constexpr int R_OVR_SWING_AXIS_ANGLE = 4;
constexpr int R_SHAPE = 1;
constexpr int ROW_I = 8;
// Post stage ints: counts, then index lists.
constexpr int Q_PARTS = 0;
constexpr int Q_POINTS = 1;
constexpr int Q_OBS_PARTS = 2;
constexpr int Q_ACTIONS = 3;
constexpr int Q_HEAD_BODY = 4;
constexpr int Q_TORSO_BODY = 5;
constexpr int Q_LISTS = 6;  // part_body[P], parent_body[P], obs_body[O], action_col[A]

struct Q4 {
  float x, y, z, w;
};

struct M3 {
  float m[9];
};

__device__ __forceinline__ V3 ld3(const float* p) { return {__ldg(p), __ldg(p + 1), __ldg(p + 2)}; }
__device__ __forceinline__ Q4 ld4(const float* p) {
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)};
}
__device__ __forceinline__ float length(V3 a) { return sqrtf(dot(a, a)); }

__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
  return {a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w,
          a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z};
}
__device__ __forceinline__ Q4 qconj(Q4 q) { return {-q.x, -q.y, -q.z, q.w}; }
// v + 2 * cross(q.xyz, cross(q.xyz, v) + q.w * v)
__device__ __forceinline__ V3 qrot(Q4 q, V3 v) {
  const V3 u = {q.x, q.y, q.z};
  const V3 t = add(cross(u, v), scale(v, q.w));
  return add(v, scale(cross(u, t), 2.0f));
}
__device__ __forceinline__ Q4 qnormalize(Q4 q) {
  const float n = fmaxf(sqrtf(q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w), 1e-12f);
  return {q.x / n, q.y / n, q.z / n, q.w / n};
}
// Normalize-or-zero.
__device__ __forceinline__ V3 noz(V3 v) {
  const float sl = dot(v, v);
  const float d = sqrtf(fmaxf(sl, 1e-8f));
  return sl < 1e-8f ? V3{0.0f, 0.0f, 0.0f} : V3{v.x / d, v.y / d, v.z / d};
}

__device__ __forceinline__ M3 mat_from_quat(Q4 q) {
  const float xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  const float xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  const float wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  return {{1.0f - 2.0f * (yy + zz), 2.0f * (xy - wz), 2.0f * (xz + wy),
           2.0f * (xy + wz), 1.0f - 2.0f * (xx + zz), 2.0f * (yz - wx),
           2.0f * (xz - wy), 2.0f * (yz + wx), 1.0f - 2.0f * (xx + yy)}};
}
// a * b, or a * b^T.
__device__ __forceinline__ M3 mat_mul(const M3& a, const M3& b, bool b_transposed) {
  M3 out;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float acc = 0.0f;
      for (int k = 0; k < 3; ++k) acc += a.m[3 * i + k] * (b_transposed ? b.m[3 * j + k] : b.m[3 * k + j]);
      out.m[3 * i + j] = acc;
    }
  return out;
}
__device__ __forceinline__ V3 mv(const M3& a, V3 x) {
  return {a.m[0] * x.x + a.m[1] * x.y + a.m[2] * x.z, a.m[3] * x.x + a.m[4] * x.y + a.m[5] * x.z,
          a.m[6] * x.x + a.m[7] * x.y + a.m[8] * x.z};
}
__device__ __forceinline__ M3 skew(V3 v) { return {{0.0f, -v.z, v.y, v.z, 0.0f, -v.x, -v.y, v.x, 0.0f}}; }

// Closed-form adjugate inverse of K + 1e-9 I; zero when inactive or singular.
__device__ M3 safe_inv3(M3 K, bool active) {
  if (!active) return M3{{0, 0, 0, 0, 0, 0, 0, 0, 0}};
  const float a = K.m[0] + 1e-9f, b = K.m[1], c = K.m[2];
  const float d = K.m[3], e = K.m[4] + 1e-9f, f = K.m[5];
  const float g = K.m[6], h = K.m[7], i = K.m[8] + 1e-9f;
  const float A = e * i - f * h;
  const float B = -(d * i - f * g);
  const float C = d * h - e * g;
  const float det = a * A + b * B + c * C;
  const float inv_det = fabsf(det) > 1e-20f ? 1.0f / det : 0.0f;
  return {{A * inv_det, -(b * i - c * h) * inv_det, (b * f - c * e) * inv_det,
           B * inv_det, (a * i - c * g) * inv_det, -(a * f - c * d) * inv_det,
           C * inv_det, -(a * h - b * g) * inv_det, (a * e - b * d) * inv_det}};
}

// Duff et al. branch-free orthonormal basis of unit n.
__device__ __forceinline__ void orthonormal_basis(V3 n, V3& t1, V3& t2) {
  const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + n.z);
  const float b = n.x * n.y * a;
  t1 = {1.0f + sign * n.x * n.x * a, sign * b, -sign * n.x};
  t2 = {b, sign + n.y * n.y * a, -n.y};
}

// Writes one row's prep: field f of this row is p[f].
struct PrepOut {
  float* p;
  __device__ __forceinline__ void set(int f, float x) const { p[f] = x; }
  __device__ __forceinline__ void set3(int f, V3 x) const {
    set(f, x.x);
    set(f + 1, x.y);
    set(f + 2, x.z);
  }
  __device__ __forceinline__ void set9(int f, const M3& x) const {
    for (int k = 0; k < 9; ++k) set(f + k, x.m[k]);
  }
};

// The scene's body state in the team's shared memory: N bodies and the world
// slot N.
struct Scene {
  V3* pos;
  Q4* rot;
  V3* v;
  V3* w;
  M3* iiw;
};

// Floats of body state per slot: pos 3, rot 4, v 3, w 3, iiw 9.
constexpr int SLOT_FLOATS = 22;

// One team's shared floats: the prep, the impulses, the body state.  The
// wrapper mirrors this (a CPU test holds the two together).
__host__ __device__ inline int fused_team_floats(int num_bodies, int planes, int num_impulses, int W) {
  return team_floats(planes + num_impulses + SLOT_FLOATS * (num_bodies + 1), W);
}

// ---- joint preps (physics/joints.py) ---------------------------------------

struct JointCommon {
  int a, b;
  Q4 qa, qb;
  V3 ra, rb, ga, gb;
  float im_a, im_b;
  bool active;
};

__device__ JointCommon joint_common(const Scene& S, const float* body_f, const float* K, int a, int b,
                                    bool active) {
  JointCommon c;
  c.a = a;
  c.b = b;
  c.qa = S.rot[a];
  c.qb = S.rot[b];
  c.ra = qrot(c.qa, sub(ld3(K + K_ANCHOR_A), ld3(body_f + a * BODY_F + B_LOCAL_COG)));
  c.rb = qrot(c.qb, sub(ld3(K + K_ANCHOR_B), ld3(body_f + b * BODY_F + B_LOCAL_COG)));
  c.ga = add(S.pos[a], c.ra);
  c.gb = add(S.pos[b], c.rb);
  c.im_a = __ldg(body_f + a * BODY_F + B_INV_MASS);
  c.im_b = __ldg(body_f + b * BODY_F + B_INV_MASS);
  c.active = active;
  return c;
}

// The ball part: ra, rb, bias, inv_K, im_a, im_b, ii_a, ii_b.
__device__ void prep_ball_part(const Scene& S, const JointCommon& c, float bias_scale, const PrepOut& out) {
  const M3& ii_a = S.iiw[c.a];
  const M3& ii_b = S.iiw[c.b];
  const M3 sa = skew(c.ra), sb = skew(c.rb);
  const M3 ka = mat_mul(mat_mul(sa, ii_a, false), sa, true);
  const M3 kb = mat_mul(mat_mul(sb, ii_b, false), sb, true);
  const float ims = c.im_a + c.im_b;
  M3 K;
  for (int k = 0; k < 9; ++k) K.m[k] = ka.m[k] + kb.m[k] + (k % 4 == 0 ? ims : 0.0f);
  out.set3(J_RA, c.ra);
  out.set3(J_RB, c.rb);
  out.set3(J_BIAS, scale(sub(c.gb, c.ga), bias_scale));
  out.set9(J_INV_K, safe_inv3(K, c.active));
  out.set(J_IM_A, c.im_a);
  out.set(J_IM_B, c.im_b);
  out.set9(J_II_A, ii_a);
  out.set9(J_II_B, ii_b);
}

// Effective mass and impulse-to-omega maps of a rotation about `axis`.
__device__ __forceinline__ float axial(const M3& ii_a, const M3& ii_b, V3 axis, bool active, V3& to_wa,
                                       V3& to_wb) {
  to_wa = mv(ii_a, axis);
  to_wb = mv(ii_b, axis);
  const float inv_k = dot(axis, to_wa) + dot(axis, to_wb);
  return (inv_k != 0.0f ? 1.0f / inv_k : 0.0f) * (active ? 1.0f : 0.0f);
}

// A runtime motor target from the override column `col`, or the constant.
__device__ __forceinline__ float motor_param(const FusedArgs& A, int s, int col, const float* K, int f) {
  return col >= 0 ? __ldg(A.ovr + (size_t)s * A.ovr_cols + col) : __ldg(K + f);
}

__device__ void prep_distance(const FusedArgs& A, const Scene& S, const JointCommon& c, const float* K,
                              const PrepOut& out) {
  V3 u = sub(c.gb, c.ga);
  const float l = length(u);
  const float d = fmaxf(l, 1e-3f);
  u = l > 1e-3f ? V3{u.x / d, u.y / d, u.z / d} : V3{0.0f, 0.0f, 0.0f};
  const V3 ca = cross(c.ra, u), cb = cross(c.rb, u);
  const V3 to_wa = mv(S.iiw[c.a], ca), to_wb = mv(S.iiw[c.b], cb);
  const float k = c.im_a + c.im_b + dot(ca, to_wa) + dot(cb, to_wb);
  out.set3(D_RA, c.ra);
  out.set3(D_RB, c.rb);
  out.set3(D_U, u);
  out.set(D_BIAS, (l - __ldg(K + K_LENGTH)) * A.distance_bias);
  out.set(D_EFF, (k != 0.0f ? 1.0f / k : 0.0f) * (c.active ? 1.0f : 0.0f));
  out.set(D_IM_A, c.im_a);
  out.set(D_IM_B, c.im_b);
  out.set3(D_TO_WA, to_wa);
  out.set3(D_TO_WB, to_wb);
}

__device__ void prep_fixed(const FusedArgs& A, const Scene& S, const JointCommon& c, const float* K,
                           const PrepOut& out) {
  prep_ball_part(S, c, A.ball_bias, out);
  M3 sum;
  for (int k = 0; k < 9; ++k) sum.m[k] = S.iiw[c.a].m[k] + S.iiw[c.b].m[k];
  out.set9(F_INV_K_ROT, safe_inv3(sum, c.active));
  const Q4 err = qmul(c.qb, qmul(ld4(K + K_INIT_INV_ROT), qconj(c.qa)));
  out.set3(F_R_BIAS, scale(V3{err.x, err.y, err.z}, A.fixed_rot_bias));
}

__device__ void prep_hinge(const FusedArgs& A, const Scene& S, const JointCommon& c, const float* K,
                           const int* I, int s, const PrepOut& out) {
  prep_ball_part(S, c, A.ball_bias, out);
  const M3& ii_a = S.iiw[c.a];
  const M3& ii_b = S.iiw[c.b];
  const float dt = A.dt;

  const V3 axis_a_w = qrot(c.qa, ld3(K + K_AXIS_A));
  const V3 axis_b_w = qrot(c.qb, ld3(K + K_AXIS_B));
  V3 tb, bb;
  orthonormal_basis(axis_b_w, tb, bb);
  const V3 bxa = cross(tb, axis_a_w);
  const V3 cxa = cross(bb, axis_a_w);
  const V3 sum_b = add(mv(ii_a, bxa), mv(ii_b, bxa));
  const V3 sum_c = add(mv(ii_a, cxa), mv(ii_b, cxa));
  const float k00 = dot(bxa, sum_b), k01 = dot(bxa, sum_c);
  const float k10 = dot(cxa, sum_b), k11 = dot(cxa, sum_c);
  const float det = k00 * k11 - k01 * k10;
  const float inv_det = (fabsf(det) > 1e-12f ? 1.0f / det : 0.0f) * (c.active ? 1.0f : 0.0f);

  const V3 cmp_a = qrot(qconj(c.qa), qrot(c.qb, ld3(K + K_TANGENT_B)));
  const float angle = atan2f(dot(cmp_a, ld3(K + K_BITANGENT_A)), dot(cmp_a, ld3(K + K_TANGENT_A)));

  const float min_l = __ldg(K + K_MIN_LIMIT), max_l = __ldg(K + K_MAX_LIMIT);
  const bool min_active = min_l <= 0.0f, max_active = max_l >= 0.0f;
  const bool min_violated = min_active && angle <= min_l;
  const bool max_violated = max_active && angle >= max_l;
  const bool solve_limit = (min_violated || max_violated) && c.active;
  V3 to_wa, to_wb;
  const float eff_ax = axial(ii_a, ii_b, axis_a_w, c.active, to_wa, to_wb);

  const float max_torque = __ldg(K + K_MAX_TORQUE);
  const bool motor_active = max_torque > 0.0f && c.active;
  const float target = motor_param(A, s, I[R_OVR_MOTOR_TARGET], K, K_MOTOR_TARGET);
  const float tgt = clip(target, min_active ? min_l : -PI, max_active ? max_l : PI);
  const bool position = __ldg(K + K_MOTOR_TYPE) == MOTOR_POSITION;

  out.set3(H_AXIS, axis_a_w);
  out.set(H_MOTOR_VEL, position ? (tgt - angle) / dt : target);
  out.set(H_EFF_MOTOR, eff_ax * (motor_active ? 1.0f : 0.0f));
  out.set(H_MAX_IMP, fmaxf(max_torque, 0.0f) * dt);
  out.set3(H_TO_WA_AX, to_wa);
  out.set3(H_TO_WB_AX, to_wb);
  out.set(H_LIMIT_SIGN, min_violated ? 1.0f : -1.0f);
  out.set(H_LIMIT_BIAS, (min_violated ? angle - min_l : max_l - angle) * A.hinge_limit_bias);
  out.set(H_EFF_LIMIT, eff_ax * (solve_limit ? 1.0f : 0.0f));
  out.set3(H_BXA, bxa);
  out.set3(H_CXA, cxa);
  out.set(H_R_BIAS, dot(axis_a_w, tb) * A.hinge_rot_bias);
  out.set(H_R_BIAS + 1, dot(axis_a_w, bb) * A.hinge_rot_bias);
  out.set(H_I2, k11 * inv_det);
  out.set(H_I2 + 1, -k01 * inv_det);
  out.set(H_I2 + 2, -k10 * inv_det);
  out.set(H_I2 + 3, k00 * inv_det);
}

__device__ void prep_cone_twist(const FusedArgs& A, const Scene& S, const JointCommon& c, const float* K,
                                const int* I, int s, const PrepOut& out) {
  prep_ball_part(S, c, A.ball_bias, out);
  const M3& ii_a = S.iiw[c.a];
  const M3& ii_b = S.iiw[c.b];
  const float dt = A.dt;
  const V3 axis_a = ld3(K + K_AXIS_A);
  const V3 tangent_a = ld3(K + K_TANGENT_A), bitangent_a = ld3(K + K_BITANGENT_A);

  // Swing / twist decomposition in A's frame.
  const Q4 btoa = qmul(qconj(c.qa), c.qb);
  const V3 axis_cmp = qrot(btoa, ld3(K + K_AXIS_B));
  Q4 swing_q;
  {  // shortest arc from axis_a to axis_cmp
    const float w = 1.0f + dot(axis_a, axis_cmp);
    V3 v = cross(axis_a, axis_cmp), t1, t2;
    orthonormal_basis(axis_a, t1, t2);
    const bool anti = w < 1e-6f;
    v = anti ? t1 : v;
    swing_q = qnormalize(Q4{v.x, v.y, v.z, anti ? 0.0f : w});
  }
  const V3 twist_tan = qrot(swing_q, tangent_a);
  const V3 twist_bitan = qrot(swing_q, bitangent_a);
  const V3 tan_cmp = qrot(btoa, ld3(K + K_TANGENT_B));
  const float twist_angle = atan2f(dot(tan_cmp, twist_bitan), dot(tan_cmp, twist_tan));
  V3 swing_axis_l;
  float swing_angle;
  {  // axis and signed angle 2 atan2(|v|, w)
    const V3 v = {swing_q.x, swing_q.y, swing_q.z};
    const float l = length(v);
    swing_angle = 2.0f * atan2f(l, swing_q.w);
    const float d = fmaxf(l, 1e-9f);
    swing_axis_l = l > 1e-9f ? V3{v.x / d, v.y / d, v.z / d} : V3{1.0f, 0.0f, 0.0f};
    if (swing_angle < 0.0f) swing_axis_l = neg(swing_axis_l);
    swing_angle = fabsf(swing_angle);
  }

  // Swing limit.
  const float sl = __ldg(K + K_SWING_LIMIT);
  const bool solve_swing = sl >= 0.0f && swing_angle >= sl && c.active;
  const V3 swing_axis_w = qrot(c.qa, swing_axis_l);
  V3 sw_to_wa, sw_to_wb;
  const float eff_swing = axial(ii_a, ii_b, swing_axis_w, c.active, sw_to_wa, sw_to_wb);

  // Swing motor.
  const float max_swing_torque = __ldg(K + K_MAX_SWING_TORQUE);
  const bool swing_motor_active = max_swing_torque > 0.0f && c.active;
  const float saa = motor_param(A, s, I[R_OVR_SWING_AXIS_ANGLE], K, K_SWING_AXIS_ANGLE);
  const V3 local_motor_axis = add(scale(tangent_a, cosf(saa)), scale(bitangent_a, sinf(saa)));
  const float swing_target = motor_param(A, s, I[R_OVR_SWING_TARGET], K, K_SWING_TARGET);
  const float sw_tgt = sl >= 0.0f ? clip(swing_target, -sl, sl) : swing_target;
  const float half = 0.5f * sw_tgt;
  const V3 sv = scale(local_motor_axis, sinf(half));
  const V3 local_target_dir = qrot(Q4{sv.x, sv.y, sv.z, cosf(half)}, axis_a);
  const V3 pos_axis_l = noz(cross(axis_cmp, local_target_dir));
  const float cos_ang = clip(dot(local_target_dir, axis_cmp), 0.0f, 1.0f);
  const bool swing_position = __ldg(K + K_SWING_MOTOR_TYPE) == MOTOR_POSITION;
  const V3 swing_motor_axis_w = qrot(c.qa, swing_position ? pos_axis_l : local_motor_axis);
  V3 swm_to_wa, swm_to_wb;
  const float eff_swing_motor = axial(ii_a, ii_b, swing_motor_axis_w, c.active, swm_to_wa, swm_to_wb);

  // Twist limit and motor, about A's axis.
  const float tl = __ldg(K + K_TWIST_LIMIT);
  const V3 twist_axis_w = qrot(c.qa, axis_a);
  const bool min_violated = tl >= 0.0f && twist_angle <= -tl;
  const bool max_violated = tl >= 0.0f && twist_angle >= tl;
  const bool solve_twist = (min_violated || max_violated) && c.active;
  V3 tw_to_wa, tw_to_wb;
  const float eff_tw = axial(ii_a, ii_b, twist_axis_w, c.active, tw_to_wa, tw_to_wb);
  const float max_twist_torque = __ldg(K + K_MAX_TWIST_TORQUE);
  const bool twist_motor_active = max_twist_torque > 0.0f && c.active;
  const float lim = tl >= 0.0f ? tl : PI;
  const float twist_target = motor_param(A, s, I[R_OVR_TWIST_TARGET], K, K_TWIST_TARGET);
  const float tw_tgt = clip(twist_target, -lim, lim);
  const bool twist_position = __ldg(K + K_TWIST_MOTOR_TYPE) == MOTOR_POSITION;

  out.set3(CT_TWIST_AXIS, twist_axis_w);
  out.set(CT_EFF_TWIST_MOTOR, eff_tw * (twist_motor_active ? 1.0f : 0.0f));
  out.set(CT_TWIST_MOTOR_VEL, twist_position ? (tw_tgt - twist_angle) / dt : twist_target);
  out.set(CT_MAX_TWIST_IMP, fmaxf(max_twist_torque, 0.0f) * dt);
  out.set3(CT_TW_TO_WA, tw_to_wa);
  out.set3(CT_TW_TO_WB, tw_to_wb);
  out.set3(CT_SWING_MOTOR_AXIS, swing_motor_axis_w);
  out.set(CT_EFF_SWING_MOTOR, eff_swing_motor * (swing_motor_active ? 1.0f : 0.0f));
  out.set(CT_SWING_MOTOR_VEL, swing_position ? acosf(cos_ang) / dt * SWING_MOTOR_GAIN : swing_target);
  out.set(CT_MAX_SWING_IMP, fmaxf(max_swing_torque, 0.0f) * dt);
  out.set3(CT_SWM_TO_WA, swm_to_wa);
  out.set3(CT_SWM_TO_WB, swm_to_wb);
  out.set(CT_TWIST_SIGN, min_violated ? 1.0f : -1.0f);
  out.set(CT_EFF_TWIST_LIMIT, eff_tw * (solve_twist ? 1.0f : 0.0f));
  out.set(CT_TWIST_BIAS, (min_violated ? tl + twist_angle : tl - twist_angle) * A.twist_limit_bias);
  out.set3(CT_SWING_AXIS, swing_axis_w);
  out.set(CT_EFF_SWING, eff_swing * (solve_swing ? 1.0f : 0.0f));
  out.set(CT_SWING_BIAS, (sl - swing_angle) * A.hinge_limit_bias);
  out.set3(CT_SW_TO_WA, sw_to_wa);
  out.set3(CT_SW_TO_WB, sw_to_wb);
}

// ---- plane narrowphase and contact prep (physics/collide.py, narrow.py,
// solver.py prep_contacts_full), A = the static world --------------------

struct Manifold {
  V3 point[4];
  float depth[4];
  bool hit[4];
};

// One point against the plane, at `radius` around `center`.
__device__ __forceinline__ void sphere_point(V3 center, float radius, V3 n, float off, Manifold& m, int k) {
  const float dist = dot(n, center) - off;
  const float depth = radius - dist;
  m.point[k] = sub(center, scale(n, dist + 0.5f * depth));
  m.depth[k] = depth;
  m.hit[k] = depth >= 0.0f;
}

__device__ Manifold plane_manifold(const Scene& S, const float* body_f, const float* P, int b, int shape) {
  Manifold m;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m.point[k] = {0.0f, 0.0f, 0.0f};
    m.depth[k] = 0.0f;
    m.hit[k] = false;
  }
  const Q4 qb = S.rot[b];
  const Q4 wrot = qmul(qb, ld4(P + P_LOCAL_ROT));
  const V3 wpos = add(S.pos[b], qrot(qb, sub(ld3(P + P_LOCAL_POS), ld3(body_f + b * BODY_F + B_LOCAL_COG))));
  const V3 n = ld3(P + P_NORMAL);
  const float off = __ldg(P + P_OFFSET);
  const V3 size = ld3(P + P_SIZE);
  if (shape == SHAPE_SPHERE) {
    sphere_point(wpos, size.x, n, off, m, 0);
  } else if (shape == SHAPE_CAPSULE) {
    const V3 axis = qrot(wrot, V3{0.0f, 1.0f, 0.0f});
    sphere_point(sub(wpos, scale(axis, size.y)), size.x, n, off, m, 0);
    sphere_point(add(wpos, scale(axis, size.y)), size.x, n, off, m, 1);
  } else {
    // Box: 8 corners, x fastest, then the 4 deepest hits by iterated
    // first-index argmax (ties keep the lowest corner first).  Every index
    // is a constant after unrolling, so the arrays stay in registers.
    V3 pts[8];
    float depth[8], score[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const V3 local = {(j & 1 ? 1.0f : -1.0f) * size.x, (j & 2 ? 1.0f : -1.0f) * size.y,
                        (j & 4 ? 1.0f : -1.0f) * size.z};
      const V3 p = add(wpos, qrot(wrot, local));
      depth[j] = -(dot(p, n) - off);
      pts[j] = add(p, scale(n, 0.5f * depth[j]));
      score[j] = depth[j] >= 0.0f ? depth[j] : -INFINITY;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int best = 0;
      float best_score = score[0];
      V3 best_pt = pts[0];
      float best_depth = depth[0];
#pragma unroll
      for (int j = 1; j < 8; ++j)
        if (score[j] > best_score) {
          best = j;
          best_score = score[j];
          best_pt = pts[j];
          best_depth = depth[j];
        }
      m.point[k] = best_pt;
      m.depth[k] = best_depth;
      m.hit[k] = best_depth >= 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j == best) score[j] = -INFINITY;
    }
  }
  return m;
}

__device__ void prep_contact(const FusedArgs& A, const Scene& S, const float* P, int b, int shape, bool valid,
                             const PrepOut& out) {
  const Manifold m = plane_manifold(S, A.body_f, P, b, shape);
  const V3 n = ld3(P + P_NORMAL);
  const float im_b = __ldg(A.body_f + b * BODY_F + B_INV_MASS);
  const M3& ii_b = S.iiw[b];
  out.set3(C_NORMAL, n);
  out.set(C_FRICTION, __ldg(P + P_FRICTION));
  out.set(C_INV_MASS_B, im_b);
  const float restitution = __ldg(P + P_RESTITUTION);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const V3 r_b = sub(m.point[k], S.pos[b]);
    const V3 relv = add(S.v[b], cross(S.w[b], r_b));
    const float vrel_n = dot(relv, n);
    const V3 tangent = noz(sub(relv, scale(n, vrel_n)));
    const V3 n_to_wb = mv(ii_b, cross(r_b, n));
    const V3 t_to_wb = mv(ii_b, cross(r_b, tangent));
    const float kn = im_b + dot(cross(r_b, n), n_to_wb);
    const float kt = im_b + dot(cross(r_b, tangent), t_to_wb);
    const float depth = m.depth[k];
    const float bias = depth > CONTACT_SLOP && vrel_n < 0.0f
                           ? -restitution * vrel_n + BAUMGARTE_SCALE * (depth - CONTACT_SLOP) / A.dt
                           : 0.0f;
    out.set3(C_R_B + 3 * k, r_b);
    out.set3(C_TANGENT + 3 * k, tangent);
    out.set(C_BIAS + k, bias);
    out.set(C_EFF_MASS_N + k, kn != 0.0f ? 1.0f / kn : 0.0f);
    out.set(C_EFF_MASS_T + k, kt != 0.0f ? 1.0f / kt : 0.0f);
    out.set3(C_N_TO_WB + 3 * k, n_to_wb);
    out.set3(C_T_TO_WB + 3 * k, t_to_wb);
    out.set(C_PMASK + k, (m.hit[k] && valid) ? 1.0f : 0.0f);
  }
}

// ---- the locomotion env's post stage (learning/loco_env.py) ---------------
//
// The lanes of the team take the parts: a lane sums the errors of each of
// its parts over the part's sample points into `partial` (3 floats per part,
// then a done flag: the team's prep, free after the solve).  The first lane
// adds the parts up in part order and writes the obs, reward and done; then
// the lanes reset their bodies of a done scene to the standing pose.

template <int W>
__device__ void post_stage(const FusedArgs& A, const Team& team, Scene& S, int s, float* partial) {
  const int* Q = A.post_i;
  const int P = Q[Q_PARTS], K = Q[Q_POINTS], O = Q[Q_OBS_PARTS], NA = Q[Q_ACTIONS];
  const int* part_body = Q + Q_LISTS;
  const int* parent_body = part_body + P;
  const int* obs_body = parent_body + P;
  const int* action_col = obs_body + O;
  const float* F = A.post_f;
  const float head_h = F[0];
  const float* rel = F + 1;
  const float* target = rel + P * K * 3;
  const float* target_lrot = target + P * K * 3;
  const float* obs0 = target_lrot + P * 4;
  const int n_obs = 3 + 6 * O + NA;
  const float* s0 = obs0 + n_obs;
  const int N = A.num_bodies;

  if (team.active) {
    for (int p = team.lane; p < P; p += W) {
      const int b = part_body[p];
      float pos_err = 0.0f, vel_err = 0.0f;
      for (int k = 0; k < K; ++k) {
        const V3 pt = add(S.pos[b], qrot(S.rot[b], ld3(rel + (p * K + k) * 3)));
        pos_err += length(sub(pt, ld3(target + (p * K + k) * 3)));
        vel_err += length(add(S.v[b], cross(S.w[b], sub(pt, S.pos[b]))));
      }
      const int parent = parent_body[p];
      const Q4 qp = parent >= 0 ? S.rot[parent] : Q4{0.0f, 0.0f, 0.0f, 1.0f};
      const Q4 local = qmul(S.rot[b], qconj(qp));
      const Q4 diff = qmul(ld4(target_lrot + 4 * p), qconj(local));
      partial[3 * p] = pos_err;
      partial[3 * p + 1] = vel_err;
      partial[3 * p + 2] = 2.0f * acosf(clip(diff.w, -1.0f, 1.0f));
    }
  }
  team.sync();
  if (team.active && team.lane == 0) {
    float pos_err = 0.0f, vel_err = 0.0f, rot_err = 0.0f;
    for (int p = 0; p < P; ++p) {
      pos_err += partial[3 * p];
      vel_err += partial[3 * p + 1];
      rot_err += partial[3 * p + 2];
    }
    const int torso = Q[Q_TORSO_BODY];
    const float n = (float)P;
    const float rsum = expf(-10.0f / n * pos_err) + expf(-1.0f / n * vel_err) + expf(-10.0f / n * rot_err) +
                       expf(-length(S.v[torso]));
    const float head_y = S.pos[Q[Q_HEAD_BODY]].y;
    const float fall = clip(1.3f - 1.4f * (head_h - head_y), 0.0f, 1.0f);
    const bool done = head_y < 1.0f;

    float* out = A.extras + (size_t)s * A.n_extra;
    if (done) {
      for (int c = 0; c < n_obs; ++c) out[c] = __ldg(obs0 + c);
    } else {
      const V3 origin = {S.pos[torso].x, 0.0f, S.pos[torso].z};
      out[0] = S.v[torso].x;
      out[1] = S.v[torso].y;
      out[2] = S.v[torso].z;
      for (int o = 0; o < O; ++o) {
        const int b = obs_body[o];
        const V3 rp = sub(S.pos[b], origin);
        float* q = out + 3 + 6 * o;
        q[0] = rp.x;
        q[1] = rp.y;
        q[2] = rp.z;
        q[3] = S.v[b].x;
        q[4] = S.v[b].y;
        q[5] = S.v[b].z;
      }
      for (int a = 0; a < NA; ++a) out[3 + 6 * O + a] = __ldg(A.ovr + (size_t)s * A.ovr_cols + action_col[a]);
    }
    out[n_obs] = done ? 0.0f : fall * rsum;
    out[n_obs + 1] = done ? 1.0f : 0.0f;
    partial[3 * P] = done ? 1.0f : 0.0f;
  }
  team.sync();
  if (team.active && partial[3 * P] != 0.0f) {
    for (int i = team.lane; i < N; i += W) {
      S.pos[i] = ld3(s0 + 3 * i);
      S.rot[i] = ld4(s0 + 3 * N + 4 * i);
      S.v[i] = ld3(s0 + 7 * N + 3 * i);
      S.w[i] = ld3(s0 + 10 * N + 3 * i);
    }
  }
}

// ---- the kernel --------------------------------------------------------------

template <int W>
__global__ void __launch_bounds__(WARP) fused_substep_kernel(const FusedArgs A) {
  DYNAMIC_SHARED(smem);
  const Team team = make_team<W>(A.batch);
  const int s = team.scene;
  const int N = A.num_bodies;
  const float dt = A.dt;
  float* prep = smem + (size_t)team.index * fused_team_floats(N, A.planes, A.num_impulses, W);
  float* imp = prep + A.planes;
  Scene S;
  S.pos = reinterpret_cast<V3*>(imp + A.num_impulses);
  S.rot = reinterpret_cast<Q4*>(S.pos + N + 1);
  S.v = reinterpret_cast<V3*>(S.rot + N + 1);
  S.w = S.v + N + 1;
  S.iiw = reinterpret_cast<M3*>(S.w + N + 1);

  // 1. Load the state; forces, from the pre-step rotation.  One body per lane.
  if (team.active) {
    for (int i = team.lane; i < N; i += W) {
      const size_t o = (size_t)s * N + i;
      const float* bf = A.body_f + i * BODY_F;
      const Q4 q = {A.rot_in[4 * o], A.rot_in[4 * o + 1], A.rot_in[4 * o + 2], A.rot_in[4 * o + 3]};
      S.pos[i] = {A.pos_in[3 * o], A.pos_in[3 * o + 1], A.pos_in[3 * o + 2]};
      S.rot[i] = q;
      const M3 R = mat_from_quat(q);
      M3 I;
      for (int k = 0; k < 9; ++k) I.m[k] = __ldg(bf + B_INV_INERTIA + k);
      const M3 iiw = mat_mul(mat_mul(R, I, false), R, true);
      S.iiw[i] = iiw;
      const float im = __ldg(bf + B_INV_MASS);
      const V3 f = {A.force_in[3 * o] + A.gff_x, A.force_in[3 * o + 1] + A.gff_y, A.force_in[3 * o + 2] + A.gff_z};
      const V3 torque = {A.torque_in[3 * o], A.torque_in[3 * o + 1], A.torque_in[3 * o + 2]};
      const V3 gravity = {0.0f, GRAVITY * __ldg(bf + B_GRAVITY_FACTOR), 0.0f};
      const V3 lin_acc = im > 0.0f ? add(gravity, scale(f, im)) : V3{0.0f, 0.0f, 0.0f};
      const V3 ang_acc = mv(iiw, torque);
      const V3 v = add(V3{A.vel_in[3 * o], A.vel_in[3 * o + 1], A.vel_in[3 * o + 2]}, scale(lin_acc, dt));
      const V3 w = add(V3{A.omega_in[3 * o], A.omega_in[3 * o + 1], A.omega_in[3 * o + 2]}, scale(ang_acc, dt));
      const float ld = 1.0f + dt * __ldg(bf + B_LINEAR_DAMPING);
      const float ad = 1.0f + dt * __ldg(bf + B_ANGULAR_DAMPING);
      S.v[i] = {v.x / ld, v.y / ld, v.z / ld};
      S.w[i] = {w.x / ad, w.y / ad, w.z / ad};
    }
    if (team.lane == 0) {
      S.pos[N] = {0.0f, 0.0f, 0.0f};
      S.rot[N] = {0.0f, 0.0f, 0.0f, 1.0f};
      S.v[N] = S.w[N] = S.pos[N];
      S.iiw[N] = M3{{0, 0, 0, 0, 0, 0, 0, 0, 0}};
    }
    for (int i = team.lane; i < A.num_impulses; i += W) imp[i] = 0.0f;
  }
  team.sync();

  // 2-3. Contact and joint preps into the team's prep, one row per lane.
  if (team.active) {
    for (int t = 0; t < A.num_tables; ++t) {
      const int* T = A.tables + t * TABLE_INTS;
      const int kind = T[T_KIND];
      const int rows = T[T_ROWS];
      for (int r = team.lane; r < rows; r += W) {
        const int row = T[T_ROW_BASE] + r;
        const float* K = A.row_f + row * ROW_F;
        const int* I = A.row_i + row * ROW_I;
        const PrepOut out = {prep + T[T_PLANE_BASE] + r * T[T_ROW_STRIDE]};
        if (kind == KIND_CONTACT) {
          prep_contact(A, S, K, A.body_b[row], I[R_SHAPE], I[R_ACTIVE] != 0, out);
          continue;
        }
        const JointCommon c = joint_common(S, A.body_f, K, A.body_a[row], A.body_b[row], I[R_ACTIVE] != 0);
        switch (kind) {
          case KIND_HINGE: prep_hinge(A, S, c, K, I, s, out); break;
          case KIND_CONE_TWIST: prep_cone_twist(A, S, c, K, I, s, out); break;
          case KIND_DISTANCE: prep_distance(A, S, c, K, out); break;
          case KIND_BALL: prep_ball_part(S, c, A.ball_bias, out); break;
          default: prep_fixed(A, S, c, K, out); break;
        }
      }
    }
  }
  team.sync();

  // 4. The solve.
  solve_scene<W, false>(team, S.v, S.w, imp, prep, A.tables, A.num_tables, A.colors, A.body_a, A.body_b,
                        A.dynamic, A.iterations);

  // 5. Semi-implicit Euler: pos += v dt, rot = normalize(rot + dt (w/2, 0) rot).
  if (team.active) {
    for (int i = team.lane; i < N; i += W) {
      S.pos[i] = add(S.pos[i], scale(S.v[i], dt));
      const Q4 q = S.rot[i];
      const Q4 dq = qmul(Q4{0.5f * S.w[i].x, 0.5f * S.w[i].y, 0.5f * S.w[i].z, 0.0f}, q);
      S.rot[i] = qnormalize(Q4{q.x + dq.x * dt, q.y + dq.y * dt, q.z + dq.z * dt, q.w + dq.w * dt});
    }
  }
  team.sync();

  // 6. The env's post stage.
  if (A.extras != nullptr) post_stage<W>(A, team, S, s, prep);
  team.sync();

  if (team.active) {
    for (int i = team.lane; i < N; i += W) {
      const size_t o = (size_t)s * N + i;
      A.pos_out[3 * o] = S.pos[i].x;
      A.pos_out[3 * o + 1] = S.pos[i].y;
      A.pos_out[3 * o + 2] = S.pos[i].z;
      A.rot_out[4 * o] = S.rot[i].x;
      A.rot_out[4 * o + 1] = S.rot[i].y;
      A.rot_out[4 * o + 2] = S.rot[i].z;
      A.rot_out[4 * o + 3] = S.rot[i].w;
      A.vel_out[3 * o] = S.v[i].x;
      A.vel_out[3 * o + 1] = S.v[i].y;
      A.vel_out[3 * o + 2] = S.v[i].z;
      A.omega_out[3 * o] = S.w[i].x;
      A.omega_out[3 * o + 1] = S.w[i].y;
      A.omega_out[3 * o + 2] = S.w[i].z;
      for (int c = 0; c < 3; ++c) A.force_out[3 * o + c] = A.torque_out[3 * o + c] = 0.0f;
    }
  }
}

template <int W>
int launch(const FusedArgs& a, cudaStream_t stream) {
  const int bytes = (WARP / W) * fused_team_floats(a.num_bodies, a.planes, a.num_impulses, W) * 4;
  const void* kernel = (const void*)fused_substep_kernel<W>;
  cudaError_t err = cudaSuccess;
  if (bytes > DEFAULT_SHARED_BYTES) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  void* params[] = {(void*)&a};
  const dim3 blocks((a.batch + WARP / W - 1) / (WARP / W)), threads(WARP);
  err = cudaLaunchKernel(kernel, blocks, threads, params, bytes, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_substep_args_size() { return (int)sizeof(FusedArgs); }

// Blocks of the team width `team` resident on one SM at `bytes` of dynamic
// shared memory per block, or a negative CUDA error.
extern "C" int fused_substep_blocks_per_sm(int team, int bytes) {
  const void* kernel = team == 8    ? (const void*)fused_substep_kernel<8>
                       : team == 16 ? (const void*)fused_substep_kernel<16>
                                    : (const void*)fused_substep_kernel<32>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, WARP, bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Launches on `stream`; returns cudaGetLastError() after the launch (0 = ok),
// or -1 for a team width other than 8, 16 or 32.
extern "C" int fused_substep_launch(const FusedArgs* args, int team, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (team) {
    case 8: return launch<8>(*args, st);
    case 16: return launch<16>(*args, st);
    case 32: return launch<32>(*args, st);
    default: return -1;
  }
}
