// Row solves of the sequential-impulse solver and the team solve of one
// scene, shared by the colored solver (colored_solver.cu) and the fused
// whole-substep kernel (fused_substep.cu).
//
// A team of W lanes of one warp solves one scene (W = 8, 16 or 32; host
// builds of the kernel sources use W = 1).  The scene's body velocities, the
// prep of its rows and its accumulated impulses live in the team's slice of
// the block's dynamic shared memory.  Within the scene, a table's prep is
// laid out [row][field] with an odd row stride (the table's field count,
// made odd): a row's fields sit at constant offsets from its start, so they
// load with no address arithmetic, and the lanes of a team, which take
// neighbouring rows of one color, fall on different banks.  A table's
// impulses are [impulse][row]: lanes read neighbouring words.  The field
// offsets below are the packed layout of physics/solver_cuda.py (a CPU test
// holds the two together).

#pragma once

#include "rn_math.cuh"

namespace {

// Table kinds and the per-table record of `tables`.
constexpr int KIND_HINGE = 0;
constexpr int KIND_CONE_TWIST = 1;
constexpr int KIND_CONTACT = 2;
constexpr int KIND_DISTANCE = 3;
constexpr int KIND_BALL = 4;
constexpr int KIND_FIXED = 5;
constexpr int KIND_SLIDER = 6;
constexpr int T_KIND = 0;
constexpr int T_ROWS = 1;
constexpr int T_ROW_BASE = 2;
constexpr int T_COLOR_BASE = 3;
constexpr int T_NUM_COLORS = 4;
constexpr int T_PLANE_BASE = 5;
constexpr int T_IMP_BASE = 6;
constexpr int T_A_STATIC = 7;
constexpr int T_B_STATIC = 8;
constexpr int T_ROW_STRIDE = 9;
constexpr int TABLE_INTS = 10;

// ---- packed prep layout (scalar plane offsets within one row) -------------
// Ball part: the whole ball row, and the first fields of fixed, hinge and
// cone-twist rows.
constexpr int J_RA = 0;
constexpr int J_RB = 3;
constexpr int J_BIAS = 6;
constexpr int J_INV_K = 9;
constexpr int J_IM_A = 18;
constexpr int J_IM_B = 19;
constexpr int J_II_A = 20;
constexpr int J_II_B = 29;
constexpr int J_NUM_FIELDS = 38;
// Hinge.
constexpr int H_AXIS = 38;
constexpr int H_MOTOR_VEL = 41;
constexpr int H_EFF_MOTOR = 42;
constexpr int H_MAX_IMP = 43;
constexpr int H_TO_WA_AX = 44;
constexpr int H_TO_WB_AX = 47;
constexpr int H_LIMIT_SIGN = 50;
constexpr int H_LIMIT_BIAS = 51;
constexpr int H_EFF_LIMIT = 52;
constexpr int H_BXA = 53;
constexpr int H_CXA = 56;
constexpr int H_R_BIAS = 59;
constexpr int H_I2 = 61;
constexpr int H_NUM_FIELDS = 65;
// Cone-twist.
constexpr int CT_TWIST_AXIS = 38;
constexpr int CT_EFF_TWIST_MOTOR = 41;
constexpr int CT_TWIST_MOTOR_VEL = 42;
constexpr int CT_MAX_TWIST_IMP = 43;
constexpr int CT_TW_TO_WA = 44;
constexpr int CT_TW_TO_WB = 47;
constexpr int CT_SWING_MOTOR_AXIS = 50;
constexpr int CT_EFF_SWING_MOTOR = 53;
constexpr int CT_SWING_MOTOR_VEL = 54;
constexpr int CT_MAX_SWING_IMP = 55;
constexpr int CT_SWM_TO_WA = 56;
constexpr int CT_SWM_TO_WB = 59;
constexpr int CT_TWIST_SIGN = 62;
constexpr int CT_EFF_TWIST_LIMIT = 63;
constexpr int CT_TWIST_BIAS = 64;
constexpr int CT_SWING_AXIS = 65;
constexpr int CT_EFF_SWING = 68;
constexpr int CT_SWING_BIAS = 69;
constexpr int CT_SW_TO_WA = 70;
constexpr int CT_SW_TO_WB = 73;
constexpr int CT_NUM_FIELDS = 76;
// Distance.
constexpr int D_RA = 0;
constexpr int D_RB = 3;
constexpr int D_U = 6;
constexpr int D_BIAS = 9;
constexpr int D_EFF = 10;
constexpr int D_IM_A = 11;
constexpr int D_IM_B = 12;
constexpr int D_TO_WA = 13;
constexpr int D_TO_WB = 16;
constexpr int D_NUM_FIELDS = 19;
// Fixed: the ball part, then the rotation part.
constexpr int F_INV_K_ROT = 38;
constexpr int F_R_BIAS = 47;
constexpr int F_NUM_FIELDS = 50;
// Slider.
constexpr int S_AXIS = 0;
constexpr int S_MOTOR_VEL = 3;
constexpr int S_EFF_MOTOR = 4;
constexpr int S_MAX_IMP = 5;
constexpr int S_IM_A = 6;
constexpr int S_IM_B = 7;
constexpr int S_LIMIT_SIGN = 8;
constexpr int S_EFF_LIMIT = 9;
constexpr int S_LIMIT_BIAS = 10;
constexpr int S_RBXS = 11;
constexpr int S_RAUXS = 14;
constexpr int S_LIM_TO_WA = 17;
constexpr int S_LIM_TO_WB = 20;
constexpr int S_INV_K_ROT = 23;
constexpr int S_R_BIAS = 32;
constexpr int S_II_A = 35;
constexpr int S_II_B = 44;
constexpr int S_T = 53;
constexpr int S_B = 56;
constexpr int S_RBXT = 59;
constexpr int S_RBXB = 62;
constexpr int S_RAUXT = 65;
constexpr int S_RAUXB = 68;
constexpr int S_T_BIAS = 71;
constexpr int S_I2 = 73;
constexpr int S_NUM_FIELDS = 77;
// Contact: 4 manifold points; per-point vectors are [point][xyz].
constexpr int C_NORMAL = 0;
constexpr int C_FRICTION = 3;
constexpr int C_INV_MASS_B = 4;
constexpr int C_R_B = 5;
constexpr int C_TANGENT = 17;
constexpr int C_BIAS = 29;
constexpr int C_EFF_MASS_N = 33;
constexpr int C_EFF_MASS_T = 37;
constexpr int C_N_TO_WB = 41;
constexpr int C_T_TO_WB = 53;
constexpr int C_PMASK = 65;
constexpr int C_B_FIELDS = 69;
// Present only when the table's A side is not static.
constexpr int C_INV_MASS_A = 69;
constexpr int C_R_A = 70;
constexpr int C_N_TO_WA = 82;
constexpr int C_T_TO_WA = 94;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float clip(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

// One row's prep in shared memory: field f of this row is p[f].
struct Row {
  const float* __restrict__ p;
  __device__ __forceinline__ float operator()(int f) const { return p[f]; }
  __device__ __forceinline__ V3 vec(int f) const { return {(*this)(f), (*this)(f + 1), (*this)(f + 2)}; }
  // Row-major 3x3 matrix at plane f, times x.
  __device__ __forceinline__ V3 mv(int f, V3 x) const {
    return {(*this)(f + 0) * x.x + (*this)(f + 1) * x.y + (*this)(f + 2) * x.z,
            (*this)(f + 3) * x.x + (*this)(f + 4) * x.y + (*this)(f + 5) * x.z,
            (*this)(f + 6) * x.x + (*this)(f + 7) * x.y + (*this)(f + 8) * x.z};
  }
};

// Point-to-point part shared by ball, fixed, hinge and cone-twist rows.
__device__ __forceinline__ void solve_ball_part(const Row& R, V3& va, V3& wa, V3& vb, V3& wb) {
  const V3 ra = R.vec(J_RA), rb = R.vec(J_RB);
  const V3 av_a = add(va, cross(wa, ra));
  const V3 av_b = add(vb, cross(wb, rb));
  const V3 cdot = add(sub(av_b, av_a), R.vec(J_BIAS));
  const V3 P = neg(R.mv(J_INV_K, cdot));
  va = sub(va, scale(P, R(J_IM_A)));
  wa = sub(wa, R.mv(J_II_A, cross(ra, P)));
  vb = add(vb, scale(P, R(J_IM_B)));
  wb = add(wb, R.mv(J_II_B, cross(rb, P)));
}

// Distance: one impulse along the anchor-to-anchor direction.
__device__ __forceinline__ void solve_distance(const Row& R, V3& va, V3& wa, V3& vb, V3& wb) {
  const V3 ra = R.vec(D_RA), rb = R.vec(D_RB), u = R.vec(D_U);
  const V3 av_a = add(va, cross(wa, ra));
  const V3 av_b = add(vb, cross(wb, rb));
  const float cdot = dot(u, sub(av_b, av_a)) + R(D_BIAS);
  const float lam = -R(D_EFF) * cdot;
  const V3 P = scale(u, lam);
  va = sub(va, scale(P, R(D_IM_A)));
  wa = sub(wa, scale(R.vec(D_TO_WA), lam));
  vb = add(vb, scale(P, R(D_IM_B)));
  wb = add(wb, scale(R.vec(D_TO_WB), lam));
}

// Fixed: rotation part, then the point-to-point part.
__device__ __forceinline__ void solve_fixed(const Row& R, V3& va, V3& wa, V3& vb, V3& wb) {
  const V3 lam = neg(R.mv(F_INV_K_ROT, add(sub(wb, wa), R.vec(F_R_BIAS))));
  wa = sub(wa, R.mv(J_II_A, lam));
  wb = add(wb, R.mv(J_II_B, lam));
  solve_ball_part(R, va, wa, vb, wb);
}

// Hinge: motor -> limit -> rotation -> position.  imp: [motor, limit].
__device__ __forceinline__ void solve_hinge(const Row& R, V3& va, V3& wa, V3& vb, V3& wb, float* imp) {
  const V3 axis = R.vec(H_AXIS);
  const V3 to_wa = R.vec(H_TO_WA_AX), to_wb = R.vec(H_TO_WB_AX);

  float relw = dot(axis, wb) - dot(axis, wa);
  float lam = -R(H_EFF_MOTOR) * (relw - R(H_MOTOR_VEL));
  const float max_imp = R(H_MAX_IMP);
  float nw = clip(imp[0] + lam, -max_imp, max_imp);
  lam = nw - imp[0];
  imp[0] = nw;
  wa = sub(wa, scale(to_wa, lam));
  wb = add(wb, scale(to_wb, lam));

  const float sgn = R(H_LIMIT_SIGN);
  relw = sgn * (dot(axis, wb) - dot(axis, wa));
  lam = -R(H_EFF_LIMIT) * (relw + R(H_LIMIT_BIAS));
  nw = fmaxf(imp[1] + lam, 0.0f);
  lam = (nw - imp[1]) * sgn;
  imp[1] = nw;
  wa = sub(wa, scale(to_wa, lam));
  wb = add(wb, scale(to_wb, lam));

  const V3 dw = sub(wb, wa);
  const V3 bxa = R.vec(H_BXA), cxa = R.vec(H_CXA);
  const float c0 = dot(bxa, dw) + R(H_R_BIAS);
  const float c1 = dot(cxa, dw) + R(H_R_BIAS + 1);
  const float l0 = -(R(H_I2) * c0 + R(H_I2 + 1) * c1);
  const float l1 = -(R(H_I2 + 2) * c0 + R(H_I2 + 3) * c1);
  const V3 P = add(scale(bxa, l0), scale(cxa, l1));
  wa = sub(wa, R.mv(J_II_A, P));
  wb = add(wb, R.mv(J_II_B, P));

  solve_ball_part(R, va, wa, vb, wb);
}

// Cone-twist: twist motor -> swing motor -> twist limit -> swing limit ->
// position.  imp: [twist motor, swing motor, twist limit, swing limit].
__device__ __forceinline__ void solve_cone_twist(const Row& R, V3& va, V3& wa, V3& vb, V3& wb, float* imp) {
  const V3 ax = R.vec(CT_TWIST_AXIS);
  const V3 tw_to_wa = R.vec(CT_TW_TO_WA), tw_to_wb = R.vec(CT_TW_TO_WB);

  float relw = dot(ax, wb) - dot(ax, wa);
  float lam = -R(CT_EFF_TWIST_MOTOR) * (relw - R(CT_TWIST_MOTOR_VEL));
  float mx = R(CT_MAX_TWIST_IMP);
  float nw = clip(imp[0] + lam, -mx, mx);
  lam = nw - imp[0];
  imp[0] = nw;
  wa = sub(wa, scale(tw_to_wa, lam));
  wb = add(wb, scale(tw_to_wb, lam));

  const V3 axm = R.vec(CT_SWING_MOTOR_AXIS);
  relw = dot(axm, wb) - dot(axm, wa);
  lam = -R(CT_EFF_SWING_MOTOR) * (relw - R(CT_SWING_MOTOR_VEL));
  mx = R(CT_MAX_SWING_IMP);
  nw = clip(imp[1] + lam, -mx, mx);
  lam = nw - imp[1];
  imp[1] = nw;
  wa = sub(wa, scale(R.vec(CT_SWM_TO_WA), lam));
  wb = add(wb, scale(R.vec(CT_SWM_TO_WB), lam));

  const float sgn = R(CT_TWIST_SIGN);
  relw = sgn * (dot(ax, wb) - dot(ax, wa));
  lam = -R(CT_EFF_TWIST_LIMIT) * (relw + R(CT_TWIST_BIAS));
  nw = fmaxf(imp[2] + lam, 0.0f);
  lam = (nw - imp[2]) * sgn;
  imp[2] = nw;
  wa = sub(wa, scale(tw_to_wa, lam));
  wb = add(wb, scale(tw_to_wb, lam));

  // Swing limit: inverted application sign (Cdot = a.wA - a.wB).
  const V3 axs = R.vec(CT_SWING_AXIS);
  const float cdot = dot(axs, wa) - dot(axs, wb) + R(CT_SWING_BIAS);
  lam = -R(CT_EFF_SWING) * cdot;
  nw = fmaxf(imp[3] + lam, 0.0f);
  lam = nw - imp[3];
  imp[3] = nw;
  wa = add(wa, scale(R.vec(CT_SW_TO_WA), lam));
  wb = sub(wb, scale(R.vec(CT_SW_TO_WB), lam));

  solve_ball_part(R, va, wa, vb, wb);
}

// Slider: motor -> limit -> rotation (three locked angular dof) -> position
// (the two dof across the axis).  imp: [motor, limit].
__device__ __forceinline__ void solve_slider(const Row& R, V3& va, V3& wa, V3& vb, V3& wb, float* imp) {
  const V3 ax = R.vec(S_AXIS);
  const float im_a = R(S_IM_A), im_b = R(S_IM_B);

  // Motor: linear, no angular arms.
  float cdot = dot(vb, ax) - dot(va, ax) - R(S_MOTOR_VEL);
  float lam = -R(S_EFF_MOTOR) * cdot;
  const float max_imp = R(S_MAX_IMP);
  float nw = clip(imp[0] + lam, -max_imp, max_imp);
  lam = nw - imp[0];
  imp[0] = nw;
  V3 P = scale(ax, lam);
  va = sub(va, scale(P, im_a));
  vb = add(vb, scale(P, im_b));

  const float sgn = R(S_LIMIT_SIGN);
  cdot = dot(vb, ax) + dot(wb, R.vec(S_RBXS)) - dot(va, ax) - dot(wa, R.vec(S_RAUXS));
  lam = -R(S_EFF_LIMIT) * (sgn * cdot + R(S_LIMIT_BIAS));
  nw = fmaxf(imp[1] + lam, 0.0f);
  lam = (nw - imp[1]) * sgn;
  imp[1] = nw;
  P = scale(ax, lam);
  va = sub(va, scale(P, im_a));
  wa = sub(wa, scale(R.vec(S_LIM_TO_WA), lam));
  vb = add(vb, scale(P, im_b));
  wb = add(wb, scale(R.vec(S_LIM_TO_WB), lam));

  const V3 lam3 = neg(R.mv(S_INV_K_ROT, add(sub(wb, wa), R.vec(S_R_BIAS))));
  wa = sub(wa, R.mv(S_II_A, lam3));
  wb = add(wb, R.mv(S_II_B, lam3));

  const V3 t = R.vec(S_T), b = R.vec(S_B);
  const V3 rbxt = R.vec(S_RBXT), rbxb = R.vec(S_RBXB);
  const V3 rauxt = R.vec(S_RAUXT), rauxb = R.vec(S_RAUXB);
  const float c0 = dot(t, vb) + dot(rbxt, wb) - dot(t, va) - dot(rauxt, wa) + R(S_T_BIAS);
  const float c1 = dot(b, vb) + dot(rbxb, wb) - dot(b, va) - dot(rauxb, wa) + R(S_T_BIAS + 1);
  const float l0 = -(R(S_I2) * c0 + R(S_I2 + 1) * c1);
  const float l1 = -(R(S_I2 + 2) * c0 + R(S_I2 + 3) * c1);
  P = add(scale(t, l0), scale(b, l1));
  va = sub(va, scale(P, im_a));
  wa = sub(wa, R.mv(S_II_A, add(scale(rauxt, l0), scale(rauxb, l1))));
  vb = add(vb, scale(P, im_b));
  wb = add(wb, R.mv(S_II_B, add(scale(rbxt, l0), scale(rbxb, l1))));
}

// Contact row: 4 manifold points in order, friction then normal each.
// imp: [normal x4, tangent x4].  A side that is static for the whole table
// keeps zero velocity and takes no update, as in the reference kernel.  In a
// table whose A side is dynamic somewhere (collider-pair rows), a plane row
// names the world slot as A: its inverse mass and inertia arms are zero, so
// its velocity stays zero, and the caller never writes that slot back.
__device__ __forceinline__ void solve_contact(const Row& R, V3& va, V3& wa, V3& vb, V3& wb, float* imp,
                              bool a_static, bool b_static) {
  const V3 zero = {0.0f, 0.0f, 0.0f};
  const V3 n = R.vec(C_NORMAL);
  const float friction = R(C_FRICTION);
  const float im_b = R(C_INV_MASS_B);
  const float im_a = a_static ? 0.0f : R(C_INV_MASS_A);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // A masked point leaves velocities and impulses unchanged.
    if (!(R(C_PMASK + k) > 0.5f)) continue;
    const V3 rb = R.vec(C_R_B + 3 * k);
    const V3 ra = a_static ? zero : R.vec(C_R_A + 3 * k);
    const V3 t = R.vec(C_TANGENT + 3 * k);

    V3 relv = sub(add(vb, cross(wb, rb)), a_static ? va : add(va, cross(wa, ra)));
    const float vt = dot(relv, t);
    float lam = -R(C_EFF_MASS_T + k) * vt;
    const float max_f = friction * imp[k];
    float nw = clip(imp[4 + k] + lam, -max_f, max_f);
    lam = nw - imp[4 + k];
    imp[4 + k] = nw;
    V3 P = scale(t, lam);
    if (!a_static) {
      va = sub(va, scale(P, im_a));
      wa = sub(wa, scale(R.vec(C_T_TO_WA + 3 * k), lam));
    }
    if (!b_static) {
      vb = add(vb, scale(P, im_b));
      wb = add(wb, scale(R.vec(C_T_TO_WB + 3 * k), lam));
    }

    relv = sub(add(vb, cross(wb, rb)), a_static ? va : add(va, cross(wa, ra)));
    const float vn = dot(relv, n);
    lam = -R(C_EFF_MASS_N + k) * (vn - R(C_BIAS + k));
    nw = fmaxf(imp[k] + lam, 0.0f);
    lam = nw - imp[k];
    imp[k] = nw;
    P = scale(n, lam);
    if (!a_static) {
      va = sub(va, scale(P, im_a));
      wa = sub(wa, scale(R.vec(C_N_TO_WA + 3 * k), lam));
    }
    if (!b_static) {
      vb = add(vb, scale(P, im_b));
      wb = add(wb, scale(R.vec(C_N_TO_WB + 3 * k), lam));
    }
  }
}

// ---- the team solve ---------------------------------------------------------

constexpr int WARP = 32;
// Dynamic shared memory a block gets without opting in to more.
constexpr int DEFAULT_SHARED_BYTES = 48 * 1024;

// One team: W lanes of a warp that solve one scene.  A team past the end of
// the batch is not active: it skips the work but keeps to every barrier.
// The barrier is the whole warp's: every team of a warp walks the same
// archetype, so all of them reach each barrier, and meeting there keeps the
// teams of a warp converged (a barrier of one team's lanes lets the teams of
// a warp drift apart and run one after another).
struct Team {
  int lane;   // 0 .. W-1
  int index;  // the team's slot in the block's shared memory
  int scene;
  bool active;
  __device__ __forceinline__ void sync() const { __syncwarp(); }
};

template <int W>
__device__ __forceinline__ Team make_team(int batch) {
  Team t;
  t.lane = threadIdx.x % W;
  t.index = threadIdx.x / W;
  t.scene = blockIdx.x * (blockDim.x / W) + t.index;
  t.active = t.scene < batch;
  return t;
}

// Floats of one team's slice of shared memory for a scene that needs `need`:
// rounded up to 32 words, then W more (W < 32), so that the teams of a warp
// start on different banks.
__host__ __device__ inline int team_floats(int need, int W) { return (need + 31) / 32 * 32 + W % WARP; }

// The lanes of a team take the rows [begin, end) of one color in turn: lane
// l takes rows begin + l, begin + l + W, ...  Whole rows go to lanes.
template <int W, class F>
__device__ __forceinline__ void team_rows(int lane, int begin, int end, F&& f) {
  for (int r = begin + lane; r < end; r += W) f(r);
}

// The colors of one table of kind K, one after another; the rows of a color
// at the same time, whole rows to lanes.  A row's impulses sit in registers
// during its solve: with no store to shared memory before the row's end, its
// prep loads can all be issued up front.
template <int W, int K>
__device__ __forceinline__ void solve_table(const Team& team, V3* v, V3* w, float* imp, const float* prep,
                                            const int* T, const int* __restrict__ colors,
                                            const int* __restrict__ body_a, const int* __restrict__ body_b,
                                            const int* __restrict__ dynamic) {
  constexpr int IMPS = (K == KIND_HINGE || K == KIND_SLIDER) ? 2
                       : (K == KIND_CONE_TWIST ? 4 : (K == KIND_CONTACT ? 8 : 0));
  const int rows = __ldg(T + T_ROWS);
  const int row_base = __ldg(T + T_ROW_BASE);
  const int row_stride = __ldg(T + T_ROW_STRIDE);
  const bool a_static = __ldg(T + T_A_STATIC) != 0;
  const bool b_static = __ldg(T + T_B_STATIC) != 0;
  const int num_colors = __ldg(T + T_NUM_COLORS);
  const int* bounds = colors + 2 * __ldg(T + T_COLOR_BASE);
  prep += __ldg(T + T_PLANE_BASE);
  imp += __ldg(T + T_IMP_BASE);  // impulse k of row r: imp[k * rows + r]
  for (int c = 0; c < num_colors; ++c) {
    if (team.active)
      team_rows<W>(team.lane, __ldg(bounds + 2 * c), __ldg(bounds + 2 * c + 1), [&](int r) {
        const int ia = __ldg(body_a + row_base + r);
        const int ib = __ldg(body_b + row_base + r);
        const Row R = {prep + r * row_stride};
        float acc[IMPS > 0 ? IMPS : 1];
#pragma unroll
        for (int k = 0; k < IMPS; ++k) acc[k] = imp[k * rows + r];
        V3 va = v[ia], wa = w[ia], vb = v[ib], wb = w[ib];
        switch (K) {
          case KIND_HINGE: solve_hinge(R, va, wa, vb, wb, acc); break;
          case KIND_CONE_TWIST: solve_cone_twist(R, va, wa, vb, wb, acc); break;
          case KIND_CONTACT: solve_contact(R, va, wa, vb, wb, acc, a_static, b_static); break;
          case KIND_DISTANCE: solve_distance(R, va, wa, vb, wb); break;
          case KIND_BALL: solve_ball_part(R, va, wa, vb, wb); break;
          case KIND_SLIDER: solve_slider(R, va, wa, vb, wb, acc); break;
          default: solve_fixed(R, va, wa, vb, wb); break;
        }
#pragma unroll
        for (int k = 0; k < IMPS; ++k) imp[k * rows + r] = acc[k];
        if (!a_static && __ldg(dynamic + ia)) {
          v[ia] = va;
          w[ia] = wa;
        }
        if (!b_static && __ldg(dynamic + ib)) {
          v[ib] = vb;
          w[ib] = wb;
        }
      });
    team.sync();
  }
}

// The `iterations`-long solve of one scene by its team: every table in order
// (joint tables in JOINT_SOLVE_ORDER, then contacts), color by color.  The
// rows of one color touch disjoint dynamic bodies (a CPU test checks every
// archetype's colors), so the team's lanes solve them at the same time and
// the result is the reference's per-color parallel update.  Only dynamic
// bodies are written back; the world slot is never written.  v, w, imp and
// prep are the team's shared memory; `imp` must hold zeros on entry.  A
// lane's writes reach the other lanes at the barrier after each color.
// `Sliders` false compiles no slider row solve, for a kernel whose
// archetypes never have sliders (the fused kernel refuses them): the unused
// code would only add register pressure (it spilled there).
template <int W, bool Sliders = true>
__device__ void solve_scene(const Team& team, V3* v, V3* w, float* imp, const float* prep,
                            const int* __restrict__ tables, int num_tables,
                            const int* __restrict__ colors, const int* __restrict__ body_a,
                            const int* __restrict__ body_b, const int* __restrict__ dynamic,
                            int iterations) {
  for (int it = 0; it < iterations; ++it) {
    for (int t = 0; t < num_tables; ++t) {
      const int* T = tables + t * TABLE_INTS;
      switch (__ldg(T + T_KIND)) {
        case KIND_HINGE:
          solve_table<W, KIND_HINGE>(team, v, w, imp, prep, T, colors, body_a, body_b, dynamic);
          break;
        case KIND_CONE_TWIST:
          solve_table<W, KIND_CONE_TWIST>(team, v, w, imp, prep, T, colors, body_a, body_b, dynamic);
          break;
        case KIND_CONTACT:
          solve_table<W, KIND_CONTACT>(team, v, w, imp, prep, T, colors, body_a, body_b, dynamic);
          break;
        case KIND_DISTANCE:
          solve_table<W, KIND_DISTANCE>(team, v, w, imp, prep, T, colors, body_a, body_b, dynamic);
          break;
        case KIND_BALL:
          solve_table<W, KIND_BALL>(team, v, w, imp, prep, T, colors, body_a, body_b, dynamic);
          break;
        case KIND_SLIDER:
          if constexpr (Sliders)
            solve_table<W, KIND_SLIDER>(team, v, w, imp, prep, T, colors, body_a, body_b, dynamic);
          break;
        default:
          solve_table<W, KIND_FIXED>(team, v, w, imp, prep, T, colors, body_a, body_b, dynamic);
          break;
      }
    }
  }
}

}  // namespace
