// Row solves of the sequential-impulse solver, shared by the colored solver
// (colored_solver.cu) and the fused whole-substep kernel (fused_substep.cu).
//
// A row's prep is read from a float buffer laid out [plane][row][scene],
// scene innermost: plane f of one row and scene is p[f * stride].  The field
// offsets below are the packed layout of physics/solver_cuda.py (a CPU test
// holds the two together).  Accumulated impulses are reached through an
// accessor, so that a kernel may keep them in local memory (a pointer) or in
// a [impulse][scene] global buffer (`StridedImp`).

#pragma once

namespace {

// Table kinds and the per-table record of `tables`.
constexpr int KIND_HINGE = 0;
constexpr int KIND_CONE_TWIST = 1;
constexpr int KIND_CONTACT = 2;
constexpr int KIND_DISTANCE = 3;
constexpr int KIND_BALL = 4;
constexpr int KIND_FIXED = 5;
constexpr int T_KIND = 0;
constexpr int T_ROWS = 1;
constexpr int T_ROW_BASE = 2;
constexpr int T_COLOR_BASE = 3;
constexpr int T_NUM_COLORS = 4;
constexpr int T_PLANE_BASE = 5;
constexpr int T_IMP_BASE = 6;
constexpr int T_A_STATIC = 7;
constexpr int T_B_STATIC = 8;
constexpr int TABLE_INTS = 9;

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

// Accumulated impulses of one row, by kind.
__device__ __forceinline__ int kind_impulses(int kind) {
  return kind == KIND_HINGE ? 2 : (kind == KIND_CONE_TWIST ? 4 : (kind == KIND_CONTACT ? 8 : 0));
}

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

// One row's prep: plane f of this row and scene is p[f * stride].  A plain
// load, not __ldg: the fused kernel writes this buffer in the same launch.
struct Row {
  const float* __restrict__ p;
  size_t stride;
  __device__ __forceinline__ float operator()(int f) const { return p[f * stride]; }
  __device__ __forceinline__ V3 vec(int f) const { return {(*this)(f), (*this)(f + 1), (*this)(f + 2)}; }
  // Row-major 3x3 matrix at plane f, times x.
  __device__ __forceinline__ V3 mv(int f, V3 x) const {
    return {(*this)(f + 0) * x.x + (*this)(f + 1) * x.y + (*this)(f + 2) * x.z,
            (*this)(f + 3) * x.x + (*this)(f + 4) * x.y + (*this)(f + 5) * x.z,
            (*this)(f + 6) * x.x + (*this)(f + 7) * x.y + (*this)(f + 8) * x.z};
  }
};

// Impulses in a [impulse][scene] buffer: impulse i of this scene is p[i * stride].
struct StridedImp {
  float* p;
  size_t stride;
  __device__ __forceinline__ float& operator[](int i) const { return p[i * stride]; }
  __device__ __forceinline__ StridedImp operator+(int i) const { return {p + i * stride, stride}; }
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
template <class Imp>
__device__ void solve_hinge(const Row& R, V3& va, V3& wa, V3& vb, V3& wb, Imp imp) {
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
template <class Imp>
__device__ void solve_cone_twist(const Row& R, V3& va, V3& wa, V3& vb, V3& wb, Imp imp) {
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

// Contact row: 4 manifold points in order, friction then normal each.
// imp: [normal x4, tangent x4].  A static side keeps zero velocity and takes
// no update, as in the reference kernel.
template <class Imp>
__device__ void solve_contact(const Row& R, V3& va, V3& wa, V3& vb, V3& wb, Imp imp,
                              bool a_static, bool b_static) {
  const V3 zero = {0.0f, 0.0f, 0.0f};
  const V3 n = R.vec(C_NORMAL);
  const float friction = R(C_FRICTION);
  const float im_b = R(C_INV_MASS_B);
  const float im_a = a_static ? 0.0f : R(C_INV_MASS_A);
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

// The `iterations`-long solve of scene s: every table in order (joint tables
// in JOINT_SOLVE_ORDER, then contacts), color by color, row by row within a
// color.  Rows of one color touch disjoint dynamic bodies, so solving them
// one after another equals the reference's per-color parallel update.  Only
// dynamic bodies are written back.  `imp` must hold zeros on entry.
template <class Imp>
__device__ void solve_scene(V3* v, V3* w, Imp imp, const float* __restrict__ prep,
                            const int* __restrict__ tables, int num_tables,
                            const int* __restrict__ colors, const int* __restrict__ body_a,
                            const int* __restrict__ body_b, const int* __restrict__ dynamic,
                            int batch, int s, int iterations) {
  for (int it = 0; it < iterations; ++it) {
    for (int t = 0; t < num_tables; ++t) {
      const int* T = tables + t * TABLE_INTS;
      const int kind = T[T_KIND];
      const int rows = T[T_ROWS];
      const bool a_static = T[T_A_STATIC] != 0;
      const bool b_static = T[T_B_STATIC] != 0;
      const int imp_dim = kind_impulses(kind);
      const size_t stride = (size_t)rows * batch;
      for (int c = 0; c < T[T_NUM_COLORS]; ++c) {
        const int* bounds = colors + 2 * (T[T_COLOR_BASE] + c);
        for (int r = bounds[0]; r < bounds[1]; ++r) {
          const int ia = body_a[T[T_ROW_BASE] + r];
          const int ib = body_b[T[T_ROW_BASE] + r];
          const Row R = {prep + ((size_t)T[T_PLANE_BASE] + r) * batch + s, stride};
          const Imp ip = imp + (T[T_IMP_BASE] + r * imp_dim);
          V3 va = v[ia], wa = w[ia], vb = v[ib], wb = w[ib];
          switch (kind) {
            case KIND_HINGE: solve_hinge(R, va, wa, vb, wb, ip); break;
            case KIND_CONE_TWIST: solve_cone_twist(R, va, wa, vb, wb, ip); break;
            case KIND_CONTACT: solve_contact(R, va, wa, vb, wb, ip, a_static, b_static); break;
            case KIND_DISTANCE: solve_distance(R, va, wa, vb, wb); break;
            case KIND_BALL: solve_ball_part(R, va, wa, vb, wb); break;
            default: solve_fixed(R, va, wa, vb, wb); break;
          }
          if (!a_static && dynamic[ia]) {
            v[ia] = va;
            w[ia] = wa;
          }
          if (!b_static && dynamic[ib]) {
            v[ib] = vb;
            w[ib] = wb;
          }
        }
      }
    }
  }
}

}  // namespace
