"""Joint constraints: hinge and cone-twist with limits and motors, the
ragdoll's kinds (counterpart of the JAX package's ``physics/joints.py``).

Prep runs once per substep; the solve runs once per solver iteration, color
by color, in the reference's type order.  Runtime motor targets (the RL
action) come in through `motor_overrides`.  Tensors carry a leading scene
axis B.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from ..core import maths as m
from ..device import resolve_device
from .solver import ColorPlan, color_plans, scatter_bodies
from .types import JointTable, SceneArchetype

BALL_BETA = 0.1
HINGE_ROTATION_BETA = 0.3
HINGE_LIMIT_BETA = 0.1
TWIST_LIMIT_BETA = 0.1
DT_THRESHOLD = 1e-5

MOTOR_POSITION = 1.0   # motor_type 0 is a velocity motor

SWING_MOTOR_GAIN = 0.2

# The ragdoll's joint kinds, in the reference's solve order (distance, ball
# and fixed joints come before them, sliders after; the ragdoll has none).
JOINT_SOLVE_ORDER = ("hinge", "cone_twist")

IMPULSE_DIMS = {
    "hinge": 2,       # motor, limit
    "cone_twist": 4,  # twist motor, swing motor, twist limit, swing limit
}

# Prep fields the row solves do not read (prep-time diagnostics).
DROP_FIELDS = frozenset({"ia", "ib", "angle", "swing_angle", "twist_angle",
                         "dist"})


class JointContext(NamedTuple):
    """Per-substep body data shared by all joint preps (N+1 slots)."""

    pos1: torch.Tensor       # (B, N+1, 3)
    rot1: torch.Tensor       # (B, N+1, 4)
    inv_mass1: torch.Tensor  # (N+1,)
    ii_w1: torch.Tensor      # (B, N+1, 3, 3) world inverse inertia
    local_cog1: torch.Tensor # (N+1, 3)
    dt: float


def _skew(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    rows = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return rows.reshape(v.shape[:-1] + (3, 3))


def _safe_div(num, den, cond):
    """where(cond, num / den, 0) without dividing by zero."""
    safe = torch.where(den == 0, torch.ones_like(den), den)
    return torch.where(cond, num / safe, torch.zeros_like(den))


def _safe_inv3(K, active):
    """Closed-form adjugate inverse of (..., 3, 3) K; 0 where inactive."""
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    K = torch.where(active[..., None, None], K, eye) + 1e-9 * eye
    a, b, c = K[..., 0, 0], K[..., 0, 1], K[..., 0, 2]
    d, e, f = K[..., 1, 0], K[..., 1, 1], K[..., 1, 2]
    g, h, i = K[..., 2, 0], K[..., 2, 1], K[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = _safe_div(torch.ones_like(det), det, torch.abs(det) > 1e-20)
    adj = torch.stack([
        A, -(b * i - c * h), b * f - c * e,
        B, a * i - c * g, -(a * f - c * d),
        C, -(a * h - b * g), a * e - b * d,
    ], dim=-1).reshape(K.shape)
    inv = adj * inv_det[..., None, None]
    return torch.where(active[..., None, None], inv, torch.zeros_like(inv))


def _inv22(k00, k01, k10, k11, active):
    det = k00 * k11 - k01 * k10
    inv_det = _safe_div(torch.ones_like(det), det, torch.abs(det) > 1e-12)
    inv_det = inv_det * active
    return k11 * inv_det, -k01 * inv_det, -k10 * inv_det, k00 * inv_det


_mv = m.mat3_vec


def _rdot(a, b):
    return torch.sum(a * b, dim=-1)


def _common(table: JointTable, ctx: JointContext, p):
    """Anchors, masses and world inertia of every row."""
    ia, ib = table.body_a, table.body_b
    batch = ctx.pos1.shape[0]
    qa, qb = ctx.rot1[:, ia], ctx.rot1[:, ib]
    ra = m.quat_rotate(qa, p["anchor_a"] - ctx.local_cog1[ia])
    rb = m.quat_rotate(qb, p["anchor_b"] - ctx.local_cog1[ib])
    ga = ctx.pos1[:, ia] + ra
    gb = ctx.pos1[:, ib] + rb
    im_a = ctx.inv_mass1[ia].expand(batch, -1)
    im_b = ctx.inv_mass1[ib].expand(batch, -1)
    ii_a, ii_b = ctx.ii_w1[:, ia], ctx.ii_w1[:, ib]
    active = table.valid & ((im_a > 0) | (im_b > 0))
    return ia, ib, qa, qb, ra, rb, ga, gb, im_a, im_b, ii_a, ii_b, active


def _ball_K_inv(ra, rb, im_a, im_b, ii_a, ii_b, active):
    """inv(skewA iiA skewA^T + skewB iiB skewB^T + (imA + imB) I)."""
    sa, sb = _skew(ra), _skew(rb)
    eye = torch.eye(3, dtype=ra.dtype, device=ra.device)
    K = (sa @ ii_a @ sa.transpose(-1, -2) + sb @ ii_b @ sb.transpose(-1, -2)
         + (im_a + im_b)[..., None, None] * eye)
    return _safe_inv3(K, active)


def _bias_scale(dt, beta):
    return beta / dt if dt > DT_THRESHOLD else 0.0


def _apply_linear3(prep, P, va, wa, vb, wb):
    va = va - prep["im_a"][..., None] * P
    wa = wa - _mv(prep["ii_a"], m.cross(prep["ra"], P))
    vb = vb + prep["im_b"][..., None] * P
    wb = wb + _mv(prep["ii_b"], m.cross(prep["rb"], P))
    return va, wa, vb, wb


def _solve_ball_part(prep, va, wa, vb, wb):
    av_a = va + m.cross(wa, prep["ra"])
    av_b = vb + m.cross(wb, prep["rb"])
    cdot = av_b - av_a + prep["bias"]
    P = -_mv(prep["inv_K"], cdot)
    return _apply_linear3(prep, P, va, wa, vb, wb)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _where(c, a, b):
    dtype = torch.get_default_dtype()
    return torch.where(c, m.constant(a, dtype, c.device),
                       m.constant(b, dtype, c.device))


# --------------------------------------------------------------------------
# Distance, ball, fixed
# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# Hinge
# --------------------------------------------------------------------------

def _axial_limit_motor(axis_w, ii_a, ii_b, active):
    to_wa, to_wb = _mv(ii_a, axis_w), _mv(ii_b, axis_w)
    inv_k = _rdot(axis_w, to_wa) + _rdot(axis_w, to_wb)
    eff = _safe_div(torch.ones_like(inv_k), inv_k, inv_k != 0) * active
    return eff, to_wa, to_wb


def _prep_hinge(table, ctx, p):
    ia, ib, qa, qb, ra, rb, ga, gb, im_a, im_b, ii_a, ii_b, active = _common(
        table, ctx, p)
    inv_K = _ball_K_inv(ra, rb, im_a, im_b, ii_a, ii_b, active)
    t_bias = (gb - ga) * _bias_scale(ctx.dt, BALL_BETA)

    axis_a_w = m.quat_rotate(qa, p["axis_a"])
    axis_b_w = m.quat_rotate(qb, p["axis_b"])
    tb, bb = m.orthonormal_basis(axis_b_w)
    bxa = m.cross(tb, axis_a_w)
    cxa = m.cross(bb, axis_a_w)
    ii_sum_b = _mv(ii_a, bxa) + _mv(ii_b, bxa)
    ii_sum_c = _mv(ii_a, cxa) + _mv(ii_b, cxa)
    k00 = _rdot(bxa, ii_sum_b)
    k01 = _rdot(bxa, ii_sum_c)
    k10 = _rdot(cxa, ii_sum_b)
    k11 = _rdot(cxa, ii_sum_c)
    i2 = _inv22(k00, k01, k10, k11, active)
    r_bias = torch.stack([_rdot(axis_a_w, tb), _rdot(axis_a_w, bb)], -1) \
        * _bias_scale(ctx.dt, HINGE_ROTATION_BETA)

    cmp_a = m.quat_inv_rotate(qa, m.quat_rotate(qb, p["tangent_b"]))
    angle = torch.atan2(_rdot(cmp_a, p["bitangent_a"]),
                        _rdot(cmp_a, p["tangent_a"]))

    min_l, max_l = p["min_limit"], p["max_limit"]
    min_active = min_l <= 0.0
    max_active = max_l >= 0.0
    min_violated = min_active & (angle <= min_l)
    max_violated = max_active & (angle >= max_l)
    solve_limit = (min_violated | max_violated) & active
    limit_sign = _where(min_violated, 1.0, -1.0)

    eff_ax, to_wa_ax, to_wb_ax = _axial_limit_motor(axis_a_w, ii_a, ii_b, active)
    eff_limit = eff_ax * solve_limit
    d = torch.where(min_violated, angle - min_l, max_l - angle)
    limit_bias = d * _bias_scale(ctx.dt, HINGE_LIMIT_BETA)

    motor_active = (p["max_torque"] > 0.0) & active
    max_imp = torch.clamp(p["max_torque"], min=0.0) * ctx.dt
    tgt = _clip(p["motor_target"],
                torch.where(min_active, min_l, torch.full_like(min_l, -math.pi)),
                torch.where(max_active, max_l, torch.full_like(max_l, math.pi)))
    pos_vel = ((tgt - angle) / ctx.dt if ctx.dt > DT_THRESHOLD
               else torch.zeros_like(angle))
    motor_vel = torch.where(p["motor_type"] == MOTOR_POSITION, pos_vel,
                            p["motor_target"])
    eff_motor = eff_ax * motor_active

    return dict(ia=ia, ib=ib, ra=ra, rb=rb, inv_K=inv_K, bias=t_bias,
                bxa=bxa, cxa=cxa, i2=i2, r_bias=r_bias,
                axis=axis_a_w, eff_limit=eff_limit, limit_sign=limit_sign,
                limit_bias=limit_bias, eff_motor=eff_motor, motor_vel=motor_vel,
                max_imp=max_imp, to_wa_ax=to_wa_ax, to_wb_ax=to_wb_ax,
                im_a=im_a, im_b=im_b, ii_a=ii_a, ii_b=ii_b, angle=angle)


def _solve_axial_motor(prep, wa, wb, imp, slot):
    relw = _rdot(prep["axis"], wb) - _rdot(prep["axis"], wa)
    lam = -prep["eff_motor"] * (relw - prep["motor_vel"])
    new = _clip(imp[..., slot] + lam, -prep["max_imp"], prep["max_imp"])
    lam = new - imp[..., slot]
    imp[..., slot] = new
    wa = wa - prep["to_wa_ax"] * lam[..., None]
    wb = wb + prep["to_wb_ax"] * lam[..., None]
    return wa, wb


def _solve_axial_limit(prep, wa, wb, imp, slot):
    s = prep["limit_sign"]
    relw = s * (_rdot(prep["axis"], wb) - _rdot(prep["axis"], wa))
    lam = -prep["eff_limit"] * (relw + prep["limit_bias"])
    new = torch.clamp(imp[..., slot] + lam, min=0.0)
    lam = (new - imp[..., slot]) * s
    imp[..., slot] = new
    wa = wa - prep["to_wa_ax"] * lam[..., None]
    wb = wb + prep["to_wb_ax"] * lam[..., None]
    return wa, wb


def _solve_hinge(prep, va, wa, vb, wb, imp):
    """Motor -> limit -> rotation -> position.  `imp` (B, R, 2) is the
    color's own copy and is updated in place."""
    wa, wb = _solve_axial_motor(prep, wa, wb, imp, 0)
    wa, wb = _solve_axial_limit(prep, wa, wb, imp, 1)

    dw = wb - wa
    c0 = _rdot(prep["bxa"], dw) + prep["r_bias"][..., 0]
    c1 = _rdot(prep["cxa"], dw) + prep["r_bias"][..., 1]
    i00, i01, i10, i11 = prep["i2"]
    l0 = -(i00 * c0 + i01 * c1)
    l1 = -(i10 * c0 + i11 * c1)
    P = prep["bxa"] * l0[..., None] + prep["cxa"] * l1[..., None]
    wa = wa - _mv(prep["ii_a"], P)
    wb = wb + _mv(prep["ii_b"], P)
    return _solve_ball_part(prep, va, wa, vb, wb)


# --------------------------------------------------------------------------
# Cone-twist
# --------------------------------------------------------------------------

def _prep_cone_twist(table, ctx, p):
    ia, ib, qa, qb, ra, rb, ga, gb, im_a, im_b, ii_a, ii_b, active = _common(
        table, ctx, p)
    inv_K = _ball_K_inv(ra, rb, im_a, im_b, ii_a, ii_b, active)
    t_bias = (gb - ga) * _bias_scale(ctx.dt, BALL_BETA)
    dt = ctx.dt

    # Swing / twist decomposition in A's frame.
    btoa = m.quat_mul(m.quat_conj(qa), qb)
    axis_cmp = m.quat_rotate(btoa, p["axis_b"])
    swing_q = m.quat_from_to(p["axis_a"], axis_cmp)
    twist_tan = m.quat_rotate(swing_q, p["tangent_a"])
    twist_bitan = m.quat_rotate(swing_q, p["bitangent_a"])
    tan_cmp = m.quat_rotate(btoa, p["tangent_b"])
    twist_angle = torch.atan2(_rdot(tan_cmp, twist_bitan),
                              _rdot(tan_cmp, twist_tan))
    swing_axis_l, swing_angle = m.quat_to_axis_angle(swing_q)
    neg = swing_angle < 0.0
    swing_angle = torch.abs(swing_angle)
    swing_axis_l = torch.where(neg[..., None], -swing_axis_l, swing_axis_l)

    # Swing limit.
    sl = p["swing_limit"]
    solve_swing = (sl >= 0.0) & (swing_angle >= sl) & active
    swing_axis_w = m.quat_rotate(qa, swing_axis_l)
    eff_swing, sw_to_wa, sw_to_wb = _axial_limit_motor(swing_axis_w, ii_a, ii_b,
                                                       active)
    eff_swing = eff_swing * solve_swing
    swing_bias = (sl - swing_angle) * _bias_scale(dt, HINGE_LIMIT_BETA)

    # Swing motor.
    swing_motor_active = (p["max_swing_torque"] > 0.0) & active
    max_swing_imp = torch.clamp(p["max_swing_torque"], min=0.0) * dt
    ax_c = torch.cos(p["swing_axis_angle"])
    ax_s = torch.sin(p["swing_axis_angle"])
    local_motor_axis = (ax_c[..., None] * p["tangent_a"]
                        + ax_s[..., None] * p["bitangent_a"])
    sw_tgt = torch.where(sl >= 0.0, _clip(p["swing_target"], -sl, sl),
                         p["swing_target"])
    local_target_dir = m.quat_rotate(
        m.quat_from_axis_angle(local_motor_axis, sw_tgt), p["axis_a"])
    pos_axis_l = m.noz(m.cross(axis_cmp, local_target_dir))
    cos_ang = torch.clamp(_rdot(local_target_dir, axis_cmp), 0.0, 1.0)
    pos_vel = (torch.acos(cos_ang) / dt * SWING_MOTOR_GAIN
               if dt > DT_THRESHOLD else torch.zeros_like(cos_ang))
    is_pos = p["swing_motor_type"] == MOTOR_POSITION
    motor_axis_l = torch.where(is_pos[..., None], pos_axis_l, local_motor_axis)
    swing_motor_vel = torch.where(is_pos, pos_vel, p["swing_target"])
    swing_motor_axis_w = m.quat_rotate(qa, motor_axis_l)
    eff_swing_motor, swm_to_wa, swm_to_wb = _axial_limit_motor(
        swing_motor_axis_w, ii_a, ii_b, active)
    eff_swing_motor = eff_swing_motor * swing_motor_active

    # Twist limit and motor, about A's axis.
    tl = p["twist_limit"]
    twist_axis_w = m.quat_rotate(qa, p["axis_a"])
    min_violated = (tl >= 0.0) & (twist_angle <= -tl)
    max_violated = (tl >= 0.0) & (twist_angle >= tl)
    solve_twist = (min_violated | max_violated) & active
    eff_tw, tw_to_wa, tw_to_wb = _axial_limit_motor(twist_axis_w, ii_a, ii_b,
                                                    active)
    eff_twist_limit = eff_tw * solve_twist
    twist_sign = _where(min_violated, 1.0, -1.0)
    d = torch.where(min_violated, tl + twist_angle, tl - twist_angle)
    twist_bias = d * _bias_scale(dt, TWIST_LIMIT_BETA)

    twist_motor_active = (p["max_twist_torque"] > 0.0) & active
    max_twist_imp = torch.clamp(p["max_twist_torque"], min=0.0) * dt
    lim = torch.where(tl >= 0.0, tl, torch.full_like(tl, math.pi))
    tw_tgt = _clip(p["twist_target"], -lim, lim)
    tw_pos_vel = ((tw_tgt - twist_angle) / dt if dt > DT_THRESHOLD
                  else torch.zeros_like(twist_angle))
    twist_motor_vel = torch.where(p["twist_motor_type"] == MOTOR_POSITION,
                                  tw_pos_vel, p["twist_target"])
    eff_twist_motor = eff_tw * twist_motor_active

    return dict(
        ia=ia, ib=ib, ra=ra, rb=rb, inv_K=inv_K, bias=t_bias,
        im_a=im_a, im_b=im_b, ii_a=ii_a, ii_b=ii_b,
        swing_axis=swing_axis_w, eff_swing=eff_swing, swing_bias=swing_bias,
        sw_to_wa=sw_to_wa, sw_to_wb=sw_to_wb,
        swing_motor_axis=swing_motor_axis_w, eff_swing_motor=eff_swing_motor,
        swing_motor_vel=swing_motor_vel, max_swing_imp=max_swing_imp,
        swm_to_wa=swm_to_wa, swm_to_wb=swm_to_wb,
        twist_axis=twist_axis_w, eff_twist_limit=eff_twist_limit,
        twist_sign=twist_sign, twist_bias=twist_bias,
        eff_twist_motor=eff_twist_motor, twist_motor_vel=twist_motor_vel,
        max_twist_imp=max_twist_imp, tw_to_wa=tw_to_wa, tw_to_wb=tw_to_wb,
        swing_angle=swing_angle, twist_angle=twist_angle,
    )


def _solve_cone_twist(prep, va, wa, vb, wb, imp):
    """Twist motor -> swing motor -> twist limit -> swing limit -> position.
    `imp` (B, R, 4) is the color's own copy and is updated in place."""
    ax = prep["twist_axis"]
    relw = _rdot(ax, wb) - _rdot(ax, wa)
    lam = -prep["eff_twist_motor"] * (relw - prep["twist_motor_vel"])
    new = _clip(imp[..., 0] + lam, -prep["max_twist_imp"], prep["max_twist_imp"])
    lam = new - imp[..., 0]
    imp[..., 0] = new
    wa = wa - prep["tw_to_wa"] * lam[..., None]
    wb = wb + prep["tw_to_wb"] * lam[..., None]

    axm = prep["swing_motor_axis"]
    relw = _rdot(axm, wb) - _rdot(axm, wa)
    lam = -prep["eff_swing_motor"] * (relw - prep["swing_motor_vel"])
    new = _clip(imp[..., 1] + lam, -prep["max_swing_imp"], prep["max_swing_imp"])
    lam = new - imp[..., 1]
    imp[..., 1] = new
    wa = wa - prep["swm_to_wa"] * lam[..., None]
    wb = wb + prep["swm_to_wb"] * lam[..., None]

    s = prep["twist_sign"]
    relw = s * (_rdot(ax, wb) - _rdot(ax, wa))
    lam = -prep["eff_twist_limit"] * (relw + prep["twist_bias"])
    new = torch.clamp(imp[..., 2] + lam, min=0.0)
    lam = (new - imp[..., 2]) * s
    imp[..., 2] = new
    wa = wa - prep["tw_to_wa"] * lam[..., None]
    wb = wb + prep["tw_to_wb"] * lam[..., None]

    # Swing limit: inverted application sign (Cdot = a.wA - a.wB).
    axs = prep["swing_axis"]
    cdot = _rdot(axs, wa) - _rdot(axs, wb) + prep["swing_bias"]
    lam = -prep["eff_swing"] * cdot
    new = torch.clamp(imp[..., 3] + lam, min=0.0)
    lam = new - imp[..., 3]
    imp[..., 3] = new
    wa = wa + prep["sw_to_wa"] * lam[..., None]
    wb = wb - prep["sw_to_wb"] * lam[..., None]

    return _solve_ball_part(prep, va, wa, vb, wb)


# --------------------------------------------------------------------------
# Slider
# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# Registry + orchestration
# --------------------------------------------------------------------------

_PREP_FNS = {
    "hinge": _prep_hinge,
    "cone_twist": _prep_cone_twist,
}

_SOLVE_FNS = {
    "hinge": _solve_hinge,
    "cone_twist": _solve_cone_twist,
}


def prep_all(arch: SceneArchetype, ctx: JointContext,
             motor_overrides: Optional[Sequence[Optional[Dict]]] = None):
    """Per-joint constraint data for every table, each field (B, J, ...).
    `motor_overrides[k]` replaces parameters of table k with (B, J) tensors
    (the RL action path)."""
    batch = ctx.pos1.shape[0]
    preps = []
    for k, table in enumerate(arch.joints):
        params = {name: v.expand((batch,) + v.shape)
                  for name, v in table.params.items()}
        if motor_overrides is not None and motor_overrides[k]:
            params.update(motor_overrides[k])
        preps.append(_PREP_FNS[table.kind](table, ctx, params))
    return tuple(preps)


def init_impulses(arch: SceneArchetype, batch: int, dtype=torch.float32,
                  device="cuda"):
    device = resolve_device(device)
    return tuple(
        torch.zeros((batch, t.body_a.shape[0], IMPULSE_DIMS[t.kind]),
                    dtype=dtype, device=device)
        for t in arch.joints)


def color_plans_of(arch: SceneArchetype, device):
    """Each joint table's color plans on `device`, built once per
    archetype."""
    key = ("joint_color_plans", str(device))
    if key not in arch.cache:
        dynamic = arch.inv_mass.cpu().numpy() > 0.0
        arch.cache[key] = tuple(
            color_plans(arch.joint_color_indices[k], t.body_a.to(device),
                        t.body_b.to(device), dynamic)
            for k, t in enumerate(arch.joints))
    return arch.cache[key]


def _gather_prep(prep, rows):
    out = {}
    for k, v in prep.items():
        if k in DROP_FIELDS:
            continue
        out[k] = tuple(x[:, rows] for x in v) if isinstance(v, tuple) else v[:, rows]
    return out


def _solve_table_colored(plans: Sequence[ColorPlan], prep, imp, vel, omega,
                         row_solver):
    for plan in plans:
        p = _gather_prep(prep, plan.rows)
        va, wa = vel[:, plan.ia], omega[:, plan.ia]
        vb, wb = vel[:, plan.ib], omega[:, plan.ib]
        imp_c = imp[:, plan.rows]
        va, wa, vb, wb = row_solver(p, va, wa, vb, wb, imp_c)
        scatter_bodies(plan, vel, omega, va, wa, vb, wb)
        imp[:, plan.rows] = imp_c


def solve_all_one_iteration(arch: SceneArchetype,
                            plans: Sequence[Sequence[ColorPlan]],
                            preps, impulses, vel, omega):
    """One Gauss-Seidel sweep over all joint tables in the reference's type
    order.  `plans[k]` are table k's colors; `vel`, `omega` and `impulses`
    are updated in place."""
    tables = {t.kind: k for k, t in enumerate(arch.joints)}
    for kind in JOINT_SOLVE_ORDER:
        if kind not in tables:
            continue
        k = tables[kind]
        _solve_table_colored(plans[k], preps[k], impulses[k], vel, omega,
                             _SOLVE_FNS[kind])
