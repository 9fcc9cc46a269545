"""Fused whole-substep route: forces, plane narrowphase, contact and joint
prep, the `iterations`-long solve and semi-implicit Euler (and, for the
locomotion env, its obs / reward / fall check / auto-reset) as one CUDA
kernel per step, `csrc/fused_substep.cu`.

Counterpart of ``d3d12renderer_tpu/physics/substep_pallas.py``
(`support_reason`, `_extract_consts`, `make_kernel_runner`,
`make_fused_substep`).  The kernel's plain version is the unfused route
(`step.physics_substep(allow_fused=False)`, and `LocoEnv._step_core` for the
env step), which is also the ground truth the JAX package holds its kernel
to.  The route takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.

The archetype comes to the kernel as small constant tensors, built once per
archetype, device and override layout and kept in `arch.cache`: body
constants, one record per row in the colored solver's packed (color-permuted)
order, and the colored solver's tables and colors.  The kernel writes every
row's prep into a (planes, B) scratch in that solver's layout and solves it
exactly as `csrc/colored_solver.cu` does.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import joints as joints_mod
from .solver_cuda import ColoredSolver, KernelArrays, load_library
from .types import (SHAPE_BOX, SHAPE_CAPSULE, SHAPE_SPHERE, BodyState,
                    PhysicsSettings, SceneArchetype)

_SUPPORTED_JOINTS = ("distance", "ball", "fixed", "hinge", "cone_twist")
# Runtime motor targets, in the order of the kernel's R_OVR_* row ints.
OVERRIDE_KEYS = ("motor_target", "twist_target", "swing_target",
                 "swing_axis_angle")
MAX_BODIES = 64
MAX_PLANE_ROWS = 256

# --------------------------------------------------------------------------
# Constant layouts, mirrored by the constants of csrc/fused_substep.cu (a CPU
# test holds the two together).
# --------------------------------------------------------------------------

BODY_FIELDS = (("inv_mass", 1), ("inv_inertia", 9), ("gravity_factor", 1),
               ("linear_damping", 1), ("angular_damping", 1),
               ("local_cog", 3))
JOINT_CONST_FIELDS = (
    ("anchor_a", 3), ("anchor_b", 3), ("axis_a", 3), ("axis_b", 3),
    ("tangent_a", 3), ("bitangent_a", 3), ("tangent_b", 3),
    ("init_inv_rot", 4), ("length", 1), ("min_limit", 1), ("max_limit", 1),
    ("motor_type", 1), ("motor_target", 1), ("max_torque", 1),
    ("swing_limit", 1), ("twist_limit", 1), ("swing_motor_type", 1),
    ("swing_target", 1), ("swing_axis_angle", 1), ("max_swing_torque", 1),
    ("twist_motor_type", 1), ("twist_target", 1), ("max_twist_torque", 1))
PLANE_CONST_FIELDS = (("size", 3), ("local_pos", 3), ("local_rot", 4),
                      ("normal", 3), ("offset", 1), ("friction", 1),
                      ("restitution", 1))
BODY_F, ROW_F, ROW_I = 16, 40, 8
R_ACTIVE, R_SHAPE = 0, 1
# Post-stage ints: P, K, O, A, head body, torso body, then the index lists.
Q_LISTS = 6


def const_offsets() -> Dict[str, int]:
    """Offset of every constant field, under the kernel's names."""
    out = {"BODY_F": BODY_F, "ROW_F": ROW_F, "ROW_I": ROW_I,
           "R_ACTIVE": R_ACTIVE, "R_SHAPE": R_SHAPE, "Q_LISTS": Q_LISTS}
    for prefix, fields in (("B", BODY_FIELDS), ("K", JOINT_CONST_FIELDS),
                           ("P", PLANE_CONST_FIELDS)):
        off = 0
        for name, n in fields:
            out[f"{prefix}_{name.upper()}"] = off
            off += n
    for i, key in enumerate(OVERRIDE_KEYS):
        out[f"R_OVR_{key.upper()}"] = 1 + i
    return out


# --------------------------------------------------------------------------
# Support and dispatch
# --------------------------------------------------------------------------

def support_reason(arch: SceneArchetype, settings: PhysicsSettings
                   ) -> Optional[str]:
    """None if the fused kernel can run this archetype, else why not.  The
    JAX package also refuses terrain rows, pair buckets, the runtime
    broadphase and force fields; the port's builder refuses those scenes, so
    no archetype here has them."""
    if settings.contact_mode != "colored":
        return f"contact_mode {settings.contact_mode!r}"
    if settings.solver_backend == "plain":
        return "solver_backend plain"
    for (stype, _, _) in arch.vs_plane_segments:
        if stype not in (SHAPE_SPHERE, SHAPE_CAPSULE, SHAPE_BOX):
            return f"plane collider type {stype}"
    for t in arch.joints:
        if t.kind not in _SUPPORTED_JOINTS:
            return f"joint kind {t.kind!r}"
    if arch.num_bodies > MAX_BODIES:
        return "too many bodies"
    if arch.vs_plane_collider.shape[0] > MAX_PLANE_ROWS:
        return "too many plane rows"
    return None


def should_build(settings: PhysicsSettings, device) -> Optional[str]:
    """"auto" or "force" where the fused route is built, None where not:
    never for "off"; for "auto" only on a CUDA device.  "force" on the CPU
    builds the route, which there runs its plain version (the JAX package
    runs its kernel in interpret mode there)."""
    mode = settings.fused_substep
    if mode == "off":
        return None
    if mode == "auto" and torch.device(device).type != "cuda":
        return None
    return mode


# --------------------------------------------------------------------------
# Archetype constants
# --------------------------------------------------------------------------

def _np(x):
    return x.detach().cpu().numpy()


def _floats(v):
    return (tuple(float(x) for x in np.ravel(v)) if np.ndim(v) > 0
            else float(v))


def extract_consts(arch: SceneArchetype):
    """(body, plane rows, contact colors, joint tables in solve order), the
    structure of the JAX `_extract_consts`: invalid plane rows and inactive
    joint rows are None, so that the color lists stay aligned."""
    n = arch.num_bodies
    body = {name: _np(getattr(arch, name))[:n] for name in (
        "inv_mass", "inv_inertia", "gravity_factor", "linear_damping",
        "angular_damping", "local_cog")}

    ci, pi = _np(arch.vs_plane_collider), _np(arch.vs_plane_plane)
    bi, valid = _np(arch.vs_plane_body), _np(arch.vs_plane_valid)
    col_type, col_size = _np(arch.col_type), _np(arch.col_size)
    col_lp, col_lr = _np(arch.col_local_pos), _np(arch.col_local_rot)
    pn, po = _np(arch.plane_normal), _np(arch.plane_offset)
    col_f, col_r = _np(arch.col_friction), _np(arch.col_restitution)
    pf, pr = _np(arch.plane_friction), _np(arch.plane_restitution)
    rows = []
    for r in range(ci.shape[0]):
        if not bool(valid[r]):
            rows.append(None)
            continue
        c, p = int(ci[r]), int(pi[r])
        rows.append(dict(
            body=int(bi[r]), type=int(col_type[c]), size=_floats(col_size[c]),
            local_pos=_floats(col_lp[c]), local_rot=_floats(col_lr[c]),
            n=_floats(pn[p]), off=float(po[p]),
            friction=float(np.clip(np.sqrt(col_f[c] * pf[p]), 0.0, 1.0)),
            restitution=float(np.clip(max(col_r[c], pr[p]), 0.0, 1.0))))
    contact_colors = [list(_np(idx).astype(int))
                      for idx in arch.contact_color_indices]

    tables = []
    for k in _table_order(arch):
        t = arch.joints[k]
        ba, bb, tvalid = _np(t.body_a), _np(t.body_b), _np(t.valid)
        params = {key: _np(v) for key, v in t.params.items()}
        jrows = []
        for j in range(ba.shape[0]):
            a, b = int(ba[j]), int(bb[j])
            im_a = float(body["inv_mass"][a]) if a < n else 0.0
            im_b = float(body["inv_mass"][b]) if b < n else 0.0
            if not (bool(tvalid[j]) and (im_a > 0 or im_b > 0)):
                jrows.append(None)
                continue
            row = dict(a=a, b=b, im_a=im_a, im_b=im_b)
            row.update({key: _floats(v[j]) for key, v in params.items()})
            jrows.append(row)
        tables.append(dict(kind=t.kind, arch_index=k, rows=jrows, colors=[
            list(_np(idx).astype(int)) for idx in arch.joint_color_indices[k]]))
    return body, rows, contact_colors, tables


def _table_order(arch: SceneArchetype) -> List[int]:
    order = {k: i for i, k in enumerate(joints_mod.JOINT_SOLVE_ORDER)}
    return sorted(range(len(arch.joints)),
                  key=lambda k: order[arch.joints[k].kind])


def _put(rec, fields, values):
    off = 0
    for name, n in fields:
        if name in values:
            rec[off:off + n] = np.ravel(values[name])
        off += n


@dataclass
class FusedConsts:
    """One archetype's kernel constants on one device."""

    body_f: torch.Tensor            # (N + 1, BODY_F)
    row_f: torch.Tensor             # (rows, ROW_F), packed row order
    row_i: torch.Tensor             # (rows, ROW_I)
    arrays: KernelArrays            # the colored solver's tables and colors
    num_tables: int
    num_impulses: int
    planes: int                     # prep planes per scene
    ovr_cols: int
    iterations: int
    scalars: Dict[str, float]       # dt, bias scales, global force field


def pack_consts(arch: SceneArchetype, settings: PhysicsSettings, dt: float,
                ovr_columns: Dict[Tuple[int, str], Sequence[int]],
                ovr_cols: int, device) -> FusedConsts:
    """Pack `extract_consts` into the kernel's tensors.  `ovr_columns[(k,
    key)][j]` is the column of the (B, ovr_cols) override matrix holding
    parameter `key` of row j of joint table k (arch order)."""
    body, crows, _, jtables = extract_consts(arch)
    num_pairs = arch.vs_plane_collider.shape[0]
    solver = ColoredSolver(arch, num_pairs, settings.solver_iterations,
                           "kernel")
    n = arch.num_bodies
    body_f = np.zeros((n + 1, BODY_F), np.float32)
    for i in range(n):
        _put(body_f[i], BODY_FIELDS, {k: v[i] for k, v in body.items()})

    by_arch = {t["arch_index"]: t for t in jtables}
    recs_f, recs_i = [], []
    for m in solver.tables:
        for src in m.perm:
            rf = np.zeros(ROW_F, np.float32)
            ri = np.full(ROW_I, -1, np.int32)
            if m.kind == "contact":
                row = crows[src]
                ri[R_ACTIVE] = row is not None
                if row is not None:
                    ri[R_SHAPE] = row["type"]
                    _put(rf, PLANE_CONST_FIELDS, dict(
                        row, normal=row["n"], offset=row["off"]))
            else:
                row = by_arch[m.arch_index]["rows"][src]
                ri[R_ACTIVE] = row is not None
                if row is not None:
                    _put(rf, JOINT_CONST_FIELDS, row)
                for i, key in enumerate(OVERRIDE_KEYS):
                    cols = ovr_columns.get((m.arch_index, key))
                    if cols is not None:
                        ri[1 + i] = cols[src]
            recs_f.append(rf)
            recs_i.append(ri)
    if any(m.kind == "contact" and not m.a_static for m in solver.tables):
        raise ValueError("plane contact rows must have the static world as A")

    def scale(beta):
        return float(np.float32(beta / dt))

    gff = [float(x) for x in settings.global_force_field]
    return FusedConsts(
        body_f=torch.as_tensor(body_f, device=device),
        row_f=torch.as_tensor(np.stack(recs_f) if recs_f
                              else np.zeros((0, ROW_F), np.float32),
                              device=device),
        row_i=torch.as_tensor(np.stack(recs_i) if recs_i
                              else np.zeros((0, ROW_I), np.int32),
                              device=device),
        arrays=solver.kernel_arrays(torch.device(device)),
        num_tables=len(solver.tables), num_impulses=solver.num_impulses,
        planes=sum(m.perm.shape[0] * sum(k for _, k in m.fields)
                   for m in solver.tables),
        ovr_cols=ovr_cols, iterations=settings.solver_iterations,
        scalars=dict(
            dt=float(np.float32(dt)),
            ball_bias=scale(joints_mod.BALL_BETA),
            hinge_rot_bias=scale(joints_mod.HINGE_ROTATION_BETA),
            hinge_limit_bias=scale(joints_mod.HINGE_LIMIT_BETA),
            twist_limit_bias=scale(joints_mod.TWIST_LIMIT_BETA),
            distance_bias=scale(joints_mod.DISTANCE_BETA),
            fixed_rot_bias=scale(2.0 * joints_mod.SLIDER_BETA),
            gff_x=gff[0], gff_y=gff[1], gff_z=gff[2]))


@dataclass
class PostConsts:
    """The env post stage's constants (`LocoEnv.post_consts`)."""

    post_f: torch.Tensor
    post_i: torch.Tensor
    n_extra: int


# --------------------------------------------------------------------------
# The kernel wrapper
# --------------------------------------------------------------------------

_PTR_FIELDS = (
    "pos_in", "rot_in", "vel_in", "omega_in", "force_in", "torque_in",
    "pos_out", "rot_out", "vel_out", "omega_out", "force_out", "torque_out",
    "ovr", "extras", "prep", "imp", "body_f", "row_f", "row_i", "tables",
    "colors", "body_a", "body_b", "dynamic", "post_f", "post_i")
_INT_FIELDS = ("num_tables", "num_bodies", "num_impulses", "ovr_cols",
               "n_extra", "batch", "iterations")
_FLOAT_FIELDS = ("dt", "ball_bias", "hinge_rot_bias", "hinge_limit_bias",
                 "twist_limit_bias", "distance_bias", "fixed_rot_bias",
                 "gff_x", "gff_y", "gff_z")


class FusedArgs(ctypes.Structure):
    """The kernel's `FusedArgs`, field for field."""

    _fields_ = ([(f, ctypes.c_void_p) for f in _PTR_FIELDS]
                + [(f, ctypes.c_int) for f in _INT_FIELDS]
                + [(f, ctypes.c_float) for f in _FLOAT_FIELDS])


def launch_args(state: BodyState, ovr: Optional[torch.Tensor],
                consts: FusedConsts, post: Optional[PostConsts]):
    """Check the inputs, allocate outputs and scratch on the state's device
    and fill a `FusedArgs`.  Returns (args, outputs, extras): the tensors
    must stay alive until the launch has run."""
    batch, n = state.pos.shape[0], state.pos.shape[1]
    device = state.pos.device
    shapes = dict(pos=3, rot=4, vel=3, omega=3, force=3, torque=3)
    for name, k in shapes.items():
        x = getattr(state, name)
        if (x.device != device or x.dtype != torch.float32
                or not x.is_contiguous() or tuple(x.shape) != (batch, n, k)):
            raise ValueError(f"state.{name} must be a contiguous float32 "
                             f"({batch}, {n}, {k}) tensor on {device}: got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if consts.body_f.device != device or consts.body_f.shape[0] != n + 1:
        raise ValueError(f"constants for {consts.body_f.shape[0] - 1} bodies "
                         f"on {consts.body_f.device}, state has {n} on "
                         f"{device}")
    if consts.ovr_cols:
        if (ovr is None or ovr.device != device or ovr.dtype != torch.float32
                or not ovr.is_contiguous()
                or tuple(ovr.shape) != (batch, consts.ovr_cols)):
            raise ValueError(f"overrides must be a contiguous float32 "
                             f"({batch}, {consts.ovr_cols}) tensor on {device}")
    outs = {f"{name}_out": torch.empty_like(getattr(state, name))
            for name in shapes}
    extras = None
    if post is not None:
        extras = torch.empty((batch, post.n_extra), dtype=torch.float32,
                             device=device)
    prep = torch.empty((consts.planes, batch), dtype=torch.float32,
                       device=device)
    imp = torch.empty((consts.num_impulses, batch), dtype=torch.float32,
                      device=device)
    keep = dict(outs, prep=prep, imp=imp)
    ptrs = {f"{name}_in": getattr(state, name) for name in shapes}
    ptrs.update(outs, ovr=ovr if consts.ovr_cols else None, extras=extras,
                prep=prep, imp=imp, body_f=consts.body_f, row_f=consts.row_f,
                row_i=consts.row_i, tables=consts.arrays.tables,
                colors=consts.arrays.colors, body_a=consts.arrays.body_a,
                body_b=consts.arrays.body_b, dynamic=consts.arrays.dynamic,
                post_f=post.post_f if post else None,
                post_i=post.post_i if post else None)
    args = FusedArgs(
        **{f: (ptrs[f].data_ptr() if ptrs[f] is not None and ptrs[f].numel()
               else None) for f in _PTR_FIELDS},
        num_tables=consts.num_tables, num_bodies=n,
        num_impulses=consts.num_impulses, ovr_cols=consts.ovr_cols,
        n_extra=post.n_extra if post else 0, batch=batch,
        iterations=consts.iterations, **consts.scalars)
    return args, keep, extras


def fused_substep_cuda(state: BodyState, ovr: Optional[torch.Tensor],
                       consts: FusedConsts, post: Optional[PostConsts] = None):
    """Launch the kernel on the current stream for CUDA tensors.  Returns
    (new state, extras (B, n_extra) or None).  Counts its launches in
    `fused_substep_cuda.launches`."""
    if not state.pos.is_cuda:
        raise ValueError(f"the fused kernel needs CUDA tensors; got a tensor "
                         f"on {state.pos.device}")
    lib = load_library()
    if state.pos.shape[1] > lib.fused_substep_max_bodies():
        raise ValueError(f"{state.pos.shape[1]} bodies > kernel limit "
                         f"{lib.fused_substep_max_bodies()}")
    if ctypes.sizeof(FusedArgs) != lib.fused_substep_args_size():
        raise RuntimeError("FusedArgs does not match the kernel's struct")
    args, keep, extras = launch_args(state, ovr, consts, post)
    new_state = BodyState(*(keep[f"{f}_out"] for f in (
        "pos", "rot", "vel", "omega", "force", "torque")))
    if state.pos.shape[0] == 0:
        return new_state, extras
    device = state.pos.device
    err = lib.fused_substep_launch(
        ctypes.addressof(args), device.index if device.index is not None else 0,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused substep launch failed: CUDA error {err}")
    fused_substep_cuda.launches += 1
    return new_state, extras


fused_substep_cuda.launches = 0


# --------------------------------------------------------------------------
# Runners
# --------------------------------------------------------------------------

def make_kernel_runner(arch: SceneArchetype, settings: PhysicsSettings,
                       dt: float,
                       ovr_columns: Dict[Tuple[int, str], Sequence[int]],
                       ovr_cols: int, post: Optional[PostConsts] = None):
    """`run(state, ovr) -> (new_state, extras)` over CUDA tensors, or None
    where the JAX package's runner is None too: an unsupported archetype, dt
    at or below the joints' threshold, or an override outside the runtime
    motor targets.  Constants are built per device at first use."""
    if support_reason(arch, settings) is not None:
        return None
    if dt <= joints_mod.DT_THRESHOLD:
        return None
    if not {key for _, key in ovr_columns} <= set(OVERRIDE_KEYS):
        return None
    prefix = ("fused_consts", dt, settings.solver_iterations,
              tuple(settings.global_force_field), ovr_cols,
              tuple(sorted((k, key, tuple(c))
                           for (k, key), c in ovr_columns.items())))

    def run(state: BodyState, ovr: Optional[torch.Tensor]):
        key = prefix + (state.pos.device,)
        if key not in arch.cache:
            arch.cache[key] = pack_consts(arch, settings, dt, ovr_columns,
                                          ovr_cols, state.pos.device)
        return fused_substep_cuda(state, ovr, arch.cache[key], post)

    return run


def override_layout(motor_overrides) -> Optional[List[Tuple[int, str]]]:
    """(table, key) of every override leaf in leaf order (tables in arch
    order, keys sorted), or None when a key is not a runtime motor target."""
    spec = []
    for k, d in enumerate(motor_overrides or ()):
        if not d:
            continue
        if not set(d) <= set(OVERRIDE_KEYS):
            return None
        spec += [(k, key) for key in sorted(d)]
    return spec


def make_fused_substep(arch: SceneArchetype, settings: PhysicsSettings,
                       dt: float, motor_overrides, device):
    """`fused(state, motor_overrides) -> new_state`, or None where the JAX
    package returns None: the mode is off (or "auto" off the card), the
    archetype or the settings are outside the kernel's family, dt is too
    small or an override is not a runtime motor target.  On CUDA tensors the
    route launches the kernel; on CPU tensors (fused_substep="force") it runs
    its plain version, the unfused substep."""
    if should_build(settings, device) is None:
        return None
    spec = override_layout(motor_overrides)
    if spec is None:
        return None
    cache_key = ("fused_substep", dt, settings, tuple(
        (k, key, arch.joints[k].body_a.shape[0]) for k, key in spec))
    if cache_key not in arch.cache:
        columns, start = {}, 0
        for k, key in spec:
            rows = arch.joints[k].body_a.shape[0]
            columns[(k, key)] = range(start, start + rows)
            start += rows
        arch.cache[cache_key] = make_kernel_runner(arch, settings, dt,
                                                   columns, start)
    run = arch.cache[cache_key]
    if run is None:
        return None

    def fused(state: BodyState, overrides) -> BodyState:
        if not state.pos.is_cuda:
            from . import step as step_mod
            return step_mod.physics_substep(arch, state, dt, settings,
                                            overrides, allow_fused=False)[0]
        leaves = [d[key] for d in (overrides or ()) if d for key in sorted(d)]
        ovr = (torch.cat([x.to(torch.float32) for x in leaves], dim=1)
               .contiguous() if leaves else None)
        return run(state, ovr)[0]

    return fused

