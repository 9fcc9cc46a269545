"""Whole-loop colored solver: the `iterations`-long sequential-impulse solve
(joint tables in `JOINT_SOLVE_ORDER`, then contact rows color by color) as
one CUDA kernel, `csrc/colored_solver.cu` (the team solve and row solves in
`csrc/solver_rows.cuh`, shared with the fused kernel of `substep_cuda.py`).
A team of `TEAM_WIDTH` lanes solves one scene from shared memory.

The contact rows are one table in the builder's global color order: plane
rows, terrain rows, then the collider-pair buckets.  Plane and terrain rows
name the world slot as A, which the kernel never writes (`dynamic` is 0
there); where some row's A body is dynamic (a pair row), the table carries
the A fields.

Counterpart of ``d3d12renderer_tpu/physics/solver_pallas.py``
(`make_colored_solver` and its kernel `_build_kernel`).  Beside the kernel
sits its plain PyTorch version, the per-color gather / solve / scatter loop
over `joints.solve_all_one_iteration` and `solver.solve_contacts_colored`.
A solver built with backend:

* "auto" launches the kernel for CUDA tensors and runs the plain version for
  CPU tensors;
* "kernel" launches the kernel and raises for CPU tensors;
* "plain" runs the plain version on any device (tests and the chip check
  compare the two with it).

The kernel library (this solver, the fused whole-substep kernel of
`substep_cuda.py` and the ray kernels of `ops/ray_trace.py`) is built and
bound by `cuda_build.py`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..cuda_build import load_library
from . import joints as joints_mod
from . import solver as solver_mod
from .types import SceneArchetype

# --------------------------------------------------------------------------
# Packed prep layout.  The buffer is [scene][plane]: each scene's planes are
# contiguous, table after table, each table's planes [row][field component]
# with an odd row stride (`row_stride`), so that a row's fields sit at
# constant offsets and the lanes of a team, which take neighbouring rows,
# fall on different banks of shared memory.  A scene's planes are padded to
# 16 bytes for the kernel's bulk copy.  The field offsets below are mirrored
# by the constants of csrc/solver_rows.cuh (a CPU test holds the two
# together).
# --------------------------------------------------------------------------

# The ball part: a whole ball row, and the first fields of fixed, hinge and
# cone-twist rows.
BALL_FIELDS = (("ra", 3), ("rb", 3), ("bias", 3), ("inv_K", 9), ("im_a", 1),
               ("im_b", 1), ("ii_a", 9), ("ii_b", 9))
DISTANCE_FIELDS = (("ra", 3), ("rb", 3), ("u", 3), ("bias", 1), ("eff", 1),
                   ("im_a", 1), ("im_b", 1), ("to_wa", 3), ("to_wb", 3))
FIXED_FIELDS = BALL_FIELDS + (("inv_K_rot", 9), ("r_bias", 3))
HINGE_FIELDS = BALL_FIELDS + (
    ("axis", 3), ("motor_vel", 1), ("eff_motor", 1), ("max_imp", 1),
    ("to_wa_ax", 3), ("to_wb_ax", 3), ("limit_sign", 1), ("limit_bias", 1),
    ("eff_limit", 1), ("bxa", 3), ("cxa", 3), ("r_bias", 2), ("i2", 4))
CONE_TWIST_FIELDS = BALL_FIELDS + (
    ("twist_axis", 3), ("eff_twist_motor", 1), ("twist_motor_vel", 1),
    ("max_twist_imp", 1), ("tw_to_wa", 3), ("tw_to_wb", 3),
    ("swing_motor_axis", 3), ("eff_swing_motor", 1), ("swing_motor_vel", 1),
    ("max_swing_imp", 1), ("swm_to_wa", 3), ("swm_to_wb", 3),
    ("twist_sign", 1), ("eff_twist_limit", 1), ("twist_bias", 1),
    ("swing_axis", 3), ("eff_swing", 1), ("swing_bias", 1), ("sw_to_wa", 3),
    ("sw_to_wb", 3))
SLIDER_FIELDS = (
    ("axis", 3), ("motor_vel", 1), ("eff_motor", 1), ("max_imp", 1),
    ("im_a", 1), ("im_b", 1), ("limit_sign", 1), ("eff_limit", 1),
    ("limit_bias", 1), ("rbxs", 3), ("rauxs", 3), ("lim_to_wa", 3),
    ("lim_to_wb", 3), ("inv_K_rot", 9), ("r_bias", 3), ("ii_a", 9),
    ("ii_b", 9), ("t", 3), ("b", 3), ("rbxt", 3), ("rbxb", 3), ("rauxt", 3),
    ("rauxb", 3), ("t_bias", 2), ("i2", 4))
# Contact rows: B side always; the A side only when A is dynamic somewhere.
CONTACT_FIELDS = (
    ("normal", 3), ("friction", 1), ("inv_mass_b", 1), ("r_b", 12),
    ("tangent", 12), ("bias", 4), ("eff_mass_n", 4), ("eff_mass_t", 4),
    ("n_to_wb", 12), ("t_to_wb", 12), ("pmask", 4))
CONTACT_A_FIELDS = (("inv_mass_a", 1), ("r_a", 12), ("n_to_wa", 12),
                    ("t_to_wa", 12))

KIND_IDS = {"hinge": 0, "cone_twist": 1, "contact": 2, "distance": 3,
            "ball": 4, "fixed": 5, "slider": 6}
JOINT_FIELDS = {"distance": DISTANCE_FIELDS, "ball": BALL_FIELDS,
                "fixed": FIXED_FIELDS, "hinge": HINGE_FIELDS,
                "cone_twist": CONE_TWIST_FIELDS, "slider": SLIDER_FIELDS}
# Per-table record of the kernel's `tables` array.
(T_KIND, T_ROWS, T_ROW_BASE, T_COLOR_BASE, T_NUM_COLORS, T_PLANE_BASE,
 T_IMP_BASE, T_A_STATIC, T_B_STATIC, T_ROW_STRIDE, TABLE_INTS) = range(11)

# --------------------------------------------------------------------------
# Teams and shared memory (csrc/solver_rows.cuh).  Both solver kernels run a
# team of TEAM_WIDTH lanes per scene, one warp per block of WARP // width
# teams, each team's scene in its own slice of the block's dynamic shared
# memory.  TEAM_WIDTH is the fastest of TEAM_WIDTHS on the card (PERF.md).
# A scene too large for WARP // TEAM_WIDTH teams in one block runs at the
# narrowest wider width whose block fits (`pick_team_width`).
# --------------------------------------------------------------------------

WARP = 32
TEAM_WIDTHS = (8, 16, 32)
TEAM_WIDTH = 8
# Shared memory one block may opt in to on sm_90 (227 KB); the launch
# checks the device's own limit.
SHARED_LIMIT = 232448
# Floats ahead of a colored-solver team's prep: its mbarrier.
BARRIER_FLOATS = 4


def team_floats(need: int, width: int) -> int:
    """`team_floats` of solver_rows.cuh: `need` rounded up to 32 words plus
    `width % 32`, so that the teams of a warp start on different banks."""
    return -(-need // WARP) * WARP + width % WARP


def block_shared_bytes(floats_per_team: int, width: int) -> int:
    """Dynamic shared memory of one block of WARP // width teams."""
    return (WARP // width) * floats_per_team * 4


def colored_team_floats(slots: int, prep_stride: int, num_impulses: int,
                        width: int) -> int:
    """One colored-solver team: barrier, prep, v and w, impulses."""
    return team_floats(BARRIER_FLOATS + prep_stride + 6 * slots + num_impulses,
                       width)


def pick_team_width(team_floats_of, limit: int) -> int:
    """The team width of a launch: the narrowest of TEAM_WIDTHS from
    TEAM_WIDTH up whose block of WARP // width teams fits in `limit` bytes
    of shared memory.  `team_floats_of(width)` gives one team's floats.
    Raises if not even one team of WARP lanes fits."""
    for width in TEAM_WIDTHS:
        if width < TEAM_WIDTH:
            continue
        if block_shared_bytes(team_floats_of(width), width) <= limit:
            return width
    raise ValueError(
        f"the scene needs {block_shared_bytes(team_floats_of(WARP), WARP)} "
        f"bytes of shared memory for one team of {WARP} lanes; the device "
        f"allows {limit}")


def layout_offsets() -> Dict[str, int]:
    """Scalar-plane offset of every field, under the kernel's names."""
    out = {}

    def put(prefix, fields, start):
        off = start
        for name, n in fields:
            out[f"{prefix}_{name.upper()}"] = off
            off += n
        return off

    out["J_NUM_FIELDS"] = put("J", BALL_FIELDS, 0)
    out["D_NUM_FIELDS"] = put("D", DISTANCE_FIELDS, 0)
    out["F_NUM_FIELDS"] = put("F", FIXED_FIELDS[len(BALL_FIELDS):],
                              sum(n for _, n in BALL_FIELDS))
    out["H_NUM_FIELDS"] = put("H", HINGE_FIELDS[len(BALL_FIELDS):],
                              sum(n for _, n in BALL_FIELDS))
    out["CT_NUM_FIELDS"] = put("CT", CONE_TWIST_FIELDS[len(BALL_FIELDS):],
                               sum(n for _, n in BALL_FIELDS))
    out["S_NUM_FIELDS"] = put("S", SLIDER_FIELDS, 0)
    out["C_B_FIELDS"] = put("C", CONTACT_FIELDS, 0)
    put("C", CONTACT_A_FIELDS, out["C_B_FIELDS"])
    return out


# --------------------------------------------------------------------------
# Static structure
# --------------------------------------------------------------------------

@dataclass
class _TableMeta:
    """One table in solve order: kind, color-permuted rows, packed fields."""

    kind: str
    arch_index: int                 # joint table index; -1 for contacts
    perm: np.ndarray                # rows in color order
    color_bounds: List[Tuple[int, int]]
    body_a: np.ndarray              # body ids in perm order
    body_b: np.ndarray
    imp_dim: int
    fields: Tuple[Tuple[str, int], ...]
    a_static: bool = False
    b_static: bool = False

    @property
    def num_fields(self) -> int:
        return sum(n for _, n in self.fields)

    @property
    def row_stride(self) -> int:
        """Floats per packed row: the field count, made odd."""
        return self.num_fields | 1


def _table_meta(kind, arch_index, color_indices, body_a, body_b, imp_dim,
                fields):
    colors = [c.cpu().numpy().astype(np.int64) for c in color_indices]
    perm = np.concatenate(colors) if colors else np.zeros(0, np.int64)
    bounds, start = [], 0
    for c in colors:
        bounds.append((start, start + len(c)))
        start += len(c)
    return _TableMeta(kind=kind, arch_index=arch_index, perm=perm,
                      color_bounds=bounds, body_a=body_a[perm],
                      body_b=body_b[perm], imp_dim=imp_dim, fields=fields)


@dataclass
class KernelArrays:
    """The kernel's static int32 arrays on one device."""

    tables: torch.Tensor
    colors: torch.Tensor
    body_a: torch.Tensor
    body_b: torch.Tensor
    dynamic: torch.Tensor
    perms: List[torch.Tensor]


class ColoredSolver:
    """`solve(joint_preps, contact_prep, vel1, omega1) -> (vel1, omega1)`
    for one archetype, `num_pairs` contact rows and `iterations` sweeps.
    vel1/omega1 are (B, N+1, 3); the preps are the port's batched preps."""

    def __init__(self, arch: SceneArchetype, num_pairs: int, iterations: int,
                 backend: str = "auto"):
        if backend not in ("auto", "kernel", "plain"):
            raise ValueError(f"solver_backend must be 'auto', 'kernel' or "
                             f"'plain', not {backend!r}")
        self.arch = arch
        self.num_pairs = num_pairs
        self.iterations = iterations
        self.backend = backend
        self.dynamic = arch.inv_mass.cpu().numpy() > 0.0

        order = {k: i for i, k in enumerate(joints_mod.JOINT_SOLVE_ORDER)}
        table_order = sorted(range(len(arch.joints)),
                             key=lambda k: order[arch.joints[k].kind])
        self.tables: List[_TableMeta] = []
        for k in table_order:
            t = arch.joints[k]
            self.tables.append(_table_meta(
                t.kind, k, arch.joint_color_indices[k],
                t.body_a.cpu().numpy(), t.body_b.cpu().numpy(),
                joints_mod.IMPULSE_DIMS[t.kind], JOINT_FIELDS[t.kind]))
        if num_pairs > 0:
            ia, ib = contact_bodies(arch)
            if ia.shape[0] != num_pairs:
                raise ValueError(f"{num_pairs} contact rows, archetype has "
                                 f"{ia.shape[0]}")
            a_static = bool(np.all(~self.dynamic[ia]))
            meta = _table_meta(
                "contact", -1, arch.contact_color_indices, ia, ib, 8,
                CONTACT_FIELDS + (() if a_static else CONTACT_A_FIELDS))
            meta.a_static = a_static
            meta.b_static = bool(np.all(~self.dynamic[ib]))
            self.tables.append(meta)
        self._plans: Dict[torch.device, tuple] = {}
        self._kernel_arrays: Dict[torch.device, KernelArrays] = {}

    # -- dispatch ----------------------------------------------------------

    def __call__(self, joint_preps, contact_prep, vel1, omega1):
        if self.backend == "plain":
            return self.plain(joint_preps, contact_prep, vel1, omega1)
        if vel1.is_cuda:
            return self.kernel(joint_preps, contact_prep, vel1, omega1)
        if self.backend == "kernel":
            raise RuntimeError("solver_backend='kernel' needs CUDA tensors; "
                               f"got a tensor on {vel1.device}")
        return self.plain(joint_preps, contact_prep, vel1, omega1)

    # -- plain PyTorch version ---------------------------------------------

    def _color_plans(self, device):
        if device not in self._plans:
            arch = self.arch
            joint_plans = joints_mod.color_plans_of(arch, device)
            contact_plans = []
            if self.num_pairs > 0:
                ia, ib = (torch.as_tensor(x, device=device)
                          for x in contact_bodies(arch))
                contact_plans = solver_mod.color_plans(
                    arch.contact_color_indices, ia, ib, self.dynamic)
            self._plans[device] = (joint_plans, contact_plans)
        return self._plans[device]

    def plain(self, joint_preps, contact_prep, vel1, omega1):
        """The solve as per-color PyTorch ops (the JAX fallback loop)."""
        batch = vel1.shape[0]
        joint_plans, contact_plans = self._color_plans(vel1.device)
        vel, omega = vel1.clone(), omega1.clone()
        impulses = joints_mod.init_impulses(self.arch, batch, vel1.dtype,
                                            vel1.device)
        imp_n = vel1.new_zeros((batch, self.num_pairs, 4))
        imp_t = vel1.new_zeros((batch, self.num_pairs, 4))
        for _ in range(self.iterations):
            joints_mod.solve_all_one_iteration(
                self.arch, joint_plans, joint_preps, impulses, vel, omega)
            if contact_prep is not None:
                solver_mod.solve_contacts_colored(
                    contact_prep, contact_plans, vel, omega, imp_n, imp_t)
        return vel, omega

    # -- kernel ------------------------------------------------------------

    def kernel_arrays(self, device) -> KernelArrays:
        if device not in self._kernel_arrays:
            recs, colors = [], []
            row_base = plane_base = imp_base = 0
            for m in self.tables:
                rows = m.perm.shape[0]
                rec = [0] * TABLE_INTS
                rec[T_KIND], rec[T_ROWS], rec[T_ROW_BASE] = (
                    KIND_IDS[m.kind], rows, row_base)
                rec[T_COLOR_BASE], rec[T_NUM_COLORS] = (
                    len(colors), len(m.color_bounds))
                rec[T_PLANE_BASE], rec[T_IMP_BASE] = plane_base, imp_base
                rec[T_A_STATIC], rec[T_B_STATIC] = int(m.a_static), int(m.b_static)
                rec[T_ROW_STRIDE] = m.row_stride
                recs.append(rec)
                colors += m.color_bounds
                row_base += rows
                plane_base += rows * m.row_stride
                imp_base += rows * m.imp_dim

            def i32(x):
                return torch.as_tensor(np.asarray(x, np.int32).reshape(-1),
                                       device=device)

            self._kernel_arrays[device] = KernelArrays(
                tables=i32(recs), colors=i32(colors),
                body_a=i32(np.concatenate([m.body_a for m in self.tables])),
                body_b=i32(np.concatenate([m.body_b for m in self.tables])),
                dynamic=i32(self.dynamic),
                perms=[torch.as_tensor(m.perm, device=device)
                       for m in self.tables])
        return self._kernel_arrays[device]

    @property
    def num_impulses(self) -> int:
        return sum(m.perm.shape[0] * m.imp_dim for m in self.tables)

    @property
    def planes(self) -> int:
        """Prep floats of one scene, row padding included."""
        return sum(m.perm.shape[0] * m.row_stride for m in self.tables)

    @property
    def prep_stride(self) -> int:
        """Floats per scene in the packed buffer: the planes, padded to 16
        bytes."""
        return -(-self.planes // 4) * 4

    def pack_prep(self, joint_preps, contact_prep, batch,
                  device) -> torch.Tensor:
        """Flatten the batched preps into the kernel's [scene][plane] buffer,
        rows in color order.  Returns a contiguous (B, prep_stride) tensor
        whose padding is zero."""
        perms = self.kernel_arrays(device).perms
        out = torch.zeros((batch, self.prep_stride), dtype=torch.float32,
                          device=device)
        base = 0
        for m, perm in zip(self.tables, perms):
            rows = m.perm.shape[0]
            prep = (_contact_fields(contact_prep) if m.kind == "contact"
                    else joint_preps[m.arch_index])
            block = out[:, base:base + rows * m.row_stride].view(
                batch, rows, m.row_stride)
            col = 0
            for name, n in m.fields:
                x = prep[name]
                if isinstance(x, tuple):
                    x = torch.stack(x, dim=-1)
                block[:, :, col:col + n] = x[:, perm].reshape(batch, rows, n)
                col += n
            base += rows * m.row_stride
        return out

    def kernel(self, joint_preps, contact_prep, vel1, omega1):
        batch = vel1.shape[0]
        arrays = self.kernel_arrays(vel1.device)
        prep = self.pack_prep(joint_preps, contact_prep, batch, vel1.device)
        return colored_solve_cuda(vel1.contiguous(), omega1.contiguous(), prep,
                                  arrays, len(self.tables), self.num_impulses,
                                  self.iterations)


def contact_bodies(arch: SceneArchetype):
    """(body_a, body_b) numpy arrays of every contact row, in the order of
    `collide.generate_contacts`: plane rows, then terrain rows (A the world
    slot in both), then the buckets."""
    ib = [arch.vs_plane_body.cpu().numpy(), arch.vs_terrain_body.cpu().numpy()]
    ia = [np.full_like(b, arch.world_body) for b in ib]
    for bucket in arch.contact_buckets:
        ia.append(bucket.body_a.cpu().numpy())
        ib.append(bucket.body_b.cpu().numpy())
    return np.concatenate(ia), np.concatenate(ib)


def _contact_fields(cp: solver_mod.ContactPrep) -> dict:
    return {name: getattr(cp, name)
            for name, _ in CONTACT_FIELDS + CONTACT_A_FIELDS}


def make_colored_solver(arch: SceneArchetype, num_pairs: int, iterations: int,
                        backend: str = "auto") -> ColoredSolver:
    """The archetype's solver, built once and kept in `arch.cache`."""
    key = ("colored_solver", num_pairs, iterations, backend)
    if key not in arch.cache:
        arch.cache[key] = ColoredSolver(arch, num_pairs, iterations, backend)
    return arch.cache[key]


def shared_limit(device: torch.device) -> int:
    """The shared memory one block of `device` may opt in to, in bytes."""
    return _shared_limit(device.index if device.index is not None else 0)


@functools.lru_cache(maxsize=None)
def _shared_limit(index: int) -> int:
    limit = load_library().solver_shared_limit(index)
    if limit < 0:
        raise RuntimeError(f"cannot read the shared-memory limit of "
                           f"cuda:{index}")
    return limit


def colored_solve_cuda(vel1, omega1, prep, arrays: KernelArrays,
                       num_tables: int, num_impulses: int, iterations: int,
                       team_width=None):
    """Launch the kernel on the current stream.  vel1/omega1 (B, S, 3) and
    prep (B, prep_stride) float32, contiguous, on one CUDA device;
    prep_stride a multiple of 4.  `team_width` None takes
    `pick_team_width`'s; a given width whose block does not fit raises.
    Counts its launches in `colored_solve_cuda.launches`."""
    lib = load_library()
    batch, slots = vel1.shape[0], vel1.shape[1]
    for name, x in (("vel1", vel1), ("omega1", omega1), ("prep", prep)):
        if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor "
                             f"(got {x.dtype} on {x.device})")
        if x.device != vel1.device:
            raise ValueError(f"{name} is on {x.device}, vel1 on {vel1.device}")
    if vel1.shape != (batch, slots, 3) or omega1.shape != vel1.shape:
        raise ValueError(f"vel1/omega1 must be (B, S, 3): {tuple(vel1.shape)}, "
                         f"{tuple(omega1.shape)}")
    if (prep.dim() != 2 or prep.shape[0] != batch or prep.shape[1] % 4
            or prep.data_ptr() % 16):
        raise ValueError(f"prep must be ({batch}, planes padded to a multiple "
                         f"of 4), 16-byte aligned: {tuple(prep.shape)}")
    def team_floats_of(width):
        return colored_team_floats(slots, prep.shape[1], num_impulses, width)

    limit = shared_limit(vel1.device)
    if team_width is None:
        team_width = pick_team_width(team_floats_of, limit)
    if team_width not in TEAM_WIDTHS:
        raise ValueError(f"team_width must be one of {TEAM_WIDTHS}, not "
                         f"{team_width}")
    need = block_shared_bytes(team_floats_of(team_width), team_width)
    if need > limit:
        raise ValueError(f"the scene needs {need} bytes of shared memory per "
                         f"block at team width {team_width}; the device "
                         f"allows {limit}")
    vel_out = torch.empty_like(vel1)
    omega_out = torch.empty_like(omega1)
    if batch == 0:
        return vel_out, omega_out
    err = lib.colored_solver_launch(
        vel1.data_ptr(), omega1.data_ptr(), vel_out.data_ptr(),
        omega_out.data_ptr(), prep.data_ptr(), prep.shape[1],
        arrays.tables.data_ptr(), num_tables, arrays.colors.data_ptr(),
        arrays.body_a.data_ptr(), arrays.body_b.data_ptr(),
        arrays.dynamic.data_ptr(), slots, num_impulses, batch, iterations,
        team_width, vel1.device.index if vel1.device.index is not None else 0,
        torch.cuda.current_stream(vel1.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"colored solver launch failed: CUDA error {err}")
    colored_solve_cuda.launches += 1
    return vel_out, omega_out


colored_solve_cuda.launches = 0
