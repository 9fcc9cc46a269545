"""Whole-loop colored solver: the `iterations`-long sequential-impulse solve
(joint tables in `JOINT_SOLVE_ORDER`, then contact rows color by color) as
one CUDA kernel, `csrc/colored_solver.cu` (row solves in
`csrc/solver_rows.cuh`).

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

The kernel library (this solver and the fused whole-substep kernel of
`substep_cuda.py`) is compiled with one nvcc call at first use from the
package's `csrc/*.cu` and `csrc/*.cuh` into
`build/torch_kernels/<source hash>/` and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import joints as joints_mod
from . import solver as solver_mod
from .types import SceneArchetype

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I",
              "csrc")
LIBRARY_NAME = "libd3d12_torch_kernels.so"

# --------------------------------------------------------------------------
# Packed prep layout.  Each table's prep is one block of scalar planes
# [field component][row][scene], scenes innermost so that neighbouring
# threads read neighbouring addresses.  The offsets below are mirrored by the
# constants of csrc/solver_rows.cuh (a CPU test holds the two together).
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
# Contact rows: B side always; the A side only when A is dynamic somewhere.
CONTACT_FIELDS = (
    ("normal", 3), ("friction", 1), ("inv_mass_b", 1), ("r_b", 12),
    ("tangent", 12), ("bias", 4), ("eff_mass_n", 4), ("eff_mass_t", 4),
    ("n_to_wb", 12), ("t_to_wb", 12), ("pmask", 4))
CONTACT_A_FIELDS = (("inv_mass_a", 1), ("r_a", 12), ("n_to_wa", 12),
                    ("t_to_wa", 12))

KIND_IDS = {"hinge": 0, "cone_twist": 1, "contact": 2, "distance": 3,
            "ball": 4, "fixed": 5}
JOINT_FIELDS = {"distance": DISTANCE_FIELDS, "ball": BALL_FIELDS,
                "fixed": FIXED_FIELDS, "hinge": HINGE_FIELDS,
                "cone_twist": CONE_TWIST_FIELDS}
# Per-table record of the kernel's `tables` array.
(T_KIND, T_ROWS, T_ROW_BASE, T_COLOR_BASE, T_NUM_COLORS, T_PLANE_BASE,
 T_IMP_BASE, T_A_STATIC, T_B_STATIC, TABLE_INTS) = range(10)


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
            if t.kind not in JOINT_FIELDS:
                raise NotImplementedError(
                    f"{t.kind} rows are not ported yet (ROADMAP.md Queue 1: "
                    "slider rows and preps)")
            self.tables.append(_table_meta(
                t.kind, k, arch.joint_color_indices[k],
                t.body_a.cpu().numpy(), t.body_b.cpu().numpy(),
                joints_mod.IMPULSE_DIMS[t.kind], JOINT_FIELDS[t.kind]))
        if num_pairs > 0:
            ib = arch.vs_plane_body.cpu().numpy()
            ia = np.full_like(ib, arch.world_body)
            if ia.shape[0] != num_pairs:
                raise ValueError(f"{num_pairs} contact rows, archetype has "
                                 f"{ia.shape[0]} plane rows")
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
            joint_plans = tuple(
                solver_mod.color_plans(arch.joint_color_indices[k],
                                       t.body_a.to(device), t.body_b.to(device),
                                       self.dynamic)
                for k, t in enumerate(arch.joints))
            contact_plans = []
            if self.num_pairs > 0:
                ib = arch.vs_plane_body.to(device)
                contact_plans = solver_mod.color_plans(
                    arch.contact_color_indices,
                    torch.full_like(ib, arch.world_body), ib, self.dynamic)
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
                recs.append(rec)
                colors += m.color_bounds
                row_base += rows
                plane_base += rows * sum(n for _, n in m.fields)
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

    def pack_prep(self, joint_preps, contact_prep, batch,
                  device) -> torch.Tensor:
        """Flatten the batched preps into the kernel's [plane][scene] buffer,
        rows in color order.  Returns a contiguous (planes, B) tensor."""
        perms = self.kernel_arrays(device).perms
        planes = []
        for m, perm in zip(self.tables, perms):
            rows = m.perm.shape[0]
            prep = (_contact_fields(contact_prep) if m.kind == "contact"
                    else joint_preps[m.arch_index])
            for name, n in m.fields:
                x = prep[name]
                if isinstance(x, tuple):
                    x = torch.stack(x, dim=-1)
                x = x[:, perm].to(torch.float32).reshape(batch, rows, n)
                planes.append(x.permute(2, 1, 0).reshape(n * rows, batch))
        return torch.cat(planes, dim=0)

    def kernel(self, joint_preps, contact_prep, vel1, omega1):
        batch = vel1.shape[0]
        arrays = self.kernel_arrays(vel1.device)
        prep = self.pack_prep(joint_preps, contact_prep, batch, vel1.device)
        return colored_solve_cuda(vel1.contiguous(), omega1.contiguous(), prep,
                                  arrays, len(self.tables), self.num_impulses,
                                  self.iterations)


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


# --------------------------------------------------------------------------
# Build and bind
# --------------------------------------------------------------------------

def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def build_dir() -> Path:
    """`BUILD_DIR/<hash>`: the hash covers the flags and every csrc/*.cu and
    csrc/*.cuh, so an edit to a shared header rebuilds the library."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / digest.hexdigest()[:16]


def build_library() -> Path:
    """Compile csrc/*.cu (one nvcc call, one library) unless a build of the
    same sources and flags exists.  Raises if nvcc fails; the compiler's
    output (ptxas register and spill counts included) is kept in build.log."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    out_dir = build_dir()
    lib = out_dir / LIBRARY_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIBRARY_NAME}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           *map(str, sources)],
                          capture_output=True, text=True, cwd=CSRC_DIR.parent)
    (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (rc={proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


_library: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library once per process;
    binds the entry points of both kernels."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build_library()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.colored_solver_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr,          # vel/omega in, out; prep
            ptr, i32, ptr, ptr, ptr, ptr,     # tables, count, colors, a, b, dyn
            i32, i32, i32, i32, i32, ptr]     # slots, imps, B, iters, dev, stream
        lib.colored_solver_launch.restype = i32
        lib.colored_solver_max_slots.restype = i32
        lib.colored_solver_max_impulses.restype = i32
        # The fused whole-substep kernel (substep_cuda.py): a FusedArgs
        # struct by address, the device and the stream.
        lib.fused_substep_launch.argtypes = [ptr, i32, ptr]
        lib.fused_substep_launch.restype = i32
        lib.fused_substep_max_bodies.restype = i32
        lib.fused_substep_args_size.restype = i32
        _library = lib
    return _library


def colored_solve_cuda(vel1, omega1, prep, arrays: KernelArrays,
                       num_tables: int, num_impulses: int, iterations: int):
    """Launch the kernel on the current stream.  vel1/omega1 (B, S, 3) and
    prep (planes, B) float32, contiguous, on one CUDA device.  Counts its
    launches in `colored_solve_cuda.launches`."""
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
    if prep.dim() != 2 or prep.shape[1] != batch:
        raise ValueError(f"prep must be (planes, {batch}): {tuple(prep.shape)}")
    if slots > lib.colored_solver_max_slots():
        raise ValueError(f"{slots} body slots > kernel limit "
                         f"{lib.colored_solver_max_slots()}")
    if num_impulses > lib.colored_solver_max_impulses():
        raise ValueError(f"{num_impulses} impulses > kernel limit "
                         f"{lib.colored_solver_max_impulses()}")
    vel_out = torch.empty_like(vel1)
    omega_out = torch.empty_like(omega1)
    if batch == 0:
        return vel_out, omega_out
    err = lib.colored_solver_launch(
        vel1.data_ptr(), omega1.data_ptr(), vel_out.data_ptr(),
        omega_out.data_ptr(), prep.data_ptr(),
        arrays.tables.data_ptr(), num_tables, arrays.colors.data_ptr(),
        arrays.body_a.data_ptr(), arrays.body_b.data_ptr(),
        arrays.dynamic.data_ptr(), slots, num_impulses, batch, iterations,
        vel1.device.index if vel1.device.index is not None else 0,
        torch.cuda.current_stream(vel1.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"colored solver launch failed: CUDA error {err}")
    colored_solve_cuda.launches += 1
    return vel_out, omega_out


colored_solve_cuda.launches = 0
