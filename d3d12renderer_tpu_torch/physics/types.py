"""Core physics data structures (counterpart of
``d3d12renderer_tpu/physics/types.py``).

A scene is compiled once into fixed-shape structure-of-arrays tables
(`SceneArchetype`, shared by every scene of a batch); the dynamic state is a
`BodyState` whose tensors carry a leading batch axis ``(B, N, k)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Tuple

import torch

SHAPE_SPHERE = 0
SHAPE_CAPSULE = 1
SHAPE_BOX = 2
SHAPE_CYLINDER = 3
SHAPE_HULL = 4

SHAPE_NAMES = {
    SHAPE_SPHERE: "sphere",
    SHAPE_CAPSULE: "capsule",
    SHAPE_BOX: "box",
    SHAPE_CYLINDER: "cylinder",
    SHAPE_HULL: "hull",
}

MAX_CONTACT_POINTS = 4


@dataclass
class BodyState:
    """Dynamic rigid-body state, every tensor shaped (B, N, k)."""

    pos: torch.Tensor       # (B, N, 3) centre-of-gravity position
    rot: torch.Tensor       # (B, N, 4) orientation (x, y, z, w)
    vel: torch.Tensor       # (B, N, 3) linear velocity
    omega: torch.Tensor     # (B, N, 3) angular velocity
    force: torch.Tensor     # (B, N, 3) per-step force accumulator
    torque: torch.Tensor    # (B, N, 3) per-step torque accumulator

    @property
    def num_bodies(self):
        return self.pos.shape[-2]

    def replace(self, **kw) -> "BodyState":
        return replace(self, **kw)


@dataclass
class JointTable:
    """Static per-kind joint table; `params` entries are (J, ...) tensors."""

    body_a: torch.Tensor      # (J,) int64
    body_b: torch.Tensor      # (J,) int64
    color: torch.Tensor       # (J,) int64
    valid: torch.Tensor       # (J,) bool
    params: Dict[str, torch.Tensor]
    kind: str
    num_colors: int


@dataclass
class SceneArchetype:
    """Compiled static scene: the fields of the JAX archetype that the
    plane-contact, colored-solver path reads.  Body tables have N+1 rows; the
    last one is the static world body."""

    inv_mass: torch.Tensor          # (N+1,)
    inv_inertia: torch.Tensor       # (N+1, 3, 3) local inverse inertia
    gravity_factor: torch.Tensor    # (N+1,)
    linear_damping: torch.Tensor    # (N+1,)
    angular_damping: torch.Tensor   # (N+1,)
    local_cog: torch.Tensor         # (N+1, 3)

    col_body: torch.Tensor          # (C,) int64
    col_type: torch.Tensor          # (C,) int64
    col_local_pos: torch.Tensor     # (C, 3)
    col_local_rot: torch.Tensor     # (C, 4)
    col_size: torch.Tensor          # (C, 3)
    col_friction: torch.Tensor      # (C,)
    col_restitution: torch.Tensor   # (C,)
    col_bound_radius: torch.Tensor  # (C,)

    plane_normal: torch.Tensor      # (G, 3)
    plane_offset: torch.Tensor      # (G,)
    plane_friction: torch.Tensor    # (G,)
    plane_restitution: torch.Tensor # (G,)

    vs_plane_collider: torch.Tensor # (Q,) int64
    vs_plane_plane: torch.Tensor    # (Q,) int64
    vs_plane_body: torch.Tensor     # (Q,) int64
    vs_plane_color: torch.Tensor    # (Q,) int64
    vs_plane_valid: torch.Tensor    # (Q,) bool

    joints: Tuple[JointTable, ...]
    # Per-color row indices into the contact table (plane rows only here).
    contact_color_indices: Tuple[torch.Tensor, ...]
    joint_color_indices: Tuple[Tuple[torch.Tensor, ...], ...]

    num_bodies: int
    num_colliders: int
    num_planes: int
    vs_plane_num_colors: int
    # Static (shape_type, start, end) runs of the type-sorted plane rows.
    vs_plane_segments: Tuple[Tuple[int, int, int], ...] = ()
    # Derived static data (solver metadata, device index arrays), built on
    # first use and kept for the archetype's life.
    cache: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def world_body(self) -> int:
        return self.num_bodies


@dataclass(frozen=True)
class PhysicsSettings:
    """Same fields and defaults as the JAX `PhysicsSettings`.

    `fused_substep` takes "auto" (the fused whole-substep CUDA kernel for
    supported archetypes on CUDA tensors, the unfused step otherwise),
    "force" (as "auto", and on CPU tensors the fused route's plain version,
    the unfused step) or "off" (always the unfused step).  `solver_backend`
    picks the unfused step's solve: "auto" (the CUDA kernel for CUDA
    tensors, the plain PyTorch solve for CPU tensors), "kernel" (the CUDA
    kernel; raises on CPU tensors) or "plain" (the plain PyTorch solve on any
    device; it also keeps the fused kernel out).  Only
    `contact_mode="colored"` is ported; the step raises
    `NotImplementedError` for the others."""

    frame_rate: int = 120
    max_substeps: int = 4
    solver_iterations: int = 30
    contact_mode: str = "colored"
    jacobi_matmul_threshold: int = 256 * 1024
    runtime_gs_colors: int = 32
    solver_backend: str = "auto"
    global_force_field: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    fused_substep: str = "auto"
