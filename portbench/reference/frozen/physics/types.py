"""Core physics data structures (counterpart of
the JAX package's ``physics/types.py``).

A scene is compiled once into fixed-shape structure-of-arrays tables
(`SceneArchetype`, shared by every scene of a batch); the dynamic state is a
`BodyState` whose tensors carry a leading batch axis ``(B, N, k)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

import torch

SHAPE_SPHERE = 0
SHAPE_CAPSULE = 1
SHAPE_BOX = 2
SHAPE_CYLINDER = 3
SHAPE_HULL = 4
# Vertices of a hull collider's table row (the JAX package's).
MAX_HULL_VERTS = 32

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

    def replace(self, **kw) -> "BodyState":
        return replace(self, **kw)


@dataclass
class ContactBucket:
    """Static candidate-pair table of one (type_a, type_b) narrowphase, with
    type_a <= type_b.  Pairs are enumerated when the scene is compiled; at
    run time the manifolds' masks say which of them touch."""

    collider_a: torch.Tensor  # (P,) int64
    collider_b: torch.Tensor  # (P,) int64
    body_a: torch.Tensor      # (P,) int64
    body_b: torch.Tensor      # (P,) int64
    color: torch.Tensor       # (P,) int64 solver color
    valid: torch.Tensor       # (P,) bool
    type_a: int
    type_b: int
    num_colors: int


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
    """Compiled static scene: the fields of the JAX archetype (plane and
    terrain rows, static pair buckets, hull tables, force fields, triggers
    and the runtime broadphase's settings).  Body tables have N+1 rows; the
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
    col_hull_verts: torch.Tensor    # (C, MAX_HULL_VERTS, 3)
    col_hull_mask: torch.Tensor     # (C, MAX_HULL_VERTS) bool

    plane_normal: torch.Tensor      # (G, 3)
    plane_offset: torch.Tensor      # (G,)
    plane_friction: torch.Tensor    # (G,)
    plane_restitution: torch.Tensor # (G,)

    vs_plane_collider: torch.Tensor # (Q,) int64
    vs_plane_plane: torch.Tensor    # (Q,) int64
    vs_plane_body: torch.Tensor     # (Q,) int64
    vs_plane_color: torch.Tensor    # (Q,) int64
    vs_plane_valid: torch.Tensor    # (Q,) bool

    # Heightfield terrains (one grid resolution for all) and the
    # (dynamic collider, terrain) rows, sorted by collider type.
    terrain_height: torch.Tensor        # (T, R0, R1)
    terrain_origin: torch.Tensor        # (T, 3)
    terrain_cell: torch.Tensor          # (T,)
    terrain_friction: torch.Tensor      # (T,)
    terrain_restitution: torch.Tensor   # (T,)
    vs_terrain_collider: torch.Tensor   # (Q2,) int64
    vs_terrain_terrain: torch.Tensor    # (Q2,) int64
    vs_terrain_body: torch.Tensor       # (Q2,) int64
    vs_terrain_valid: torch.Tensor      # (Q2,) bool
    # Spherical force fields and trigger volumes (physics/events.py).
    ff_center: torch.Tensor             # (F, 3)
    ff_radius: torch.Tensor             # (F,)
    ff_force: torch.Tensor              # (F, 3)
    trigger_center: torch.Tensor        # (TR, 3)
    trigger_radius: torch.Tensor        # (TR,)

    contact_buckets: Tuple[ContactBucket, ...]
    joints: Tuple[JointTable, ...]
    # Per-color row indices into the contact table: plane rows first, then
    # terrain rows, then the buckets in order.  Rows of one color share no
    # dynamic body.
    contact_color_indices: Tuple[torch.Tensor, ...]
    joint_color_indices: Tuple[Tuple[torch.Tensor, ...], ...]

    num_bodies: int
    num_colliders: int
    num_planes: int
    num_terrains: int
    # Colors of the whole contact table (plane, terrain and bucket rows).
    vs_plane_num_colors: int
    # Static (shape_type, start, end) runs of the type-sorted plane and
    # terrain rows.
    vs_plane_segments: Tuple[Tuple[int, int, int], ...] = ()
    vs_terrain_segments: Tuple[Tuple[int, int, int], ...] = ()

    # Runtime broadphase (physics/broadphase.py), as in the JAX archetype.
    # sap_neighbors 0: collider pairs come from the static buckets only;
    # > 0: from the sweep (window of sap_neighbors sorted neighbours, at
    # most sap_row_cap partners per collider) or the dense AABB test each
    # substep, compacted to sap_max_contacts candidate rows and then to
    # sap_active_budget active rows (0: no compaction).  Such scenes need
    # contact_mode "split_jacobi" or "runtime_gs".
    sap_neighbors: int = 0
    sap_max_contacts: int = 0
    sap_row_cap: int = 16
    sap_mode: str = "sweep"
    sap_active_budget: int = 0
    # The (type_a, type_b) combos present among the colliders, type_a <= type_b.
    sap_type_pairs: Tuple[Tuple[int, int], ...] = ()
    # (C, C) upper-triangular pair admissibility for the dense test (empty
    # for static scenes); the sweep reads the per-body attributes instead.
    sap_collidable: Optional[torch.Tensor] = None   # (C, C) bool
    sap_body_kinematic: Optional[torch.Tensor] = None  # (N,) bool
    sap_body_group: Optional[torch.Tensor] = None   # (N,) int64, -1 = none
    sap_joint_excl: Optional[torch.Tensor] = None   # (E, 2) body pairs, lo < hi
    # True: box and hull rows collide against the heightfield's triangles
    # (min-max mip descent, physics/heightmap_collision.py); False: against
    # the bilinear tangent plane under the collider.
    terrain_tri_exact: bool = False
    # Derived static data (solver metadata, device index arrays), built on
    # first use and kept for the archetype's life.
    cache: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def world_body(self) -> int:
        return self.num_bodies

    @property
    def num_contact_rows(self) -> int:
        """Rows of the contact table: plane rows, terrain rows, then bucket
        rows."""
        return (int(self.vs_plane_collider.shape[0])
                + int(self.vs_terrain_collider.shape[0])
                + sum(int(b.collider_a.shape[0])
                      for b in self.contact_buckets))


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
    device; it also keeps the fused kernel out).  `contact_mode` takes
    "colored" (the static colors' Gauss-Seidel solve), "split_jacobi"
    (mass-splitting Jacobi) or "runtime_gs" (Gauss-Seidel over colors found
    each substep, `runtime_gs_colors` of them).  `jacobi_matmul_threshold`
    is accepted and has no effect: the JAX package switches its Jacobi
    gather / scatter to one-hot matmuls above it because XLA's TPU
    scatter-add serialises; the port always gathers and scatter-adds."""

    frame_rate: int = 120
    max_substeps: int = 4
    solver_iterations: int = 30
    contact_mode: str = "colored"
    jacobi_matmul_threshold: int = 256 * 1024
    runtime_gs_colors: int = 32
    solver_backend: str = "auto"
    global_force_field: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    fused_substep: str = "auto"
