"""The game frame's check (the flythrough's rigid-body pile under the 1080p
raster frame), recomputed by a plain reference that imports nothing of
the program:

* physics: one 60 Hz frame (two 120 Hz substeps, 30 colored
  sequential-impulse iterations) of the pile from the program's own
  pre-frame body state: plane rows and the pair buckets' manifolds
  (sphere-sphere, sphere-box, box-box, `frozen/physics/pair_narrow.py`),
  the solve color by color in the builder's order (the order of the
  program's colored-solver kernel), semi-implicit Euler;
* render: the frame from the program's own posed triangles, its frame
  state before the frame, its camera, previous camera and jitter, and its
  cascades, through the frozen raster pipeline with the point light added
  (the Forward+ tile lists of the program cull nothing a light reaches, so
  the reference sums every light at every pixel);
* cascades: a grid of each cascade's texels traced again by
  Moller-Trumbore against every posed triangle (`raster.texel_depths`).

The pile (`add_pile`) is examples/flythrough.py's, the bodies' x and z
drawn by numpy's `default_rng(seed)`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .frozen.core import maths as m
from .frozen.physics import builder as builder_mod
from .frozen.physics import collide, pair_narrow
from .frozen.physics import step as step_mod
from .frozen.physics.narrow import ContactTable, combine_materials
from .frozen.physics.types import (SHAPE_BOX, SHAPE_SPHERE, BodyState,
                                   PhysicsSettings)
from .frozen.render import pipeline
from .frozen.render.camera import Camera
from .frozen.render.shadows import SunShadowMaps
from .pathtrace import _default_dtype
from .raster import FRAME_STATE_FIELDS, SHADOW_FIELDS

BODY_FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")
# The posed BVH's arrays the frame is rendered from.
TRIANGLE_FIELDS = ("tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1",
                   "tri_n2", "tri_uv0", "tri_uv1", "tri_uv2", "tri_material",
                   "tri_valid")


# --------------------------------------------------------------------------
# Physics
# --------------------------------------------------------------------------

class PileBuilder(builder_mod.SceneBuilder):
    """The frozen builder with sphere colliders and every collider pair of
    bodies that may touch as a bucket row, by (type_a, type_b), type_a <=
    type_b (the program's rule for a scene without joints)."""

    def add_sphere_collider(self, body, radius, center=(0, 0, 0),
                            density=1000.0, friction=0.5, restitution=0.0):
        return self._add_collider(body, SHAPE_SPHERE, center,
                                  builder_mod._IDENTITY_QUAT,
                                  (radius, 0, 0), density, friction,
                                  restitution)

    def _pair_rows(self):
        by_type = {}
        c = len(self.colliders)
        for i in range(c):
            for j in range(i + 1, c):
                ci, cj = self.colliders[i], self.colliders[j]
                if not self._collides(ci.body, cj.body):
                    continue
                a, b, ta, tb = i, j, ci.shape, cj.shape
                if ta > tb:
                    a, b, ta, tb = b, a, tb, ta
                by_type.setdefault((ta, tb), []).append(
                    (a, b, self.colliders[a].body, self.colliders[b].body))
        return by_type


def add_pile(b: PileBuilder, pile: dict, seed: int):
    """examples/flythrough.py's pile as the configuration's "pile" gives
    it: a plane, `bodies` bodies at heights first_height + spacing i over a
    square of half-side `spread` (x, z from `default_rng(seed)`), every
    `sphere_every`-th (from 0) a sphere, the others boxes."""
    b.add_static_plane((0, 1, 0), 0.0, friction=pile["plane_friction"])
    rng = np.random.default_rng(seed)
    for i in range(pile["bodies"]):
        pos = (float(rng.uniform(-pile["spread"], pile["spread"])),
               pile["first_height"] + pile["spacing"] * i,
               float(rng.uniform(-pile["spread"], pile["spread"])))
        body = b.add_body(position=pos)
        if i % pile["sphere_every"]:
            b.add_box_collider(body, (pile["box_half"],) * 3,
                               friction=pile["box_friction"])
        else:
            b.add_sphere_collider(body, radius=pile["sphere_radius"],
                                  restitution=pile["sphere_restitution"])


def pile_archetype(config: dict, seed: int, device):
    b = PileBuilder()
    add_pile(b, config["pile"], seed)
    arch, _ = b.finalize(device=device)
    return arch


def _pair_manifolds(arch, bucket, wpos, wrot) -> ContactTable:
    ia, ib = bucket.collider_a, bucket.collider_b
    pa, ra, pb, rb = wpos[:, ia], wrot[:, ia], wpos[:, ib], wrot[:, ib]
    sa = arch.col_size[ia].expand(pa.shape)
    sb = arch.col_size[ib].expand(pb.shape)
    kind = (bucket.type_a, bucket.type_b)
    if kind == (SHAPE_SPHERE, SHAPE_SPHERE):
        out = pair_narrow.sphere_vs_sphere(pa, sa[..., 0], pb, sb[..., 0])
    elif kind == (SHAPE_SPHERE, SHAPE_BOX):
        out = pair_narrow.sphere_vs_box(pa, sa[..., 0], pb, rb, sb)
    elif kind == (SHAPE_BOX, SHAPE_BOX):
        out = pair_narrow.box_vs_box(pa, ra, sa, pb, rb, sb)
    else:
        raise NotImplementedError(f"the reference's pair narrowphase has no "
                                  f"{kind} pairs")
    normal, pts, dep, msk = out
    pts, dep, msk = collide._pad4(pts, dep, msk)
    msk = msk & bucket.valid[:, None]
    friction, restitution = combine_materials(
        arch.col_friction[ia], arch.col_friction[ib],
        arch.col_restitution[ia], arch.col_restitution[ib])
    return ContactTable(
        body_a=bucket.body_a, body_b=bucket.body_b, normal=normal, point=pts,
        depth=dep, pmask=msk, friction=friction.expand(dep.shape[:-1]),
        restitution=restitution.expand(dep.shape[:-1]),
        active=torch.any(msk, dim=-1))


def generate_contacts(arch, state: BodyState) -> ContactTable:
    """Plane rows, then the buckets in order: the builder's row order."""
    wpos, wrot = collide.collider_world_poses(arch, state)
    tables = [collide._vs_plane_manifolds(arch, wpos, wrot)]
    tables += [_pair_manifolds(arch, bucket, wpos, wrot)
               for bucket in arch.contact_buckets]

    def cat(attr, dim):
        return torch.cat([getattr(t, attr) for t in tables], dim=dim)

    return ContactTable(
        body_a=cat("body_a", -1), body_b=cat("body_b", -1),
        normal=cat("normal", -2), point=cat("point", -3),
        depth=cat("depth", -2), pmask=cat("pmask", -2),
        friction=cat("friction", -1), restitution=cat("restitution", -1),
        active=cat("active", -1))


def physics_substep(arch, state: BodyState, dt: float,
                    settings: PhysicsSettings):
    """One substep: contacts from the pre-integration poses, gravity and
    damping, the contact prep, `settings.solver_iterations` colored
    sweeps, semi-implicit Euler.  (new state, contacts)."""
    n = arch.num_bodies
    contacts = generate_contacts(arch, state)
    vel, omega, ii_w = step_mod.integrate_forces(
        arch, state.pos, state.rot, state.vel, state.omega, state.force,
        state.torque, dt, settings.global_force_field)
    pos1 = step_mod._append_world(state.pos)
    vel1 = step_mod._append_world(vel)
    omega1 = step_mod._append_world(omega)
    ii_w1 = step_mod._append_world(ii_w)
    prep = step_mod.solver.prep_contacts_full(
        contacts, pos1, arch.inv_mass, ii_w1, vel1, omega1, dt)
    rot1 = step_mod._append_world(state.rot)
    rot1[:, -1, 3] = 1.0
    ctx = step_mod.joints_mod.JointContext(
        pos1=pos1, rot1=rot1, inv_mass1=arch.inv_mass, ii_w1=ii_w1,
        local_cog1=arch.local_cog, dt=dt)
    joint_preps = step_mod.joints_mod.prep_all(arch, ctx, None)
    vel1, omega1 = step_mod.colored_solve(
        arch, contacts.body_a.shape[0], settings.solver_iterations,
        joint_preps, prep, vel1, omega1)
    vel, omega = vel1[:, :n], omega1[:, :n]
    pos, rot = step_mod.integrate_velocities(state.pos, state.rot, vel,
                                             omega, dt)
    return state.replace(pos=pos, rot=rot, vel=vel, omega=omega,
                         force=torch.zeros_like(state.force),
                         torque=torch.zeros_like(state.torque)), contacts


def physics_frame(arch, bodies: dict, config: dict):
    """One physics frame of the configuration's `physics` from the body
    state `bodies` (tensors by name, batch 1): (state, the last substep's
    contacts)."""
    phys = config["physics"]
    settings = PhysicsSettings(frame_rate=phys["substep_hz"],
                               solver_iterations=phys["solver_iterations"])
    state = BodyState(**{k: bodies[k].float() for k in BODY_FIELDS})
    contacts = None
    with torch.no_grad():
        for _ in range(phys["substeps"]):
            state, contacts = physics_substep(arch, state,
                                              1.0 / phys["substep_hz"],
                                              settings)
    return state, contacts


def body_gaps(got: dict, ref: BodyState) -> dict:
    """`pose_gap`: the largest difference of a position (m) or rotation
    component; `vel_gap`: of a linear (m/s) or angular (rad/s) velocity
    component.  Non-finite differences count as 1e30."""
    def worst(fields):
        out = 0.0
        for f in fields:
            d = (got[f].float() - getattr(ref, f)).abs()
            d = torch.where(torch.isfinite(d), d, torch.full_like(d, 1e30))
            out = max(out, float(d.max()))
        return out

    return {"pose_gap": worst(("pos", "rot")),
            "vel_gap": worst(("vel", "omega"))}


# --------------------------------------------------------------------------
# Render
# --------------------------------------------------------------------------

class PosedScene:
    """The program's posed triangles (`TRIANGLE_FIELDS` by name) with the
    configuration's materials, sky and point lights, in the shape the
    frozen raster pipeline and `raster.texel_depths` read."""

    def __init__(self, config: dict, triangles: dict):
        dev = triangles["tri_v0"].device
        self.tri = {"v0": triangles["tri_v0"].float(),
                    "e1": triangles["tri_e1"].float(),
                    "e2": triangles["tri_e2"].float()}
        for k in ("n0", "n1", "n2", "uv0", "uv1", "uv2"):
            self.tri[k] = triangles[f"tri_{k}"].float()
        self.mat = triangles["tri_material"].to(torch.int64)
        self.valid = triangles["tri_valid"].to(torch.bool)
        self.num_tris = int(self.mat.shape[0])

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=dev)

        mats = config["materials"]
        self.albedo = f32(mats["albedo"])
        self.roughness = f32(mats["roughness"])
        self.metallic = f32(mats["metallic"])
        self.emissive = torch.zeros_like(self.albedo)
        sky = config["sky"]
        sun = np.asarray(sky["sun_direction"], np.float64)
        self.sun_direction = f32((sun / np.linalg.norm(sun)).astype(np.float32))
        self.sun_radiance = f32(sky["sun_radiance"])
        self.zenith = f32(sky["zenith"])
        self.horizon = f32(sky["horizon"])
        self.ground = f32(sky["ground"])
        light = config["point_light"]
        self.light_position = f32(light["positions"])
        self.light_color = f32(light["colors"])
        self.light_radius = f32(light["radii"])
        self.width, self.height = config["width"], config["height"]

    @property
    def tri_v0(self):
        return self.tri["v0"]

    @property
    def tri_e1(self):
        return self.tri["e1"]

    @property
    def tri_e2(self):
        return self.tri["e2"]

    @property
    def tri_valid(self):
        return self.valid

    def lowered(self, dtype):
        """Every float table of the scene in `dtype` (the control)."""
        for name in ("albedo", "roughness", "metallic", "emissive",
                     "sun_direction", "sun_radiance", "zenith", "horizon",
                     "ground", "light_position", "light_color",
                     "light_radius"):
            setattr(self, name, getattr(self, name).to(dtype))
        self.tri = {k: v.to(dtype) for k, v in self.tri.items()}
        return self


def point_lights(scene: PosedScene, gb, camera: Camera):
    """Every point light at every surface pixel: the GGX + Lambert BRDF
    times n.l, the light's colour and the windowed inverse-square falloff
    clip(1 - (d / r)^4, 0, 1)^2 / (d^2 + 0.01)."""
    v = m.noz(camera.position - gb.world_pos)
    total = torch.zeros_like(gb.world_pos)
    for i in range(scene.light_position.shape[0]):
        to_l = scene.light_position[i] - gb.world_pos
        dist = torch.linalg.norm(to_l + 1e-9, dim=-1)
        ldir = to_l / dist[..., None]
        x = dist / scene.light_radius[i]
        x2 = x * x
        f = torch.clamp(1.0 - x2 * x2, 0.0, 1.0)
        att = f * f / (dist * dist + 1e-2)
        brdf = pipeline.eval_brdf_pixel(gb.normal, v, ldir, gb.albedo,
                                        gb.roughness, gb.metallic)
        total = total + torch.where(
            gb.hit[..., None], brdf * scene.light_color[i] * att[..., None],
            0.0)
    return total


def settings(config: dict):
    r = config["raster"]
    return pipeline.RendererSettings(primary=r["primary"],
                                     half_res_effects=r["half_res_effects"])


def _camera(view: dict, config: dict) -> Camera:
    return Camera(position=view["position"], rotation=view["rotation"],
                  v_fov=math.radians(config["camera"]["v_fov_deg"]),
                  aspect=config["width"] / config["height"])


@dataclass
class FrameInputs:
    """What the program held before a checked frame, by name."""

    triangles: dict          # TRIANGLE_FIELDS, posed for the frame
    state: dict              # FRAME_STATE_FIELDS before the frame
    shadow_maps: dict        # SHADOW_FIELDS, the frame's cascades
    camera: dict             # position, rotation
    prev_camera: dict
    jitter: torch.Tensor


def frame(scene: PosedScene, config: dict, inputs: FrameInputs,
          dtype=torch.float32):
    """The reference's LDR frame (H, W, 3) from the program's inputs, in
    `dtype`: the frozen pipeline's stages with the point lights added
    after the opaque pass, as the program adds them."""
    def low(x):
        return x.to(dtype) if x.is_floating_point() else x

    maps = SunShadowMaps(**{k: low(inputs.shadow_maps[k])
                            for k in SHADOW_FIELDS})
    fs = pipeline.FrameState(**{k: low(inputs.state[k])
                                for k in FRAME_STATE_FIELDS})
    # The cameras stay in float32, as the raster check's reference keeps
    # its camera.
    cam = _camera(inputs.camera, config)
    prev = _camera(inputs.prev_camera, config)
    rs = settings(config)
    w, h = scene.width, scene.height
    with torch.no_grad(), _default_dtype(dtype):
        gb = pipeline.render_gbuffer(scene, cam, w, h, prev_camera=prev,
                                     jitter=inputs.jitter.to(torch.float32))
        half = (pipeline._HalfRes.of(gb, fs) if rs.half_res_effects
                else None)
        lit, ao, updates = pipeline._effects(scene, cam, gb, maps, fs, half,
                                             rs, w, h)
        color = pipeline._opaque(scene, cam, gb, lit, ao, rs)
        color = color + point_lights(scene, gb, cam)
        color, ssr_updates = pipeline._reflections(cam, color, gb, fs, half,
                                                   rs)
        updates.update(ssr_updates)
        color = pipeline._compose(scene, cam, color, gb, w, h)
        color, _ = pipeline._taa(color, gb, fs, updates, rs)
        ldr = pipeline._post(color, rs)
    return ldr.float()


def camera_fields(camera) -> dict:
    return {"position": camera.position.clone(),
            "rotation": camera.rotation.clone()}


def lowered_bodies(bodies: dict, dtype) -> dict:
    """The body state rounded to `dtype` (the control's physics input)."""
    return {k: v.to(dtype).float() for k, v in bodies.items()}


def contact_rows(contacts: Optional[ContactTable]) -> int:
    return 0 if contacts is None else int(contacts.active.sum())
