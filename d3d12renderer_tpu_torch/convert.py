"""Carry weights and states between the JAX package and the port through
numpy (neither side's tensors cross over)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .cuda_build import resolve_device
from .learning.loco_env import EnvState
from .learning.monitor import EpisodeStats
from .learning.networks import ActorCritic
from .learning.ppo import AdamState, TrainState
from .physics.types import BodyState, SceneArchetype
from .render import bvh as bvh_mod
from .render.camera import Camera
from .render.decals import Decals
from .render.light_probe import LightProbeGrid
from .render.lights import PointLights, SpotLights
from .render.pathtracer import Materials, Sky
from .render.pipeline import FrameState
from .render.shadows import PointShadowMap, SpotShadowMap, SunShadowMaps
from .render.transparent import TransparentObject

_DENSE = ("pi_0", "pi_1", "action_head", "vf_0", "vf_1", "value_head")
_BODY_FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")


def _state_dict_from_flax(params_np: Mapping) -> Dict[str, np.ndarray]:
    """ActorCritic's state_dict names for a flax `ActorCritic` tree (or
    any tree of its shape, such as adam's moments): flax Dense kernels are
    (in, out), torch Linear weights (out, in)."""
    p = params_np.get("params", params_np)
    out = {"log_std": np.array(p["log_std"], np.float32)}
    for name in _DENSE:
        out[f"{name}.weight"] = np.array(p[name]["kernel"], np.float32).T
        out[f"{name}.bias"] = np.array(p[name]["bias"], np.float32)
    return out


def actor_critic_from_flax(params_np: Mapping,
                          device="cuda") -> ActorCritic:
    """Build the port's ActorCritic from flax `ActorCritic` parameters as
    numpy arrays (`{"params": {...}}` or the inner dict)."""
    sd = _state_dict_from_flax(params_np)
    model = ActorCritic(sd["pi_0.weight"].shape[1], sd["log_std"].shape[0])
    model.load_state_dict({k: torch.as_tensor(np.ascontiguousarray(v))
                           for k, v in sd.items()})
    return model.to(resolve_device(device))


def train_state_from_numpy(src, device="cuda") -> TrainState:
    """The port's `TrainState` from the JAX package's (`ppo.TrainState`, or
    anything with its fields as numpy-convertible trees): the flax params,
    optax's adam count and moments, the env state, `last_obs` and the `EpisodeStats`.
    JAX's keys do not carry over: the action-noise / permutation and poke
    generators are new ones on `device`, seeded 0."""
    device = resolve_device(device)

    def tensors(tree):
        return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
                for k, v in _state_dict_from_flax(tree).items()}

    # chain(clip_by_global_norm, adam)'s state: (the clip's EmptyState,
    # (ScaleByAdamState, the learning rate's EmptyState)).
    adam = _get(src, "opt_state")[1][0]
    env = _get(src, "env_state")
    new_gen = lambda: torch.Generator(device=device).manual_seed(0)  # noqa: E731
    return TrainState(
        params=tensors(_get(src, "params")),
        opt_state=AdamState(
            torch.as_tensor(np.array(adam.count, np.int32), device=device),
            tensors(adam.mu), tensors(adam.nu)),
        env_state=env_state_from_numpy(
            _get(env, "bodies"), _get(env, "last_action"), _get(env, "steps"),
            new_gen(), device),
        last_obs=_tensor(_get(src, "last_obs"), device),
        rng=new_gen(),
        stats=_fields(EpisodeStats, _get(src, "stats"), device))


def distributed_train_state_from_numpy(src, rank: int, world_size: int,
                                       device="cuda", seed: int = 0
                                       ) -> TrainState:
    """Rank `rank`'s `TrainState` of a data-parallel run from the JAX
    package's global one (`make_distributed_ppo`'s): the parameters, the
    optimizer state and the episode aggregates whole, this rank's slice of
    the env state, `last_obs` and the running return and length.  The
    generators are new, seeded per rank as
    `data_parallel.make_distributed_ppo`'s init seeds them."""
    from .parallel.data_parallel import rank_generator

    env, stats = _get(src, "env_state"), _get(src, "stats")
    rows = np.asarray(_get(src, "last_obs")).shape[0] // world_size
    part = slice(rank * rows, (rank + 1) * rows)

    def local(x):
        return np.asarray(x)[part]

    bodies = _get(env, "bodies")
    local_src = {
        "params": _get(src, "params"), "opt_state": _get(src, "opt_state"),
        "env_state": {
            "bodies": {f: local(_get(bodies, f)) for f in _BODY_FIELDS},
            "last_action": local(_get(env, "last_action")),
            "steps": local(_get(env, "steps"))},
        "last_obs": local(_get(src, "last_obs")),
        "stats": {**{f: _get(stats, f) for f in (
            "episode_count", "return_sum", "length_sum", "best_return")},
            "running_return": local(_get(stats, "running_return")),
            "running_length": local(_get(stats, "running_length"))}}
    state = train_state_from_numpy(local_src, device)
    device = resolve_device(device)
    env_state = dataclasses.replace(
        state.env_state, generator=rank_generator(seed, rank, 0, device))
    return state._replace(env_state=env_state,
                          rng=rank_generator(seed, rank, 1, device))


def _get(src, name):
    """A field of an object or a mapping; None where it has none."""
    return src.get(name) if isinstance(src, Mapping) else getattr(src, name,
                                                                   None)


def _tensor(x, device) -> Optional[torch.Tensor]:
    """numpy-convertible -> tensor on `device`, keeping the dtype (float64
    becomes float32); None stays None."""
    if x is None:
        return None
    x = np.array(x)
    return torch.as_tensor(x.astype(np.float32) if x.dtype == np.float64
                           else x, device=device)


def _fields(cls, src, device, names=None):
    names = names or cls.__dataclass_fields__
    return cls(**{f: _tensor(_get(src, f), device) for f in names})


def dense_from_numpy(src, device="cuda") -> bvh_mod.DenseTris:
    """The port's DenseTris from the JAX package's (or any object with the
    same fields as numpy-convertible arrays)."""
    return _fields(bvh_mod.DenseTris, src, resolve_device(device))


def bvh_from_numpy(src, device="cuda") -> bvh_mod.BVH:
    """The port's BVH from the JAX package's; its dense table is carried
    over, or built when the source has none."""
    device = resolve_device(device)
    bvh = _fields(bvh_mod.BVH, src, device, bvh_mod.BVH_FIELDS)
    dense = _get(src, "dense")
    bvh.dense = (dense_from_numpy(dense, device) if dense is not None
                 else bvh_mod.build_dense(bvh))
    return bvh


def materials_from_numpy(src, device="cuda") -> Materials:
    return _fields(Materials, src, resolve_device(device))


def sky_from_numpy(src, device="cuda") -> Sky:
    return _fields(Sky, src, resolve_device(device))


def point_lights_from_numpy(src, device="cuda") -> PointLights:
    return _fields(PointLights, src, resolve_device(device))


def spot_lights_from_numpy(src, device="cuda") -> SpotLights:
    return _fields(SpotLights, src, resolve_device(device))


def spot_shadow_map_from_numpy(src, device="cuda") -> SpotShadowMap:
    return _fields(SpotShadowMap, src, resolve_device(device))


def point_shadow_map_from_numpy(src, device="cuda") -> PointShadowMap:
    return _fields(PointShadowMap, src, resolve_device(device))


def light_probe_grid_from_numpy(src, device="cuda") -> LightProbeGrid:
    """A probe grid with its irradiance and depth texels."""
    device = resolve_device(device)
    return LightProbeGrid(
        dims=tuple(int(n) for n in _get(src, "dims")),
        **{f: _tensor(_get(src, f), device)
           for f in ("origin", "spacing", "irradiance", "depth")})


def decals_from_numpy(src, device="cuda") -> Decals:
    return _fields(Decals, src, resolve_device(device))


def transparent_object_from_numpy(src, device="cuda") -> TransparentObject:
    """A transparent object: its BVH (`bvh_from_numpy`), colour and
    alpha."""
    return TransparentObject(
        bvh=bvh_from_numpy(_get(src, "bvh"), device),
        color=tuple(float(c) for c in _get(src, "color")),
        alpha=float(_get(src, "alpha")))


def camera_from_numpy(src, device="cuda") -> Camera:
    device = resolve_device(device)
    return Camera(position=_tensor(_get(src, "position"), device),
                  rotation=_tensor(_get(src, "rotation"), device),
                  **{f: float(_get(src, f))
                     for f in ("v_fov", "aspect", "near", "far")})


def frame_state_from_numpy(src, device="cuda") -> FrameState:
    """The raster frame's temporal state (TAA history, frame index, half-res
    AO / SSR histories) from the JAX package's `FrameState`, so that both
    packages render the next frame from the same state."""
    return _fields(FrameState, src, resolve_device(device))


def sun_shadow_maps_from_numpy(src, device="cuda") -> SunShadowMaps:
    """Sun cascades (depth maps and volumes) from the JAX package's
    `SunShadowMaps`."""
    return _fields(SunShadowMaps, src, resolve_device(device))


def body_state_from_numpy(src, device="cuda") -> BodyState:
    """BodyState from any object or mapping with (B, N, k) numpy-convertible
    pos / rot / vel / omega / force / torque."""
    device = resolve_device(device)

    def get(name):
        x = src[name] if isinstance(src, Mapping) else getattr(src, name)
        return torch.as_tensor(np.array(x, np.float32), device=device)

    return BodyState(*(get(f) for f in _BODY_FIELDS))


def env_state_from_numpy(bodies, last_action, steps,
                         generator: torch.Generator, device="cuda") -> EnvState:
    device = resolve_device(device)
    return EnvState(
        bodies=body_state_from_numpy(bodies, device),
        last_action=torch.as_tensor(np.array(last_action, np.float32),
                                    device=device),
        generator=generator,
        steps=torch.as_tensor(np.array(steps, np.int32), device=device))


SAP_MODES = ("sweep", "dense")
_TABLE_FIELDS = ("joints", "contact_buckets", "contact_color_indices",
                 "joint_color_indices", "cache")
_SEGMENT_FIELDS = ("vs_plane_segments", "vs_terrain_segments")
_COUNT_FIELDS = ("num_bodies", "num_colliders", "num_planes", "num_terrains",
                 "vs_plane_num_colors")
_BUCKET_FIELDS = ("collider_a", "collider_b", "body_a", "body_b", "color",
                  "valid")


def archetype_to_numpy(arch) -> Dict[str, np.ndarray]:
    """Flatten an archetype (the port's, or the JAX package's) into named
    numpy arrays over the fields the port has, for field-by-field
    comparison and for `archetype_from_numpy`.  Ints come out as int64;
    `sap_mode` as its index in SAP_MODES; the segment tables and
    `sap_type_pairs` as (k, 3) / (k, 2) int arrays."""
    out: Dict[str, np.ndarray] = {}

    def put(name, x):
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        out[name] = x.astype(np.int64) if x.dtype.kind in "iu" else x

    for f in SceneArchetype.__dataclass_fields__:
        if f in _TABLE_FIELDS + _SEGMENT_FIELDS + _COUNT_FIELDS + (
                "sap_mode", "sap_type_pairs"):
            continue
        put(f, getattr(arch, f))
    put("sap_mode", SAP_MODES.index(arch.sap_mode))
    put("sap_type_pairs", np.asarray(arch.sap_type_pairs,
                                     np.int64).reshape(-1, 2))
    for i, idx in enumerate(arch.contact_color_indices):
        put(f"contact_color_{i}", idx)
    for bucket in arch.contact_buckets:
        key = f"bucket_{bucket.type_a}_{bucket.type_b}"
        for f in _BUCKET_FIELDS:
            put(f"{key}_{f}", getattr(bucket, f))
        put(f"{key}_num_colors", bucket.num_colors)
    for k, table in enumerate(arch.joints):
        for f in ("body_a", "body_b", "color", "valid"):
            put(f"joint_{table.kind}_{f}", getattr(table, f))
        for name, v in table.params.items():
            put(f"joint_{table.kind}_param_{name}", v)
        for i, idx in enumerate(arch.joint_color_indices[k]):
            put(f"joint_{table.kind}_color_{i}", idx)
    for f in _COUNT_FIELDS:
        put(f, getattr(arch, f))
    for f in _SEGMENT_FIELDS:
        put(f, np.asarray(getattr(arch, f), np.int64).reshape(-1, 3))
    return out


def archetype_from_numpy(flat: Mapping[str, np.ndarray],
                         device="cuda") -> SceneArchetype:
    """The port's archetype from `archetype_to_numpy`'s arrays (of the
    port's archetype or of the JAX package's), on `device`.  Derived data
    (solver tables, terrain mips) is rebuilt on first use."""
    from .physics.builder import JOINT_KINDS
    from .physics.types import ContactBucket, JointTable

    device = resolve_device(device)

    def tensor(x):
        return torch.as_tensor(np.array(x), device=device)

    def listed(prefix):
        out, i = [], 0
        while f"{prefix}{i}" in flat:
            out.append(tensor(flat[f"{prefix}{i}"]))
            i += 1
        return tuple(out)

    kw = {}
    for f, spec in SceneArchetype.__dataclass_fields__.items():
        if f in _TABLE_FIELDS:
            continue
        x = flat[f]
        if f in _SEGMENT_FIELDS or f == "sap_type_pairs":
            kw[f] = tuple(tuple(int(v) for v in row) for row in x)
        elif f == "sap_mode":
            kw[f] = SAP_MODES[int(x)]
        elif spec.type in ("int", "bool"):
            kw[f] = {"int": int, "bool": bool}[spec.type](x)
        else:
            kw[f] = tensor(x)

    buckets = []
    for key in dict.fromkeys(k.rsplit("_", 2)[0] for k in flat
                             if k.startswith("bucket_")
                             and k.endswith("_num_colors")):
        _, ta, tb = key.split("_")
        buckets.append(ContactBucket(
            **{f: tensor(flat[f"{key}_{f}"]) for f in _BUCKET_FIELDS},
            type_a=int(ta), type_b=int(tb),
            num_colors=int(flat[f"{key}_num_colors"])))
    joints, joint_colors = [], []
    kinds = [k for k in JOINT_KINDS if f"joint_{k}_body_a" in flat]
    for kind in sorted(kinds, key=lambda k: list(flat).index(
            f"joint_{k}_body_a")):
        colors = listed(f"joint_{kind}_color_")
        prefix = f"joint_{kind}_param_"
        joints.append(JointTable(
            **{f: tensor(flat[f"joint_{kind}_{f}"])
               for f in ("body_a", "body_b", "color", "valid")},
            params={k[len(prefix):]: tensor(v) for k, v in flat.items()
                    if k.startswith(prefix)},
            kind=kind, num_colors=len(colors)))
        joint_colors.append(colors)
    return SceneArchetype(
        **kw, contact_buckets=tuple(buckets), joints=tuple(joints),
        contact_color_indices=listed("contact_color_"),
        joint_color_indices=tuple(joint_colors))


def particle_pool_from_numpy(src, generator: torch.Generator,
                             device=None):
    """A `particles.ParticlePool` from the JAX package's (or any object or
    mapping with position / velocity / age / lifetime / alive / data /
    emit_carry), on `device` (default: the generator's), drawing from
    `generator` (the JAX pool's PRNG key is not carried over)."""
    from .particles.particles import ParticlePool

    device = resolve_device(device if device is not None
                            else generator.device)
    fields = {f: _tensor(_get(src, f), device)
              for f in ("position", "velocity", "age", "lifetime", "alive",
                        "emit_carry")}
    data = {k: _tensor(v, device) for k, v in (_get(src, "data") or {}).items()}
    return ParticlePool(data=data, generator=generator, **fields)


def model_asset_from_numpy(src):
    """The port's host `ModelAsset` from the JAX package's (or any object
    with its fields): meshes, materials, skeletons, clips and skins copied
    as numpy arrays."""
    from .assets import loaders
    from .render.mesh import MeshData

    def arr(x):
        return None if x is None else np.array(x)

    return loaders.ModelAsset(
        meshes=[MeshData(arr(m.positions), arr(m.normals), arr(m.uvs),
                         arr(m.indices)) for m in src.meshes],
        materials=[loaders.LoadedMaterial(**dataclasses.asdict(m))
                   for m in src.materials],
        mesh_material=list(src.mesh_material),
        skeletons=[loaders.LoadedSkeleton(
            names=list(s.names), parents=list(s.parents),
            bind_local_pos=arr(s.bind_local_pos),
            bind_local_rot=arr(s.bind_local_rot)) for s in src.skeletons],
        animations=[loaders.LoadedClip(
            name=c.name, positions=arr(c.positions),
            rotations=arr(c.rotations), scales=arr(c.scales),
            duration=float(c.duration), looping=bool(c.looping))
            for c in src.animations],
        mesh_skin=[None if s is None else loaders.SkinData(
            joint_indices=arr(s.joint_indices),
            joint_weights=arr(s.joint_weights)) for s in src.mesh_skin])
