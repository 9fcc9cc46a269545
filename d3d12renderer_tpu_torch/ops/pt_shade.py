"""The path tracer's shading of one bounce: the wrappers of the two CUDA
kernels of `csrc/pt_shade.cu`.

`render/pathtracer.py` `trace_sample` shades each bounce in two halves
around the bounce's shadow queries:

* `shade_hit`: the sky on a miss, the hit's shading row and normal,
  two-sided normals, the offset hit point, emission, the sun's direction
  and its shadow query's t_max, the point-light sample and its t_max.
* `shade_next`: the sun's and the point light's NEE terms with MIS, the
  BRDF sample, throughput, live mask, roulette, the next ray and its t_max.

Both take the bounce's random numbers drawn beforehand (`BounceDraws`) and
add the rays they ask for into an int64 counter on the device.  The plain
versions with the same contracts, which CPU tensors take, are the path
tracer's own (`pathtracer.shade_hit_plain` / `shade_next_plain`); this
module reads the scene only through the tensors and settings the path
tracer hands it.

Replaces no Pallas kernel: the JAX package leaves this shading to XLA's
fusion.  The wrappers launch the kernels on CUDA tensors (counted in
`.launches`) and raise on any other.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core import profiling
from ..cuda_build import launcher

# Mirrors of csrc/pt_shade.cu.
TABLE_COLS = 28
SKY_GRADIENT, SKY_PREETHAM, SKY_CUBEMAP = 0, 1, 2
# The packed sky: sun direction 0:3, sun radiance 3:6, zenith 6:9, horizon
# 9:12, ground 12:15; Preetham's scale 15, the Perez coefficients of Y, x
# and y 16:31, their zenith values 31:34 and each Perez function at the
# zenith 34:37 (zero for the other skies).
SKY_COLS = 40


def _f32(x) -> float:
    return float(np.float32(x))


def _reciprocal(x) -> float:
    """PyTorch's CUDA division by a Python float `x`: a product with
    float(1 / float(x))."""
    return float(np.float32(1.0) / np.float32(x))


class ShadeArgs(ctypes.Structure):
    """pt_shade.cu `ShadeArgs`."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "t", "tri", "uv", "alive", "origin", "direction", "throughput",
        "radiance", "table", "sky", "cubemap", "atlas", "light_position",
        "light_color", "light_radius", "light_valid", "light_count",
        "sun_u1", "sun_u2", "light_rank", "light_normal", "brdf_u1",
        "brdf_u2", "brdf_pick", "roulette", "normal", "point", "sun_dir",
        "sun_t_max", "light_dir", "light_t_max", "sun_shadowed",
        "light_shadowed", "direction_out", "t_max_out", "counts")]
        + [(name, ctypes.c_float) for name in (
            "sun_cone", "sun_cos", "two_pi", "pi", "inv_pi", "sun_pdf",
            "inv_sun_pdf", "inv_fade", "light_size", "intensity")]
        + [(name, ctypes.c_int) for name in (
            "num_rays", "num_lights", "cube_res", "atlas_res", "sky_kind",
            "has_lights", "has_atlas", "first", "direct", "mis", "last",
            "live_slot")])


@dataclass
class BounceDraws:
    """One bounce's random numbers."""

    sun: Optional[Tuple[torch.Tensor, torch.Tensor]] = None   # u1, u2: ()
    light: Optional[Tuple[torch.Tensor, torch.Tensor]] = None  # rank, normal
    brdf: Optional[Tuple[torch.Tensor, ...]] = None   # u1, u2, pick: (R,)
    roulette: Optional[torch.Tensor] = None            # (R,)


@dataclass
class HitShading:
    """`shade_hit`'s answer: the radiance so far, the two-sided shading
    normal and the offset hit point p (R, 3); the shadow rays from p toward
    the sun and the point light with their t_max (0 where the ray is
    masked), None without direct lighting or point lights."""

    radiance: torch.Tensor
    normal: torch.Tensor
    point: torch.Tensor
    sun_dir: Optional[torch.Tensor] = None
    sun_t_max: Optional[torch.Tensor] = None
    light_dir: Optional[torch.Tensor] = None
    light_t_max: Optional[torch.Tensor] = None


# --------------------------------------------------------------------------
# The kernels' wrappers
# --------------------------------------------------------------------------

def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or not x.is_contiguous() or tuple(x.shape) != shape:
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {shape}, got {x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the rays on {device}")


def _ptr(x) -> int:
    return 0 if x is None else x.data_ptr()


def _args(ctx, res, d, alive, throughput, radiance, draws: BounceDraws,
          counts, first: bool) -> ShadeArgs:
    """The launch's arguments common to both kernels, the inputs checked.
    `ctx` is the path tracer's `ShadeContext`; read of it: `table` (T, 28),
    `sky` (SKY_COLS,) and `sky_kind` (SKY_*), `cubemap` and `atlas` (or
    None), `lights` and `light_count` (or None), `sun_cos_cone` and
    `settings`."""
    dev, r = d.device, d.shape[0]
    f32, b8 = torch.float32, torch.bool
    for name, x, dtype, shape in (
            ("t", res["t"], f32, (r,)), ("tri", res["tri"], torch.int32, (r,)),
            ("uv", res["uv"], f32, (r, 2)),
            ("direction", d, f32, (r, 3)), ("alive", alive, b8, (r,)),
            ("throughput", throughput, f32, (r, 3)),
            ("radiance", radiance, f32, (r, 3)),
            ("table", ctx.table, f32, (ctx.table.shape[0], TABLE_COLS)),
            ("sky", ctx.sky, f32, (SKY_COLS,)),
            ("counts", counts, torch.int64, (counts.shape[0],))):
        _check(name, x, dtype, shape, dev)
    s, cube, atlas = ctx.settings, ctx.cubemap, ctx.atlas
    if cube is not None:
        _check("cubemap", cube, f32, (6, cube.shape[1], cube.shape[1], 3), dev)
    if atlas is not None:
        _check("texture_atlas", atlas, f32,
               (atlas.shape[0], atlas.shape[1], atlas.shape[1], 3), dev)
    sun_pdf = 1.0 / (2.0 * math.pi * (1.0 - ctx.sun_cos_cone))
    a = ShadeArgs(
        t=res["t"].data_ptr(), tri=res["tri"].data_ptr(),
        uv=res["uv"].data_ptr(), alive=alive.data_ptr(),
        direction=d.data_ptr(), throughput=throughput.data_ptr(),
        radiance=radiance.data_ptr(), table=ctx.table.data_ptr(),
        sky=ctx.sky.data_ptr(), cubemap=_ptr(cube), atlas=_ptr(atlas),
        counts=counts.data_ptr(),
        sun_cone=_f32(1.0 - ctx.sun_cos_cone), sun_cos=_f32(ctx.sun_cos_cone),
        two_pi=_f32(2.0 * math.pi), pi=_f32(math.pi),
        inv_pi=_reciprocal(math.pi), sun_pdf=_f32(sun_pdf),
        inv_sun_pdf=_reciprocal(sun_pdf), inv_fade=_reciprocal(0.02),
        light_size=_f32(s.point_light_radius),
        intensity=_f32(s.light_intensity_scale), num_rays=r,
        cube_res=0 if cube is None else cube.shape[1],
        atlas_res=0 if atlas is None else atlas.shape[1],
        sky_kind=ctx.sky_kind, has_atlas=int(atlas is not None),
        first=int(first), direct=int(s.enable_direct_lighting),
        mis=int(s.multiple_importance_sampling))
    if draws.sun is not None:
        for name, u in zip(("sun_u1", "sun_u2"), draws.sun):
            _check(name, u, f32, (), dev)
        a.sun_u1, a.sun_u2 = draws.sun[0].data_ptr(), draws.sun[1].data_ptr()
    lights = ctx.lights
    if lights is not None:
        nl = lights.position.shape[0]
        for name, x, dtype, shape in (
                ("light position", lights.position, f32, (nl, 3)),
                ("light color", lights.color, f32, (nl, 3)),
                ("light radius", lights.radius, f32, (nl,)),
                ("light valid", lights.valid, b8, (nl,)),
                ("light count", ctx.light_count, torch.int64, ()),
                ("light rank", draws.light[0], torch.int64, (r,)),
                ("light normal", draws.light[1], f32, (r, 3))):
            _check(name, x, dtype, shape, dev)
        a.has_lights, a.num_lights = 1, nl
        a.light_position, a.light_color = (lights.position.data_ptr(),
                                           lights.color.data_ptr())
        a.light_radius, a.light_valid = (lights.radius.data_ptr(),
                                         lights.valid.data_ptr())
        a.light_count = ctx.light_count.data_ptr()
        a.light_rank, a.light_normal = (draws.light[0].data_ptr(),
                                        draws.light[1].data_ptr())
    return a


def _run(launch_fn: Callable, args: ShadeArgs):
    err = launch_fn(ctypes.byref(args))
    if err != 0:
        raise RuntimeError(f"pt_shade kernel launch failed: error {err}")


def launch_hit(launch_fn: Callable, ctx, res, o, d, alive,
               throughput, radiance, draws: BounceDraws, counts,
               first: bool) -> HitShading:
    """Checks the inputs, allocates the outputs and calls
    `launch_fn(ShadeArgs*)`: a CUDA launcher bound to a device and stream
    (`shade_hit`) or, in the CPU tests, the kernel source compiled as host
    code.  `radiance` is updated in place (written whole at the first
    bounce); `alive` and `throughput` are not read at the first bounce."""
    a = _args(ctx, res, d, alive, throughput, radiance, draws, counts, first)
    r = o.shape[0]
    _check("origin", o, torch.float32, (r, 3), d.device)
    a.origin = o.data_ptr()
    out = HitShading(radiance, torch.empty_like(o), torch.empty_like(o))
    a.normal, a.point = out.normal.data_ptr(), out.point.data_ptr()
    if draws.sun is not None:
        out.sun_dir = torch.empty_like(o)
        out.sun_t_max = torch.empty((r,), device=o.device)
        a.sun_dir, a.sun_t_max = (out.sun_dir.data_ptr(),
                                  out.sun_t_max.data_ptr())
    if draws.light is not None:
        out.light_dir = torch.empty_like(o)
        out.light_t_max = torch.empty((r,), device=o.device)
        a.light_dir, a.light_t_max = (out.light_dir.data_ptr(),
                                      out.light_t_max.data_ptr())
    _run(launch_fn, a)
    return out


def launch_next(launch_fn: Callable, ctx, res, d, alive,
                throughput, hs: HitShading, sun_shadowed, light_shadowed,
                draws: BounceDraws, counts, first: bool, live_slot: int):
    """`launch_hit`'s counterpart for `shade_next`: `hs.radiance`,
    `throughput` and `alive` are updated in place (the latter two written
    whole at the first bounce, left at the last), the next direction and
    t_max allocated."""
    r = d.shape[0]
    a = _args(ctx, res, d, alive, throughput, hs.radiance, draws, counts,
              first)
    for name, x, shape in (("normal", hs.normal, (r, 3)),
                           ("point", hs.point, (r, 3))):
        _check(name, x, torch.float32, shape, d.device)
    a.normal, a.point = hs.normal.data_ptr(), hs.point.data_ptr()
    if draws.sun is not None:
        _check("sun_shadowed", sun_shadowed, torch.bool, (r,), d.device)
        a.sun_shadowed = sun_shadowed.data_ptr()
    if draws.light is not None:
        _check("light_shadowed", light_shadowed, torch.bool, (r,), d.device)
        a.light_shadowed = light_shadowed.data_ptr()
    if draws.brdf is None:
        a.last = 1
        _run(launch_fn, a)
        return hs.radiance, None, None, None, None
    for name, x in zip(("brdf_u1", "brdf_u2", "brdf_pick"), draws.brdf):
        _check(name, x, torch.float32, (r,), d.device)
    a.brdf_u1, a.brdf_u2, a.brdf_pick = (x.data_ptr() for x in draws.brdf)
    if draws.roulette is not None:
        _check("roulette", draws.roulette, torch.float32, (r,), d.device)
        a.roulette = draws.roulette.data_ptr()
    if not 0 < live_slot < counts.shape[0]:
        raise ValueError(f"live_slot {live_slot} outside counts[1:]")
    direction = torch.empty_like(d)
    t_max = torch.empty((r,), device=d.device)
    a.direction_out, a.t_max_out = direction.data_ptr(), t_max.data_ptr()
    a.live_slot = live_slot
    _run(launch_fn, a)
    return hs.radiance, throughput, alive, direction, t_max


def _on_card(x, name):
    if not x.is_cuda:
        raise ValueError(f"pt_shade.{name} launches a CUDA kernel: the rays "
                         f"are on {x.device} (the plain version is "
                         "render/pathtracer.py's)")
    return x.device


def shade_hit(ctx, res, o, d, alive, throughput, radiance,
              draws: BounceDraws, counts, first: bool) -> HitShading:
    """The first half of a bounce's shading (see the module's docstring):
    launches `pt_shade_hit`, counted in `shade_hit.launches`, which updates
    `radiance` in place.  `res` is the bounce's closest-hit answer ({t,
    tri, uv, hit}); `o`, `d` its rays, CUDA tensors; `counts` (int64) gets
    the rays the bounce asks for in [0]."""
    dev = _on_card(o, "shade_hit")
    out = launch_hit(launcher("pt_shade_hit_launch", dev), ctx, res, o, d,
                     alive, throughput, radiance, draws, counts, first)
    shade_hit.launches += 1
    return out


def shade_next(ctx, res, d, alive, throughput, hs: HitShading,
               sun_shadowed, light_shadowed, draws: BounceDraws, counts,
               first: bool, live_slot: int):
    """The second half, after the shadow queries (`sun_shadowed`,
    `light_shadowed`: their `hit`, None where not traced): launches
    `pt_shade_next`, counted in `shade_next.launches` and in the
    `pt.shade_fused` counter (one a bounce), which updates the radiance,
    throughput and alive tensors in place.  Returns (radiance, throughput,
    alive, next direction, next t_max), the last four None at the last
    bounce; the next query's live rays go to counts[0] and
    counts[live_slot]."""
    dev = _on_card(d, "shade_next")
    out = launch_next(launcher("pt_shade_next_launch", dev), ctx, res, d,
                      alive, throughput, hs, sun_shadowed, light_shadowed,
                      draws, counts, first, live_slot)
    shade_next.launches += 1
    profiling.profile_stat("pt.shade_fused", 1)
    return out


shade_hit.launches = 0
shade_next.launches = 0
