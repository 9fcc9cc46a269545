"""The screen-space reflections' march: the wrapper of its CUDA kernel
(`csrc/ssr.cu`) and its plain PyTorch version, the loop that
`render/post.py`'s `ssr` ran (counterpart of the march in
``d3d12renderer_tpu/render/post.py`` `ssr`, which XLA fused).

`ssr_march` takes the projected rays of every pixel (start, extent, inverse
depths, exit parameter) and the linear-depth min-pyramid, and returns the
march parameter of each pixel's hit and whether it hit: the kernel on CUDA
tensors, one launch; `ssr_march_plain` on CPU tensors (about 45 tensor
operations a step).  Both give the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda_build import launcher

MAX_MIPS = 8              # csrc/ssr.cu SSR_MAX_MIPS


class SsrArgs(ctypes.Structure):
    """ssr.cu `SsrArgs`."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x0", "y0", "dx", "dy", "k0", "dk", "t_max", "pyramid", "t_hit",
        "found")]
        + [("n", ctypes.c_longlong), ("steps", ctypes.c_int),
           ("mips", ctypes.c_int), ("thickness", ctypes.c_float),
           ("pad_", ctypes.c_int)]
        + [(n, ctypes.c_int * MAX_MIPS) for n in ("offsets", "widths",
                                                   "heights")])


def ssr_march_plain(x0, y0, dx, dy, k0, dk, t_max, flat, offs, ws, hs,
                    num_steps: int, thickness: float):
    """The march as tensor ops on (H, W) rays: (t_hit, found).  `flat`,
    `offs`, `ws`, `hs`: `post.build_min_depth_pyramid`'s levels."""
    h, w = x0.shape
    dev = x0.device
    n_mips = int(offs.shape[0])
    sx = torch.where(dx >= 0, 1.0, -1.0)
    sy = torch.where(dy >= 0, 1.0, -1.0)

    def cell_exit_t(t, mip):
        size = (1 << mip).to(torch.float32)
        x = x0 + t * dx
        y = y0 + t * dy
        bx = (torch.floor(x / size) + (sx > 0)) * size + sx * 0.01
        by = (torch.floor(y / size) + (sy > 0)) * size + sy * 0.01
        tx = torch.where(torch.abs(dx) > 1e-6, (bx - x0) / dx, torch.inf)
        ty = torch.where(torch.abs(dy) > 1e-6, (by - y0) / dy, torch.inf)
        return torch.minimum(tx, ty)

    def z_at(t):
        return 1.0 / torch.clamp(k0 + t * dk, min=1e-8)

    # Step out of the originating pixel first, so a surface never reflects
    # itself.
    mip = torch.zeros((h, w), dtype=torch.int32, device=dev)
    t = torch.minimum(cell_exit_t(torch.zeros((h, w), device=dev), mip), t_max)
    found = torch.zeros((h, w), dtype=torch.bool, device=dev)
    t_hit = torch.zeros((h, w), device=dev)
    for _ in range(num_steps):
        t_exit = torch.minimum(cell_exit_t(t, mip), t_max)
        x = x0 + t * dx
        y = y0 + t * dy
        size_i = 1 << mip
        mi = mip.long()
        mw, mh = ws[mi], hs[mi]
        cx = torch.clamp(torch.div(x.to(torch.int32), size_i,
                                   rounding_mode="floor"), min=0)
        cx = torch.minimum(cx, mw - 1)
        cy = torch.clamp(torch.div(y.to(torch.int32), size_i,
                                   rounding_mode="floor"), min=0)
        cy = torch.minimum(cy, mh - 1)
        zmin = flat[(offs[mi] + cy * mw + cx).long()]
        z_a, z_b = z_at(t), z_at(t_exit)
        z_far = torch.maximum(z_a, z_b)
        in_front = z_far < zmin + 0.01
        # A mip-0 crossing is a hit when the ray depth lands within
        # [zmin, zmin + thickness]; crossings in the last cell count too.
        hit_now = ((mip == 0) & ~in_front & (z_far >= zmin)
                   & (torch.minimum(z_a, z_b) <= zmin + thickness)
                   & ~found)
        advance = in_front | ((mip == 0) & ~hit_now)
        stop = found | hit_now
        t_new = torch.where(stop, t, torch.where(advance, t_exit, t))
        mip = torch.where(stop, mip, torch.where(
            advance, torch.clamp(mip + 1, max=n_mips - 1),
            torch.clamp(mip - 1, min=0)))
        t_hit = torch.where(hit_now, t, t_hit)
        found = stop
        t = t_new
    return t_hit, found


def march_args(x0, y0, dx, dy, k0, dk, t_max, flat, levels, num_steps: int,
               thickness: float, t_hit, found) -> SsrArgs:
    """The kernel's arguments; `levels` = (offsets, widths, heights) as
    host integers."""
    offs, ws, hs = levels
    if not 1 <= len(offs) <= MAX_MIPS:
        raise ValueError(f"{len(offs)} pyramid levels: the kernel takes 1 to "
                         f"{MAX_MIPS}")
    for name, x in (("x0", x0), ("y0", y0), ("dx", dx), ("dy", dy),
                    ("k0", k0), ("dk", dk), ("t_max", t_max),
                    ("pyramid", flat)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
        if name != "pyramid" and x.numel() != x0.numel():
            raise ValueError(f"{name} has {x.numel()} values, x0 "
                             f"{x0.numel()}")
    a = SsrArgs(*(x.data_ptr() for x in (x0, y0, dx, dy, k0, dk, t_max, flat,
                                         t_hit, found)),
                x0.numel(), num_steps, len(offs), thickness, 0)
    for i in range(len(offs)):
        a.offsets[i], a.widths[i], a.heights[i] = offs[i], ws[i], hs[i]
    return a


def ssr_march(x0, y0, dx, dy, k0, dk, t_max, flat, offs, ws, hs,
              num_steps: int, thickness: float, levels=None):
    """The march of every pixel: (t_hit (H, W), found (H, W) bool).  On CUDA
    tensors one launch of the kernel (`levels`: the pyramid's offsets,
    widths and heights as host integers, which the caller knows from the
    shapes), counted in `ssr_march.launches`; on CPU tensors
    `ssr_march_plain`."""
    if not x0.is_cuda:
        return ssr_march_plain(x0, y0, dx, dy, k0, dk, t_max, flat, offs, ws,
                               hs, num_steps, thickness)
    t_hit = torch.empty_like(x0)
    found = torch.empty(x0.shape, dtype=torch.int32, device=x0.device)
    rays = [x.contiguous() for x in (x0, y0, dx, dy, k0, dk, t_max)]
    args = march_args(*rays, flat.contiguous(), levels, num_steps, thickness,
                      t_hit, found)
    err = launcher("ssr_march_launch", x0.device)(ctypes.byref(args))
    if err != 0:
        raise RuntimeError(f"ssr march launch failed: error {err}")
    ssr_march.launches += 1
    return t_hit, found.bool()


ssr_march.launches = 0
