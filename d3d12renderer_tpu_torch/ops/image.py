"""The frame's image passes with hand-written kernels: the separable
gaussian blur and the Uncharted-2 tonemap, the wrappers of
`csrc/image.cu` beside their plain PyTorch versions.

Counterpart of ``d3d12renderer_tpu/ops/pallas_kernels.py``:

* `gaussian_blur` (kernel #7's port, `_blur_kernel` `:122`) computes
  `render/post.py`'s `gaussian_blur` (`_sep_conv` over `gaussian_kernel`'s
  taps): along axis 0, then axis 1, edge-clamped, each output summed
  from zero in tap order.  `blur_plain` is that sum as tensor ops.
* `tonemap` (kernel #6's port, `_tonemap_kernel` `:57`) computes
  `post.tonemap_uncharted2` with `srgb=False` (the frame's pass) and
  `tonemap_srgb` with `srgb=True`: the Pallas kernel's encode,
  1.055 exp(log(max(x, 1e-7)) / 2.4) - 0.055 (not `post.to_srgb`'s
  clip(x, 0, 1) ** (1/2.4)).  `tonemap_plain` is the same as tensor ops.

On CUDA tensors the wrappers launch the kernels (and count the launches in
`.launches`); on CPU tensors they run the plain versions.  Images are
(H, W) or (H, W, C), float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..cuda_build import launcher

# Mirrors of csrc/image.cu.
BLUR_MAX_RADIUS = 16
BLUR_MAX_TAPS = 2 * BLUR_MAX_RADIUS + 1


class BlurArgs(ctypes.Structure):
    """image.cu `BlurArgs`."""

    _fields_ = ([("src", ctypes.c_void_p), ("dst", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in ("height", "width", "channels",
                                                "radius")]
                + [("taps", ctypes.c_float * BLUR_MAX_TAPS),
                   ("pad_", ctypes.c_int)])


class TonemapArgs(ctypes.Structure):
    """image.cu `TonemapArgs`."""

    _fields_ = ([("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                 ("n", ctypes.c_longlong)]
                + [(n, ctypes.c_float) for n in ("scale", "a", "b", "cb", "de",
                                                  "df", "ef", "white")]
                + [("srgb", ctypes.c_int), ("pad_", ctypes.c_int)])


def _contiguous_f32(name, x):
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")


# --------------------------------------------------------------------------
# Gaussian blur (kernel #7)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _taps(sigma: float, radius: int) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def gaussian_kernel(sigma: float, radius: Optional[int] = None) -> torch.Tensor:
    """The (2r+1,) normalised gaussian taps, r = max(1, int(3 sigma)) by
    default: float32, on the CPU (the card and the CPU paths use the same
    taps; the kernel takes them by value), cached."""
    radius = radius if radius is not None else max(1, int(3 * sigma))
    return _taps(float(sigma), int(radius))


def blur_plain(img, taps):
    """`_sep_conv`: the taps down the rows axis (axis 0), then along the
    columns axis (axis 1), edge-clamped; (H, W) or (H, W, C)."""
    r = taps.shape[0] // 2

    def conv_axis(x, axis):
        n = x.shape[axis]
        base = torch.arange(n, device=x.device)
        out = torch.zeros_like(x)
        for i in range(taps.shape[0]):
            idx = torch.clamp(base + (i - r), 0, n - 1)
            out = out + taps[i] * torch.index_select(x, axis, idx)
        return out

    return conv_axis(conv_axis(img, 0), 1)


def blur_launch(launch_fn, img, taps):
    """Checks the image, allocates the output, calls `launch_fn(BlurArgs*)`
    and raises if it reports an error.  `launch_fn` is the CUDA launcher or,
    in the CPU tests, the kernel source compiled as host code."""
    _contiguous_f32("img", img)
    if img.dim() not in (2, 3):
        raise ValueError(f"img must be (H, W) or (H, W, C), got "
                         f"{tuple(img.shape)}")
    radius = taps.shape[0] // 2
    if taps.shape[0] != 2 * radius + 1 or radius > BLUR_MAX_RADIUS:
        raise ValueError(f"{taps.shape[0]} taps: want an odd count of at most "
                         f"{BLUR_MAX_TAPS}")
    h, w = img.shape[:2]
    c = img.shape[2] if img.dim() == 3 else 1
    out = torch.empty_like(img)
    args = BlurArgs(img.data_ptr(), out.data_ptr(), h, w, c, radius)
    args.taps[:taps.shape[0]] = taps.tolist()
    err = launch_fn(ctypes.byref(args))
    if err != 0:
        raise RuntimeError(f"blur kernel launch failed: error {err}")
    return out


def gaussian_blur(img, taps):
    """Kernel #7's port on CUDA tensors, `blur_plain` on CPU tensors; `taps`
    on the CPU (`gaussian_kernel`).  Counts its launches in
    `gaussian_blur.launches`."""
    if not img.is_cuda:
        return blur_plain(img, taps.to(img.device))
    out = blur_launch(launcher("gaussian_blur_launch", img.device),
                      img.contiguous(), taps)
    gaussian_blur.launches += 1
    return out


gaussian_blur.launches = 0


# --------------------------------------------------------------------------
# Tonemap (kernel #6)
# --------------------------------------------------------------------------

_TONEMAP_CONSTANTS = ("scale", "a", "b", "cb", "de", "df", "ef", "white")


def _f32(x) -> float:
    return float(np.float32(x))


def _curve(v, k):
    """The Uncharted-2 curve in the kernel's operation order."""
    return ((v * (k["a"] * v + k["cb"]) + k["de"])
            / (v * (k["a"] * v + k["b"]) + k["df"])) - k["ef"]


@functools.lru_cache(maxsize=16)
def tonemap_constants(settings) -> dict:
    """The kernel's float32 constants of a `post.TonemapSettings`: products
    and quotients of the settings in double precision, then rounded, as
    JAX's weakly typed Python scalars; `white` = the curve at the linear
    white, computed in float32."""
    s = settings
    k = {"scale": _f32(2.0 ** s.exposure), "a": _f32(s.A), "b": _f32(s.B),
         "cb": _f32(s.C * s.B), "de": _f32(s.D * s.E), "df": _f32(s.D * s.F),
         "ef": _f32(s.E / s.F)}
    k["white"] = float(_curve(torch.tensor(s.linear_white,
                                           dtype=torch.float32), k))
    return k


def tonemap_plain(x, k: dict, srgb: bool):
    exposed = torch.clamp(x * k["scale"], min=0.0)
    # A tensor divisor: on the card PyTorch turns a division by a Python
    # scalar into a product with its reciprocal, which rounds differently.
    white = torch.tensor(k["white"], device=x.device)
    y = torch.clamp(_curve(exposed, k) / white, 0.0, 1.0)
    if srgb:
        y = torch.where(y <= 0.0031308, y * 12.92,
                        1.055 * torch.exp(torch.log(torch.clamp(y, min=1e-7))
                                          * (1 / 2.4)) - 0.055)
    return y


def tonemap_args(k: dict, srgb: bool) -> TonemapArgs:
    """A launch's arguments with the constants `k`; the wrapper fills in
    the tensors."""
    return TonemapArgs(None, None, 0, *(k[n] for n in _TONEMAP_CONSTANTS),
                       int(srgb), 0)


@functools.lru_cache(maxsize=16)
def _settings_args(settings, srgb: bool) -> TonemapArgs:
    return tonemap_args(tonemap_constants(settings), srgb)


def tonemap_launch(launch_fn, x, args: TonemapArgs):
    """As `blur_launch`, for the tonemap kernel: `args` from
    `tonemap_args`, its tensors left out (it is not changed)."""
    _contiguous_f32("x", x)
    out = torch.empty_like(x)
    a = TonemapArgs.from_buffer_copy(args)
    a.src, a.dst, a.n = x.data_ptr(), out.data_ptr(), x.numel()
    err = launch_fn(ctypes.byref(a))
    if err != 0:
        raise RuntimeError(f"tonemap kernel launch failed: error {err}")
    return out


def tonemap(x, settings, srgb: bool = False):
    """Kernel #6's port on CUDA tensors, `tonemap_plain` on CPU tensors:
    exposure, the Uncharted-2 curve over its value at the linear white,
    clamped to [0, 1]; with `srgb` the Pallas kernel's sRGB encode.
    Counts its launches in `tonemap.launches`."""
    if not x.is_cuda:
        return tonemap_plain(x, tonemap_constants(settings), srgb)
    out = tonemap_launch(launcher("tonemap_launch", x.device),
                         x.contiguous(),
                         _settings_args(settings, srgb))
    tonemap.launches += 1
    return out


tonemap.launches = 0
