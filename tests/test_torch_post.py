"""The port's post-processing (`render/post.py`, `ops/image.py`) against
the JAX package's `render/post.py` and its Pallas image kernels (interpret
mode), on inputs made with numpy from seeds or from a JAX G-buffer; and
`csrc/image.cu` compiled as host C++ against the plain versions."""

import ctypes
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.ops import pallas_kernels as jpk
from d3d12renderer_tpu.render import bvh as jbvh
from d3d12renderer_tpu.render import camera as jcam
from d3d12renderer_tpu.render import mesh as jmesh
from d3d12renderer_tpu.render import pathtracer as jpt
from d3d12renderer_tpu.render import post as jpost
from d3d12renderer_tpu.render.gbuffer import render_gbuffer
from d3d12renderer_tpu_torch import cuda_build
from d3d12renderer_tpu_torch.ops import image
from d3d12renderer_tpu_torch.render import post

from tests.torch_host_build import build_host

torch.set_num_threads(1)
# Float32 functions of the same operations in the same order: XLA's CPU
# code may contract a * b + c into FMA and sums in another order, so a few
# ulps of the values' scale.
TOL = 1e-5


def _img(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).random(shape) * scale).astype(np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, atol=TOL, rtol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.fixture(scope="module")
def gbuffer():
    """A JAX G-buffer of the pipeline tests' scene at 64x48 (rays through
    pixel centres): view positions and normals with sky, edges and
    contact creases, for HBAO and SSR."""
    meshes = [(jmesh.quad(half=20.0), 0),
              (jmesh.ico_sphere(1.0, 2).transformed(translate=(0, 1.0, 0)), 1),
              (jmesh.box((0.7, 0.7, 0.7)).transformed(
                  translate=(2.2, 0.7, -0.5)), 2)]
    mats = jpt.Materials(albedo=jnp.full((3, 3), 0.5), emissive=jnp.zeros((3, 3)),
                         roughness=jnp.array([0.8, 0.3, 0.6]),
                         metallic=jnp.zeros(3))
    scene = jpt.Scene(bvh=jbvh.build_bvh(meshes, cache=False), materials=mats,
                      sky=jpt.default_sky()).with_shading_table()
    cam = jcam.look_at((5, 3, 6), (0.5, 0.8, 0), aspect=64 / 48,
                       v_fov=math.radians(50))
    gb = render_gbuffer(scene, cam, 64, 48)
    return {k: np.asarray(getattr(gb, k)) for k in (
        "view_pos", "view_normal", "roughness", "depth", "hit")}, cam


@pytest.mark.parametrize("sigma,shape", [(1.5, (48, 40, 1)), (1.5, (33, 60, 3)),
                                         (1.0, (40, 64, 3)), (2.0, (20, 24))])
def test_gaussian_blur_matches_jax(sigma, shape):
    """`post.gaussian_blur` (the plain version on the CPU) against JAX's
    `post.gaussian_blur` (`_sep_conv`) and against the Pallas blur kernel in
    interpret mode; the taps against `gaussian_kernel`'s."""
    x = _img(1, shape, 4.0)
    got = post.gaussian_blur(_t(x), sigma)
    _close(got, jpost.gaussian_blur(jnp.asarray(x), sigma))
    _close(got, jpk.gaussian_blur_pallas(jnp.asarray(x), sigma, interpret=True))
    _close(image.gaussian_kernel(sigma), jpost.gaussian_kernel(sigma), atol=1e-7,
           rtol=1e-6)


@pytest.mark.parametrize("srgb", [False, True])
def test_tonemap_matches_jax(srgb):
    """srgb=False against `post.tonemap_uncharted2` (the frame's pass);
    srgb=True against the Pallas kernel `tonemap_srgb` in interpret mode
    (the port's sRGB encode follows that kernel's exp/log form, not
    `post.to_srgb`'s power)."""
    x = _img(2, (37, 50, 3), 30.0)
    x[0, :4, 0] = [0.0, 1e-4, 11.2, 500.0]
    got = post.tonemap_uncharted2(_t(x)) if not srgb else image.tonemap(
        _t(x), post.TonemapSettings(), srgb=True)
    want = (jpk.tonemap_srgb(jnp.asarray(x), interpret=True) if srgb
            else jpost.tonemap_uncharted2(jnp.asarray(x)))
    _close(got, want, atol=2e-6, rtol=2e-6)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def test_to_srgb_matches_jax():
    x = _img(3, (20, 30, 3), 1.2) - 0.1
    _close(post.to_srgb(_t(x)), jpost.to_srgb(jnp.asarray(x)), atol=2e-6)


def test_downsample_and_bloom_upsample_ratios_match_jax():
    """`downsample2` (odd edges dropped), and `upsample2` at the ratios of
    the 1080p bloom pyramid (540, 270, 135, 67 and 33 rows back to 1080):
    `F.interpolate(bilinear, align_corners=False)` against
    `jax.image.resize(bilinear)`, the edge rows and columns included (both
    clamp the taps that fall outside)."""
    x = _img(4, (67, 121, 3), 3.0)
    _close(post.downsample2(_t(x)), jpost.downsample2(jnp.asarray(x)))
    for h, w in ((540, 960), (270, 480), (135, 240), (67, 120), (33, 60)):
        low = _img(h, (h, w, 3))
        got = post.upsample2(_t(low), (1080, 1920)).numpy()
        want = np.asarray(jpost.upsample2(jnp.asarray(low), (1080, 1920)))
        for edge in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
            np.testing.assert_allclose(got[edge], want[edge], atol=2e-6)
        np.testing.assert_allclose(got, want, atol=2e-6)


def test_bilateral_upsample_matches_jax():
    low = _img(5, (12, 16, 3))
    dlow = _img(6, (12, 16), 5.0) + 1.0
    dfull = _img(7, (24, 32), 5.0) + 1.0
    _close(post.bilateral_upsample(_t(low), _t(dlow), _t(dfull)),
           jpost.bilateral_upsample(jnp.asarray(low), jnp.asarray(dlow),
                                    jnp.asarray(dfull)))
    _close(post.bilateral_upsample(_t(low[..., 0]), _t(dlow), _t(dfull)),
           jpost.bilateral_upsample(jnp.asarray(low[..., 0]),
                                    jnp.asarray(dlow), jnp.asarray(dfull)))


@pytest.mark.parametrize("first", [None, True, False])
def test_temporal_accumulate_and_taa_match_jax(first):
    """Reprojection by rounded motion (half-way motions included: both
    round half to even), 3x3 clamp, blend."""
    cur = _img(8, (20, 24, 3))
    hist = _img(9, (20, 24, 3))
    motion = (_img(10, (20, 24, 2)) - 0.5) * 6.0
    motion[0, :4] = [[0.5, 1.5], [2.5, -0.5], [-1.5, -2.5], [3.5, 0.5]]
    f_t = None if first is None else torch.tensor(first)
    f_j = None if first is None else jnp.asarray(first)
    _close(post.temporal_accumulate(_t(cur), _t(hist), _t(motion), first=f_t),
           jpost.temporal_accumulate(jnp.asarray(cur), jnp.asarray(hist),
                                     jnp.asarray(motion), first=f_j))
    _close(post.taa(_t(cur), _t(hist), _t(motion)),
           jpost.taa(jnp.asarray(cur), jnp.asarray(hist), jnp.asarray(motion)))


def test_hbao_matches_jax(gbuffer):
    g, _ = gbuffer
    got = post.hbao(_t(g["view_pos"]), _t(g["view_normal"]))
    want = jpost.hbao(jnp.asarray(g["view_pos"]), jnp.asarray(g["view_normal"]))
    assert float(got.min()) < 0.9
    _close(got, want)


def test_min_depth_pyramid_matches_jax(gbuffer):
    g, _ = gbuffer
    depth = np.maximum(-g["view_pos"][..., 2], 1e-4)[:45, :61]
    got = post.build_min_depth_pyramid(_t(depth), 6)
    want = jpost.build_min_depth_pyramid(jnp.asarray(depth), 6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_ssr_matches_jax(gbuffer):
    """The 64-step hierarchical march: the same cells and hits, so colour
    and confidence agree to float rounding (a march step that flips on a
    rounding would show as a pixel of difference; none do here)."""
    g, cam = gbuffer
    color = _img(11, g["view_pos"].shape, 2.0)
    args = (color, g["view_pos"], g["view_normal"], g["roughness"])
    kw = dict(tan_half=math.tan(cam.v_fov * 0.5), aspect=cam.aspect)
    got = post.ssr(*map(_t, args), **kw)
    want = jpost.ssr(*map(jnp.asarray, args), **kw)
    assert float((want[1] > 0).mean()) > 0.05
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("sun", [(0.3, 0.8, 0.5), (-0.6, 0.7, -0.4)])
def test_screen_space_shadows_match_jax(gbuffer, sun):
    """`screen_space_shadows` on the G-buffer's view positions at the
    settings' defaults: the march's pixel offsets are rounded, so a step
    that lands within rounding of a depth test may flip one pixel; at
    least 99% of pixels within TOL, and some pixels shadowed."""
    g, _ = gbuffer
    d = np.array(sun, np.float32)
    d /= np.linalg.norm(d)
    want = np.asarray(jpost.screen_space_shadows(
        jnp.asarray(g["view_pos"]), jnp.asarray(d), jnp.asarray(g["depth"])))
    got = post.screen_space_shadows(_t(g["view_pos"]), _t(d),
                                    _t(g["depth"])).numpy()
    assert got.shape == want.shape == g["depth"].shape
    assert (np.abs(got - want) <= TOL).mean() >= 0.99
    assert (want < 1).mean() > 0.01


def test_sep_conv_and_kernel_match_jax():
    """`_sep_conv` (the blur's plain version) with `gaussian_kernel`'s taps,
    at a given radius too, within TOL."""
    x = _img(4, (30, 26, 2), 3.0)
    for sigma, radius in ((2.0, None), (1.2, 2)):
        taps = post.gaussian_kernel(sigma, radius)
        _close(taps, jpost.gaussian_kernel(sigma, radius), atol=1e-7,
               rtol=1e-6)
        _close(post._sep_conv(_t(x), taps),
               jpost._sep_conv(jnp.asarray(x), jpost.gaussian_kernel(sigma,
                                                                     radius)))


# One bfloat16 ulp of values below 2 (the images here): the intermediate
# and the operands are rounded to bfloat16, so a sum taken in another order
# may round the other way (measured: equal to JAX's bit for bit).
BF16_TOL = 2.0 ** -7


@pytest.mark.parametrize("shape", [(24, 36, 3), (20, 17)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gaussian_blur_matmul_matches_jax(shape, dtype):
    """`gaussian_blur_matmul` at bfloat16 (the default, as JAX) within a
    bfloat16 tolerance of the image's scale, and at float32 within 1e-5;
    at float32 also the shift-chain blur within 1e-5 (the same edge
    handling)."""
    x = _img(6, shape, 2.0)
    tdt = getattr(torch, dtype)
    got = post.gaussian_blur_matmul(_t(x), 1.5, dtype=tdt)
    want = np.asarray(jpost.gaussian_blur_matmul(jnp.asarray(x), 1.5,
                                                 dtype=getattr(jnp, dtype)))
    assert got.dtype == torch.float32 and got.shape == x.shape
    tol = BF16_TOL if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
    if dtype == "float32":
        _close(got, post.gaussian_blur(_t(x), 1.5), atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(got.numpy() - x).max() > 0.01    # it does blur


@pytest.mark.parametrize("size", [3, 5])
def test_dilate_erode_sobel_match_jax(size):
    """Morphology and the Sobel magnitude on a single-channel image with
    edges: dilate / erode exactly (min and max), sobel within TOL."""
    x = (_img(7, (21, 30)) > 0.7).astype(np.float32) * _img(8, (21, 30), 3.0)
    np.testing.assert_array_equal(post.dilate(_t(x), size).numpy(),
                                  np.asarray(jpost.dilate(jnp.asarray(x),
                                                          size)))
    np.testing.assert_array_equal(post.erode(_t(x), size).numpy(),
                                  np.asarray(jpost.erode(jnp.asarray(x),
                                                         size)))
    _close(post.sobel(_t(x)), jpost.sobel(jnp.asarray(x)))


def test_bloom_and_sharpen_match_jax():
    x = _img(12, (72, 100, 3), 8.0)
    settings = post.BloomSettings(threshold=3.0, strength=0.3)
    _close(post.bloom(_t(x), settings),
           jpost.bloom(jnp.asarray(x), jpost.BloomSettings(threshold=3.0,
                                                          strength=0.3)))
    y = _img(13, (40, 56, 3))
    _close(post.sharpen(_t(y)), jpost.sharpen(jnp.asarray(y)))


def test_settings_defaults_match_jax():
    for name in ("HBAOSettings", "SSRSettings", "TAASettings", "BloomSettings",
                 "SharpenSettings", "TonemapSettings", "SSSSettings"):
        ours, theirs = getattr(post, name)(), getattr(jpost, name)()
        for f in ours.__dataclass_fields__:
            assert getattr(ours, f) == pytest.approx(float(getattr(theirs, f)))


# --------------------------------------------------------------------------
# The kernels' source, compiled as host C++
# --------------------------------------------------------------------------

HARNESS = """\
#include "image.cu"
// Each block of the launch's plan run by one thread, which walks all of
// the block's work; `shared_limit` the bytes a block may have.
extern "C" int host_blur(const BlurArgs* a, int shared_limit) {
  if (a->radius < 0 || a->radius > BLUR_MAX_RADIUS) return -1;
  BlurPlan plan;
  if (blur_plan(*a, shared_limit, &plan) != 0) return -1;
  host_dynamic_shared.assign(plan.shared_bytes / 4, 0.0f);
  blockDim = dim3(1, 1);
  threadIdx = dim3(0, 0);
  gridDim = dim3(plan.grid_x, plan.grid_y, plan.grid_z);
  for (int bz = 0; bz < plan.grid_z; ++bz)
    for (int by = 0; by < plan.grid_y; ++by)
      for (int bx = 0; bx < plan.grid_x; ++bx) {
        blockIdx = dim3(bx, by, bz);
        blur_kernel(a->radius, a->channels, plan.group)(*a);
      }
  return 0;
}
// The channel slices of the launch's plan (grid.z); -1 if refused.
extern "C" int host_blur_slices(const BlurArgs* a, int shared_limit) {
  BlurPlan plan;
  return blur_plan(*a, shared_limit, &plan) == 0 ? plan.grid_z : -1;
}
// Every thread of the launch's grid, one after another, with at most
// `resident` blocks (the card's launch holds its SM count times the blocks
// an SM holds).
extern "C" int host_tonemap_grid(const TonemapArgs* a, int resident) {
  if (a->n == 0) return 0;
  blockDim = dim3(TONEMAP_THREADS);
  gridDim = dim3((unsigned)tonemap_blocks(*a, resident));
  for (unsigned b = 0; b < gridDim.x; ++b)
    for (unsigned t = 0; t < blockDim.x; ++t) {
      blockIdx = dim3(b);
      threadIdx = dim3(t);
      tonemap_kernel(a->srgb)(*a);
    }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_image(tmp_path_factory):
    host = build_host(tmp_path_factory, "host_image", HARNESS,
                      ("host_blur", "host_blur_slices", "host_tonemap_grid",
                       "blur_args_size", "tonemap_args_size",
                       "blur_max_radius"))
    host.host_blur.argtypes = host.host_blur_slices.argtypes = [
        ctypes.c_void_p, ctypes.c_int]
    host.host_tonemap_grid.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return host


# The shared memory a block of the H100 may have, in bytes.
SHARED_LIMIT = 232448


def _host_blur(host, limit=SHARED_LIMIT):
    return lambda args: host.host_blur(args, limit)


@pytest.mark.parametrize("sigma,shape", [(1.5, (70, 45, 1)), (1.5, (33, 60, 3)),
                                         (1.0, (64, 96, 3)), (2.0, (5, 7)),
                                         (5.0, (40, 50, 2))])
def test_host_blur_matches_plain(host_image, sigma, shape):
    """Bit for bit, through the real wrapper, ragged tiles and radii 3 to
    15 included."""
    x = torch.as_tensor(_img(14, shape, 3.0))
    taps = image.gaussian_kernel(sigma)
    got = image.blur_launch(_host_blur(host_image), x, taps)
    assert torch.equal(got, image.blur_plain(x, taps))


@pytest.mark.parametrize("radius,shape,limit,slices", [
    (0, (67, 120, 3), SHARED_LIMIT, 1), (1, (67, 120, 1), SHARED_LIMIT, 1),
    (3, (67, 120, 3), SHARED_LIMIT, 1), (4, (67, 120, 3), SHARED_LIMIT, 1),
    (4, (67, 120, 1), SHARED_LIMIT, 1), (3, (130, 200, 3), SHARED_LIMIT, 1),
    (16, (67, 120, 3), SHARED_LIMIT, 1), (16, (5, 7, 3), SHARED_LIMIT, 1),
    (16, (20, 70, 24), SHARED_LIMIT, 3), (16, (67, 120, 3), 48 * 1024, 2),
    (4, (40, 50, 24), 48 * 1024, 6), (16, (9, 9, 1), 16 * 1024, -1)])
def test_host_blur_matches_plain_at_radius(host_image, radius, shape, limit,
                                          slices):
    """Bit for bit at the radii 0 to 16 (3 and 4 are the frame's), on
    sizes that are not multiples of the 64 x 16 tile, with tiles clear of
    every edge (130 x 200) and an image smaller than the halo; channels
    beyond what a block's shared memory holds split into slices (24 at r =
    16 on the H100, and at a smaller limit), and a launch where not even
    one channel fits refused."""
    x = torch.as_tensor(_img(17, shape, 3.0))
    taps = image.gaussian_kernel(1.5, radius)
    args = image.BlurArgs(x.data_ptr(), 0, shape[0], shape[1], shape[2],
                          radius)
    assert host_image.host_blur_slices(ctypes.byref(args), limit) == slices
    if slices < 0:
        with pytest.raises(RuntimeError, match="launch failed"):
            image.blur_launch(_host_blur(host_image, limit), x, taps)
        return
    got = image.blur_launch(_host_blur(host_image, limit), x, taps)
    assert torch.equal(got, image.blur_plain(x, taps))


def _host_tonemap(host, resident=3):
    return lambda args: host.host_tonemap_grid(args, resident)


def _tonemap_inputs():
    """A 30 x 41 RGB image (3,690 floats: not a multiple of 4) with a zero,
    a negative and a tiny value, and two views of a flat copy: at offset 1
    (not 16-byte aligned) and of an odd length."""
    x = torch.as_tensor(_img(15, (30, 41, 3), 25.0))
    x[0, 0] = torch.tensor([0.0, -1.0, 1e-6])
    flat = torch.cat([torch.zeros(1), x.reshape(-1), torch.ones(4)])
    return {"image": x, "offset 1": flat[1:], "odd length": flat[2:3691]}


def _assert_tonemap_equal(got, want, srgb):
    if srgb:
        torch.testing.assert_close(got, want, rtol=2.5e-7, atol=1e-7)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("srgb", [False, True])
def test_host_tonemap_matches_plain(host_image, srgb):
    """Bit for bit without the sRGB encode; with it, within 2 ulps (the
    host's libm expf/logf against PyTorch's vectorised exp/log): on the
    image, a view at offset 1 and an odd length, through the real wrapper
    and every thread of a launch of three blocks."""
    k = image.tonemap_constants(post.TonemapSettings())
    for name, x in _tonemap_inputs().items():
        if name != "image":
            assert x.data_ptr() % 16 != 0 or x.numel() % 4 != 0, name
        got = image.tonemap_launch(_host_tonemap(host_image), x,
                                   image.tonemap_args(k, srgb))
        _assert_tonemap_equal(got, image.tonemap_plain(x, k, srgb), srgb)


@pytest.mark.parametrize("shift,n,resident", [
    (0, 3690, 3), (1, 3690, 3), (3, 3689, 3), (2, 7, 3), (0, 4, 1),
    (1, 2, 1), (0, 40000, 5)])
def test_host_tonemap_covers_every_float(host_image, shift, n, resident):
    """Every float written once, in the right place, where the input sits
    at `shift` floats past a 16-byte boundary: as vectors with a scalar
    head and tail where the output sits at the same offset, one at a time
    where it does not; grids of one to five blocks."""
    k = image.tonemap_constants(post.TonemapSettings())
    src = torch.as_tensor(_img(19, (n + 8,), 25.0))[shift:shift + n]
    for out_shift in sorted({shift, (shift + 1) % 4}):
        out = torch.full((n + 8,), float("nan"))[out_shift:out_shift + n]
        args = image.tonemap_args(k, False)
        args.src, args.dst, args.n = src.data_ptr(), out.data_ptr(), n
        assert host_image.host_tonemap_grid(ctypes.byref(args), resident) == 0
        assert torch.equal(out, image.tonemap_plain(src, k, False))


def test_image_layout_matches_the_wrapper(host_image):
    src = (cuda_build.CSRC_DIR / "image.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (BLUR_[A-Z_]+) = (\d+);", src)}
    assert consts["BLUR_MAX_RADIUS"] == image.BLUR_MAX_RADIUS
    assert host_image.blur_max_radius() == image.BLUR_MAX_RADIUS
    assert host_image.blur_args_size() == ctypes.sizeof(image.BlurArgs)
    assert host_image.tonemap_args_size() == ctypes.sizeof(image.TonemapArgs)
    for struct, cls in (("BlurArgs", image.BlurArgs),
                        ("TonemapArgs", image.TonemapArgs)):
        body = re.search(rf"struct {struct} \{{(.*?)\}};", src, re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body)
        names = [n for decl in body.split(";")
                 for n in re.findall(r"(\w+)(?:\[\w+\])?\s*(?:,|$)", decl.strip())]
        assert names == [f for f, _ in cls._fields_], struct


def test_wrappers_take_the_plain_versions_on_cpu():
    x = torch.as_tensor(_img(16, (20, 30, 3), 5.0))
    before = (image.gaussian_blur.launches, image.tonemap.launches)
    taps = image.gaussian_kernel(1.5)
    assert torch.equal(image.gaussian_blur(x, taps), image.blur_plain(x, taps))
    k = image.tonemap_constants(post.TonemapSettings())
    assert torch.equal(image.tonemap(x, post.TonemapSettings()),
                       image.tonemap_plain(x, k, False))
    assert (image.gaussian_blur.launches, image.tonemap.launches) == before
