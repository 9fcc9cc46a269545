"""The SSR march (`ops/ssr.py`, `csrc/ssr.cu`): the kernel's source built as
host C++ (one pixel at a time) against `ssr_march_plain`, bit for bit, on
the rays `post.ssr_rays` makes from a small scene's view (a floor, a wall
and boxes, seen at three camera tilts), and on rays where the march runs
out of steps; the pyramid's host levels against the built pyramid's; and
on the card (`cuda`) the kernel against the plain march."""

import ctypes
import math

import pytest
import torch

from d3d12renderer_tpu_torch.ops import ssr as ssr_ops
from d3d12renderer_tpu_torch.render import post

_HARNESS = """\
#include "ssr.cu"

extern "C" int host_ssr(const SsrArgs* a) {
  for (long long i = 0; i < a->n; ++i) ssr_march_pixel(*a, i);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_ssr(tmp_path_factory):
    from tests.torch_host_build import build_host

    host = build_host(tmp_path_factory, "host_ssr", _HARNESS,
                      ("host_ssr", "ssr_args_size", "ssr_max_mips"))
    host.host_ssr.argtypes = [ctypes.c_void_p]
    return host


def _view(h, w, frame, seed):
    """View-space positions and normals of the flythrough's pile (bodies
    over the ground quad, `flythrough_world(pile_seed=seed)`) from frame
    `frame` of a 12-frame orbit, through the raster primary's G-buffer."""
    from d3d12renderer_tpu_torch import entry
    from d3d12renderer_tpu_torch.render import pathtracer as pt
    from d3d12renderer_tpu_torch.render.gbuffer import render_gbuffer
    from d3d12renderer_tpu_torch.render.instances import retransform

    world = entry.flythrough_world("cpu", pile_seed=seed)
    pos = torch.cat([world.state.pos[0], torch.zeros(1, 3)])
    pos[:-1, 1] = 0.4 + 0.1 * pos[:-1, 1]            # lowered onto the ground
    rot = torch.cat([world.state.rot[0], torch.tensor([[0.0, 0, 0, 1]])])
    scene = pt.Scene(bvh=retransform(world.instances, pos, rot),
                     materials=world.materials, sky=world.sky)
    cam = entry.flythrough_camera(frame, 12, w, h, device="cpu")
    with torch.inference_mode():
        gb = render_gbuffer(scene, cam, w, h, primary="raster")
    return gb.view_pos.contiguous(), gb.view_normal.contiguous(), cam


def _march_inputs(h, w, frame, seed, steps=64):
    settings = post.SSRSettings(num_steps=steps)
    view_pos, view_n, cam = _view(h, w, frame, seed)
    r = post.ssr_rays(view_pos, view_n, settings,
                      math.tan(cam.v_fov * 0.5), cam.aspect)
    return r, settings


@pytest.mark.parametrize("frame,steps", [(0, 64), (4, 64), (7, 64),
                                         (4, 5)])
def test_host_kernel_matches_plain_march(host_ssr, frame, steps):
    h, w = 48, 80
    r, settings = _march_inputs(h, w, frame, 3, steps)
    want_t, want_found = ssr_ops.ssr_march_plain(
        r["x0"], r["y0"], r["dx"], r["dy"], r["k0"], r["dk"], r["t_max"],
        r["flat"], r["offs"], r["ws"], r["hs"], steps, settings.thickness)
    t_hit = torch.empty(h * w)
    found = torch.empty(h * w, dtype=torch.int32)
    rays = [r[k].contiguous() for k in ("x0", "y0", "dx", "dy", "k0", "dk",
                                        "t_max")]
    args = ssr_ops.march_args(*rays, r["flat"], r["levels"], steps,
                              settings.thickness, t_hit, found)
    assert host_ssr.ssr_args_size() == ctypes.sizeof(ssr_ops.SsrArgs)
    assert host_ssr.ssr_max_mips() == ssr_ops.MAX_MIPS
    assert host_ssr.host_ssr(ctypes.byref(args)) == 0
    assert torch.equal(found.bool().reshape(h, w), want_found)
    assert torch.equal(t_hit.reshape(h, w), want_t)
    hits = int(want_found.sum())
    assert 0.01 * h * w < hits < h * w, hits


def test_pyramid_levels_match_the_built_pyramid():
    for h, w in ((540, 960), (33, 17), (1, 8), (64, 64)):
        flat, offs, ws, hs = post.build_min_depth_pyramid(torch.rand(h, w))
        levels = post.pyramid_levels(h, w)
        assert [offs.tolist(), ws.tolist(), hs.tolist()] == [list(x)
                                                             for x in levels]
        assert flat.numel() == levels[0][-1] + levels[1][-1] * levels[2][-1]


def test_wrapper_refuses_too_many_levels():
    x = torch.zeros(4)
    with pytest.raises(ValueError):
        ssr_ops.march_args(*(x,) * 8, ([0] * 9, [1] * 9, [1] * 9), 4, 1.0,
                           x, torch.zeros(4, dtype=torch.int32))


@pytest.mark.cuda
def test_kernel_matches_plain_march_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SSR kernel has no CPU build here")
    dev = torch.device("cuda")
    for frame in (0, 4, 7):
        r, settings = _march_inputs(540, 960, frame, 5)
        r = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
             for k, v in r.items()}
        args = [r[k] for k in ("x0", "y0", "dx", "dy", "k0", "dk", "t_max",
                               "flat", "offs", "ws", "hs")]
        before = ssr_ops.ssr_march.launches
        got = ssr_ops.ssr_march(*args, 64, settings.thickness,
                                levels=r["levels"])
        want = ssr_ops.ssr_march_plain(*args, 64, settings.thickness)
        assert ssr_ops.ssr_march.launches == before + 1
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
