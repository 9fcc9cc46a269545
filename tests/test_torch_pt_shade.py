"""The path tracer's two shading kernels (`csrc/pt_shade.cu`,
`ops/pt_shade.py`) against their plain versions
(`render/pathtracer.py` `shade_hit_plain` / `shade_next_plain`).

On the CPU the kernel source is compiled as host C++ (g++
-ffp-contract=off, tests/torch_host_build.py) and driven through
`pt_shade.launch_hit` / `launch_next` on CPU tensors.  It rounds as
PyTorch's CUDA kernels round (a three-term sum as (x0 + x2) + x1, a
division by a Python float as a product with its reciprocal), which the CPU
plain version does not, and the host's libm is not CUDA's: so here each
half is held to its plain half within float tolerances, and a path may part
on a rounding at a rare row.  Tests marked `cuda` run the kernels on the
card against the plain halves on the same inputs and draws: no row may
differ in its live mask or shadow t_max.  Imports no JAX."""

import ctypes

import pytest
import torch

import torch_pt_cases as cases
from d3d12renderer_tpu_torch.ops import pt_shade
from d3d12renderer_tpu_torch.render import pathtracer as tpt
from torch_host_build import build_host

torch.set_num_threads(1)

HARNESS = r"""
#include "pt_shade.cu"

typedef void (*ShadeKernel)(const ShadeArgs);

// Every thread of every block in turn (no barrier is needed: each
// thread adds its own counts when compiled as host code).
static int run(const void* kernel, const ShadeArgs* a) {
  if (kernel == nullptr) return -1;
  ShadeKernel fn = (ShadeKernel)kernel;
  const int blocks = (a->num_rays + PT_SHADE_THREADS - 1) / PT_SHADE_THREADS;
  for (int b = 0; b < blocks; ++b)
    for (int t = 0; t < PT_SHADE_THREADS; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      fn(*a);
    }
  return 0;
}

extern "C" int host_shade_hit(const ShadeArgs* a) { return run(pick_hit(*a), a); }
extern "C" int host_shade_next(const ShadeArgs* a) { return run(pick_next(*a), a); }
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return build_host(tmp_path_factory, "pt_shade", HARNESS,
                      ("host_shade_hit", "host_shade_next",
                       "pt_shade_args_size"))


def test_args_layout_matches_the_kernel(host):
    assert ctypes.sizeof(pt_shade.ShadeArgs) == host.pt_shade_args_size()
    assert pt_shade.SKY_COLS >= 37 and pt_shade.TABLE_COLS == 28


def _close(got, want, rtol, what, mask=None):
    """|got - want| <= rtol (|want| + 1e-6) on the rows of `mask`."""
    if mask is not None:
        got, want = got[mask], want[mask]
    bad = ~((got - want).abs() <= rtol * (want.abs() + 1e-6))
    assert not bad.any(), (what, int(bad.sum()), got[bad][:4], want[bad][:4])


class Checked:
    """The halves of `trace_sample`'s shading (`pathtracer.shaders`) as
    the kernels (`hit_fn`, `next_fn`: launchers of the ShadeArgs), each
    launch held against the plain half on copies of the same inputs.
    `rtol` bounds the float outputs; `decisions` the share of rows whose
    live mask or shadow t_max may differ (0 on the card)."""

    def __init__(self, hit_fn, next_fn, rtol, decisions=0.0):
        self.hit_fn, self.next_fn = hit_fn, next_fn
        self.rtol, self.decisions = rtol, decisions
        self.launches = 0

    def _decisions(self, got, want, what):
        """The rows where `got` and `want` (a live mask, or a t_max whose
        rays are masked at 0) decide alike; a t_max where it is set within
        `rtol`, and equal on the card."""
        if got.dtype != torch.bool:
            if self.decisions == 0:
                assert torch.equal(got, want), what
            _close(got, want, self.rtol, what, (got > 0) & (want > 0))
            got, want = got > 0, want > 0
        differ = float((got != want).float().mean())
        assert differ <= self.decisions, (what, differ)
        return got == want

    def hit(self, ctx, res, o, d, alive, throughput, radiance, draws, counts,
            first):
        c = counts.clone()
        want = tpt.shade_hit_plain(ctx, res, o, d, alive.clone(),
                                        throughput.clone(), radiance.clone(),
                                        draws, c, first)
        got = pt_shade.launch_hit(self.hit_fn, ctx, res, o, d, alive,
                                  throughput, radiance, draws, counts, first)
        self.launches += 1
        for name in ("radiance", "normal", "point"):
            _close(getattr(got, name), getattr(want, name), self.rtol, name)
        for name in ("sun", "light"):
            if getattr(want, f"{name}_dir") is None:
                assert getattr(got, f"{name}_dir") is None
                continue
            same = self._decisions(getattr(got, f"{name}_t_max"),
                                   getattr(want, f"{name}_t_max"),
                                   f"{name} t_max")
            got_dir = getattr(got, f"{name}_dir")
            _close(got_dir, getattr(want, f"{name}_dir").expand_as(got_dir),
                   self.rtol, f"{name} dir", same)
        if self.decisions == 0:
            assert torch.equal(counts, c)
        return got

    def next(self, ctx, res, d, alive, throughput, hs, sun_shadowed,
             light_shadowed, draws, counts, first, live_slot):
        c = counts.clone()
        plain_hs = pt_shade.HitShading(**{
            k: (None if v is None else v.clone())
            for k, v in vars(hs).items()})
        want = tpt.shade_next_plain(
            ctx, res, d, alive.clone(), throughput.clone(), plain_hs,
            sun_shadowed, light_shadowed, draws, c, first, live_slot)
        got = pt_shade.launch_next(self.next_fn, ctx, res, d, alive,
                                   throughput, hs, sun_shadowed,
                                   light_shadowed, draws, counts, first,
                                   live_slot)
        self.launches += 1
        _close(got[0], want[0], self.rtol, "radiance")
        if want[1] is None:
            assert all(x is None for x in got[1:])
        else:
            same = self._decisions(got[2], want[2], "alive")
            self._decisions(got[4], want[4], "t_max")
            live = same & want[2]
            _close(got[1], want[1], self.rtol, "throughput", live)
            _close(got[3], want[3], self.rtol, "direction", live)
        if self.decisions == 0:
            assert torch.equal(counts, c)
        return got


def _host_launchers(host):
    return (lambda a: host.host_shade_hit(a),
            lambda a: host.host_shade_next(a))


def _trace(case, device, checked, monkeypatch, width=cases.W,
           height=cases.H, seed=5):
    """The case's sample through `checked`'s kernels, and through the
    plain halves alone, from one seed."""
    scene = cases.case_scene(case, device)
    settings = cases.case_settings(case)
    o, d = cases.case_rays(device, width, height)
    out = []
    for halves in ((checked.hit, checked.next),
                   (tpt.shade_hit_plain, tpt.shade_next_plain)):
        with monkeypatch.context() as mp:
            mp.setattr(tpt, "shaders", lambda device, h=halves: h)
            out.append(tpt.trace_sample(scene, settings, o, d, tpt.Sampler(
                torch.Generator(device=device).manual_seed(seed))))
    assert checked.launches == 2 * (settings.recursion_depth + 1)
    return out


@pytest.mark.parametrize("case", cases.CASES)
def test_host_kernels_match_plain(case, host, monkeypatch):
    """Every feature case through both kernels compiled as host code, each
    half against its plain half at every bounce; float outputs within 2e-5
    relative (CPU and CUDA rounding), at most 1% of the rows' decisions
    parted by a rounding; the image's mean within 2%."""
    checked = Checked(*_host_launchers(host), rtol=2e-5, decisions=0.01)
    (rad, rays), (want, want_rays) = _trace(case, "cpu", checked,
                                            monkeypatch)
    assert torch.isfinite(rad).all() and rad.mean() > 0
    assert abs(float(rad.mean() / want.mean()) - 1) < 0.02
    assert abs(int(rays) / int(want_rays) - 1) < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("case", cases.CASES)
def test_kernels_match_plain_on_cuda(case, monkeypatch):
    """Each kernel against its plain half on the card at every bounce of
    every feature case, on the same inputs and draws: the live mask, the
    shadow t_max and the ray counts equal, radiance, throughput, normals,
    points and directions within 1e-5 relative; so the whole sample
    equals the plain one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    from d3d12renderer_tpu_torch.cuda_build import launcher

    dev = torch.device("cuda")
    checked = Checked(launcher("pt_shade_hit_launch", dev),
                      launcher("pt_shade_next_launch", dev), rtol=1e-5)
    (rad, rays), (want, want_rays) = _trace(case, "cuda", checked,
                                            monkeypatch, 64, 48)
    torch.cuda.synchronize()
    _close(rad, want, 1e-5, "sample radiance")
    assert int(rays) == int(want_rays)


@pytest.mark.cuda
def test_atrium_bounce_on_cuda(monkeypatch):
    """The atrium's 1080p frame: each wrapper's `.launches` rises by one a
    bounce, `pt.shade_fused` equals `pt.bounces`; at bounce 1 (the first
    regrouped bounce, 2,073,600 rows) both kernels against their plain
    halves as in `test_kernels_match_plain_on_cuda`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    from d3d12renderer_tpu_torch.core import profiling
    from d3d12renderer_tpu_torch.cuda_build import launcher
    from d3d12renderer_tpu_torch.entry import pathtrace_entry

    dev = torch.device("cuda")
    fn, args = pathtrace_entry(width=1920, height=1080)
    depth = tpt.PathTracerSettings().recursion_depth
    before = pt_shade.shade_hit.launches, pt_shade.shade_next.launches
    profiling.set_enabled(True)
    try:
        profiling.resolve_frame()
        fn(*args)
        stats = profiling.resolve_frame()["stats"]
    finally:
        profiling.set_enabled(False)
    assert (pt_shade.shade_hit.launches - before[0],
            pt_shade.shade_next.launches - before[1]) == (depth + 1,) * 2
    assert stats["pt.shade_fused"] == stats["pt.bounces"] == depth + 1
    checked = Checked(launcher("pt_shade_hit_launch", dev),
                      launcher("pt_shade_next_launch", dev), rtol=1e-5)
    calls = {"hit": 0, "next": 0}

    def at_bounce_1(kind, checked_fn, kernel_fn):
        def fn_(*a):
            calls[kind] += 1
            return (checked_fn if calls[kind] == 2 else kernel_fn)(*a)
        return fn_

    halves = (at_bounce_1("hit", checked.hit, pt_shade.shade_hit),
              at_bounce_1("next", checked.next, pt_shade.shade_next))
    monkeypatch.setattr(tpt, "shaders", lambda device: halves)
    img, _ = fn(*args)
    torch.cuda.synchronize()
    assert checked.launches == 2 and torch.isfinite(img).all()
    assert calls == {"hit": depth + 1, "next": depth + 1}


def test_wrappers_take_only_cuda_tensors():
    """The kernels' wrappers raise on rays off the card (no fallback) and
    launch nothing; `shaders` gives the plain halves there."""
    scene = cases.case_scene("gradient", "cpu")
    settings = tpt.PathTracerSettings()
    o, d = cases.case_rays("cpu")
    ctx = tpt.shading_context(scene, settings)
    res = {"t": torch.zeros(o.shape[0]), "hit": torch.zeros(
        o.shape[0], dtype=torch.bool)}
    before = pt_shade.shade_hit.launches, pt_shade.shade_next.launches
    with pytest.raises(ValueError, match="CUDA"):
        pt_shade.shade_hit(ctx, res, o, d, None, None, None,
                           pt_shade.BounceDraws(), None, True)
    with pytest.raises(ValueError, match="CUDA"):
        pt_shade.shade_next(ctx, res, d, None, None, None, None, None,
                            pt_shade.BounceDraws(), None, True, 1)
    assert (pt_shade.shade_hit.launches,
            pt_shade.shade_next.launches) == before
    assert tpt.shaders(o.device) == (tpt.shade_hit_plain,
                                     tpt.shade_next_plain)


def test_shade_bytes_counts_dead_rows_at_their_masks():
    """`profiling.shade_bytes`: a live row at the kernels' full bytes, a
    dead one at its alive byte and the masks it writes (the shadow
    queries' t_max in pt_shade_hit, the next query's in pt_shade_next
    before the last bounce)."""
    from d3d12renderer_tpu_torch.core import profiling

    def bytes_(live, last=False, lights=True):
        return profiling.shade_bytes(100, live, 10, False, last, True,
                                     lights, False, False)

    full, none = bytes_(100), bytes_(0)
    assert none == (100 * 9 + 600, 100 * 5 + 200)
    # 25 + 76 + 16 + 36 bytes a live row in pt_shade_hit, 13 + 36 + 25 +
    # 33 + 41 in pt_shade_next.
    assert full == (100 * 153 + 600, 100 * 148 + 200)
    assert bytes_(40) == (40 * 153 + 60 * 9 + 600, 40 * 148 + 60 * 5 + 200)
    assert bytes_(0, last=True)[1] == 100 * 1 + 200
    assert bytes_(0, lights=False)[0] == 100 * 5 + 600
    first = profiling.shade_bytes(100, 100, 10, True, False, True, True,
                                  False, False)
    assert all(a < b for a, b in zip(first, full))
