"""The port's span and counter recorder (`core/profiling.py`) in the path
tracer and the ray queries, on the CPU at small sizes: off by default and
then recording nothing and changing nothing; the tree of one frame on a
scene of more than one 1024-row chunk; spans on the clock of
`torch.profiler`'s events, and on while a session runs; the live-row
counters against the frame's ray count; the stage and phase times that
`render_frame` and `train_iteration` return through it."""

import math

import pytest
import torch

from d3d12renderer_tpu_torch.core import profiling as prof
from d3d12renderer_tpu_torch.learning import ppo
from d3d12renderer_tpu_torch.learning.loco_env import LocoEnv
from d3d12renderer_tpu_torch.ops import ray_trace
from d3d12renderer_tpu_torch.render import bvh as tbvh
from d3d12renderer_tpu_torch.render import mesh as tmesh
from d3d12renderer_tpu_torch.render import pathtracer as tpt
from d3d12renderer_tpu_torch.render import pipeline as tpipe
from d3d12renderer_tpu_torch.render.camera import look_at

torch.set_num_threads(1)
W, H, DEPTH = 16, 12, 2


def small_scene(subdivisions):
    """A ground quad and an ico sphere (subdivision 3: 1,282 rows, more
    than one chunk; 1: 82 rows, one chunk)."""
    meshes = [(tmesh.quad(half=30.0), 0),
              (tmesh.ico_sphere(1.0, subdivisions).transformed(
                  translate=(0, 1.0, 0)), 1)]
    materials = tpt.Materials(
        albedo=torch.tensor([[0.5, 0.5, 0.5], [0.7, 0.2, 0.1]]),
        emissive=torch.zeros(2, 3), roughness=torch.tensor([0.6, 0.3]),
        metallic=torch.tensor([0.0, 0.0]))
    return tpt.Scene(bvh=tbvh.build_bvh(meshes, device="cpu"),
                     materials=materials,
                     sky=tpt.default_sky(device="cpu")).with_shading_table()


@pytest.fixture(scope="module")
def scene():
    s = small_scene(3)
    assert s.bvh.dense.n.shape[0] > ray_trace.TRI_CHUNK
    return s


@pytest.fixture
def recorder():
    """The recorder emptied, and off again afterwards."""
    prof.set_enabled(False)
    prof.resolve_frame()
    yield prof
    prof.set_enabled(False)
    prof.resolve_frame()


CAMERA = look_at((4, 3, 5), (0, 0.8, 0), aspect=W / H,
                 v_fov=math.radians(45), device="cpu")


def frame(scene, seed=5):
    return tpt.render(scene, CAMERA, W, H,
                      tpt.PathTracerSettings(recursion_depth=DEPTH),
                      sampler=tpt.Sampler(
                          torch.Generator().manual_seed(seed)))


def test_recorder_off_records_nothing_and_changes_nothing(scene, recorder):
    """Off (the default), a frame records no span and no counter, and its
    image and ray count are bit-equal to the same seed's frame recorded."""
    assert prof.profile_block("x") is prof.profile_block("y")
    img_off, rays_off = frame(scene)
    assert recorder.recorded() == {"spans": [], "counters": {}}
    recorder.set_enabled(True)
    img_on, rays_on = frame(scene)
    recorder.set_enabled(False)
    assert len(recorder.recorded()["spans"]) > 0
    assert torch.equal(img_off, img_on)
    assert int(rays_off) == int(rays_on)


def _children(spans, i):
    return [j for j, s in enumerate(spans) if s["parent"] == i]


def _names(spans, idx):
    return [spans[j]["name"] for j in idx]


def test_frame_span_tree(scene, recorder):
    """One frame: `pt.frame` > `pt.camera`, DEPTH + 1 `pt.bounce` (each
    `ray.trace` > [`ray.regroup`,] `ray.walk` [, `ray.regroup`], then
    `pt.shade` > the sun's shadow query, regrouped after the first bounce
    too), `pt.accumulate`, `pt.sync`; every span carries the frame's id, and
    each lies inside its parent on the host's clock."""
    recorder.set_enabled(True)
    frame(scene)
    frame(scene)
    recorder.set_enabled(False)
    spans = recorder.recorded()["spans"]
    roots = [i for i, s in enumerate(spans) if s["parent"] is None]
    assert _names(spans, roots) == ["pt.frame", "pt.frame"]
    assert spans[roots[0]]["frame"] != spans[roots[1]]["frame"]
    root = roots[0]
    top = _children(spans, root)
    assert _names(spans, top) == (["pt.camera"] + ["pt.bounce"] * (DEPTH + 1)
                                  + ["pt.accumulate", "pt.sync"])

    def query(i, regrouped):
        assert spans[i]["name"] == "ray.trace"
        want = (["ray.regroup", "ray.walk", "ray.regroup"] if regrouped
                else ["ray.walk"])
        assert _names(spans, _children(spans, i)) == want

    for b, i in enumerate(top[1:DEPTH + 2]):
        assert spans[i]["attrs"] == {"bounce": b}
        trace, shade = _children(spans, i)
        query(trace, b > 0)
        assert spans[shade]["name"] == "pt.shade"
        (shadow,) = _children(spans, shade)
        query(shadow, b > 0)
    ours = [s for s in spans if s["frame"] == spans[root]["frame"]]
    assert len(ours) == roots[1] - roots[0]
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        assert s["device_ms"] is None            # no card on the CPU
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["frame"] == s["frame"]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= \
                p["end_ns"]


def test_one_chunk_scene_queries_are_not_regrouped(recorder):
    """On a scene of one chunk a bounce query takes the brute kernel's path
    unregrouped, as JAX's Pallas backend does: no `ray.regroup`."""
    recorder.set_enabled(True)
    frame(small_scene(1))
    recorder.set_enabled(False)
    names = [s["name"] for s in recorder.recorded()["spans"]]
    assert "ray.regroup" not in names
    assert names.count("ray.walk") == names.count("ray.trace") == \
        2 * (DEPTH + 1)


def test_spans_on_the_profilers_clock(recorder):
    """Under a CPU `torch.profiler` session, with no `set_enabled` call, the
    recorder is on; a span around a matmul contains the profiler's
    `aten::mm` once both are in Unix-time ns; after the session it is off
    again."""
    a = torch.randn(256, 256)
    assert prof.profile_block("before") is prof.profile_block("x")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as session:
        with prof.profile_block("mm"):
            a @ a
    assert prof.profile_block("after") is prof.profile_block("x")
    (span,) = recorder.recorded()["spans"]
    mms = [ev for ev in session.profiler.kineto_results.events()
           if ev.name() == "aten::mm"]
    assert len(mms) == 1
    assert span["start_ns"] <= mms[0].start_ns()
    assert mms[0].start_ns() + mms[0].duration_ns() <= span["end_ns"]


def test_live_row_counters_against_the_ray_count(scene, recorder,
                                                 monkeypatch):
    """`pt.rows` is DEPTH x R and the sum of `pt.live_rows` is the frame's
    `rays_traced` less its R primary rays and its shadow rays (counted
    here from the shadow queries' t_max)."""
    shadow = []
    any_hit = tbvh.any_hit

    def counting(bvh, origin, direction, t_max, **kw):
        shadow.append(int((t_max > 0).sum()))
        return any_hit(bvh, origin, direction, t_max, **kw)

    monkeypatch.setattr(tpt.bvh_mod, "any_hit", counting)
    recorder.set_enabled(True)
    _, rays = frame(scene)
    recorder.set_enabled(False)
    counters = recorder.recorded()["counters"]
    r = W * H
    assert len(shadow) == DEPTH + 1
    assert counters["pt.rows"] == DEPTH * r
    assert counters["pt.live_rows"] == int(rays) - r - sum(shadow)
    assert 0 < counters["pt.live_rows"] < counters["pt.rows"]


def test_stage_and_phase_times_keep_their_keys(recorder):
    """`render_frame(profile_stages=True)`'s `stage_ms` and
    `train_iteration(profile_phases=True)`'s `phase_ms` keep their keys,
    with the recorder off and without recording into it; with the recorder
    on the same stages are `raster.*` and `ppo.*` spans."""
    scene = small_scene(1)
    cam = look_at((4, 3, 5), (0, 0.8, 0), aspect=64 / 48,
                  v_fov=math.radians(45), device="cpu")
    _, _, aux = tpipe.render_frame(scene, cam, 64, 48,
                                   tpipe.RendererSettings(),
                                   profile_stages=True)
    stages = ["gbuffer", "effects", "opaque", "reflections", "compose",
              "taa", "post"]
    assert list(aux["stage_ms"]) == stages
    assert all(ms >= 0 for ms in aux["stage_ms"].values())
    init, train_iteration, _ = ppo.make_ppo(
        LocoEnv(device="cpu"), ppo.PPOConfig(num_envs=2, rollout_steps=2,
                                             minibatches=1, epochs=1))
    _, metrics = train_iteration(init(0), profile_phases=True)
    assert list(metrics["phase_ms"]) == ["rollout", "gae", "update",
                                         "monitor"]
    assert all(ms >= 0 for ms in metrics["phase_ms"].values())
    assert recorder.recorded()["spans"] == []

    _, _, aux = tpipe.render_frame(scene, cam, 64, 48,
                                   tpipe.RendererSettings())
    assert "stage_ms" not in aux and recorder.recorded()["spans"] == []
    recorder.set_enabled(True)
    tpipe.render_frame(scene, cam, 64, 48, tpipe.RendererSettings())
    recorder.set_enabled(False)
    names = [s["name"] for s in recorder.recorded()["spans"]]
    assert [n for n in names if n.startswith("raster.")] == [
        f"raster.{s}" for s in stages]


def test_counters_keep_device_values_and_sum_when_read(recorder):
    """A counter keeps a 0-d tensor as given and sums on read; integers
    stay integers; `resolve_frame` takes spans and counters, and the
    chrome trace carries a span's attributes."""
    recorder.set_enabled(True)
    with prof.profile_block("outer", attrs={"k": 1}):
        prof.profile_stat("n", torch.tensor(3))
        prof.profile_stat("n", 4)
        prof.profile_stat("x", torch.tensor(0.5))
    recorder.set_enabled(False)
    got = recorder.recorded()
    assert got["counters"] == {"n": 7, "x": 0.5}
    assert isinstance(got["counters"]["n"], int)
    taken = recorder.resolve_frame()
    assert taken["stats"] == {"n": 7, "x": 0.5}
    (event,) = taken["events"]
    assert event["args"]["k"] == 1 and event["name"] == "outer"
    assert recorder.recorded() == {"spans": [], "counters": {}}
