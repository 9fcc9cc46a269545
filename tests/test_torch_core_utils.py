"""The port's host utilities against the JAX package's: the log ring
(`core/log.py`), profiling's block tree, stats and chrome export
(`core/profiling.py`), the kernel registry's invalidation
(`utils/hot_reload.py`, as tests/test_misc_utils.py:21 drives JAX's), the
four maths helpers `quat`, `quat_axis`, `transform_point` and
`inverse_transform_point` (within MATH_TOL of JAX's on seeded inputs)."""

import json
import os
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.core import log as jlog
from d3d12renderer_tpu.core import maths as jm
from d3d12renderer_tpu.core import profiling as jprof
from d3d12renderer_tpu_torch.core import log as tlog
from d3d12renderer_tpu_torch.core import maths as tm
from d3d12renderer_tpu_torch.core import profiling as tprof
from d3d12renderer_tpu_torch.utils.hot_reload import KernelRegistry

# Quaternion rotations of float32 points up to ~10 in size: a few ulps.
MATH_TOL = 1e-5


def test_log_ring_levels_and_origin():
    """The same messages leave the same (level, message) ring in both
    packages; `recent_messages(n)` is the ring's tail; origins name the
    caller's file and line; `set_level` sets the logger's level."""
    script = [("info", "hello %d", (1,)), ("warning", "careful", ()),
              ("error", "bad %s", ("x",)), ("debug", "quiet", ())]
    rows = {}
    for name, mod in (("jax", jlog), ("torch", tlog)):
        mod._ring.clear()
        for level, msg, args in script:
            getattr(mod, f"log_{level}")(msg, *args)
        got = mod.recent_messages()
        rows[name] = [(e.level, e.message) for e in got]
        assert all(e.origin.startswith("test_torch_core_utils.py:")
                   for e in got)
        assert [(e.level, e.message) for e in mod.recent_messages(2)] == \
            rows[name][-2:]
    assert rows["jax"] == rows["torch"] == [
        ("info", "hello 1"), ("warning", "careful"), ("error", "bad x"),
        ("debug", "quiet")]
    for i in range(tlog.LOG_RING_SIZE + 5):
        tlog.log_info("m%d", i)
    assert len(tlog.recent_messages()) == tlog.LOG_RING_SIZE == \
        jlog.LOG_RING_SIZE
    assert tlog.recent_messages(1)[0].message == \
        f"m{tlog.LOG_RING_SIZE + 4}"
    tlog.set_level("warning")
    assert tlog._logger.level == 30
    tlog.set_level("info")


def _nested_blocks(prof):
    with prof.profile_block("frame"):
        with prof.profile_block("physics"):
            time.sleep(0.002)
        with prof.profile_block("render"):
            with prof.profile_block("trace"):
                time.sleep(0.001)
    prof.profile_stat("rays", 10.0)
    prof.profile_stat("rays", 5.0)


def test_profiling_tree_stats_and_chrome_export(tmp_path):
    """Nested blocks resolve into the same tree (names and nesting) as
    JAX's, stats add up, and the chrome trace holds every event.  The
    port's recorder is off by default: it records once turned on, and
    nothing after it is turned off again."""
    trees = {}
    tprof.set_enabled(True)
    try:
        for name, mod in (("jax", jprof), ("torch", tprof)):
            mod.resolve_frame()
            _nested_blocks(mod)
            path = tmp_path / f"{name}.json"
            mod.export_chrome_trace(str(path))
            doc = json.loads(path.read_text())
            assert sorted(e["name"] for e in doc["traceEvents"]) == [
                "frame", "physics", "render", "trace"]
            frame = mod.resolve_frame()
            assert frame["stats"] == {"rays": 15.0}

            def shape(nodes):
                return [(n["name"], shape(n["children"])) for n in nodes]

            trees[name] = shape(frame["tree"])
            assert mod.resolve_frame()["events"] == []
    finally:
        tprof.set_enabled(False)
    assert trees["torch"] == trees["jax"] == [
        ("frame", [("physics", []), ("render", [("trace", [])])])]
    _nested_blocks(tprof)
    assert tprof.resolve_frame() == {"events": [], "stats": {}, "tree": []}


def test_device_timing_and_kernel_report_on_the_cpu(tmp_path):
    """`kernel_report` times CPU tensors on the host clock; the report
    keeps JAX's keys (and adds the card), counts a matmul's 2mnk operations
    and the inputs' and output's bytes, and holds no TPU peak;
    `device_trace` writes a chrome trace."""
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    rep = tprof.kernel_report(torch.matmul, a, b, iters=2, warmup=1)
    assert 0 < rep["wall_s_per_call"] < 1
    jkeys = {"compile_s", "wall_s_per_call", "device_s_per_call", "flops",
             "bytes_accessed", "achieved_gflops", "achieved_gbps",
             "flops_utilization", "hbm_utilization", "platform"}
    assert jkeys <= set(rep) and rep["platform"] == "cpu"
    assert rep["flops"] == 2 * 64 * 32 * 16
    assert rep["bytes_accessed"] == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert "tpu" not in tprof.PLATFORM_PEAKS
    assert tprof.PLATFORM_PEAKS["cuda"] == {"flops": 67e12,
                                            "hbm_gbps": 3350.0}
    with tprof.device_trace(str(tmp_path), "t.json"):
        torch.matmul(a, b)
    assert "traceEvents" in json.loads((tmp_path / "t.json").read_text())


def test_kernel_registry_invalidation(tmp_path):
    """tests/test_misc_utils.py:21's script on the port's registry: a
    rewritten module reloads, its version bumps, the next call runs the
    new code; `watch` wires a FileRegistry change to the reload."""
    mod_dir = tmp_path / "tpkg"
    mod_dir.mkdir()
    (mod_dir / "__init__.py").write_text("")
    (mod_dir / "k.py").write_text("def f(x):\n    return x * 2\n")
    sys.path.insert(0, str(tmp_path))
    try:
        reg = KernelRegistry()
        reg.register("double", "tpkg.k", "f")
        assert float(reg("double", torch.tensor(3.0))) == 6.0
        v0 = reg.version("double")
        (mod_dir / "k.py").write_text("def f(x):\n    return x * 3\n")
        assert reg.invalidate_module("tpkg.k") == 1
        assert reg.version("double") == v0 + 1
        assert float(reg("double", torch.tensor(3.0))) == 9.0

        from d3d12renderer_tpu_torch.assets.cache import FileRegistry

        files = FileRegistry(str(mod_dir), registry_file="reg.yaml")
        reg.watch(files, str(mod_dir), "tpkg")
        (mod_dir / "k.py").write_text("def f(x):\n    return x * 4\n")
        os.utime(mod_dir / "k.py", (1, 1))
        files.scan()
        assert reg.version("double") == v0 + 2
        assert float(reg("double", torch.tensor(3.0))) == 12.0
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("tpkg.k", None)
        sys.modules.pop("tpkg", None)


def test_maths_helpers_match_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0] = (0.0, 0.0, 0.0, 1.0)           # identity: the +x fallback
    q[1] = (0.0, 0.0, 0.0, -1.0)
    pos = rng.normal(size=(64, 3)).astype(np.float32)
    p = rng.normal(size=(64, 3)).astype(np.float32) * 3
    np.testing.assert_array_equal(tm.quat(0.1, 0.2, 0.3, 0.9).numpy(),
                                  np.asarray(jm.quat(0.1, 0.2, 0.3, 0.9)))
    tq, tpos, tp = (torch.as_tensor(x) for x in (q, pos, p))
    for got, want in (
            (tm.quat_axis(tq), jm.quat_axis(jnp.asarray(q))),
            (tm.transform_point(tpos, tq, tp),
             jm.transform_point(jnp.asarray(pos), jnp.asarray(q),
                                jnp.asarray(p))),
            (tm.inverse_transform_point(tpos, tq, tp),
             jm.inverse_transform_point(jnp.asarray(pos), jnp.asarray(q),
                                        jnp.asarray(p)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=MATH_TOL)
    np.testing.assert_array_equal(tm.quat_axis(tq[:2]).numpy(),
                                  [[1, 0, 0], [1, 0, 0]])
    back = tm.inverse_transform_point(tpos, tq, tm.transform_point(tpos, tq,
                                                                   tp))
    np.testing.assert_allclose(back.numpy(), p, rtol=0, atol=MATH_TOL)
