"""tools/torch_perf_report.py on the CPU at tiny sizes (its module's
SIZES["cpu"], ITERATIONS and WARM_STEPS cut; one timed call a row): every
row of the report is present, with a bound where the row is a kernel
whose work the CPU can count, the table is written, the BVH cache's miss
and hit are timed, and a row that raises fails the run."""

import importlib.util
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

TOOL = Path(__file__).resolve().parent.parent / "tools" / "torch_perf_report.py"
TINY = dict(env_batch=2, rays=64, ray_w=8, ray_h=8, grid=(2, 4),
            big_grid=(3, 6), image=(64, 64), atrium=0.1, raster=(64, 32),
            solver_batch=2, cloth=8)
# (kernel column, the start of the row's name)
ROWS = [("#2", "loco env step"), ("#1", "colored solve"),
        ("plain", "cloth"), ("#3", "BVH walk, coherent tiles"),
        ("#3", "BVH walk, incoherent ("),
        ("#3", "BVH walk, incoherent + in-call regroup"),
        ("#3", "BVH walk, any-hit"), ("#3", "BVH walk, coherent ("),
        ("#3", "BVH walk, incoherent + in-call regroup"),
        ("#4", "brute force"), ("#7", "gaussian blur"),
        ("library", "library blur"), ("#6", "tonemap "),
        ("#6, #7", "tonemap + sharpen"), ("#5", "raster pair mode")]
WITH_BOUND = {"#2", "#1", "#7", "#6", "#5"}


def _tool(monkeypatch):
    spec = importlib.util.spec_from_file_location("torch_perf_report", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setitem(mod.SIZES, "cpu", TINY)
    monkeypatch.setattr(mod, "ITERATIONS", 2)
    monkeypatch.setattr(mod, "WARM_STEPS", 1)
    return mod


def _run(mod, tmp_path):
    return mod.main(["--device", "cpu", "--iters", "1", "--warmup", "0",
                     "--out", str(tmp_path / "report.md")])


def test_every_row_is_present(tmp_path, monkeypatch):
    out = _run(_tool(monkeypatch), tmp_path)
    rows = out["rows"]
    assert len(rows) == len(ROWS)
    for row, (kernel, name) in zip(rows, ROWS):
        assert row["kernel"] == kernel and row["name"].startswith(name), row
        assert row["ms"] > 0
        assert (row["bound_ms"] is not None) == (kernel in WITH_BOUND), row
        if row["bound_ms"] is not None:
            assert row["bound_ms"] > 0 and row["bound_by"] in ("bytes",
                                                               "operations")
    assert set(out["timings"]) == {"big-grid tree, cache miss (s)",
                                   "big-grid tree, cache hit (s)"}
    text = (tmp_path / "report.md").read_text()
    assert text == out["text"] and text.count("\n| ") == len(ROWS) + 1
    assert "the CPU" in text.splitlines()[0]


def test_a_failing_row_fails_the_run(tmp_path, monkeypatch):
    mod = _tool(monkeypatch)

    def broken(torch, device, size):
        def fail(x):
            raise ValueError("row failed")
        yield mod.Row("broken", "#7", fail, (torch.zeros(1),))

    monkeypatch.setattr(mod, "image_rows", broken)
    monkeypatch.setattr(mod, "ray_rows", lambda *a: iter(()))
    monkeypatch.setattr(mod, "physics_rows", lambda *a: iter(()))
    with pytest.raises(ValueError, match="row failed"):
        _run(mod, tmp_path)
    assert not (tmp_path / "report.md").exists()


def test_bound_helpers_keep_the_recorded_bounds():
    """The helpers chip_smoke.py and the tool share give the bounds
    PERF.md's kernel table records from chip_smoke.py's inputs: the
    tonemap at 1080p RGB 0.0149 ms (49.8 MB), the frame's seven blurs
    0.0359 ms (120 MB), both bytes-bound; and the plain formulas they
    replaced."""
    import chip_smoke
    from d3d12renderer_tpu_torch.core import profiling
    from d3d12renderer_tpu_torch.ops import image

    n = 1080 * 1920 * 3
    ms, by = profiling.tonemap_bound(n)
    assert by == "bytes" and round(ms, 4) == 0.0149
    assert (ms, by) == profiling.bound(2 * 4 * n, n * profiling.TONEMAP_FLOP)
    work = [profiling.blur_work(int(torch.tensor(shape).prod()),
                                image.gaussian_kernel(sigma).shape[0] // 2)
            for shape, sigma in chip_smoke.BLUR_SHAPES]
    ms, by = profiling.bound(sum(w[0] for w in work),
                             sum(w[1] for w in work))
    assert by == "bytes" and round(ms, 4) == 0.0359
    assert profiling.bound(3.35e9, 0) == (1.0, "bytes")
    assert profiling.bound(0, 67e9) == (1.0, "operations")
    assert chip_smoke.bound is profiling.bound
    assert chip_smoke.group_bound is profiling.group_bound
