"""The harness finds its configurations, cells and metrics by name, writes
BENCHMARK.json from them, and runs every cell end to end on the CPU."""

import json
import subprocess
import sys

import pytest

from portbench import harness, make_benchmark, spreads

from .tiny import TINY, run_tiny

CELLS = [name for name, _ in make_benchmark.cells()]


def test_every_cell_is_found_by_name():
    for name in CELLS:
        w = harness.load_json("workloads", name)
        assert harness.load_json("configs", w["config"])["reduced"] == []
        traffic = harness.load_json("traffic", w["traffic"])
        assert (harness.HERE / "drivers" / f"{traffic['driver']}.py").is_file()
        for metric in w["end_to_end"]:
            assert "bound" in harness.load_module("end_to_end", metric).META
        for metric in w["per_layer"]:
            meta = harness.load_module("metrics", metric).META
            assert {"unit", "better", "source", "layer", "moves"} <= set(meta)
            assert meta["moves"] in w["end_to_end"]
        assert "setup_s" in w["end_to_end"]


def test_benchmark_json_is_what_the_harness_finds():
    assert make_benchmark.main(["--check"]) == 0
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    assert [w["name"] for w in bench["workloads"]] == CELLS
    for metric in bench["per_layer"]:
        assert metric["workloads"]


@pytest.mark.parametrize("name", sorted(TINY))
def test_cell_runs_on_the_cpu_and_is_correct(name):
    result = run_tiny(name)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == set(
        harness.load_json("workloads", name)["end_to_end"])


@pytest.mark.parametrize("name", sorted(TINY))
def test_traced_cell_gives_its_per_layer_metrics_on_the_cpu(name):
    result = run_tiny(name, trace=True)
    assert result["correct"], result["checks"]
    assert "breakdown" in result
    assert result["device"]["window_s"] > 0


def test_percentile_and_spread():
    xs = list(range(1, 101))
    assert harness.percentile(xs, 95) == pytest.approx(95.05)
    assert spreads.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert spreads.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(1.0)


def test_nothing_of_jax_is_loaded_by_a_run():
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r);"
            "from tiny import run_tiny;"
            "r = run_tiny('ragdoll_loco_4096.rollout');"
            "from portbench import harness;"
            "print(harness.forbidden_loaded(sys.modules), r['correct'])"
            % (str(harness.ROOT), str(harness.HERE / 'tests')))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_are_compared_whole():
    mods = ["d3d12renderer_tpu_torch.entry", "jaxtyping", "numpy"]
    assert harness.forbidden_loaded(mods) == []
    assert harness.forbidden_loaded(mods + ["d3d12renderer_tpu.core"]) == [
        "d3d12renderer_tpu"]
    assert harness.forbidden_loaded(["jax._src"]) == ["jax"]


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r);"
            "import portbench.reference.loco, portbench.reference.pathtrace,"
            " portbench.reference.policy;"
            "print(sorted({m.split('.')[0] for m in sys.modules"
            " if m.startswith('d3d12renderer')}))" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
    for path in (harness.HERE / "reference").rglob("*.py"):
        assert "d3d12renderer" not in path.read_text(), path


def test_run_refuses_a_checkout_without_the_port(tmp_path):
    bench = tmp_path / "portbench"
    bench.mkdir()
    for path in harness.HERE.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            dest = bench / path.relative_to(harness.HERE)
            dest.parent.mkdir(parents=True, exist_ok=True)
            dest.write_bytes(path.read_bytes())
    (tmp_path / "BENCHMARK.json").write_text(
        (harness.ROOT / "BENCHMARK.json").read_text())
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
