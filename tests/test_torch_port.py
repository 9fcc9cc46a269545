"""Port-level contracts of d3d12renderer_tpu_torch: it imports no JAX, its
solver dispatches by device, the CUDA kernels' prep layout matches the
wrapper that packs it, and the build hashes every source.  Tests marked
`cuda` need an NVIDIA GPU and skip without one; `python3 chip_smoke.py` runs
the same comparisons on the card.
"""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from d3d12renderer_tpu_torch.learning.loco_env import (
    ACTION_SIZE, STATE_SIZE, LocoEnv)
from d3d12renderer_tpu_torch.physics import solver_cuda, step, substep_cuda
from d3d12renderer_tpu_torch.physics.types import PhysicsSettings

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import d3d12renderer_tpu_torch.entry, d3d12renderer_tpu_torch.convert\n"
        "from d3d12renderer_tpu_torch.physics import solver_cuda\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'd3d12renderer_tpu')]\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_sources_import_neither_jax_nor_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|d3d12renderer_tpu)\b",
                         re.M)
    for path in (REPO / "d3d12renderer_tpu_torch").rglob("*.py"):
        assert not pattern.search(path.read_text()), path
    assert not pattern.search((REPO / "chip_smoke.py").read_text())


@pytest.fixture(scope="module")
def small_prep():
    """Preps of 3 disturbed ragdolls lowered onto the ground."""
    env = LocoEnv()
    gen = torch.Generator().manual_seed(0)
    _, st = env.reset(3, gen)
    b = st.bodies
    b = b.replace(pos=b.pos - torch.tensor([0.0, 0.125, 0.0]),
                  vel=torch.rand(b.vel.shape, generator=gen) - 0.5,
                  omega=torch.rand(b.omega.shape, generator=gen) - 0.5)
    act = torch.rand((3, ACTION_SIZE), generator=gen) * 2.0 - 1.0
    with torch.no_grad():
        sp = step.substep_prep(env.arch, b, 1.0 / 60.0, env.settings,
                               env._motor_overrides(act))
    return env, sp


def _solver(env, sp, backend, iterations=4):
    return solver_cuda.ColoredSolver(env.arch, sp.contacts.body_a.shape[0],
                                     iterations, backend)


def test_kernel_backend_refuses_cpu_tensors(small_prep):
    env, sp = small_prep
    with pytest.raises(RuntimeError, match="CUDA"):
        _solver(env, sp, "kernel")(sp.joint_preps, sp.contact_prep, sp.vel1,
                                   sp.omega1)


def test_auto_backend_takes_the_plain_solve_on_cpu(small_prep):
    env, sp = small_prep
    before = solver_cuda.colored_solve_cuda.launches
    args = (sp.joint_preps, sp.contact_prep, sp.vel1, sp.omega1)
    v, w = _solver(env, sp, "auto")(*args)
    pv, pw = _solver(env, sp, "plain").plain(*args)
    assert solver_cuda.colored_solve_cuda.launches == before
    assert torch.equal(v, pv) and torch.equal(w, pw)
    assert not torch.equal(v, sp.vel1)


def test_unknown_backend_is_refused(small_prep):
    env, sp = small_prep
    with pytest.raises(ValueError):
        _solver(env, sp, "pallas")


def test_kernel_layout_constants_match_the_wrapper():
    """The offsets written in solver_rows.cuh, which both kernels include,
    are the wrapper's layout."""
    src = (solver_cuda.CSRC_DIR / "solver_rows.cuh").read_text()
    assert '#include "solver_rows.cuh"' in (
        solver_cuda.CSRC_DIR / "colored_solver.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int ([A-Z0-9_]+) = (\d+);", src)}
    for name, offset in solver_cuda.layout_offsets().items():
        assert consts.get(name) == offset, name
    kinds = {k.lower(): consts[f"KIND_{k.upper()}"]
             for k in ("hinge", "cone_twist", "contact", "distance", "ball",
                       "fixed")}
    assert kinds == solver_cuda.KIND_IDS
    for i, name in enumerate(("T_KIND", "T_ROWS", "T_ROW_BASE", "T_COLOR_BASE",
                              "T_NUM_COLORS", "T_PLANE_BASE", "T_IMP_BASE",
                              "T_A_STATIC", "T_B_STATIC", "TABLE_INTS")):
        assert consts[name] == getattr(solver_cuda, name) == i, name


def test_pack_prep_places_fields_where_the_kernel_reads_them(small_prep):
    env, sp = small_prep
    solver = _solver(env, sp, "plain")
    batch = sp.vel1.shape[0]
    packed = solver.pack_prep(sp.joint_preps, sp.contact_prep, batch,
                              torch.device("cpu"))
    arrays = solver.kernel_arrays(torch.device("cpu"))
    tables = arrays.tables.view(-1, solver_cuda.TABLE_INTS)
    offsets = solver_cuda.layout_offsets()
    assert [m.kind for m in solver.tables] == ["hinge", "cone_twist", "contact"]
    assert solver.tables[-1].a_static and not solver.tables[-1].b_static
    total = sum(m.perm.shape[0] * sum(n for _, n in m.fields)
                for m in solver.tables)
    assert packed.shape == (total, batch) and packed.is_contiguous()

    def plane(t, field, comp, row):
        rows = int(tables[t, solver_cuda.T_ROWS])
        return int(tables[t, solver_cuda.T_PLANE_BASE]) + (field + comp) * rows + row

    for t, m in enumerate(solver.tables):
        r = m.perm.shape[0] - 1                 # last row in color order
        src = int(m.perm[r])
        if m.kind == "contact":
            cp = sp.contact_prep
            checks = [("C_NORMAL", 2, cp.normal[:, src, 2]),
                      ("C_R_B", 3 * 2 + 1, cp.r_b[:, src, 2, 1]),
                      ("C_PMASK", 3, cp.pmask[:, src, 3].float())]
        else:
            p = sp.joint_preps[m.arch_index]
            checks = [("J_II_B", 5, p["ii_b"][:, src, 1, 2]),
                      ("J_IM_A", 0, p["im_a"][:, src])]
            if m.kind == "hinge":
                checks.append(("H_I2", 2, p["i2"][2][:, src]))
            else:
                checks.append(("CT_SW_TO_WB", 1, p["sw_to_wb"][:, src, 1]))
        for name, comp, want in checks:
            assert torch.equal(packed[plane(t, offsets[name], comp, r)], want), name
    body_a = arrays.body_a.tolist()
    assert body_a[-1] == env.arch.world_body                 # contact rows
    colors = arrays.colors.view(-1, 2).tolist()
    assert colors[:6] == [[0, 6]] + [[0, 3], [3, 4], [4, 5], [5, 6], [6, 7]]


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(solver_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(solver_cuda, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        solver_cuda.build_library()
    assert not list(tmp_path.rglob(solver_cuda.LIBRARY_NAME))


def test_header_edit_changes_the_build_dir(tmp_path, monkeypatch):
    """The build directory hashes csrc/*.cuh as well as csrc/*.cu, so an
    edit to the shared header cannot reuse a stale library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(solver_cuda.CSRC_DIR, csrc)
    monkeypatch.setattr(solver_cuda, "CSRC_DIR", csrc)
    before = solver_cuda.build_dir()
    header = csrc / "solver_rows.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    after = solver_cuda.build_dir()
    assert after != before and after.parent == before.parent
    assert solver_cuda.build_dir() == after
    assert "-I" in solver_cuda.NVCC_FLAGS


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """30 iterations at 64 scenes.  nvcc contracts a*b+c into FMA where the
    plain version rounds each product, hence a float-rounding bound."""
    _need_cuda()
    env = LocoEnv(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    _, st = env.reset(64, gen)
    for _ in range(10):
        act = torch.rand((64, ACTION_SIZE), generator=gen, device="cuda") * 2 - 1
        _, st, _, _ = env.step(st, act)
    sp = step.substep_prep(env.arch, st.bodies, 1.0 / 60.0, env.settings,
                           env._motor_overrides(act))
    solver = _solver(env, sp, "kernel", iterations=30)
    args = (sp.joint_preps, sp.contact_prep, sp.vel1, sp.omega1)
    before = solver_cuda.colored_solve_cuda.launches
    kv, kw = solver(*args)
    assert solver_cuda.colored_solve_cuda.launches == before + 1
    pv, pw = solver.plain(*args)
    torch.testing.assert_close(kv, pv, rtol=0, atol=1e-3)
    torch.testing.assert_close(kw, pw, rtol=0, atol=5e-3)


@pytest.mark.cuda
def test_auto_backend_launches_the_kernel_on_cuda():
    _need_cuda()
    env = LocoEnv(settings=PhysicsSettings(frame_rate=60, fused_substep="off"),
                  device="cuda")
    _, st = env.reset(8, torch.Generator(device="cuda").manual_seed(0))
    before = solver_cuda.colored_solve_cuda.launches
    obs, st, reward, done = env.step(st, torch.zeros((8, ACTION_SIZE),
                                                     device="cuda"))
    assert solver_cuda.colored_solve_cuda.launches == before + 1
    assert torch.isfinite(obs).all()


def _fused_vs_plain(batch, iterations):
    """One env step at `batch` envs from disturbed states, through the fused
    kernel and through its plain version (the unfused step, plain solve)."""
    dev = torch.device("cuda")
    env = LocoEnv(settings=PhysicsSettings(frame_rate=60,
                                           solver_iterations=iterations,
                                           fused_substep="off",
                                           solver_backend="plain"),
                  device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    _, st = env.reset(batch, gen)
    for _ in range(5):
        act = torch.rand((batch, ACTION_SIZE), generator=gen, device=dev) * 2 - 1
        _, st, _, _ = env.step(st, act)
    act = torch.rand((batch, ACTION_SIZE), generator=gen, device=dev) * 2 - 1
    b = env.apply_poke(st.bodies, *env.draw_poke(gen, batch))
    fused = LocoEnv(settings=PhysicsSettings(frame_rate=60,
                                             solver_iterations=iterations),
                    device=dev)._fused_step
    before = substep_cuda.fused_substep_cuda.launches
    got = fused(b, act)
    assert substep_cuda.fused_substep_cuda.launches == before + 1
    want = env._step_core(b, act)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [256, 1000])
def test_fused_kernel_matches_plain_on_cuda(batch):
    """B=256, and a ragged B=1000 (the last block of 128 part-filled).
    Bounds of chip_smoke.py: vel 1e-3, omega 5e-3, obs/reward 1e-3; done
    equal except where the head height lies within 1e-4 of 1 m."""
    _need_cuda()
    (gb, gobs, grew, gdone), (pb, pobs, prew, pdone) = _fused_vs_plain(batch, 30)
    assert gobs.shape == (batch, STATE_SIZE)
    torch.testing.assert_close(gb.vel, pb.vel, rtol=0, atol=1e-3)
    torch.testing.assert_close(gb.omega, pb.omega, rtol=0, atol=5e-3)
    torch.testing.assert_close(gobs, pobs, rtol=0, atol=1e-3)
    torch.testing.assert_close(grew, prew, rtol=0, atol=1e-3)
    assert torch.equal(gdone, pdone)
