"""Port-level contracts of d3d12renderer_tpu_torch: it imports no JAX, its
solver dispatches by device, the CUDA kernels' prep layout matches the
wrapper that packs it, and the build hashes every source.  Tests marked
`cuda` need an NVIDIA GPU and skip without one; `python3 chip_smoke.py` runs
the same comparisons on the card.
"""

import inspect
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from d3d12renderer_tpu_torch import cuda_build
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
        "import d3d12renderer_tpu_torch.render.pipeline\n"
        "from d3d12renderer_tpu_torch.physics import solver_cuda\n"
        "from d3d12renderer_tpu_torch.assets import fbx, async_loader, native\n"
        "from d3d12renderer_tpu_torch.animation import animation, skinning\n"
        "from d3d12renderer_tpu_torch.render import (skinned_instances,\n"
        "    debug_viz, geometry_gen)\n"
        "from d3d12renderer_tpu_torch.models import ragdoll\n"
        "from d3d12renderer_tpu_torch.scene import scene, viewer\n"
        "from d3d12renderer_tpu_torch.audio import audio, mixdown, stream\n"
        "from d3d12renderer_tpu_torch.core import (camera_controller, log,\n"
        "    profiling)\n"
        "from d3d12renderer_tpu_torch.utils import hot_reload, undo\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'd3d12renderer_tpu')]\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def _port_sources():
    """The package, chip_smoke.py, the port's tools and example scripts."""
    return (sorted((REPO / "d3d12renderer_tpu_torch").rglob("*.py"))
            + [REPO / "chip_smoke.py"]
            + sorted((REPO / "tools").glob("torch_*.py"))
            + sorted((REPO / "examples").glob("torch_*.py")))


def test_sources_import_neither_jax_nor_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|d3d12renderer_tpu)\b",
                         re.M)
    sources = _port_sources()
    assert sum(p.parent.name == "examples" for p in sources) == 9
    assert sum(p.parent.name == "tools" for p in sources) >= 8
    for path in sources:
        assert not pattern.search(path.read_text()), path


def _example_parsers():
    import importlib.util

    out = {}
    for path in sorted((REPO / "examples").glob("torch_*.py")):
        spec = importlib.util.spec_from_file_location(
            f"example_defaults_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def test_example_scripts_default_to_the_card_and_write_under_build():
    """Each port script (`main(argv)`, `build_parser()`) defaults to
    `--device cuda`, has no JAX-only flag, and writes nothing by default
    outside the repo's `build/` (the JAX scripts' defaults overwrite
    images committed at the repo root)."""
    mods = _example_parsers()
    assert len(mods) == 9
    for name, mod in mods.items():
        assert callable(mod.main), name
        parser = mod.build_parser()
        args = parser.parse_args([])
        assert args.device == "cuda", name
        flags = {a.dest for a in parser._actions}
        assert not flags & {"platform", "dispatch", "backend"}, name
        for dest in ("out", "logdir", "render", "eval_render", "audio"):
            value = getattr(args, dest, None)
            if value is not None:
                rel = Path(value).resolve().relative_to(REPO)
                assert rel.parts[0] == "build", (name, dest, value)


@pytest.fixture(scope="module")
def small_prep():
    """Preps of 3 disturbed ragdolls lowered onto the ground."""
    env = LocoEnv(device="cpu")
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
    src = (cuda_build.CSRC_DIR / "solver_rows.cuh").read_text()
    assert '#include "solver_rows.cuh"' in (
        cuda_build.CSRC_DIR / "colored_solver.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int ([A-Z0-9_]+) = (\d+);", src)}
    for name, offset in solver_cuda.layout_offsets().items():
        assert consts.get(name) == offset, name
    kinds = {k.lower(): consts[f"KIND_{k.upper()}"]
             for k in ("hinge", "cone_twist", "contact", "distance", "ball",
                       "fixed", "slider")}
    assert kinds == solver_cuda.KIND_IDS
    for i, name in enumerate(("T_KIND", "T_ROWS", "T_ROW_BASE", "T_COLOR_BASE",
                              "T_NUM_COLORS", "T_PLANE_BASE", "T_IMP_BASE",
                              "T_A_STATIC", "T_B_STATIC", "T_ROW_STRIDE",
                              "TABLE_INTS")):
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
    assert [m.row_stride for m in solver.tables] == [65, 77, 69]
    assert solver.planes == 6 * 65 + 7 * 77 + 17 * 69 == 2102
    assert solver.prep_stride == 2104
    assert packed.shape == (batch, 2104) and packed.is_contiguous()

    def plane(t, field, comp, row):
        stride = int(tables[t, solver_cuda.T_ROW_STRIDE])
        return (int(tables[t, solver_cuda.T_PLANE_BASE]) + row * stride
                + field + comp)

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
            assert torch.equal(packed[:, plane(t, offsets[name], comp, r)],
                               want), name
    body_a = arrays.body_a.tolist()
    assert body_a[-1] == env.arch.world_body                 # contact rows
    colors = arrays.colors.view(-1, 2).tolist()
    assert colors[:6] == [[0, 6]] + [[0, 3], [3, 4], [4, 5], [5, 6], [6, 7]]


def _pack_prep_plane_major(solver, joint_preps, contact_prep, batch):
    """The [plane][scene] buffer the kernel read before it took a scene per
    team: for each table, field and component, one plane of rows x scenes."""
    planes = []
    for m in solver.tables:
        rows = m.perm.shape[0]
        prep = (solver_cuda._contact_fields(contact_prep)
                if m.kind == "contact" else joint_preps[m.arch_index])
        for name, n in m.fields:
            x = prep[name]
            if isinstance(x, tuple):
                x = torch.stack(x, dim=-1)
            x = x[:, torch.as_tensor(m.perm)].reshape(batch, rows, n)
            planes.append(x.permute(2, 1, 0).reshape(n * rows, batch))
    return torch.cat(planes, dim=0)


def test_pack_prep_is_the_plane_major_buffer_transposed(small_prep):
    """The scene-major buffer is the plane-major one transposed: each
    table's [field][row][scene] block becomes [scene][row][field], each row
    zero-padded to its odd stride and each scene to a multiple of 4 floats."""
    env, sp = small_prep
    solver = _solver(env, sp, "plain")
    batch = sp.vel1.shape[0]
    packed = solver.pack_prep(sp.joint_preps, sp.contact_prep, batch,
                              torch.device("cpu"))
    old = _pack_prep_plane_major(solver, sp.joint_preps, sp.contact_prep,
                                 batch)
    want = torch.zeros_like(packed)
    old_base = new_base = 0
    for m in solver.tables:
        rows, n = m.perm.shape[0], m.num_fields
        block = old[old_base:old_base + n * rows].view(n, rows, batch)
        want[:, new_base:new_base + rows * m.row_stride].view(
            batch, rows, m.row_stride)[:, :, :n] = block.permute(2, 1, 0)
        old_base += n * rows
        new_base += rows * m.row_stride
    assert old_base == old.shape[0] and new_base == solver.planes
    assert torch.equal(packed, want)


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_build.build_library()
    assert not list(tmp_path.rglob(cuda_build.LIBRARY_NAME))


def test_header_edit_changes_the_build_dir(tmp_path, monkeypatch):
    """The build directory hashes csrc/*.cuh as well as csrc/*.cu, so an
    edit to the shared header cannot reuse a stale library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    before = cuda_build.build_dir()
    header = csrc / "solver_rows.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    after = cuda_build.build_dir()
    assert after != before and after.parent == before.parent
    assert cuda_build.build_dir() == after
    assert "-I" in cuda_build.NVCC_FLAGS


def _entry_points():
    from d3d12renderer_tpu_torch import convert, entry
    from d3d12renderer_tpu_torch.physics import builder, cloth, joints
    from d3d12renderer_tpu_torch.render import bvh, camera, decals, lights
    from d3d12renderer_tpu_torch.render import light_probe, mesh, pathtracer
    from d3d12renderer_tpu_torch.render import instances, pipeline, resources
    from d3d12renderer_tpu_torch.render import (geometry_gen, shadows,
                                                skinned_instances)
    from d3d12renderer_tpu_torch.animation import animation
    from d3d12renderer_tpu_torch.core import camera_controller
    from d3d12renderer_tpu_torch.scene import components, scene, viewer
    import numpy as np

    arch = lambda: LocoEnv(device="cpu").arch  # noqa: E731
    cloth_scene = scene.Scene()
    flag = cloth_scene.create_entity("flag")
    flag.add_component(components.Transform())
    flag.add_component(components.Cloth(grid_x=4, grid_y=4))
    return {
        "entry": (entry.entry, lambda f: f()),
        "pathtrace_entry": (entry.pathtrace_entry, lambda f: f()),
        "raster_entry": (entry.raster_entry, lambda f: f()),
        "raster_showcase_entry": (entry.raster_showcase_entry,
                                  lambda f: f()),
        "raster_lights_entry": (entry.raster_lights_entry, lambda f: f()),
        "showcase_world_entry": (entry.showcase_world_entry, lambda f: f()),
        "flythrough_entry": (entry.flythrough_entry, lambda f: f()),
        "flythrough_world": (entry.flythrough_world, lambda f: f()),
        "flythrough_camera": (entry.flythrough_camera, None),
        "character_entry": (entry.character_entry, lambda f: f()),
        "character_ragdoll_entry": (entry.character_ragdoll_entry,
                                    lambda f: f()),
        "from_model_asset": (skinned_instances.from_model_asset, None),
        "make_skeleton": (animation.make_skeleton,
                          lambda f: f([-1], np.zeros((1, 3)))),
        "metaballs_mesh": (geometry_gen.metaballs_mesh,
                           lambda f: f([[0, 0, 0]], [0.5], 8)),
        "default_white": (resources.default_white, lambda f: f()),
        "brdf_lookup": (resources.brdf_lookup, lambda f: f()),
        "build_instanced": (instances.build_instanced, lambda f: f(
            [(mesh.quad(), 0)], [0])),
        "distributed_entry": (entry.distributed_entry, lambda f: f()),
        "train_entry": (entry.train_entry, lambda f: f()),
        "stack_drop_entry": (entry.stack_drop_entry, lambda f: f()),
        "vehicle_entry": (entry.vehicle_entry, lambda f: f()),
        "terrain_entry": (entry.terrain_entry, lambda f: f()),
        "terrain_entry_ridge": (entry.terrain_entry,
                                lambda f: f(scene="ridge")),
        "cloth_entry": (entry.cloth_entry, lambda f: f()),
        "vehicle_terrain_entry": (entry.vehicle_terrain_entry,
                                  lambda f: f()),
        "create_cloth": (cloth.create_cloth,
                         lambda f: f(1.0, 1.0, 4, 4, 1.0)),
        "archetype_from_numpy": (convert.archetype_from_numpy, None),
        "train_state_from_numpy": (convert.train_state_from_numpy, None),
        "initial_frame_state": (pipeline.initial_frame_state,
                                lambda f: f(8, 8)),
        "frame_state_from_numpy": (convert.frame_state_from_numpy, None),
        "sun_shadow_maps_from_numpy": (convert.sun_shadow_maps_from_numpy,
                                       None),
        "LocoEnv": (LocoEnv.__init__, lambda f: LocoEnv()),
        "finalize": (builder.SceneBuilder.finalize,
                     lambda f: builder.SceneBuilder().finalize()),
        "init_impulses": (joints.init_impulses,
                          lambda f: f(arch(), 2)),
        "actor_critic_from_flax": (convert.actor_critic_from_flax, None),
        "body_state_from_numpy": (convert.body_state_from_numpy, None),
        "env_state_from_numpy": (convert.env_state_from_numpy, None),
        "bvh_from_numpy": (convert.bvh_from_numpy, None),
        "build_bvh": (bvh.build_bvh, lambda f: f([(mesh.quad(), 0)])),
        "look_at": (camera.look_at, lambda f: f((0, 0, 1), (0, 0, 0))),
        "make_point_lights": (lights.make_point_lights,
                              lambda f: f([[0, 1, 0]], [[1, 1, 1]], [2.0])),
        "default_sky": (pathtracer.default_sky, lambda f: f()),
        "make_spot_lights": (lights.make_spot_lights, lambda f: f(
            [[0, 3, 0]], [[0, -1, 0]], [[1, 1, 1]], [9.0], [0.9], [0.8])),
        "make_decals": (decals.make_decals, lambda f: f(
            [[0, 0, 0]], [[0, 0, 0, 1]], [[1, 1, 1]], [[0, 0, 0]])),
        "create_probe_grid": (light_probe.create_probe_grid,
                              lambda f: f((0, 0, 0), (1, 1, 1), (2, 2, 2))),
        "ShadowAtlas": (shadows.ShadowAtlas.__init__,
                        lambda f: shadows.ShadowAtlas(64)),
        "spot_lights_from_numpy": (convert.spot_lights_from_numpy, None),
        "light_probe_grid_from_numpy": (convert.light_probe_grid_from_numpy,
                                        None),
        "distributed_train_state_from_numpy": (
            convert.distributed_train_state_from_numpy, None),
        "editor_entry": (entry.editor_entry, lambda f: f()),
        "Editor": (viewer.Editor.__init__,
                   lambda f: viewer.Editor(scene.Scene())),
        "write_static": (viewer.write_static, lambda f: f(
            viewer.build_demo_scene(), "unused.html")),
        "serve": (viewer.serve, None),
        "orbit_camera": (viewer.orbit_camera,
                         lambda f: f(np.zeros(3), 5.0, 0.3, 0.4)),
        "compile_physics": (scene.Scene.compile_physics,
                            lambda f: f(viewer.build_demo_scene())),
        "compile_cloths": (scene.Scene.compile_cloths, lambda f: f(cloth_scene)),
        "build_render_scene": (scene.Scene.build_render_scene,
                               lambda f: f(viewer.build_demo_scene())),
        "OrbitController.camera": (
            camera_controller.OrbitController.camera,
            lambda f: f(camera_controller.OrbitController())),
        "FlyController.camera": (
            camera_controller.FlyController.camera,
            lambda f: f(camera_controller.FlyController())),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name):
    """Every entry point defaults to device="cuda"; without a card it
    raises a clear error instead of running on the CPU."""
    fn, call = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if call is not None and not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(fn)


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


def _runtime_physics(scene, device):
    from d3d12renderer_tpu_torch import entry as port_entry

    if scene == "vehicle":
        fn, (_, _, st) = port_entry.vehicle_entry(device=device, batch=2,
                                                  throttle=(10.0, 8.0))
    else:
        fn, (_, st) = port_entry.stack_drop_entry(device=device, bodies=40,
                                                  batch=2)
    return fn, st


def test_physics_runner_steps_like_single_frames_on_cpu():
    """On the CPU the runner steps eagerly: three frames in one call are
    the three frames of three calls, bit for bit."""
    fn, st0 = _runtime_physics("stack", "cpu")
    want = st0
    for _ in range(3):
        want, _ = fn(want, 1)
    got, contacts = fn(st0, 3)
    for f in ("pos", "rot", "vel", "omega"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert contacts is not None


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["vehicle", "stack"])
def test_physics_runner_graph_matches_eager_on_cuda(scene):
    """On a card a call of several frames runs one eagerly, captures the
    next into a CUDA graph and replays it.  The replays agree with eager
    frames (split_jacobi adds with float atomics, so not bit for bit), and
    a state the runner returned survives its later replays."""
    _need_cuda()
    fn_eager, st0 = _runtime_physics(scene, "cuda")
    fn_graph, _ = _runtime_physics(scene, "cuda")
    want = st0
    for _ in range(6):
        want, _ = fn_eager(want, 1)    # one frame a call: never captured
    first, contacts = fn_graph(st0, 4)   # eager, capture, 3 replays
    kept = first.pos.clone()
    got, _ = fn_graph(first, 2)
    assert torch.equal(first.pos, kept)
    for f, tol in (("pos", 1e-4), ("rot", 1e-4), ("vel", 1e-3),
                   ("omega", 1e-3)):
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=tol)
    assert contacts is not None and torch.isfinite(got.pos).all()


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
@pytest.mark.parametrize("batch", [256, 999])
def test_fused_kernel_matches_plain_on_cuda(batch):
    """B=256, and a ragged B=999 (the last warp's last team masked at the
    default team width).  Bounds of chip_smoke.py: vel 1e-3, omega 5e-3,
    obs/reward 1e-3; done equal except where the head height lies within
    1e-4 of 1 m."""
    _need_cuda()
    (gb, gobs, grew, gdone), (pb, pobs, prew, pdone) = _fused_vs_plain(batch, 30)
    assert gobs.shape == (batch, STATE_SIZE)
    torch.testing.assert_close(gb.vel, pb.vel, rtol=0, atol=1e-3)
    torch.testing.assert_close(gb.omega, pb.omega, rtol=0, atol=5e-3)
    torch.testing.assert_close(gobs, pobs, rtol=0, atol=1e-3)
    torch.testing.assert_close(grew, prew, rtol=0, atol=1e-3)
    assert torch.equal(gdone, pdone)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["closest", "any"])
def test_ray_kernels_match_plain_on_cuda(mode):
    """Both ray kernels against the plain version on the card, 4096 rays
    over six uv spheres (4,608 rows): the same bits in closest mode (the
    kernels round as the plain version does), the same `hit` in any-hit
    mode."""
    _need_cuda()
    import numpy as np

    from d3d12renderer_tpu_torch.ops import ray_trace
    from d3d12renderer_tpu_torch.render import bvh, mesh

    rng = np.random.default_rng(0)
    tb = bvh.build_bvh([(mesh.uv_sphere(0.5 + 0.1 * i, 16, 24).transformed(
        translate=tuple(rng.uniform(-3, 3, 3))), i) for i in range(6)],
        device="cuda")
    planes, nodes = ray_trace.kernel_tables(tb)
    o = rng.uniform(-4, 4, (4096, 3)).astype(np.float32)
    d = (rng.uniform(-3, 3, (4096, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = rng.uniform(0.0, 8.0, 4096).astype(np.float32)
    o, d, tm = (torch.as_tensor(x, device="cuda") for x in (o, d, tm))
    want_t, want_tri = ray_trace.closest_hit_plain(planes, o, d, tm)
    for fn in (lambda: ray_trace.ray_closest_hit_bvh(
                   planes, nodes, o, d, tm, mode == "any"),
               lambda: ray_trace.ray_closest_hit_brute(
                   planes, o, d, tm, mode == "any")):
        t, tri = fn()
        torch.cuda.synchronize()
        if mode == "closest":
            assert torch.equal(tri, want_tri) and torch.equal(t, want_t)
        else:
            assert torch.equal(tri >= 0, want_tri >= 0)



def _atrium_frame_inputs():
    """The atrium at 1080p on the card: its BVH, camera and the raster
    kernel's inputs (planes, pairs, segments) at a fixed jitter."""
    import math

    from d3d12renderer_tpu_torch.ops import raster
    from d3d12renderer_tpu_torch.render import bvh, camera, mesh

    tb = bvh.build_bvh(mesh.atrium_scene(1.4), device="cuda")
    cam = camera.look_at((8.0, 6.0, -14.0), (0.0, 3.0, 0.0), device="cuda",
                         v_fov=math.radians(60), aspect=1920 / 1080)
    mat, attr = raster.perspective_rows(cam, 1920, 1080)
    planes, rect, q_tri = raster.project_planes(
        tb.tri_v0, tb.tri_e1, tb.tri_e2, tb.tri_valid, mat, attr, 1920, 1088)
    pair_tri, seg = raster.bin_pairs(rect, q_tri, 1920, 1088)
    return planes, pair_tri, seg, torch.tensor([0.3, 0.7], device="cuda")


@pytest.mark.cuda
def test_raster_kernel_matches_plain_on_cuda():
    """The raster kernel against its plain version over the atrium at
    1080p (~300k pairs): q, tri, u, v equal bit for bit, one launch, most
    pairs culled."""
    _need_cuda()
    from d3d12renderer_tpu_torch.ops import raster

    args = _atrium_frame_inputs() + (1920, 1088)
    before = raster.rasterize_tiles.launches
    stats = torch.zeros(2, dtype=torch.int64, device="cuda")
    got = raster.rasterize_tiles(*args, stats=stats)
    assert raster.rasterize_tiles.launches == before + 1
    want = raster.rasterize_plain(*args)
    torch.cuda.synchronize()
    assert (want[1] >= 0).float().mean() > 0.5
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    tested, culled = stats.tolist()
    assert tested + culled == raster.BANDS * int(args[2][-1])
    assert 0 < tested < culled


@pytest.mark.cuda
def test_raster_group_kernel_matches_plain_on_cuda():
    """The group mode of the raster kernel against its plain version over
    the atrium at 1080p: every tile, then the repair phase of a garbage
    feedback (a subset of tiles over phase 1's image); q and tri equal bit
    for bit, one launch each, the counters adding up to GROUP_BANDS per
    visit and the rows tested covering those any exact cull per band
    must test."""
    _need_cuda()
    import math

    from d3d12renderer_tpu_torch.ops import raster
    from d3d12renderer_tpu_torch.render import bvh, camera, mesh

    tb = bvh.build_bvh(mesh.atrium_scene(1.4), device="cuda")
    cam = camera.look_at((8.0, 6.0, -14.0), (0.0, 3.0, 0.0), device="cuda",
                         v_fov=math.radians(60), aspect=1920 / 1080)
    mat, attr = raster.perspective_rows(cam, 1920, 1080)
    tables = raster.build_frame_tables(tb.tri_v0, tb.tri_e1, tb.tri_e2,
                                       tb.tri_valid, mat, attr, 1920, 1088)
    jit = torch.tensor([0.3, 0.7], device="cuda")
    plan = raster.visit_plan(tables, 1920, 1088, jit)
    stats = torch.zeros(4, dtype=torch.int64, device="cuda")
    before = raster.rasterize_groups.launches
    got = raster.rasterize_groups(tables, plan, jit, 1920, 1088,
                                  stats=stats)
    assert raster.rasterize_groups.launches == before + 1
    want = raster.rasterize_groups_plain(tables, plan, jit, 1920,
                                         1088)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    run, skipped, tested, _ = stats.tolist()
    assert run + skipped == raster.GROUP_BANDS * plan.visits
    assert tested >= raster.group_rows_needed(tables, plan, want[0], jit,
                                              1920, 1088)
    sub = raster.visit_plan(tables, 1920, 1088, jit,
                            tiles=plan.tiles[::3].clone())
    got = raster.rasterize_groups(tables, sub, jit, 1920, 1088,
                                  base=want)
    want = raster.rasterize_groups_plain(tables, sub, jit, 1920, 1088,
                                         base=want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _group_case(case):
    """tests/test_torch_raster_group.py's scenes for the group kernel, on
    the card through the port's own camera: (tables, plan, jitter, w, h,
    hand-counted counters or None)."""
    import math

    from d3d12renderer_tpu_torch.ops import raster
    from d3d12renderer_tpu_torch.render import bvh, camera, mesh

    import torch_group_scenes as gs

    if case in ("band-wall", "tied-rows"):
        fn = gs.band_wall if case == "band-wall" else gs.tied_rows
        (tables, plan, jit, w, h), counts = fn("cuda")
        return tables, plan, jit, w, h, counts
    if case == "slivers":
        meshes, eye, target = [(gs.sliver_mesh(), 0)], gs.SLIVER_EYE, (
            0.0, 0.0, 0.0)
        (w, h), jit = gs.SLIVER_SIZE, (0.5, 0.5)
    elif case == "early-out-wall":
        meshes = [(gs.facing_grid(1, 6.0, 0.5), 1),
                  (gs.facing_grid(24, 1.0, 3.0), 0)]
        eye, target, w, h, jit = (0.0, 0.0, -2.0), (0.0, 0.0, 0.0), 64, \
            32, (0.5, 0.5)
    else:   # tests/test_torch_raster.py's CASES, its demo scene
        meshes = [(mesh.quad(half=30.0), 0),
                  (mesh.ico_sphere(1.0, 2).transformed(translate=(0, 1.0, 0)),
                   1),
                  (mesh.box((0.7, 0.7, 0.7)).transformed(
                      translate=(2.2, 0.7, -0.5),
                      rotate=(0.0, math.sin(0.3), 0.0, math.cos(0.3))), 3),
                  (mesh.torus(0.9, 0.3).transformed(
                      translate=(0.8, 0.3, 2.2)), 4)]
        eye, target, w, h, jit = {
            "near-plane-crossing": ((0.0, 0.4, -2.0), (0.0, 0.2, 2.0), 128,
                                    64, (0.5, 0.5)),
            "jittered": ((0.0, 1.5, -6.0), (0.0, 1.0, 0.0), 96, 64,
                         (0.25, 0.75))}[case]
    tb = bvh.build_bvh(meshes, device="cuda")
    cam = camera.look_at(eye, target, device="cuda", v_fov=math.radians(60),
                         aspect=w / h)
    tables, wp, hp = gs.frame_tables(tb, cam, w, h)
    jit = torch.tensor(jit, device="cuda")
    return tables, raster.visit_plan(tables, wp, hp, jit), jit, wp, hp, None


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["slivers", "early-out-wall",
                                  "near-plane-crossing", "jittered",
                                  "band-wall", "tied-rows"])
def test_raster_group_kernel_matches_plain_on_cuda_scenes(case, monkeypatch):
    """The group kernel at its real block size against its plain version on
    the host tests' scenes (edge-on slivers, the early-out wall, the demo
    scene crossing the near plane and jittered, the one-band wall and the
    tied rows): q and tri bit for bit, also with every visit a chunk of
    its own (split tiles), then the repair phase over every other
    tile; the counters add up per band, cover the rows any exact cull
    must test, and equal the hand count where there is one."""
    _need_cuda()
    from d3d12renderer_tpu_torch.ops import raster

    tables, plan, jit, w, h, counts = _group_case(case)
    stats = torch.zeros(4, dtype=torch.int64, device="cuda")
    got = raster.rasterize_groups(tables, plan, jit, w, h, stats=stats)
    want = raster.rasterize_groups_plain(tables, plan, jit, w, h)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bool((want[1] >= 0).any())
    run, skipped, tested, _ = stats.tolist()
    assert run + skipped == raster.GROUP_BANDS * plan.visits
    assert tested >= raster.group_rows_needed(tables, plan, want[0], jit, w,
                                              h)
    # Every visit a chunk on its own blocks, merged by the 64-bit maximum.
    with monkeypatch.context() as m:
        m.setattr(raster, "GROUP_CHUNK", 1)
        split = raster.rasterize_groups(tables, plan, jit, w, h)
    assert all(torch.equal(a, b) for a, b in zip(split, want))
    if counts is not None:
        assert tuple(stats.tolist()) == counts
        return
    base = (torch.full_like(want[0], 0.25), torch.full_like(want[1], 7))
    sub = raster.visit_plan(tables, w, h, jit, tiles=plan.tiles[::2].clone())
    got = raster.rasterize_groups(tables, sub, jit, w, h, base=base)
    want = raster.rasterize_groups_plain(tables, sub, jit, w, h, base=base)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sigma", [((540, 960, 1), 1.5),
                                         ((1080, 1920, 3), 1.5),
                                         ((67, 120, 3), 1.5),
                                         ((1080, 1920, 3), 1.0)])
def test_blur_kernel_matches_plain_on_cuda(shape, sigma):
    """Frame shapes of the blur (HBAO, two bloom levels, sharpen): equal
    bit for bit."""
    _need_cuda()
    from d3d12renderer_tpu_torch.ops import image

    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand(shape, generator=g, device="cuda") * 4
    taps = image.gaussian_kernel(sigma)
    before = image.gaussian_blur.launches
    got = image.gaussian_blur(x, taps)
    assert image.gaussian_blur.launches == before + 1
    assert torch.equal(got, image.blur_plain(x, taps.to("cuda")))


@pytest.mark.cuda
@pytest.mark.parametrize("srgb", [False, True])
def test_tonemap_kernel_matches_plain_on_cuda(srgb):
    """1080p, and views of the same floats at offset 1 (not 16-byte
    aligned) and of an odd length: equal bit for bit without the sRGB
    encode; with it within 2 ulps (CUDA's expf / logf against PyTorch's exp
    / log).  One launch each."""
    _need_cuda()
    from d3d12renderer_tpu_torch.ops import image
    from d3d12renderer_tpu_torch.render import post

    g = torch.Generator(device="cuda").manual_seed(2)
    n = 1080 * 1920 * 3
    flat = torch.rand(n + 8, generator=g, device="cuda") * 20
    s = post.TonemapSettings()
    for x in (flat[:n].view(1080, 1920, 3), flat[1:n + 1], flat[3:n - 2]):
        before = image.tonemap.launches
        got = image.tonemap(x, s, srgb)
        assert image.tonemap.launches == before + 1
        want = image.tonemap_plain(x, image.tonemap_constants(s), srgb)
        if srgb:
            torch.testing.assert_close(got, want, rtol=2.5e-7, atol=1e-7)
        else:
            assert torch.equal(got, want)
