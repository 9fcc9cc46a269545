"""Chip check of the PyTorch / CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels (the colored solver and the fused
whole-substep kernel) from the sources beside this script, holds each
against its plain PyTorch version at the main path's shapes, then drives the
main path (`d3d12renderer_tpu_torch.entry`: policy forward + batched ragdoll
env step, one fused-kernel launch per step) at 4096 envs, and the unfused
route whose solve is the colored-solver kernel, and checks what comes out.
Each phase prints one line; the line before the last is a JSON summary of
the kernels, the last line `{"ok": true, "device": {...}}`.  Any failure
exits non-zero.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

BATCH = 4096
MAIN_STEPS = 120
UNFUSED_STEPS = MAIN_STEPS
STAND_STEPS = 60
WARM_STEPS = 20
PLAIN_STEPS = 3
PROFILE_STEPS = 10
ITERATIONS = 30
# Kernel vs plain after one 30-iteration solve.  nvcc contracts a*b+c into
# FMA and the plain version rounds every product, and the two differ in
# op order; those rounding differences pass through 30 sweeps of ~300
# dependent row solves, with clamps that can switch.  The fused kernel also
# computes its prep in other op orders; the same bounds hold it, and its obs
# and reward are held at OBS_TOL.
VEL_TOL = 1e-3
OMEGA_TOL = 5e-3
OBS_TOL = 1e-3
# Positions and rotations move by those velocity errors times one 1/60 s
# step (1.7e-5 and 4.2e-5).
POSE_TOL = 1e-4
# `done` (head height < 1 m) may flip only where the height is this close
# to 1 m.
DONE_BAND = 1e-4
# Card against the CPU path, obs and reward over a few whole env steps: the
# same rounding differences, plus the torch CUDA and CPU op implementations,
# grown through each step's 30 sweeps.
REF_STEPS = 5
REF_TOL = 1e-3


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def chain_scene(builder):
    """A kinematic anchor and four bodies (sphere, box, sphere, box) on the
    ground plane, jointed distance -> ball -> fixed -> hinge: the colored
    solver's row kinds 3-5 and the fused kernel's distance, ball and fixed
    preps."""
    builder.add_static_plane((0.0, 1.0, 0.0), 0.0, friction=0.9,
                             restitution=0.2)
    group = builder.new_no_collide_group()
    anchor = builder.add_body((0.0, 1.2, 0.0), kinematic=True)
    builder.set_no_collide_group(anchor, group)
    bodies = []
    for i in range(4):
        body = builder.add_body((0.5 * (i + 1), 0.45 if i % 2 == 0 else 0.28,
                                 0.0))
        if i % 2 == 0:
            builder.add_sphere_collider(body, radius=0.5, friction=0.7)
        else:
            builder.add_box_collider(body, (0.3, 0.3, 0.2), restitution=0.3)
        builder.set_no_collide_group(body, group)
        bodies.append(body)
    builder.add_distance_joint(anchor, bodies[0], (0.0, 1.2, 0.0),
                               (0.5, 0.45, 0.0))
    builder.add_ball_joint(bodies[0], bodies[1], (0.75, 0.4, 0.0))
    builder.add_fixed_joint(bodies[1], bodies[2], (1.25, 0.35, 0.0))
    builder.add_hinge_joint(bodies[2], bodies[3], (1.75, 0.35, 0.0),
                            (0.0, 0.0, 1.0), min_limit=-0.5, max_limit=0.5,
                            motor_type=1.0, motor_target=0.3, max_torque=50.0)
    return builder.finalize(device="cuda")


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this check runs only on a GPU")
    import d3d12renderer_tpu_torch as port

    if not os.path.abspath(port.__file__).startswith(here + os.sep):
        fail(f"d3d12renderer_tpu_torch comes from {port.__file__}, not from "
             "this checkout")
    from torch.autograd import DeviceType

    from d3d12renderer_tpu_torch.entry import entry
    from d3d12renderer_tpu_torch.learning.loco_env import (
        ACTION_SIZE, FRAME_RATE, STATE_SIZE, LocoEnv)
    from d3d12renderer_tpu_torch.physics import solver_cuda, step, substep_cuda
    from d3d12renderer_tpu_torch.physics.builder import SceneBuilder
    from d3d12renderer_tpu_torch.physics.types import BodyState, PhysicsSettings

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    colored = solver_cuda.colored_solve_cuda
    fused_k = substep_cuda.fused_substep_cuda

    def cuda_ms(fn, reps):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sync()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / reps

    def max_err(a, b):
        return (a - b).abs().max().item()

    # 1. Device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card)
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} | "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    # 2. Build: one nvcc call, both kernels in one library.
    t0 = time.perf_counter()
    lib_path = solver_cuda.build_library()
    solver_cuda.load_library()
    build_s = time.perf_counter() - t0
    log = (lib_path.parent / "build.log").read_text()
    ptxas = " ".join(l.strip() for l in log.splitlines()
                     if "registers" in l or "spill" in l or "entry" in l)
    print(f"build: {build_s:.1f} s -> {lib_path} | {ptxas}", flush=True)

    # 3. Colored solver vs plain on the preps of a disturbed batch.
    gen = torch.Generator(device=dev).manual_seed(7)
    unfused = PhysicsSettings(frame_rate=FRAME_RATE, fused_substep="off")
    plain_set = PhysicsSettings(frame_rate=FRAME_RATE, fused_substep="off",
                                solver_backend="plain")
    env = LocoEnv(settings=unfused, device=dev)
    _, st = env.reset(BATCH, gen)
    with torch.inference_mode():
        for _ in range(WARM_STEPS):
            act = torch.rand((BATCH, ACTION_SIZE), generator=gen,
                             device=dev) * 2.0 - 1.0
            _, st, _, _ = env.step(st, act)
        act = torch.rand((BATCH, ACTION_SIZE), generator=gen,
                         device=dev) * 2.0 - 1.0
        sp = step.substep_prep(env.arch, st.bodies, 1.0 / FRAME_RATE,
                               env.settings, env._motor_overrides(act))
        num_pairs = sp.contacts.body_a.shape[0]
        solver = solver_cuda.ColoredSolver(env.arch, num_pairs, ITERATIONS,
                                           "kernel")
        args = (sp.joint_preps, sp.contact_prep, sp.vel1, sp.omega1)
        before = colored.launches
        kv, kw = solver(*args)
        sync()
        if colored.launches != before + 1:
            fail("the colored kernel wrapper did not count exactly one launch")
        pv, pw = solver.plain(*args)
        sync()
        if not (torch.isfinite(kv).all() and torch.isfinite(kw).all()):
            fail("colored kernel output is not finite")
        err_v, err_w = max_err(kv, pv), max_err(kw, pw)
        points = int(sp.contact_prep.pmask.sum().item())
        limits = sum(int((p[k] > 0).sum().item()) for p in sp.joint_preps
                     for k in ("eff_limit", "eff_twist_limit", "eff_swing")
                     if k in p)

        # The kernel alone on a packed buffer, and the kernel route (pack +
        # kernel); in turns with the plain version.
        prep = solver.pack_prep(sp.joint_preps, sp.contact_prep, BATCH, dev)
        arrays = solver.kernel_arrays(dev)

        def kernel_only():
            return solver_cuda.colored_solve_cuda(
                sp.vel1, sp.omega1, prep, arrays, len(solver.tables),
                solver.num_impulses, ITERATIONS)

        plain_ms = [cuda_ms(lambda: solver.plain(*args), 2)]
        kernel_ms = [cuda_ms(kernel_only, 20)]
        route_ms = [cuda_ms(lambda: solver(*args), 20) for _ in range(2)]
        kernel_ms.append(cuda_ms(kernel_only, 20))
        plain_ms.append(cuda_ms(lambda: solver.plain(*args), 2))
    print(f"colored kernel vs plain (B={BATCH}, {ITERATIONS} iterations, "
          f"{points} active contact points, {limits} active limit rows): "
          f"max |dvel| {err_v:.3e} (bound {VEL_TOL}), max |domega| "
          f"{err_w:.3e} (bound {OMEGA_TOL}); ms per solve: kernel "
          f"{kernel_ms}, pack + kernel {route_ms}, plain {plain_ms} | {card}",
          flush=True)
    if not (err_v <= VEL_TOL and err_w <= OMEGA_TOL):
        fail("the colored kernel disagrees with its plain version")

    # 4. Fused kernel vs its plain version: one whole env step from the state
    # after the warm steps, with the same smoothed action and poke.
    fenv = LocoEnv(device=dev)              # the JAX env's settings: fused
    penv = LocoEnv(settings=plain_set, device=dev)
    with torch.inference_mode():
        smoothed = st.last_action + 0.1 * (act - st.last_action)
        bodies = env.apply_poke(st.bodies, *env.draw_poke(gen, BATCH))
        fused = fenv._fused_step
        if fused is None:
            fail("the fused route was not built on the card")
        before = fused_k.launches
        got = fused(bodies, smoothed)
        sync()
        if fused_k.launches != before + 1:
            fail("the fused kernel wrapper did not count exactly one launch")
        want = penv._step_core(bodies, smoothed)       # plain version
        route = env._step_core(bodies, smoothed)       # unfused kernel route
        sync()

        def compare(a, b):
            """Max errors over the envs whose `done` agrees (a flipped env
            resets on one side only), the number of flips, and whether a
            flip lies outside the band around 1 m."""
            (ab, aobs, arew, adone), (bb, bobs, brew, bdone) = a, b
            same = adone == bdone
            errs = {f: max_err(getattr(ab, f)[same], getattr(bb, f)[same])
                    for f in ("pos", "rot", "vel", "omega")}
            errs.update(obs=max_err(aobs[same], bobs[same]),
                        reward=max_err(arew[same], brew[same]))
            # The head height before the reset: the plain side's where it
            # did not fall, else the kernel side's.
            head = torch.where(bdone, ab.pos[:, fenv.part_idx[fenv._head], 1],
                               bb.pos[:, fenv.part_idx[fenv._head], 1])
            near = (head - 1.0).abs() <= DONE_BAND
            return errs, int((~same).sum()), bool((~same & ~near).any())

        f_errs, f_flips, f_bad = compare(got, want)
        r_errs, r_flips, r_bad = compare(got, route)
        finite = all(bool(torch.isfinite(x).all()) for x in
                     (got[0].pos, got[0].rot, got[0].vel, got[0].omega,
                      got[1], got[2]))
        # The kernel alone, on the constants the route packs.
        ovr = smoothed.contiguous()
        fconsts = substep_cuda.pack_consts(
            fenv.arch, fenv.settings, 1.0 / FRAME_RATE, fenv._action_columns(),
            ACTION_SIZE, dev)
        post = fenv.post_consts()

        def fused_only():
            return fused_k(bodies, ovr, fconsts, post)

        f_ms = [cuda_ms(fused_only, 20)]
        u_ms = [cuda_ms(lambda: env._step_core(bodies, smoothed), 10)]
        p_ms = [cuda_ms(lambda: penv._step_core(bodies, smoothed), 1)]
        p_ms.append(cuda_ms(lambda: penv._step_core(bodies, smoothed), 1))
        u_ms.append(cuda_ms(lambda: env._step_core(bodies, smoothed), 10))
        f_ms.append(cuda_ms(fused_only, 20))
    print(f"fused kernel vs plain (B={BATCH}, one env step, {ITERATIONS} "
          f"iterations): max err {json.dumps(f_errs)}, done flips {f_flips}; "
          f"vs the unfused kernel route: {json.dumps(r_errs)}, done flips "
          f"{r_flips} | bounds pos/rot {POSE_TOL} vel {VEL_TOL} omega "
          f"{OMEGA_TOL} obs/reward "
          f"{OBS_TOL}, done within {DONE_BAND} of 1 m | ms per env step: "
          f"fused kernel {f_ms}, unfused kernel route {u_ms}, plain {p_ms} | "
          f"{card}", flush=True)
    for errs, bad, what in ((f_errs, f_bad, "its plain version"),
                            (r_errs, r_bad, "the unfused kernel route")):
        if not (finite and errs["pos"] <= POSE_TOL and errs["rot"] <= POSE_TOL
                and errs["vel"] <= VEL_TOL and errs["omega"] <= OMEGA_TOL
                and errs["obs"] <= OBS_TOL and errs["reward"] <= OBS_TOL
                and not bad):
            fail(f"the fused kernel disagrees with {what}")
    fused_err = max(f_errs.values())

    # 5. The chain archetype (distance, ball, fixed, hinge; sphere and box
    # colliders): one substep through physics_substep, fused kernel vs the
    # unfused kernel route vs the plain route.
    arch, s0 = chain_scene(SceneBuilder())
    cs = BodyState(*(getattr(s0, f).expand((BATCH,) + getattr(s0, f).shape[1:])
                     .contiguous() for f in ("pos", "rot", "vel", "omega",
                                             "force", "torque")))
    cgen = torch.Generator(device=dev).manual_seed(3)
    moving = (arch.inv_mass[:-1] > 0)[None, :, None]
    cs = cs.replace(
        vel=(torch.rand(cs.vel.shape, generator=cgen, device=dev) - 0.5) * moving,
        omega=(torch.rand(cs.omega.shape, generator=cgen, device=dev) - 0.5)
        * moving)
    chain = {}
    with torch.inference_mode():
        for name, settings in (
                ("fused", PhysicsSettings(frame_rate=FRAME_RATE)),
                ("kernel", unfused), ("plain", plain_set)):
            f0, c0 = fused_k.launches, colored.launches
            out, contacts = step.physics_substep(arch, cs, 1.0 / FRAME_RATE,
                                                 settings)
            sync()
            chain[name] = (out, fused_k.launches - f0, colored.launches - c0)
    if [chain[k][1:] for k in ("fused", "kernel", "plain")] != [
            (1, 0), (0, 1), (0, 0)]:
        fail(f"chain routes took the wrong kernels: "
             f"{[chain[k][1:] for k in chain]}")
    c_errs = {}
    for a, b in (("fused", "plain"), ("kernel", "plain"), ("fused", "kernel")):
        c_errs[f"{a}-{b}"] = {f: max_err(getattr(chain[a][0], f),
                                         getattr(chain[b][0], f))
                              for f in ("pos", "rot", "vel", "omega")}
    print(f"chain (distance, ball, fixed, hinge; B={BATCH}, one substep): "
          f"{json.dumps(c_errs)} | bounds pos/rot {POSE_TOL} vel {VEL_TOL} "
          f"omega {OMEGA_TOL}", flush=True)
    for name, e in c_errs.items():
        if not (e["pos"] <= POSE_TOL and e["rot"] <= POSE_TOL
                and e["vel"] <= VEL_TOL and e["omega"] <= OMEGA_TOL):
            fail(f"chain: {name} disagree")
    colored_err = max(err_v, err_w, c_errs["kernel-plain"]["vel"],
                      c_errs["kernel-plain"]["omega"])
    fused_err = max(fused_err, c_errs["fused-plain"]["vel"],
                    c_errs["fused-plain"]["omega"])

    # 6. Small-input reference: the fused route on the card against the CPU
    # path (the fused route's plain version there), which the CPU tests hold
    # against JAX.  Swing targets of +-1 rad keep the swing motors out of
    # their acos-near-1 regime, where one ulp becomes ~3e-4 rad.
    small = 8
    cpu_env = LocoEnv(device="cpu")
    rng = torch.Generator().manual_seed(3)
    acts = torch.rand((REF_STEPS, small, ACTION_SIZE), generator=rng) - 0.5
    acts[..., 1:21:3] = torch.where(
        torch.rand((REF_STEPS, small, 7), generator=rng) < 0.5, -1.0, 1.0)
    pokes = [(torch.arange(small) == t, torch.full((small,), t),
              torch.full((small,), 0.5 * t)) for t in range(REF_STEPS)]
    _, gst = fenv.reset(small, gen)
    _, cst = cpu_env.reset(small, torch.Generator())
    ref_err = 0.0
    before = fused_k.launches
    with torch.inference_mode():
        for t in range(REF_STEPS):
            gobs, gst, grew, gdone = fenv.step(
                gst, acts[t].to(dev), poke=tuple(x.to(dev) for x in pokes[t]))
            cobs, cst, crew, cdone = cpu_env.step(cst, acts[t], poke=pokes[t])
            if not torch.equal(gdone.cpu(), cdone):
                fail(f"step {t}: done differs between card and CPU")
            ref_err = max(ref_err, max_err(gobs.cpu(), cobs),
                          max_err(grew.cpu(), crew))
    if fused_k.launches != before + REF_STEPS:
        fail("the reference run did not go through the fused kernel")
    print(f"reference: {small} envs x {REF_STEPS} steps, card (fused kernel) "
          f"vs CPU (plain): max |dobs|, |dreward| {ref_err:.3e} (bound "
          f"{REF_TOL})", flush=True)
    if not ref_err <= REF_TOL:
        fail("the card's env step disagrees with the CPU path")

    # 7. Main path: policy forward + env step, one fused launch per step.
    def drive(steps, **kw):
        fn, (model, est, obs) = entry(device=dev, batch=BATCH, seed=0, **kw)
        fn(model, est, obs)   # warm-up (allocator, first launches, consts)
        sync()
        fused_k.launches = colored.launches = 0
        t0 = time.perf_counter()
        with torch.inference_mode():
            any_done = torch.zeros(BATCH, dtype=torch.bool, device=dev)
            finite = torch.ones((), dtype=torch.bool, device=dev)
            for _ in range(steps):
                obs, est, reward, done = fn(model, est, obs)
                any_done |= done
                finite &= torch.isfinite(obs).all() & torch.isfinite(reward).all()
        sync()
        secs = time.perf_counter() - t0
        counts = (fused_k.launches, colored.launches)
        b = est.bodies
        finite = bool(finite) and all(bool(torch.isfinite(x).all()) for x in
                                      (b.pos, b.rot, b.vel, b.omega))
        if obs.shape != (BATCH, STATE_SIZE) or reward.shape != (BATCH,):
            fail(f"bad output shapes {tuple(obs.shape)} {tuple(reward.shape)}")
        if not finite:
            fail(f"non-finite outputs on the path {kw or 'fused'}")
        return BATCH * steps / secs, counts, int(any_done.sum()), (fn, model,
                                                                   est, obs)

    sps, (f_launch, c_launch), fell, (fn, model, est, obs) = drive(MAIN_STEPS)
    if f_launch != MAIN_STEPS or c_launch != 0:
        fail(f"main path: {f_launch} fused and {c_launch} colored launches in "
             f"{MAIN_STEPS} steps (want {MAIN_STEPS} and 0)")
    u_sps, (uf, u_launch), u_fell, _ = drive(UNFUSED_STEPS, fused_substep="off")
    if u_launch != UNFUSED_STEPS or uf != 0:
        fail(f"unfused route: {uf} fused and {u_launch} colored launches in "
             f"{UNFUSED_STEPS} steps")
    p_sps, (pf, pc), _, _ = drive(PLAIN_STEPS, solver_backend="plain")
    if pf or pc:
        fail("the plain route launched a kernel")

    # Device time per step of the fused main path, and kernels per step.
    with torch.inference_mode(), torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            obs, est, _, _ = fn(model, est, obs)
        sync()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / PROFILE_STEPS
    step_ms = 1e3 * BATCH / sps
    fused_dev = [e for e in kernels if "fused_substep" in e.name]
    print(f"main path: {MAIN_STEPS} steps x {BATCH} envs, fused launches "
          f"{f_launch}, colored launches {c_launch}, finite, {fell} envs fell "
          f"and reset | env-steps/s fused {sps:.0f}, unfused kernel route "
          f"{u_sps:.0f} ({u_launch} colored launches in {UNFUSED_STEPS} "
          f"steps, {u_fell} fell), plain {p_sps:.0f} | profiler over "
          f"{PROFILE_STEPS} fused steps: {len(kernels) / PROFILE_STEPS:.1f} "
          f"kernels per step, device busy {dev_ms:.3f} ms per step of "
          f"{step_ms:.3f} ms wall ({100 * dev_ms / step_ms:.1f}%), fused "
          f"kernel {sum(e.time_range.elapsed_us() for e in fused_dev) / 1e3 / max(1, len(fused_dev)):.3f} "
          f"ms each | {card}", flush=True)

    # 8. Standing check through the fused route: zero action, no pokes, no
    # env falls in 1 s.
    no_poke = (torch.zeros(BATCH, dtype=torch.bool, device=dev),
               torch.zeros(BATCH, dtype=torch.int64, device=dev),
               torch.zeros(BATCH, device=dev))
    _, st = fenv.reset(BATCH, gen)
    zero = torch.zeros((BATCH, ACTION_SIZE), device=dev)
    fell = torch.zeros(BATCH, dtype=torch.bool, device=dev)
    before = fused_k.launches
    with torch.inference_mode():
        for _ in range(STAND_STEPS):
            _, st, reward, done = fenv.step(st, zero, poke=no_poke)
            fell |= done
    mean_reward = reward.mean().item()
    print(f"standing (fused): {STAND_STEPS} steps, zero action, no pokes: "
          f"{int(fell.sum())} envs fell, mean reward {mean_reward:.4f}",
          flush=True)
    if fused_k.launches != before + STAND_STEPS:
        fail("the standing check did not go through the fused kernel")
    if bool(fell.any()) or not mean_reward > 0.5:
        fail("the ragdolls did not stand")

    print(json.dumps({"kernels": [{
        "name": "colored_solver",
        "route": "cuda",
        "source": "d3d12renderer_tpu_torch/csrc/colored_solver.cu",
        "replaces": "d3d12renderer_tpu/physics/solver_pallas.py:619",
        "launches": u_launch,
        "max_abs_err": colored_err,
        "ms": min(kernel_ms),
        "plain_ms": min(plain_ms),
    }, {
        "name": "fused_substep",
        "route": "cuda",
        "source": "d3d12renderer_tpu_torch/csrc/fused_substep.cu",
        "replaces": "d3d12renderer_tpu/physics/substep_pallas.py:1026",
        "launches": f_launch,
        "max_abs_err": fused_err,
        "ms": min(f_ms),
        "plain_ms": min(p_ms),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
