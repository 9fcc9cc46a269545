"""Chip check of the PyTorch / CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernel from the sources beside this script, holds it
against its plain PyTorch version at the main path's shapes, then drives the
main path (`d3d12renderer_tpu_torch.entry`: policy forward + batched ragdoll
env step) at 4096 envs and checks what comes out.  Each phase prints one
line; the line before the last is a JSON summary of the kernels, the last
line `{"ok": true, "device": {...}}`.  Any failure exits non-zero.

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
STAND_STEPS = 60
WARM_STEPS = 20
PLAIN_STEPS = 3
ITERATIONS = 30
# Kernel vs plain after one 30-iteration solve.  nvcc contracts a*b+c into
# FMA and the plain version rounds every product, and the two differ in
# op order; those rounding differences pass through 30 sweeps of ~300
# dependent row solves, with clamps that can switch.
VEL_TOL = 1e-3
OMEGA_TOL = 5e-3
# Card against the CPU path, obs and reward over a few whole env steps: the
# same rounding differences, plus the torch CUDA and CPU op implementations,
# grown through each step's 30 sweeps.
REF_STEPS = 5
REF_TOL = 1e-3


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


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
    from d3d12renderer_tpu_torch.entry import entry
    from d3d12renderer_tpu_torch.learning.loco_env import (
        ACTION_SIZE, FRAME_RATE, STATE_SIZE, LocoEnv)
    from d3d12renderer_tpu_torch.physics import solver_cuda, step
    from d3d12renderer_tpu_torch.physics.types import PhysicsSettings

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

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

    # 2. Build.
    t0 = time.perf_counter()
    lib_path = solver_cuda.build_library()
    solver_cuda.load_library()
    build_s = time.perf_counter() - t0
    log = (lib_path.parent / "build.log").read_text()
    ptxas = " ".join(l.strip() for l in log.splitlines()
                     if "registers" in l or "spill" in l)
    print(f"build: {build_s:.1f} s -> {lib_path} | {ptxas}", flush=True)

    # 3. Kernel vs plain on the preps of a disturbed batch.
    gen = torch.Generator(device=dev).manual_seed(7)
    env = LocoEnv(settings=PhysicsSettings(frame_rate=FRAME_RATE,
                                           fused_substep="off"), device=dev)
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
        before = solver_cuda.colored_solve_cuda.launches
        kv, kw = solver(*args)
        sync()
        if solver_cuda.colored_solve_cuda.launches != before + 1:
            fail("the kernel wrapper did not count exactly one launch")
        pv, pw = solver.plain(*args)
        sync()
        if not (torch.isfinite(kv).all() and torch.isfinite(kw).all()):
            fail("kernel output is not finite")
        err_v = (kv - pv).abs().max().item()
        err_w = (kw - pw).abs().max().item()
        points = int(sp.contact_prep.pmask.sum().item())
        limits = sum(int((p[k] > 0).sum().item()) for p in sp.joint_preps
                     for k in ("eff_limit", "eff_twist_limit", "eff_swing")
                     if k in p)

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
    print(f"kernel vs plain (B={BATCH}, {ITERATIONS} iterations, "
          f"{points} active contact points, {limits} active limit rows): "
          f"max |dvel| {err_v:.3e} (bound {VEL_TOL}), max |domega| "
          f"{err_w:.3e} (bound {OMEGA_TOL}); ms per solve: kernel "
          f"{kernel_ms}, pack + kernel {route_ms}, plain {plain_ms} | {card}",
          flush=True)
    if not (err_v <= VEL_TOL and err_w <= OMEGA_TOL):
        fail("kernel disagrees with its plain version")

    # Small-input reference: the whole env step on the card (kernel) against
    # the CPU path (plain solve), which the CPU tests hold against JAX.
    # Swing targets of +-1 rad keep the swing motors out of their
    # acos-near-1 regime, where one ulp becomes ~3e-4 rad.
    small = 8
    cpu_env = LocoEnv(settings=env.settings, device="cpu")
    rng = torch.Generator().manual_seed(3)
    acts = torch.rand((REF_STEPS, small, ACTION_SIZE), generator=rng) - 0.5
    acts[..., 1:21:3] = torch.where(
        torch.rand((REF_STEPS, small, 7), generator=rng) < 0.5, -1.0, 1.0)
    pokes = [(torch.arange(small) == t, torch.full((small,), t),
              torch.full((small,), 0.5 * t)) for t in range(REF_STEPS)]
    _, gst = env.reset(small, gen)
    _, cst = cpu_env.reset(small, torch.Generator())
    ref_err = 0.0
    with torch.inference_mode():
        for t in range(REF_STEPS):
            gobs, gst, grew, gdone = env.step(
                gst, acts[t].to(dev), poke=tuple(x.to(dev) for x in pokes[t]))
            cobs, cst, crew, cdone = cpu_env.step(cst, acts[t], poke=pokes[t])
            if not torch.equal(gdone.cpu(), cdone):
                fail(f"step {t}: done differs between card and CPU")
            ref_err = max(ref_err, (gobs.cpu() - cobs).abs().max().item(),
                          (grew.cpu() - crew).abs().max().item())
    print(f"reference: {small} envs x {REF_STEPS} steps, card (kernel) vs "
          f"CPU (plain): max |dobs|, |dreward| {ref_err:.3e} (bound "
          f"{REF_TOL})", flush=True)
    if not ref_err <= REF_TOL:
        fail("the card's env step disagrees with the CPU path")

    # 4. Main path: policy forward + env step, kernel launched via "auto".
    fn, (model, est, obs) = entry(device=dev, batch=BATCH, seed=0)
    fn(model, est, obs)   # warm-up (allocator, first launches)
    sync()
    solver_cuda.colored_solve_cuda.launches = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        any_done = torch.zeros(BATCH, dtype=torch.bool, device=dev)
        finite = torch.ones((), dtype=torch.bool, device=dev)
        for _ in range(MAIN_STEPS):
            obs, est, reward, done = fn(model, est, obs)
            any_done |= done
            finite &= torch.isfinite(obs).all() & torch.isfinite(reward).all()
    sync()
    main_s = time.perf_counter() - t0
    launches = solver_cuda.colored_solve_cuda.launches
    b = est.bodies
    finite = bool(finite) and all(bool(torch.isfinite(x).all()) for x in
                                  (b.pos, b.rot, b.vel, b.omega))
    if obs.shape != (BATCH, STATE_SIZE) or reward.shape != (BATCH,):
        fail(f"bad output shapes {tuple(obs.shape)} {tuple(reward.shape)}")
    if not finite:
        fail("non-finite outputs on the main path")
    if launches != MAIN_STEPS:
        fail(f"kernel launched {launches} times in {MAIN_STEPS} steps")
    sps = BATCH * MAIN_STEPS / main_s

    fn_p, (model_p, est_p, obs_p) = entry(device=dev, batch=BATCH, seed=0,
                                          solver_backend="plain")
    fn_p(model_p, est_p, obs_p)
    sync()
    t0 = time.perf_counter()
    for _ in range(PLAIN_STEPS):
        obs_p, est_p, _, _ = fn_p(model_p, est_p, obs_p)
    sync()
    plain_sps = BATCH * PLAIN_STEPS / (time.perf_counter() - t0)
    print(f"main path: {MAIN_STEPS} steps x {BATCH} envs, kernel launches "
          f"{launches}, finite, {int(any_done.sum())} envs fell and reset | "
          f"env-steps/s kernel {sps:.0f} plain {plain_sps:.0f} | {card}",
          flush=True)

    # Standing check: zero action, no pokes, no env falls in 1 s.
    no_poke = (torch.zeros(BATCH, dtype=torch.bool, device=dev),
               torch.zeros(BATCH, dtype=torch.int64, device=dev),
               torch.zeros(BATCH, device=dev))
    _, st = env.reset(BATCH, gen)
    zero = torch.zeros((BATCH, ACTION_SIZE), device=dev)
    fell = torch.zeros(BATCH, dtype=torch.bool, device=dev)
    with torch.inference_mode():
        for _ in range(STAND_STEPS):
            _, st, reward, done = env.step(st, zero, poke=no_poke)
            fell |= done
    mean_reward = reward.mean().item()
    print(f"standing: {STAND_STEPS} steps, zero action, no pokes: "
          f"{int(fell.sum())} envs fell, mean reward {mean_reward:.4f}",
          flush=True)
    if bool(fell.any()) or not mean_reward > 0.5:
        fail("the ragdolls did not stand")

    print(json.dumps({"kernels": [{
        "name": "colored_solver",
        "route": "cuda",
        "source": "d3d12renderer_tpu_torch/csrc/colored_solver.cu",
        "replaces": "d3d12renderer_tpu/physics/solver_pallas.py:619",
        "launches": launches,
        "max_abs_err": max(err_v, err_w),
        "ms": min(kernel_ms),
        "plain_ms": min(plain_ms),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
