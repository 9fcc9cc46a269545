"""The port's locomotion env, policy and entry point against the JAX package
on the CPU.

JAX and torch draw different random numbers, so the trajectory test takes
the pokes from the JAX env's own key stream and injects them into the port;
actions come from a numpy seed.  The JAX env runs the unfused XLA path
(fused_substep="off", solver_backend="xla").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.learning import networks as jnetworks
from d3d12renderer_tpu.learning.loco_env import LocoEnv as JaxLocoEnv
from d3d12renderer_tpu.physics.types import PhysicsSettings as JaxSettings
from d3d12renderer_tpu_torch.convert import (
    actor_critic_from_flax, env_state_from_numpy)
from d3d12renderer_tpu_torch.entry import entry
from d3d12renderer_tpu_torch.learning import networks
from d3d12renderer_tpu_torch.learning.loco_env import (
    ACTION_SIZE, NUM_PARTS, POKE_PROBABILITY, STATE_SIZE, LocoEnv,
    make_vec_env)

torch.set_num_threads(1)

B = 4
STEPS = 5
FALLEN_ENV = 3
JAX_SETTINGS = JaxSettings(frame_rate=60, fused_substep="off",
                           solver_backend="xla")
FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")


def _jax_poke_draws(rng):
    """The (do, part, theta) that JAX's `LocoEnv.step` draws from `rng`
    (one env), and the key it carries on."""
    rng, poke_key = jax.random.split(rng)
    k1, k2, k3 = jax.random.split(poke_key, 3)
    do = jax.random.uniform(k1) < POKE_PROBABILITY
    part = jax.random.randint(k2, (), 0, NUM_PARTS)
    theta = jax.random.uniform(k3, minval=0.0, maxval=2.0 * jnp.pi)
    return rng, do, part, theta


def _draw_sequence(seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    draws = jax.jit(jax.vmap(_jax_poke_draws))
    out = []
    for _ in range(STEPS):
        keys, do, part, theta = draws(keys)
        out.append((np.asarray(do), np.asarray(part), np.asarray(theta)))
    return out


@pytest.fixture(scope="module")
def trajectories():
    """5 steps of both envs from the same start, one env forced to fall."""
    # The first reset seed whose key stream pokes a standing env.
    seed = next(s for s in range(500)
                if any(d[:FALLEN_ENV].any() for d, _, _ in _draw_sequence(s)))
    pokes = _draw_sequence(seed)
    rng = np.random.default_rng(3)
    actions = rng.uniform(-0.5, 0.5, (STEPS, B, ACTION_SIZE))
    # Swing targets of +-1 rad keep every swing motor's error well away
    # from zero: there the position motor's acos(cos_ang) with cos_ang
    # within a few ulp of 1 turns one float32 ulp into ~3e-4 rad in either
    # package, and the obs of a light part then differ by ~1e-4 after one
    # step, far above the rounding this test is meant to bound.
    actions[..., 1:3 * 7:3] = np.where(rng.uniform(size=(STEPS, B, 7)) < 0.5,
                                       -1.0, 1.0)
    actions = actions.astype(np.float32)

    jenv = JaxLocoEnv(settings=JAX_SETTINGS)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    jobs0, jst = jax.vmap(jenv.reset)(keys)
    # Sink one ragdoll 1.5 m into the ground: its head stays below 1 m
    # through the first step, so it counts as fallen and auto-resets.
    pos = np.array(jst.bodies.pos)
    pos[FALLEN_ENV, :, 1] -= 1.5
    jst = jst.replace(bodies=jst.bodies.replace(pos=jnp.asarray(pos)))
    bodies_np = {f: np.asarray(getattr(jst.bodies, f)) for f in FIELDS}

    tenv = LocoEnv(device="cpu")
    tobs0, tst = tenv.reset(B, torch.Generator().manual_seed(0))
    tst = env_state_from_numpy(bodies_np, np.asarray(jst.last_action),
                               np.asarray(jst.steps), tst.generator,
                               device="cpu")

    jstep = jax.jit(jax.vmap(jenv.step))
    out = {"jax": [], "port": [], "pokes": pokes, "obs0": (jobs0, tobs0)}
    with torch.no_grad():
        for t in range(STEPS):
            jobs, jst, jrew, jdone = jstep(jst, jnp.asarray(actions[t]))
            do, part, theta = (torch.tensor(x) for x in pokes[t])
            tobs, tst, trew, tdone = tenv.step(
                tst, torch.as_tensor(actions[t]),
                poke=(do, part.to(torch.int64), theta))
            out["jax"].append((jobs, jst, jrew, jdone))
            out["port"].append((tobs, tst, trew, tdone))
    return out


def test_reset_matches_jax(trajectories):
    jobs0, tobs0 = trajectories["obs0"]
    np.testing.assert_allclose(tobs0.numpy(), np.asarray(jobs0), atol=1e-6)
    assert tobs0.shape == (B, STATE_SIZE)


def test_trajectory_covers_pokes_and_auto_reset(trajectories):
    assert any(d[:FALLEN_ENV].any() for d, _, _ in trajectories["pokes"])
    dones = np.stack([np.asarray(j[3]) for j in trajectories["jax"]])
    assert dones[0, FALLEN_ENV] and not dones[:, :FALLEN_ENV].any()


@pytest.mark.parametrize("t", range(STEPS))
def test_trajectory_step_matches_jax(trajectories, t):
    """Obs 5e-5, reward 1e-4, done exact, body poses (the joint
    trajectories) within the BASELINE 1e-3."""
    jobs, jst, jrew, jdone = trajectories["jax"][t]
    tobs, tst, trew, tdone = trajectories["port"][t]
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=5e-5)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-4)
    for f in ("pos", "rot"):
        np.testing.assert_allclose(getattr(tst.bodies, f).numpy(),
                                   np.asarray(getattr(jst.bodies, f)),
                                   atol=1e-3, err_msg=f)
    np.testing.assert_allclose(tst.last_action.numpy(),
                               np.asarray(jst.last_action), atol=1e-6)
    np.testing.assert_array_equal(tst.steps.numpy(), np.asarray(jst.steps))


@pytest.fixture(scope="module")
def flax_params():
    net = jnetworks.ActorCritic(action_dim=ACTION_SIZE)
    params = net.init(jax.random.PRNGKey(1), jnp.zeros((1, STATE_SIZE)))
    rng = np.random.default_rng(0)
    # Disturb every leaf so that biases and log_std are not all zero.
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(np.shape(x)))
        .astype(np.float32), params)
    return net, params


@pytest.mark.parametrize("output", ["mean", "log_std", "value"])
def test_actor_critic_from_flax_matches(flax_params, output):
    net, params = flax_params
    obs = np.random.default_rng(2).normal(0, 1, (16, STATE_SIZE)).astype(np.float32)
    want = dict(zip(("mean", "log_std", "value"),
                    net.apply(params, jnp.asarray(obs))))[output]
    model = actor_critic_from_flax(params, device="cpu")
    with torch.no_grad():
        got = dict(zip(("mean", "log_std", "value"),
                       model(torch.as_tensor(obs))))[output]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


def test_gaussian_logp_and_entropy_match():
    rng = np.random.default_rng(4)
    a, mu = (rng.normal(0, 1, (8, ACTION_SIZE)).astype(np.float32)
             for _ in range(2))
    log_std = rng.normal(0, 0.3, ACTION_SIZE).astype(np.float32)
    np.testing.assert_allclose(
        networks.gaussian_logp(*map(torch.as_tensor, (a, mu, log_std))).numpy(),
        np.asarray(jnetworks.gaussian_logp(a, mu, log_std)), rtol=1e-5)
    np.testing.assert_allclose(
        networks.gaussian_entropy(torch.as_tensor(log_std)).numpy(),
        np.asarray(jnetworks.gaussian_entropy(log_std)), rtol=1e-6)


def test_actor_critic_seeded_init_is_reproducible():
    def make(seed):
        return networks.ActorCritic(STATE_SIZE, ACTION_SIZE,
                                    generator=torch.Generator().manual_seed(seed))
    a, b, c = make(5), make(5), make(6)
    for (name, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(x, y), name
    assert not torch.equal(a.pi_0.weight, c.pi_0.weight)
    w = a.action_head.weight.detach()
    assert 0.0 <= float(w.min()) and float(w.max()) < 0.01


def test_entry_runs_on_cpu():
    fn, (model, state, obs) = entry(device="cpu", batch=2, seed=3)
    obs, state, reward, done = fn(model, state, obs)
    assert obs.shape == (2, STATE_SIZE) and reward.shape == (2,)
    assert done.dtype == torch.bool
    assert torch.isfinite(obs).all() and torch.isfinite(reward).all()
    assert state.steps.tolist() == [1, 1]


def test_vec_env_draws_pokes_from_its_generator():
    env = LocoEnv(device="cpu")
    reset, step = make_vec_env(env, 3)
    for _ in range(2):
        gen = torch.Generator().manual_seed(11)
        do, part, theta = env.draw_poke(gen, 1000)
        assert do.dtype == torch.bool and 0 < int(do.sum()) < 60
        assert int(part.min()) >= 0 and int(part.max()) == NUM_PARTS - 1
        assert 0.0 <= float(theta.min()) and float(theta.max()) < 2 * np.pi
    again = env.draw_poke(torch.Generator().manual_seed(11), 1000)
    assert all(torch.equal(x, y) for x, y in zip((do, part, theta), again))
    obs, st = reset(torch.Generator().manual_seed(1))
    obs, st, reward, done = step(st, torch.zeros(3, ACTION_SIZE))
    assert obs.shape == (3, STATE_SIZE) and torch.isfinite(reward).all()


def test_apply_poke_pushes_one_part():
    env = LocoEnv(device="cpu")
    _, st = env.reset(2, torch.Generator())
    do = torch.tensor([True, False])
    part = torch.tensor([1, 1])
    theta = torch.tensor([0.0, 0.0])
    b = env.apply_poke(st.bodies, do, part, theta)
    head = int(env.part_idx[1])
    np.testing.assert_allclose(b.force[0, head].numpy(), [1000.0, 0.0, 0.0])
    assert float(b.force[1].abs().sum()) == 0.0
    assert float(b.force[0].abs().sum()) == 1000.0
    # Pushed 0.2 m above the COG along +x: torque about -z.
    assert float(b.torque[0, head, 2]) < 0.0
