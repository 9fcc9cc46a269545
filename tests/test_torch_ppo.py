"""The port's PPO (`learning/ppo.py`, `networks.sample_action`) against the
JAX package's on the CPU, at a tiny size: 8 envs, rollout 3, 2 minibatches,
2 epochs.

JAX's `compute_gae`, `loss_fn` and `update_minibatch` are closures of its
`make_ppo`; the tests take them from the jitted `train_iteration`'s
closure, so they hold the port against JAX's own functions.  JAX and torch
draw different random numbers, so the whole-iteration test rebuilds JAX's
action noise, permutations and pokes from its key streams (as
`tests/test_torch_loco_env.py` does for the pokes) and injects them.  The
JAX env runs the unfused XLA path (fused_substep="off",
solver_backend="xla").
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from d3d12renderer_tpu.learning import networks as jnetworks
from d3d12renderer_tpu.learning import ppo as jppo
from d3d12renderer_tpu.learning.loco_env import LocoEnv as JaxLocoEnv
from d3d12renderer_tpu.physics.types import PhysicsSettings as JaxSettings
from d3d12renderer_tpu_torch.convert import (_state_dict_from_flax,
                                             actor_critic_from_flax,
                                             train_state_from_numpy)
from d3d12renderer_tpu_torch.learning import networks, ppo
from d3d12renderer_tpu_torch.learning.loco_env import (
    ACTION_SIZE, NUM_PARTS, POKE_PROBABILITY, STATE_SIZE, LocoEnv)

torch.set_num_threads(1)

B, T, MINIBATCHES, EPOCHS = 8, 3, 2, 2
N = B * T
FALLEN_ENV = 5
CONFIG = dict(num_envs=B, rollout_steps=T, minibatches=MINIBATCHES,
              epochs=EPOCHS)
JAX_SETTINGS = JaxSettings(frame_rate=60, fused_substep="off",
                           solver_backend="xla")


def _closure(fn, name):
    """A free variable of a Python function (JAX's make_ppo closures)."""
    fn = getattr(fn, "__wrapped__", fn)
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.fixture(scope="module")
def jax_ppo():
    env = JaxLocoEnv(settings=JAX_SETTINGS)
    init, train_iteration, _ = jppo.make_ppo(env, jppo.PPOConfig(**CONFIG))
    return {"env": env, "init": init, "iteration": train_iteration,
            "gae": _closure(train_iteration, "compute_gae")}


@pytest.fixture(scope="module")
def flax_params(jax_ppo):
    """JAX's initial parameters, every leaf disturbed so that biases and
    log_std are not all zero."""
    params = jax_ppo["init"](jax.random.PRNGKey(1)).params
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(np.shape(x)))
        .astype(np.float32), params)


def _port_params(flax_params):
    return {k: torch.as_tensor(np.ascontiguousarray(v))
            for k, v in _state_dict_from_flax(flax_params).items()}


def _port_apply():
    net = networks.ActorCritic(STATE_SIZE, ACTION_SIZE)
    return lambda params, obs: torch.func.functional_call(net, params, (obs,))


def test_sample_action_matches_jax():
    """With JAX's noise injected: action 1e-6, logp 1e-5 (float32 sums of
    27 terms of magnitude ~1)."""
    rng = np.random.default_rng(1)
    mean = rng.normal(0, 0.5, (B, ACTION_SIZE)).astype(np.float32)
    log_std = rng.normal(0, 0.3, ACTION_SIZE).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want_a, want_logp = jnetworks.sample_action(mean, log_std, key)
    noise = jax.random.normal(key, mean.shape)
    got_a, got_logp = networks.sample_action(_t(mean), _t(log_std),
                                             noise=_t(noise))
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), atol=1e-6)
    np.testing.assert_allclose(got_logp.numpy(), np.asarray(want_logp),
                               rtol=1e-5, atol=1e-5)
    # From a generator: the same generator state gives the same draw.
    a1, _ = networks.sample_action(_t(mean), _t(log_std),
                                   torch.Generator().manual_seed(4))
    a2, _ = networks.sample_action(_t(mean), _t(log_std),
                                   torch.Generator().manual_seed(4))
    assert torch.equal(a1, a2) and not torch.equal(a1, got_a)


def test_compute_gae_matches_jax(jax_ppo):
    """Fixed arrays over 6 steps with dones in the middle and at the end:
    advantages and returns within 1e-6 (the same float32 recursion)."""
    rng = np.random.default_rng(2)
    steps = 6
    reward = rng.normal(1, 0.5, (steps, B)).astype(np.float32)
    value = rng.normal(0, 1, (steps, B)).astype(np.float32)
    done = rng.uniform(size=(steps, B)) < 0.25
    done[-1, 0] = done[2, 1] = True
    last_value = rng.normal(0, 1, B).astype(np.float32)
    zeros = np.zeros((steps, B, 1), np.float32)
    traj = jppo.Transition(zeros, zeros, zeros[..., 0], value, reward, done)
    want_adv, want_ret = jax_ppo["gae"](traj, jnp.asarray(last_value))
    got_adv, got_ret = ppo.compute_gae(
        ppo.Transition(None, None, None, _t(value), _t(reward), _t(done)),
        _t(last_value), 0.99, 0.95)
    np.testing.assert_allclose(got_adv.numpy(), np.asarray(want_adv),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got_ret.numpy(), np.asarray(want_ret),
                               atol=1e-6, rtol=1e-6)


def _minibatch(seed, params, m=12):
    """A fixed minibatch whose old log-probabilities sit within ~0.15 of
    the policy's, so that its ratios fall on both sides of the clip range
    [0.9, 1.1] and inside it."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(0, 1, (m, STATE_SIZE)).astype(np.float32)
    action = rng.normal(0, 1, (m, ACTION_SIZE)).astype(np.float32)
    with torch.no_grad():
        mean, log_std, _ = _port_apply()(params, _t(obs))
        logp = networks.gaussian_logp(_t(action), mean, log_std).numpy()
    shift = np.linspace(-0.15, 0.15, m).astype(np.float32)
    ratio = np.exp(-shift)
    assert (ratio < 0.9).any() and (ratio > 1.1).any()
    assert ((ratio > 0.9) & (ratio < 1.1)).any()
    adv = rng.normal(0, 1, m).astype(np.float32)
    ret = rng.normal(0, 1, m).astype(np.float32)
    return obs, action, logp + shift, adv, ret


@pytest.mark.parametrize("ent_coef", [0.0, 0.01])
def test_loss_and_gradients_match_jax(jax_ppo, flax_params, ent_coef):
    """A fixed minibatch: the three losses and the total within 1e-5
    relative, every gradient within 1e-4 of its tensor's largest entry
    (float32 through two tanh layers and the exp of the ratio)."""
    obs, action, logp, adv, ret = _minibatch(5, _port_params(flax_params))
    jcfg = jppo.PPOConfig(**CONFIG, ent_coef=ent_coef)
    env = jax_ppo["env"]
    _, it, _ = jppo.make_ppo(env, jcfg)
    jloss = _closure(_closure(it, "update_minibatch"), "loss_fn")
    batch = jppo.Transition(obs, action, logp, None, None, None)
    (want_total, want_aux), want_g = jax.value_and_grad(jloss, has_aux=True)(
        flax_params, batch, jnp.asarray(adv), jnp.asarray(ret))

    params = {k: v.requires_grad_(True)
              for k, v in _port_params(flax_params).items()}
    total, aux = ppo.ppo_loss(
        _port_apply(), params,
        ppo.Transition(_t(obs), _t(action), _t(logp), None, None, None),
        _t(adv), _t(ret), ppo.PPOConfig(**CONFIG, ent_coef=ent_coef))
    grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
    for got, want in zip((total,) + tuple(aux), (want_total,) + tuple(want_aux)):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                                   atol=1e-7)
    for name, want in _state_dict_from_flax(want_g).items():
        scale = max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(grads[name].numpy(), want,
                                   atol=1e-4 * scale, err_msg=name)


def _optax_steps(grads_seq, params):
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(2.5e-5))
    state = tx.init(params)
    out = []
    for g in grads_seq:
        upd, state = tx.update(g, state)
        params = optax.apply_updates(params, upd)
        out.append((params, state[1][0]))
    return out


def test_clip_and_adam_matches_optax(flax_params):
    """Three steps of optax's clip_by_global_norm(0.5) + adam(2.5e-5): a
    gradient under the clip's norm, one over it, one under again (bias
    correction at counts 1-3).  Params within 1e-7 absolute; moments within
    1e-6 of their tensor's largest entry (the global norm is summed in
    another order, so every clipped gradient may differ by an ulp, and a
    moment that cancels to a small value keeps that ulp of the large
    terms); the count exact."""
    rng = np.random.default_rng(7)
    seq = []
    for scale in (1e-3, 10.0, 5e-4):
        g = jax.tree_util.tree_map(
            lambda x: (scale * rng.standard_normal(np.shape(x)))
            .astype(np.float32), flax_params)
        seq.append(g)
    norms = [float(optax.global_norm(g)) for g in seq]
    assert norms[0] < 0.5 < norms[1] and norms[2] < 0.5
    want = _optax_steps(seq, flax_params)

    params = _port_params(flax_params)
    state = ppo.AdamState(torch.zeros((), dtype=torch.int32),
                          {k: torch.zeros_like(v) for k, v in params.items()},
                          {k: torch.zeros_like(v) for k, v in params.items()})
    cfg = ppo.PPOConfig()
    for g, (want_p, want_s) in zip(seq, want):
        params, state = ppo.clip_and_adam(params, _port_params(g), state, cfg)
        assert int(state.count) == int(want_s.count)
        for name, w in _state_dict_from_flax(want_p).items():
            np.testing.assert_allclose(params[name].numpy(), w, atol=1e-7,
                                       rtol=0, err_msg=name)
        for got, w in ((state.mu, want_s.mu), (state.nu, want_s.nu)):
            for name, x in _state_dict_from_flax(w).items():
                np.testing.assert_allclose(got[name].numpy(), x, rtol=0,
                                           atol=1e-6 * np.abs(x).max(),
                                           err_msg=name)


# --------------------------------------------------------------------------
# One whole train_iteration from the same carried TrainState
# --------------------------------------------------------------------------

def _poke_draws(rng):
    """The (do, part, theta) that JAX's `LocoEnv.step` draws from one env's
    key, and the key it carries on."""
    rng, poke_key = jax.random.split(rng)
    k1, k2, k3 = jax.random.split(poke_key, 3)
    do = jax.random.uniform(k1) < POKE_PROBABILITY
    part = jax.random.randint(k2, (), 0, NUM_PARTS)
    theta = jax.random.uniform(k3, minval=0.0, maxval=2.0 * jnp.pi)
    return rng, do, part, theta


def _jax_draws(state):
    """JAX's train_iteration's draws from `state`'s keys: the action noise
    of each rollout step, each epoch's permutation (`ppo.py:104-113,
    :161-166`), and every env's pokes."""
    rng, noise, perms = state.rng, [], []
    for _ in range(T):
        rng, k_act = jax.random.split(rng)
        noise.append(np.asarray(jax.random.normal(k_act, (B, ACTION_SIZE))))
    for _ in range(EPOCHS):
        rng, k = jax.random.split(rng)
        perms.append(np.asarray(jax.random.permutation(k, N)))
    keys, pokes = state.env_state.rng, []
    draw = jax.jit(jax.vmap(_poke_draws))
    for _ in range(T):
        keys, do, part, theta = draw(keys)
        pokes.append((np.asarray(do), np.asarray(part), np.asarray(theta)))
    return np.stack(noise), pokes, np.stack(perms)


@pytest.fixture(scope="module")
def iteration(jax_ppo):
    """One JAX iteration and the port's from the same TrainState: the
    first seed whose key stream pokes a standing env within the rollout,
    one env sunk 1.5 m into the ground (it falls, resets and ends an
    episode in the first step)."""
    init = jax_ppo["init"]
    for seed in range(200):
        state = init(jax.random.PRNGKey(seed))
        noise, pokes, perms = _jax_draws(state)
        if any(d[:FALLEN_ENV].any() for d, _, _ in pokes):
            break
    pos = np.array(state.env_state.bodies.pos)
    pos[FALLEN_ENV, :, 1] -= 1.5
    bodies = state.env_state.bodies.replace(pos=jnp.asarray(pos))
    state = state._replace(env_state=state.env_state.replace(bodies=bodies))
    want_state, want_metrics = jax_ppo["iteration"](state)

    port = train_state_from_numpy(state, device="cpu")
    _, train_iteration, _ = ppo.make_ppo(LocoEnv(device="cpu"),
                                         ppo.PPOConfig(**CONFIG))
    draws = ppo.Draws(
        noise=_t(noise),
        pokes=[(_t(d), _t(p, torch.int64), _t(th)) for d, p, th in pokes],
        perms=_t(perms, torch.int64))
    before = {k: v.clone() for k, v in port.params.items()}
    got_state, got_metrics = train_iteration(port, draws)
    return {"want": (want_state, want_metrics), "got": (got_state, got_metrics),
            "pokes": pokes, "port_before": (port, before),
            "start_params": state.params}


def test_iteration_covers_pokes_dones_and_clipping(iteration):
    want_state, want_metrics = iteration["want"]
    assert any(d[:FALLEN_ENV].any() for d, _, _ in iteration["pokes"])
    assert float(want_state.stats.episode_count) >= 1
    assert float(want_metrics["episode_done_rate"]) > 0
    port, before = iteration["port_before"]
    assert all(torch.equal(port.params[k], v) for k, v in before.items())


# The rollout's obs and rewards within the env tests' 5e-5 / 1e-4 (three
# steps); losses averaged over 4 updates within 1e-4 relative.  Adam moves
# each parameter by at most about lr (2.5e-5) per update, so the
# parameters are held by their change over the iteration: the port's
# change within 1e-5 of JAX's (they agree to within 1e-6), which an
# iteration that drops or repeats an update cannot meet.  The moments
# are held to 1e-4 relative of their tensor's largest entry.
def test_iteration_metrics_match_jax(iteration):
    want = iteration["want"][1]
    got = iteration["got"][1]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_iteration_params_and_adam_match_jax(iteration):
    want_state, _ = iteration["want"]
    got_state, _ = iteration["got"]
    _, before = iteration["port_before"]
    start = _state_dict_from_flax(iteration["start_params"])
    updates = EPOCHS * MINIBATCHES
    for name, w in _state_dict_from_flax(want_state.params).items():
        np.testing.assert_array_equal(before[name].numpy(), start[name])
        np.testing.assert_allclose(
            (got_state.params[name] - before[name]).numpy(), w - start[name],
            atol=1e-5, rtol=0, err_msg=name)
    adam = want_state.opt_state[1][0]
    assert int(got_state.opt_state.count) == int(adam.count) == updates
    for got, w in ((got_state.opt_state.mu, adam.mu),
                   (got_state.opt_state.nu, adam.nu)):
        for name, x in _state_dict_from_flax(w).items():
            np.testing.assert_allclose(got[name].numpy(), x,
                                       atol=1e-4 * np.abs(x).max(),
                                       err_msg=name)


def test_iteration_env_and_stats_match_jax(iteration):
    want_state, _ = iteration["want"]
    got_state, _ = iteration["got"]
    np.testing.assert_allclose(got_state.last_obs.numpy(),
                               np.asarray(want_state.last_obs), atol=5e-5)
    for f in ("pos", "rot"):
        np.testing.assert_allclose(
            getattr(got_state.env_state.bodies, f).numpy(),
            np.asarray(getattr(want_state.env_state.bodies, f)), atol=1e-3)
    np.testing.assert_array_equal(got_state.env_state.steps.numpy(),
                                  np.asarray(want_state.env_state.steps))
    for f in ("running_return", "running_length", "episode_count",
              "return_sum", "length_sum", "best_return"):
        np.testing.assert_allclose(
            getattr(got_state.stats, f).numpy(),
            np.asarray(getattr(want_state.stats, f)), atol=1e-4, err_msg=f)


def test_train_state_from_numpy_carries_every_part(jax_ppo):
    state = jax_ppo["init"](jax.random.PRNGKey(2))
    port = train_state_from_numpy(state, device="cpu")
    model = actor_critic_from_flax(state.params, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(port.params[k], v), k
    assert int(port.opt_state.count) == 0
    assert set(port.opt_state.mu) == set(port.params)
    assert port.last_obs.shape == (B, STATE_SIZE)
    assert port.env_state.bodies.pos.shape == (B, NUM_PARTS, 3)
    assert float(port.stats.best_return) == -np.inf
    assert port.stats.running_return.shape == (B,)


def test_iteration_draws_from_generators_on_cpu():
    """Without injected draws: two runs from states of one seed agree
    bit for bit, and the iteration moves the parameters."""
    env = LocoEnv(device="cpu")
    init, train_iteration, policy_apply = ppo.make_ppo(
        env, ppo.PPOConfig(num_envs=2, rollout_steps=2, minibatches=2,
                           epochs=1))
    runs = [train_iteration(init(3)) for _ in range(2)]
    for k, v in runs[0][0].params.items():
        assert torch.equal(v, runs[1][0].params[k]), k
    start = init(3)
    assert any(not torch.equal(v, start.params[k])
               for k, v in runs[0][0].params.items())
    mean, log_std, value = policy_apply(start.params, start.last_obs)
    assert mean.shape == (2, ACTION_SIZE) and value.shape == (2,)
