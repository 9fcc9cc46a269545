"""The port's training utilities against the JAX package's on the CPU: the
episode monitor (`learning/monitor.py`), checkpoints and the NaN guard
(`utils/checkpoint.py`), the policy export (`learning/export.py`), and the
eval render of a physics state (`render/physics_viz.py`), whose JAX
`render` runs eagerly with its `jax.random` draws recorded and replayed
into the port's (as `tests/test_torch_pathtracer.py` does)."""

import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.learning import export as jexport
from d3d12renderer_tpu.learning import monitor as jmonitor
from d3d12renderer_tpu.learning import networks as jnetworks
from d3d12renderer_tpu.learning.loco_env import LocoEnv as JaxLocoEnv
from d3d12renderer_tpu.physics import types as jtypes
from d3d12renderer_tpu.render import physics_viz as jviz
from d3d12renderer_tpu_torch.convert import actor_critic_from_flax
from d3d12renderer_tpu_torch.entry import train_entry
from d3d12renderer_tpu_torch.learning import export, monitor
from d3d12renderer_tpu_torch.learning.loco_env import (ACTION_SIZE,
                                                       STATE_SIZE, LocoEnv)
from d3d12renderer_tpu_torch.physics import types as ttypes
from d3d12renderer_tpu_torch.render import physics_viz
from d3d12renderer_tpu_torch.utils import checkpoint

from tests.test_torch_pathtracer import ReplaySampler

torch.set_num_threads(1)
B = 6


def _steps(seed=0, steps=12):
    """Rewards and dones of `steps` steps of B envs: several episodes end,
    one env twice, one never."""
    rng = np.random.default_rng(seed)
    rewards = rng.normal(1.0, 0.7, (steps, B)).astype(np.float32)
    dones = rng.uniform(size=(steps, B)) < 0.2
    dones[:, 0] = False
    dones[3, 1] = dones[9, 1] = True
    return rewards, dones


def test_update_stats_and_summarize_match_jax():
    """Every field after each folded step within 1e-5 (float32 sums)."""
    rewards, dones = _steps()
    want = jmonitor.init_stats(B)
    got = monitor.init_stats(B, device="cpu")
    assert float(got.best_return) == -np.inf
    for r, d in zip(rewards, dones):
        want = jmonitor.update_stats(want, jnp.asarray(r), jnp.asarray(d))
        got = monitor.update_stats(got, torch.as_tensor(r), torch.as_tensor(d))
        for f in dataclasses.fields(got):
            np.testing.assert_allclose(getattr(got, f.name).numpy(),
                                       np.asarray(getattr(want, f.name)),
                                       rtol=1e-5, atol=1e-5, err_msg=f.name)
    assert monitor.summarize(got).keys() == jmonitor.summarize(want).keys()
    for k, v in jmonitor.summarize(want).items():
        assert monitor.summarize(got)[k] == pytest.approx(v, rel=1e-5), k
    assert monitor.summarize(got)["episodes"] >= 4


def test_monitor_csv_rows_match_jax(tmp_path):
    """The same header and rows but the wall time."""
    rewards, dones = _steps(1)
    want_stats, got_stats = jmonitor.init_stats(B), monitor.init_stats(
        B, device="cpu")
    jcsv = jmonitor.MonitorCSV(str(tmp_path / "jax.csv"))
    tcsv = monitor.MonitorCSV(str(tmp_path / "port.csv"))
    for i, (r, d) in enumerate(zip(rewards, dones)):
        want_stats = jmonitor.update_stats(want_stats, jnp.asarray(r),
                                           jnp.asarray(d))
        got_stats = monitor.update_stats(got_stats, torch.as_tensor(r),
                                         torch.as_tensor(d))
        if i % 4 == 3:
            jcsv.write(B * (i + 1), want_stats)
            tcsv.write(B * (i + 1), got_stats)
    rows = [list(csv.reader(open(tmp_path / f))) for f in ("jax.csv",
                                                            "port.csv")]
    assert len(rows[1]) == 4 and rows[0][0] == rows[1][0]
    assert [r[:-1] for r in rows[0]] == [r[:-1] for r in rows[1]]


# --------------------------------------------------------------------------
# Checkpoints and the NaN guard
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_state():
    """A TrainState after one tiny iteration (2 envs, rollout 2)."""
    train_iteration, state = train_entry(device="cpu", envs=2, rollout=2,
                                         minibatches=2, epochs=1)
    state, _ = train_iteration(state)
    return state


def _assert_trees_equal(a, b):
    la, lb = checkpoint.tree_leaves(a), checkpoint.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert type(x) is type(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        elif isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state())
        else:
            assert x == y


def test_checkpoint_round_trip_is_bit_equal(train_state, tmp_path):
    """A whole TrainState (dicts, NamedTuples, dataclasses, int and float
    tensors, generators): every leaf back bit for bit, the generators at
    the same state, and an unknown file refused."""
    path = str(tmp_path / "sub" / "state.bin")
    checkpoint.save_pytree(path, train_state)
    back = checkpoint.load_pytree(path)
    assert type(back) is type(train_state)
    assert type(back.env_state) is type(train_state.env_state)
    _assert_trees_equal(back, train_state)
    assert torch.equal(torch.rand(4, generator=back.rng),
                       torch.rand(4, generator=train_state.rng))
    tree = {"a": (np.arange(3), 2.5, None, "x"), "b": [torch.ones(2,
                                                                  dtype=torch.int32)]}
    checkpoint.save_pytree(path, tree)
    back = checkpoint.load_pytree(path, device="cpu")
    assert back["a"][1:] == (2.5, None, "x")
    np.testing.assert_array_equal(back["a"][0], np.arange(3))
    assert torch.equal(back["b"][0], tree["b"][0])
    bad = tmp_path / "bad.bin"
    import pickle
    bad.write_bytes(pickle.dumps({"treedef": None, "leaves": []}))
    with pytest.raises(ValueError, match="not a checkpoint"):
        checkpoint.load_pytree(str(bad))


def test_checkpoint_manager_keeps_three_and_the_best(train_state, tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ck"), device="cpu")
    assert mgr.latest() is None and mgr.latest_step() is None
    assert mgr.best() is None
    metrics = [0.5, 2.0, 1.0, 1.5, 0.1]
    for step, metric in enumerate(metrics):
        params = {k: v + step for k, v in train_state.params.items()}
        mgr.save(step * 10, params, metric=metric)
    files = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert files == ["best.bin", "ckpt_000000020.bin", "ckpt_000000030.bin",
                     "ckpt_000000040.bin"]
    assert mgr.latest_step() == 40
    name = next(iter(train_state.params))
    assert torch.equal(mgr.latest()[name], train_state.params[name] + 4)
    assert torch.equal(mgr.best()[name], train_state.params[name] + 1)


def test_nan_guard_rolls_back(train_state):
    """A step whose result holds a NaN returns its input (and True); a
    finite one its result (and False); generators pass through.  (A whole
    TrainState counts as non-finite until an episode ends: its best return
    starts at -inf, as in the JAX package.)"""
    tree = {"params": train_state.params, "opt": train_state.opt_state,
            "rng": train_state.rng}

    def step(tree, poison):
        params = {k: v + 1 for k, v in tree["params"].items()}
        if poison:
            params["log_std"] = params["log_std"] * float("nan")
        return dict(tree, params=params)

    guarded = checkpoint.nan_guard(step)
    out, rolled = guarded(tree, True)
    assert bool(rolled)
    _assert_trees_equal(out, tree)
    out, rolled = guarded(tree, False)
    assert not bool(rolled)
    for k, v in tree["params"].items():
        assert torch.equal(out["params"][k], v + 1)
    assert out["rng"] is train_state.rng
    assert not bool(checkpoint.tree_all_finite(train_state.stats))
    assert not bool(checkpoint.tree_all_finite(
        {"x": torch.tensor([1.0, float("inf")]), "i": torch.ones(2)}))


# --------------------------------------------------------------------------
# Export
# --------------------------------------------------------------------------

def test_export_header_equals_jax(tmp_path):
    """The C arrays of converted flax params, character for character, and
    the numpy forward within 1e-6 of JAX's."""
    net = jnetworks.ActorCritic(action_dim=ACTION_SIZE)
    params = net.init(jax.random.PRNGKey(4), jnp.zeros((1, STATE_SIZE)))
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(np.shape(x)))
        .astype(np.float32), params)
    model = actor_critic_from_flax(params, device="cpu")
    jexport.export_policy_header(params, str(tmp_path / "jax.h"))
    export.export_policy_header(model, str(tmp_path / "port.h"))
    export.export_policy_header(model.state_dict(), str(tmp_path / "sd.h"))
    want = (tmp_path / "jax.h").read_text()
    assert (tmp_path / "port.h").read_text() == want
    assert (tmp_path / "sd.h").read_text() == want
    obs = rng.normal(0, 1, (5, STATE_SIZE)).astype(np.float32)
    np.testing.assert_allclose(export.policy_forward_np(model, obs),
                               jexport.policy_forward_np(params, obs),
                               atol=1e-6)


# --------------------------------------------------------------------------
# The eval render
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scenes():
    """The JAX and port ragdoll archetypes with two colliders retyped to a
    cylinder and a hull (with vertices), a third to a box and a fourth to a
    sphere, so that every shape branch runs; and one env's bodies of a
    disturbed pose."""
    jenv, tenv = JaxLocoEnv(), LocoEnv(device="cpu")
    ja, ta = jenv.arch, tenv.arch
    types = np.array(ja.col_type)
    types[:4] = [jtypes.SHAPE_CYLINDER, jtypes.SHAPE_HULL, jtypes.SHAPE_BOX,
                 jtypes.SHAPE_SPHERE]
    hull_v = np.array(ja.col_hull_verts)
    hull_m = np.array(ja.col_hull_mask)
    hull_v[1, :5] = np.random.default_rng(5).normal(0, 0.1, (5, 3))
    hull_m[1, :5] = True
    ja = ja.replace(col_type=jnp.asarray(types),
                    col_hull_verts=jnp.asarray(hull_v),
                    col_hull_mask=jnp.asarray(hull_m))
    ta = dataclasses.replace(ta, col_type=torch.as_tensor(types),
                             col_hull_verts=torch.as_tensor(hull_v),
                             col_hull_mask=torch.as_tensor(hull_m))
    assert ttypes.MAX_HULL_VERTS == jtypes.MAX_HULL_VERTS
    _, jst = jenv.reset(jax.random.PRNGKey(0))
    rng = np.random.default_rng(6)
    pos = np.asarray(jst.bodies.pos) + rng.normal(0, 0.05, jst.bodies.pos.shape)
    rot = np.asarray(jst.bodies.rot) + rng.normal(0, 0.05, jst.bodies.rot.shape)
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    jb = jst.bodies.replace(pos=jnp.asarray(pos, jnp.float32),
                            rot=jnp.asarray(rot, jnp.float32))
    tb = ttypes.BodyState(*(torch.as_tensor(np.array(getattr(jb, f)))
                            for f in ("pos", "rot", "vel", "omega", "force",
                                      "torque")))
    return ja, jb, ta, tb


def test_physics_meshes_equal_jax(scenes):
    """Every collider's mesh (capsules, and the retyped cylinder, hull,
    box and sphere) and the ground quad: vertices within 1e-5 (float32
    world poses), indices and materials equal."""
    ja, jb, ta, tb = scenes
    want = jviz.physics_meshes(ja, jb)
    got = physics_viz.physics_meshes(ta, tb)
    assert len(got) == len(want) == ta.num_colliders + 1
    for (g, gm), (w, wm) in zip(got, want):
        assert gm == wm
        np.testing.assert_array_equal(g.indices, w.indices)
        np.testing.assert_allclose(g.positions, w.positions, atol=1e-5)
        np.testing.assert_allclose(g.normals, w.normals, atol=1e-5)


def test_render_physics_state_matches_jax(scenes, monkeypatch):
    """A 20x20 frame at 2 spp of the ragdoll, JAX's `render` run eagerly
    with its draws recorded and replayed into the port's: the uint8 images
    within 1 level (float32 differences that cross a truncation) on >= 99%
    of pixels, mean |difference| below 0.1 level."""
    ja, jb, ta, tb = scenes
    monkeypatch.setenv("D3D12TPU_BVH_CACHE", "0")
    draws = []
    for kind in ("uniform", "normal", "randint"):
        orig = getattr(jax.random, kind)

        def record(*a, _orig=orig, _kind=kind, **k):
            x = _orig(*a, **k)
            draws.append((_kind, np.asarray(x)))
            return x
        monkeypatch.setattr(jax.random, kind, record)
    kw = dict(eye=(4.0, 2.5, 5.0), target=(0.0, 0.9, 0.0), size=20, spp=2)
    with jax.disable_jit():
        want = jviz.render_physics_state(ja, jb, key=jax.random.PRNGKey(2),
                                         **kw)
    monkeypatch.undo()
    sampler = ReplaySampler(draws)
    got = physics_viz.render_physics_state(ta, tb, sampler=sampler, **kw)
    assert not sampler.draws, "the port drew fewer numbers than JAX"
    assert got.dtype == np.uint8 and got.shape == (20, 20, 3)
    assert 20 < got.mean() < 250
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(-1)
    assert (diff <= 1).mean() >= 0.99
    assert diff.mean() < 0.1
