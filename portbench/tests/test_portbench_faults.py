"""A run whose timed path is broken underneath comes out not correct: the
harness is driven on the CPU at a tiny size with one fault planted in the
port, for each fault the cell can have."""

import pytest
import torch

from .tiny import run_tiny


def _step_unchanged(monkeypatch):
    from d3d12renderer_tpu_torch.learning import loco_env

    monkeypatch.setattr(loco_env, "physics_step",
                        lambda arch, state, *a, **k: (state, None))


def _half_batch(monkeypatch):
    from d3d12renderer_tpu_torch.learning import loco_env
    from d3d12renderer_tpu_torch.physics.types import BodyState

    real = loco_env.physics_step

    def half(arch, state, *a, **k):
        out, contacts = real(arch, state, *a, **k)
        h = state.pos.shape[0] // 2
        return BodyState(*(torch.cat([getattr(out, f)[:h],
                                      getattr(state, f)[h:]])
                           for f in ("pos", "rot", "vel", "omega", "force",
                                     "torque"))), contacts

    monkeypatch.setattr(loco_env, "physics_step", half)


def _obs_altered(monkeypatch):
    from d3d12renderer_tpu_torch.learning import loco_env

    real = loco_env.LocoEnv._get_obs

    def altered(self, bodies, last_action):
        obs = real(self, bodies, last_action).clone()
        obs[0, 5] += 1e-2
        return obs

    monkeypatch.setattr(loco_env.LocoEnv, "_get_obs", altered)


def _frame_unchanged(monkeypatch):
    from d3d12renderer_tpu_torch.render import pathtracer

    real = pathtracer.render
    first = {}

    def stale(*a, **k):
        out = real(*a, **k)
        return first.setdefault("frame", out)

    monkeypatch.setattr(pathtracer, "render", stale)


def _half_rays(monkeypatch):
    from d3d12renderer_tpu_torch.render import pathtracer

    real = pathtracer.trace_sample

    def half(*a, **k):
        rad, n = real(*a, **k)
        rad = rad.clone()
        rad[rad.shape[0] // 2:] = rad[:rad.shape[0] - rad.shape[0] // 2]
        return rad, n

    monkeypatch.setattr(pathtracer, "trace_sample", half)


def _radiance_altered(monkeypatch):
    from d3d12renderer_tpu_torch.render import pathtracer

    real = pathtracer.trace_sample

    def altered(*a, **k):
        rad, n = real(*a, **k)
        rad = rad.clone()
        rad[::7] *= 1.01
        return rad, n

    monkeypatch.setattr(pathtracer, "trace_sample", altered)


def _update_skipped(monkeypatch):
    from d3d12renderer_tpu_torch.learning import ppo

    monkeypatch.setattr(ppo, "clip_and_adam",
                        lambda params, grads, state, config: (params, state))


def _half_minibatch(monkeypatch):
    from d3d12renderer_tpu_torch.learning import ppo

    real = ppo.ppo_loss

    def half(policy_apply, params, batch, adv, ret, config, group=None):
        n = adv.shape[0] // 2
        return real(policy_apply, params, type(batch)(*(x[:n] for x in batch)),
                    adv[:n], ret[:n], config, group)

    monkeypatch.setattr(ppo, "ppo_loss", half)


def _reward_altered(monkeypatch):
    from d3d12renderer_tpu_torch.learning import loco_env

    real = loco_env.LocoEnv._reward

    def altered(self, bodies):
        return real(self, bodies) * 1.1

    monkeypatch.setattr(loco_env.LocoEnv, "_reward", altered)


def _raster_frame_unchanged(monkeypatch):
    from d3d12renderer_tpu_torch.render import pipeline

    real = pipeline.render_frame
    first = {}

    def stale(*a, **k):
        ldr, state, aux = real(*a, **k)
        return first.setdefault("ldr", ldr), state, aux

    monkeypatch.setattr(pipeline, "render_frame", stale)


def _raster_half(monkeypatch):
    from d3d12renderer_tpu_torch.render import pipeline

    real = pipeline._post

    def half(color, settings):
        ldr = real(color, settings).clone()
        ldr[ldr.shape[0] // 2:] = 0.0
        return ldr

    monkeypatch.setattr(pipeline, "_post", half)


def _raster_altered(monkeypatch):
    from d3d12renderer_tpu_torch.render import pipeline

    real = pipeline._post

    def altered(color, settings):
        ldr = real(color, settings).clone()
        ldr.view(-1, 3)[::7] *= 1.01
        return ldr

    monkeypatch.setattr(pipeline, "_post", altered)


def _shadow_block_altered(monkeypatch):
    """One block of one cascade, a sixteenth of its texels, built wrong:
    the set-up's maps, which the frame check takes as given."""
    import dataclasses

    from d3d12renderer_tpu_torch.render import shadows

    real = shadows.render_sun_shadow_maps

    def altered(*a, **k):
        maps = real(*a, **k)
        depth = maps.depth.clone()
        q = depth.shape[-1] // 4
        block = depth[1, :q, :q]
        depth[1, :q, :q] = torch.where(torch.isinf(block), 1.0, block * 1.01)
        return dataclasses.replace(maps, depth=depth)

    monkeypatch.setattr(shadows, "render_sun_shadow_maps", altered)


FAULTS = [
    ("ragdoll_loco_4096.rollout", _step_unchanged),
    ("ragdoll_loco_4096.rollout", _half_batch),
    ("ragdoll_loco_4096.rollout", _obs_altered),
    ("atrium_1080p.pathtrace", _frame_unchanged),
    ("atrium_1080p.pathtrace", _half_rays),
    ("atrium_1080p.pathtrace", _radiance_altered),
    ("ragdoll_loco_4096.ppo", _update_skipped),
    ("ragdoll_loco_4096.ppo", _half_minibatch),
    ("ragdoll_loco_4096.ppo", _reward_altered),
    ("atrium_1080p.raster", _raster_frame_unchanged),
    ("atrium_1080p.raster", _raster_half),
    ("atrium_1080p.raster", _raster_altered),
    ("atrium_1080p.raster", _shadow_block_altered),
]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = run_tiny(cell)
    assert result["correct"] is False, result["checks"]
