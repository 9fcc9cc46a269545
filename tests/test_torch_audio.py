"""The port's audio (`audio/audio.py`, `mixdown.py`, `stream.py`: numpy on
the host in both packages) against the JAX package's on one event script:
the engine's events equal, `impact_synth`, `mixdown` and the streamed WAV
sample for sample; then `showcase_world_entry(audio=...)` at a small size
on the CPU against examples/showcase.py's `--audio` path run by the JAX
package on the same drop (its bodies lowered so that they land within
DROP_FRAMES frames): the same impacts (times equal, points and speeds
within IMPACT_TOL) and the WAVs within AUDIO_TOL
(tests/test_audio_stream.py's bound) after PCM16."""

import dataclasses
import wave

import numpy as np
import pytest
import torch

from d3d12renderer_tpu.audio import audio as jaudio
from d3d12renderer_tpu.audio import mixdown as jmix
from d3d12renderer_tpu.audio import stream as jstream
from d3d12renderer_tpu_torch.audio import audio as taudio
from d3d12renderer_tpu_torch.audio import mixdown as tmix
from d3d12renderer_tpu_torch.audio import stream as tstream

SR = 8000
AUDIO_TOL = 1e-4
# Contact points and closing speeds through a few float32 substeps.
IMPACT_TOL = 1e-4
DROP_FRAMES = 12
# Each body's centre DROP_CLEARANCE above the ground under it (the script
# drops it 3 m + 0.5 m per body higher).
DROP_CLEARANCE = 0.6


def _wav(path, freq, secs=0.3):
    t = np.arange(int(SR * secs)) / SR
    x = (np.sin(2 * np.pi * freq * t) * 0.5).astype(np.float32)
    jmix.write_wav(str(path), np.stack([x, x], -1), SR)
    return str(path)


def _script(audio, wav, reverb):
    """One timeline of every engine call: 2D, 3D and synth voices, submix
    and listener, volume and pitch updates, a stop, an impact synth, a
    missing asset's placeholder tone and a reverb preset."""
    eng = audio.AudioEngine()
    eng.set_listener((1.0, 0.5, -2.0), forward=(0.3, 0.0, -1.0))
    eng.set_submix_volume("music", 0.5)
    music = eng.play_sound_2d(wav, "music", volume=0.8, looping=True)
    eng.advance(0.2)
    shot = eng.play_sound_3d(wav, (4.0, 1.0, 0.0), "sfx", volume=0.9,
                             pitch=1.5)
    eng.advance(0.1)
    eng.play_sound_3d(wav, (-1.0, 0.0, 2.0), "sfx", volume=0.6)
    hum = eng.play_synth(audio.sine_synth(440.0, SR), "ambient", volume=0.4,
                         position=(-3.0, 0.0, 1.0))
    eng.advance(0.3)
    music.set_volume(0.3)
    shot.set_pitch(0.8)
    eng.advance(0.2)
    hum.stop()
    eng.play_synth(audio.impact_synth(4.2, seed=3, sample_rate=SR), "sfx",
                   volume=0.7, position=(0.5, 0.0, 0.5))
    eng.advance(0.25)
    eng.play_sound_2d("no/such/asset.wav", "voice", volume=0.5)
    eng.set_reverb(reverb)
    return eng


@pytest.mark.parametrize("reverb", ["off", "mountains"])
def test_engine_mixdown_and_stream_match_jax(tmp_path, reverb):
    """Events equal; `mixdown` equal sample for sample; `stream_to_wav`'s
    files equal byte for byte (odd blocks, a per-type cap of 1 that steals
    a voice) and its float blocks equal `StreamingMixer`'s."""
    wav = _wav(tmp_path / "beep.wav", 330.0)
    je, te = (_script(a, wav, reverb) for a in (jaudio, taudio))
    assert te.events == je.events
    assert te.active_voices() == je.active_voices()
    np.testing.assert_array_equal(tmix.mixdown(te, 1.4, SR),
                                  jmix.mixdown(je, 1.4, SR))
    je, te = (_script(a, wav, reverb) for a in (jaudio, taudio))
    stats = []
    for mod, eng, name in ((jstream, je, "j.wav"), (tstream, te, "t.wav")):
        stats.append(mod.stream_to_wav(eng, 1.4, str(tmp_path / name), SR,
                                       block_frames=777,
                                       max_voices_per_type=1))
    assert stats[0] == stats[1] and stats[1]["stolen"] >= 1
    assert (tmp_path / "j.wav").read_bytes() == (tmp_path / "t.wav"
                                                 ).read_bytes()
    je, te = (_script(a, wav, reverb) for a in (jaudio, taudio))
    jm, tm = jstream.StreamingMixer(je, SR, 512), tstream.StreamingMixer(
        te, SR, 512)
    for _ in range(4):
        np.testing.assert_array_equal(tm.render_block(), jm.render_block())


def test_synths_and_block_reader_match_jax(tmp_path):
    t = np.arange(4000) / SR
    for speed in (0.5, 3.0, 12.0):
        np.testing.assert_array_equal(
            taudio.impact_synth(speed, seed=7, sample_rate=SR)(t),
            jaudio.impact_synth(speed, seed=7, sample_rate=SR)(t))
    np.testing.assert_array_equal(taudio.sine_synth(220.0, SR)(t),
                                  jaudio.sine_synth(220.0, SR)(t))
    wav = _wav(tmp_path / "loop.wav", 250.0, secs=0.1)
    for looping in (True, False):
        tr = tstream.WavBlockReader(wav, SR, pitch=1.3, looping=looping)
        jr = jstream.WavBlockReader(wav, SR, pitch=1.3, looping=looping)
        for n in (300, 777, 1500):
            np.testing.assert_array_equal(tr.read(n), jr.read(n))
        assert tr.done == jr.done


def _read(path):
    with wave.open(str(path), "rb") as w:
        raw = w.readframes(w.getnframes())
        return np.frombuffer(raw, np.int16).reshape(-1, 2) / 32767.0, \
            w.getframerate()


def _jax_showcase_impacts(heights, cell, frames):
    """examples/showcase.py:110-147's drop with collision events, run by
    the JAX package, each body DROP_CLEARANCE above the ground."""
    import jax
    import jax.numpy as jnp

    from d3d12renderer_tpu.physics.builder import SceneBuilder
    from d3d12renderer_tpu.physics.step import physics_step
    from d3d12renderer_tpu.physics.types import PhysicsSettings
    from d3d12renderer_tpu.terrain.heightmap import sample_height_bilinear

    origin = (-24.0, 0.0, -24.0)
    pb = SceneBuilder()
    pb.add_terrain(heights, origin=origin, cell_size=cell, friction=0.7)
    rng = np.random.default_rng(0)
    for i in range(6):
        x, z = rng.uniform(-6, 6, 2)
        h, _ = sample_height_bilinear(jnp.asarray(heights), origin, cell,
                                      jnp.asarray(x), jnp.asarray(z))
        body = pb.add_body(position=(x, float(h) + DROP_CLEARANCE, z))
        if i % 2 == 0:
            pb.add_box_collider(body, (0.45, 0.45, 0.45), friction=0.7)
        else:
            pb.add_sphere_collider(body, 0.45, friction=0.7)
    arch, pstate = pb.finalize()
    settings = PhysicsSettings()
    step_ev = jax.jit(lambda s, pa: physics_step(
        arch, s, settings, 1 / 60, num_substeps=2, collect_events=True,
        prev_active=pa))
    prev_active = jnp.zeros((arch.vs_terrain_collider.shape[0]
                             + arch.vs_plane_collider.shape[0]
                             + sum(b.body_a.shape[0]
                                   for b in arch.contact_buckets),), bool)
    impacts = []
    for f in range(frames):
        pstate, contacts, ev = step_ev(pstate, prev_active)
        prev_active = ev.active
        begin = np.asarray(ev.begin)
        if begin.any():
            speeds = np.asarray(ev.approach_speed)[begin]
            pts = np.asarray(contacts.point[:, 0])[begin]
            for p, s in zip(pts, speeds):
                if s > 0.8:
                    impacts.append((f / 60.0, tuple(map(float, p)), float(s)))
    return impacts


def test_showcase_world_audio_matches_jax(tmp_path, monkeypatch):
    from d3d12renderer_tpu.terrain.heightmap import generate_heightmap

    from d3d12renderer_tpu_torch import entry
    from d3d12renderer_tpu_torch.models import scenes
    from d3d12renderer_tpu_torch.models import world as tworld

    torch.set_num_threads(2)
    heights = np.asarray(generate_heightmap(
        resolution=17, world_size=48.0, amplitude=5.0, noise_scale=0.06,
        seed=7), np.float32)
    cell = 48.0 / 16
    drop = scenes.add_terrain_drop

    def lowered(b, h, cell_size=scenes.TERRAIN_DROP_CELL):
        out = drop(b, h, cell_size)
        for i, body in enumerate(out["bodies"]):
            b.bodies[body].pos[1] -= np.float32(3.0 + 0.5 * i
                                                - DROP_CLEARANCE)
        return out

    monkeypatch.setattr(scenes, "add_terrain_drop", lowered)
    cfg = dataclasses.replace(
        tworld.WorldConfig(), resolution=17, grass_per_side=4,
        physics_frames=DROP_FRAMES, atlas_size=64, sun_resolution=16,
        spot_resolution=16, point_resolution=16, probe_updates=1,
        probe_rays=4, envmap_face=8, fire_steps=1)
    wav = tmp_path / "port.wav"
    fn, _ = entry.showcase_world_entry(device="cpu", width=32, height=24,
                                       config=cfg, heights=heights,
                                       envmap=None, audio=str(wav))
    got = fn.audio["impacts"]
    want = _jax_showcase_impacts(heights, cell, DROP_FRAMES)
    assert len(got) == len(want) >= 4
    for (tg, pg, sg), (tw, pw, sw) in zip(got, want):
        assert tg == tw
        np.testing.assert_allclose(pg, pw, rtol=0, atol=IMPACT_TOL)
        assert abs(sg - sw) <= IMPACT_TOL
    # examples/showcase.py:151-169 on JAX's impacts.
    eng = jaudio.AudioEngine()
    eng.set_listener((0.0, 7.5, -16.0), forward=(0, -0.25, 1))
    eng.set_reverb("mountains")
    t_prev = 0.0
    for i, (t, p, s) in enumerate(want):
        eng.advance(t - t_prev)
        t_prev = t
        eng.play_synth(jaudio.impact_synth(s, seed=i), "sfx",
                       volume=min(1.0, 0.25 + s / 10.0), position=p)
    dur = DROP_FRAMES / 60.0 + 0.5
    assert fn.audio["seconds"] == dur
    jmix.write_wav(str(tmp_path / "jax.wav"), jmix.mixdown(eng, dur))
    (a, ra), (b, rb) = _read(wav), _read(tmp_path / "jax.wav")
    assert ra == rb == 44100 and a.shape == b.shape == (
        int(round(dur * 44100)), 2)
    assert np.abs(a).max() > 0 and np.abs(a - b).max() <= AUDIO_TOL + \
        1 / 32767.0
    # A new engine streams the same timeline (the entry's engine rendered
    # once and its synths' generators moved on).
    tstream.stream_to_wav(tworld.impact_engine(got), dur,
                          str(tmp_path / "streamed.wav"))
    c, _ = _read(tmp_path / "streamed.wav")
    assert np.abs(c - a).max() <= AUDIO_TOL
