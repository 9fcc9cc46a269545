"""Streaming audio: block-based voice mixing over unbounded timelines
(counterpart of ``d3d12renderer_tpu/audio/stream.py``: numpy on the host, no
device work, as in the JAX package).

Reference: the XAudio2 streaming path — source voices pull PCM chunks from
an async reader thread instead of preloading whole files
(src/audio/sound.cpp submitSourceBuffer loop), with a bounded pool of
per-type source voices managed by the channel layer (src/audio/channel.cpp).

`mixdown` (audio/mixdown.py) materializes every source and the full
timeline in memory — right for short offline renders, wrong for long
timelines.  `StreamingMixer` renders the same event log block by block:

- WAV sources are read in CHUNKS through the stdlib `wave` module (seek +
  readframes per block), resampled/pitched with a carried fractional
  position — memory stays O(block) no matter how long the file or the
  timeline.
- Per-type voice caps with steal-quietest (the reference's fixed source
  voice pools; channel.cpp:468 picks a free voice or drops).
- The master comb reverb carries its feedback ring across blocks, so the
  tail is seamless at block boundaries.

`stream_to_wav` writes PCM16 incrementally — a one-hour timeline peaks at
a few hundred KB of Python memory.
"""

from __future__ import annotations

import math
import os
import wave
from typing import Dict, List

import numpy as np

from .audio import AudioEngine
from .mixdown import _REVERB, _pan_gains, _placeholder_tone


class WavBlockReader:
    """Chunked mono source at the mix rate: float32 blocks on demand.

    Carries a float64 source-frame position so pitch/resample stays
    drift-free across block boundaries; looping wraps the position."""

    def __init__(self, path: str, sample_rate: int, pitch: float = 1.0,
                 looping: bool = False):
        self.sr = sample_rate
        self.looping = looping
        self._pos = 0.0
        self._eof = False
        try:
            self._w = wave.open(path, "rb")
            self._frames = self._w.getnframes()
            self._width = self._w.getsampwidth()
            self._ch = self._w.getnchannels()
            self._fsr = self._w.getframerate()
        except (FileNotFoundError, OSError, wave.Error):
            # Missing asset: the deterministic placeholder tone, also
            # served blockwise (it is short; loop if asked).
            self._w = None
            tone = _placeholder_tone(path, sample_rate, 1.5)
            self._tone = tone
            self._frames = len(tone)
            self._fsr = sample_rate
        self._step = float(pitch) * self._fsr / sample_rate

    def _fetch(self, f0: int, n: int) -> np.ndarray:
        """Raw source frames [f0, f0+n) as mono float32 (zero padded)."""
        if self._w is None:
            out = np.zeros(n, np.float32)
            m = max(0, min(n, self._frames - f0))
            if m > 0:
                out[:m] = self._tone[f0:f0 + m]
            return out
        f0 = max(0, f0)
        m = max(0, min(n, self._frames - f0))
        out = np.zeros(n, np.float32)
        if m > 0:
            self._w.setpos(f0)
            raw = self._w.readframes(m)
            if self._width == 2:
                x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
            elif self._width == 1:
                x = (np.frombuffer(raw, np.uint8).astype(np.float32)
                     - 128.0) / 128.0
            elif self._width == 4:
                x = np.frombuffer(raw, np.int32).astype(np.float32) \
                    / 2147483648.0
            else:
                x = np.zeros(m * self._ch, np.float32)
            out[:m] = x.reshape(-1, self._ch).mean(-1)
        return out

    def read(self, n: int) -> np.ndarray:
        """Next `n` mix-rate frames; zeros after a non-looping EOF."""
        if self._eof:
            return np.zeros(n, np.float32)
        # Source positions for the n output samples.
        pos = self._pos + np.arange(n, dtype=np.float64) * self._step
        if self.looping and self._frames > 0:
            pos = np.mod(pos, self._frames)
            self._pos = float(np.mod(self._pos + n * self._step,
                                     self._frames))
            i0 = pos.astype(np.int64)
            # A looped block can span the wrap point: fetch the whole file
            # range it touches in two chunks only when needed.
            frac = (pos - i0).astype(np.float32)
            lo, hi = int(i0.min()), int(i0.max()) + 2
            buf = self._fetch(lo, hi - lo)
            a = buf[i0 - lo]
            b = buf[np.minimum(i0 + 1, self._frames - 1) - lo]
            return a * (1.0 - frac) + b * frac
        i0 = pos.astype(np.int64)
        frac = (pos - i0).astype(np.float32)
        lo = int(i0[0])
        hi = int(i0[-1]) + 2
        if lo >= self._frames:
            self._eof = True
            return np.zeros(n, np.float32)
        buf = self._fetch(lo, hi - lo)
        a = buf[np.minimum(i0, hi - 1) - lo]
        b = buf[np.minimum(i0 + 1, hi - 1) - lo]
        self._pos += n * self._step
        if self._pos >= self._frames:
            self._eof = True
        return a * (1.0 - frac) + b * frac

    @property
    def done(self) -> bool:
        return self._eof

    def close(self):
        if self._w is not None:
            self._w.close()
            self._w = None


class _LiveVoice:
    __slots__ = ("vid", "reader", "synth", "synth_pos", "synth_sr", "pitch",
                 "volume", "gain", "gl", "gr", "stype", "stop_at", "updates",
                 "_start_frame")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class StreamingMixer:
    """Render an AudioEngine event log block by block.

    Same mixing model as mixdown() — voice gain = volume x submix x master
    x distance attenuation, constant-power 3D pan, preset comb reverb —
    evaluated incrementally.  Per-type voice caps use steal-quietest."""

    def __init__(self, engine: AudioEngine, sample_rate: int = 44100,
                 block_frames: int = 4096, max_voices_per_type: int = 16):
        self.engine = engine
        self.sr = sample_rate
        self.block = block_frames
        self.cap = max_voices_per_type
        self.frame = 0                       # absolute mix-rate frame
        self.stolen = 0                      # voices dropped by the cap
        self._live: List[_LiveVoice] = []
        ev = sorted(engine.events, key=lambda e: float(e.get("t", 0.0)))
        self._plays = [e for e in ev if e["event"] == "play"]
        self._stops = {e["id"]: float(e.get("t", 0.0)) for e in ev
                       if e["event"] == "stop"}
        self._updates: Dict[int, list] = {}
        for e in ev:
            if e["event"] == "update":
                self._updates.setdefault(e["id"], []).append(e)
        self._next_play = 0
        rv = _REVERB.get(engine.reverb)
        self._rv = rv
        if rv is not None:
            self._rv_k = max(1, int(rv[0] * sample_rate))
            self._rv_ring = np.zeros((self._rv_k, 2), np.float32)
            self._rv_at = 0

    # -- voice management ---------------------------------------------------

    def _start(self, e: dict, offset: int):
        eng = self.engine
        vid = e["id"]
        voice = eng._voices.get(vid)
        pitch = float(e.get("pitch", 1.0))
        stype = e.get("type", "sfx")
        gain = eng.submix_volumes.get(stype, 1.0) * eng.master_volume
        pos = e.get("position")
        if pos is not None:
            d = math.dist(pos, eng.listener_position)
            gain *= 1.0 / (1.0 + 0.25 * d * d)
        gl, gr = _pan_gains(pos, eng.listener_position, eng.listener_forward)
        if voice is not None and voice.synth is not None:
            lv = _LiveVoice(vid=vid, reader=None, synth=voice.synth,
                            synth_pos=0, synth_sr=getattr(
                                voice.synth, "sample_rate", self.sr),
                            pitch=pitch, volume=float(e.get("volume", 1.0)),
                            gain=gain, gl=gl, gr=gr, stype=stype,
                            stop_at=self._stops.get(vid),
                            updates=self._updates.get(vid, []))
        else:
            rd = WavBlockReader(e.get("path") or "", self.sr, pitch,
                                looping=bool(voice.looping)
                                if voice is not None else False)
            lv = _LiveVoice(vid=vid, reader=rd, synth=None, synth_pos=0,
                            synth_sr=self.sr, pitch=pitch,
                            volume=float(e.get("volume", 1.0)), gain=gain,
                            gl=gl, gr=gr, stype=stype,
                            stop_at=self._stops.get(vid),
                            updates=self._updates.get(vid, []))
        lv._start_frame = offset  # type: ignore[attr-defined]
        same = [v for v in self._live if v.stype == stype]
        if len(same) >= self.cap:
            # Steal the quietest voice of this type (channel.cpp's bounded
            # source-voice pool).
            quietest = min(same, key=lambda v: v.volume * v.gain)
            self._drop(quietest)
            self.stolen += 1
        self._live.append(lv)

    def _drop(self, lv: _LiveVoice):
        if lv.reader is not None:
            lv.reader.close()
        self._live.remove(lv)

    # -- rendering ----------------------------------------------------------

    def render_block(self) -> np.ndarray:
        """Advance one block -> (block, 2) float32 master output."""
        n = self.block
        sr = self.sr
        f0, f1 = self.frame, self.frame + n
        t0 = f0 / sr
        out = np.zeros((n, 2), np.float32)

        # Start voices whose stamp falls inside this block.
        while self._next_play < len(self._plays):
            e = self._plays[self._next_play]
            fp = int(float(e.get("t", 0.0)) * sr)
            if fp >= f1:
                break
            self._next_play += 1
            self._start(e, max(fp - f0, 0))

        for lv in list(self._live):
            off = getattr(lv, "_start_frame", 0)
            m = n - off
            if m <= 0:
                lv._start_frame = off - n  # type: ignore[attr-defined]
                continue
            if lv.synth is not None:
                tt = (lv.synth_pos + np.arange(m)) * (lv.pitch / lv.synth_sr)
                src = np.asarray(lv.synth(tt), np.float32)
                lv.synth_pos += m
                done = False
            else:
                src = lv.reader.read(m)
                done = lv.reader.done
            # Piecewise-constant volume automation from update events.
            vol = np.full(m, lv.volume, np.float32)
            for ue in lv.updates:
                if "volume" in ue:
                    k = int(float(ue.get("t", 0.0)) * sr) - (f0 + off)
                    if k < m:
                        vol[max(k, 0):] = float(ue["volume"])
                        if k <= 0:
                            lv.volume = float(ue["volume"])
            chunk = src * vol * lv.gain
            out[off:off + m, 0] += chunk * lv.gl
            out[off:off + m, 1] += chunk * lv.gr
            lv._start_frame = 0  # type: ignore[attr-defined]
            stop_f = (int(lv.stop_at * sr) if lv.stop_at is not None
                      else None)
            if done or (stop_f is not None and stop_f < f1):
                self._drop(lv)

        # Streaming comb reverb: y[i] = x[i] + fb * y[i - k], ring carried.
        if self._rv is not None:
            _, fb = self._rv
            k, ring, at = self._rv_k, self._rv_ring, self._rv_at
            for i in range(n):                 # k is small (~1-5k frames)
                y = out[i] + fb * ring[at]
                ring[at] = y
                out[i] = y
                at = (at + 1) % k
            self._rv_at = at
            out *= 1.0 / (1.0 + fb)

        self.frame = f1
        return out

    @property
    def active(self) -> int:
        return len(self._live)


def stream_to_wav(engine: AudioEngine, duration: float, path: str,
                  sample_rate: int = 44100, block_frames: int = 4096,
                  max_voices_per_type: int = 16) -> dict:
    """Stream the timeline straight into a PCM16 WAV, O(block) memory.

    Returns {"blocks", "peak", "stolen"} stats.  The soft limiter is a
    per-block tanh knee above |1.0| (a running mix cannot normalize by the
    global peak the way the offline mixdown does)."""
    mixer = StreamingMixer(engine, sample_rate, block_frames,
                           max_voices_per_type)
    n_total = int(round(duration * sample_rate))
    peak = 0.0
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    blocks = 0
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        done = 0
        while done < n_total:
            blk = mixer.render_block()[: n_total - done]
            peak = max(peak, float(np.abs(blk).max(initial=0.0)))
            over = np.abs(blk) > 1.0
            if over.any():
                blk = np.where(over, np.tanh(blk), blk)
            w.writeframes((np.clip(blk, -1.0, 1.0)
                           * 32767.0).astype(np.int16).tobytes())
            done += len(blk)
            blocks += 1
    return {"blocks": blocks, "peak": peak, "stolen": mixer.stolen}
