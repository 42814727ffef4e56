"""Seeded pop-song audio: a tonal two-track composition rendered as a
produced mix.

A frozen copy of the repository's synthetic corpus generator
(``music2midi_tpu_torch/data/synthesize_corpus.py``: ``compose_song``,
``warp_notes``, ``shape_velocities``, ``render_fullmix`` and its stems;
``music2midi_tpu_torch/midi.py``: the additive ``synthesize``), over plain
note lists instead of the port's MIDI classes, so that the benchmark's
inputs cannot move with the program.  ``fullmix`` is the corpus's
real-recording profile: the piano (the labels) under a sub-octave synth
bass, a detuned chord pad, drums and sometimes a vocal lead, through a
room reverb over a pink-noise floor and a mix-bus compressor.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np

MAJOR = np.array([0, 2, 4, 5, 7, 9, 11])
PROGRESSIONS = [[0, 4, 5, 3], [0, 3, 4, 4], [5, 3, 0, 4], [0, 5, 3, 4]]


class Note(NamedTuple):
    start: float
    end: float
    pitch: int
    velocity: int


class Score(NamedTuple):
    """Two tracks, melody then accompaniment, and the bar's length."""
    tracks: List[List[Note]]
    bar: float

    def end_time(self) -> float:
        return max((n.end for t in self.tracks for n in t), default=0.0)


def _triad(root_degree: int, key_root: int, octave: int) -> list:
    out = []
    for step in (0, 2, 4):
        d = root_degree + step
        out.append(key_root + 12 * (octave + d // 7) + int(MAJOR[d % 7]))
    return out


def compose_song(seed: int, duration: float,
                 bar: Optional[float] = None) -> Score:
    """Melody (chord tones and passing notes, 2-4 a bar) over block chords
    and a root-fifth bass, in a seeded major key and progression; the bar
    lasts ``bar`` seconds, or a seeded 1.6, 2.0 or 2.4 (the seed's draw is
    made either way, so the rest of the song is the same)."""
    rng = np.random.default_rng(seed)
    key_root = int(rng.integers(0, 12))
    prog = PROGRESSIONS[int(rng.integers(len(PROGRESSIONS)))]
    drawn = float(rng.choice([1.6, 2.0, 2.4]))
    bar = drawn if bar is None else float(bar)
    n_bars = int(np.ceil(duration / bar))
    melody: List[Note] = []
    accomp: List[Note] = []
    for b in range(n_bars):
        t0 = b * bar
        degree = prog[b % len(prog)]
        chord = _triad(degree, key_root, octave=5)
        for half in (0.0, 0.5):
            s = t0 + half * bar
            for p in _triad(degree, key_root, octave=4):
                accomp.append(Note(s, s + 0.45 * bar, p,
                                   int(rng.integers(55, 75))))
        bass_root = key_root + 36 + int(MAJOR[degree % 7])
        accomp.append(Note(t0, t0 + 0.5 * bar, bass_root,
                           int(rng.integers(70, 90))))
        accomp.append(Note(t0 + 0.5 * bar, t0 + bar, bass_root + 7,
                           int(rng.integers(60, 80))))
        slots = int(rng.integers(2, 5))
        for k in range(slots):
            s = t0 + k * bar / slots
            if rng.random() < 0.7:
                p = int(rng.choice(chord))
            else:
                p = key_root + 60 + int(MAJOR[int(rng.integers(7))])
            melody.append(Note(s, s + bar / slots * rng.uniform(0.6, 0.95),
                               p + 12, int(rng.integers(75, 105))))
    return Score([melody, accomp], bar)


def warp_notes(score: Score, seed: int, max_dev: float = 0.05) -> Score:
    """Piecewise-linear tempo warp with local rate in 1 +- max_dev."""
    rng = np.random.default_rng(seed ^ 0x5EED)
    end = score.end_time() + 1.0
    knots_t = np.linspace(0.0, end, max(3, int(end / 8.0) + 2))
    rates = rng.uniform(1.0 - max_dev, 1.0 + max_dev, len(knots_t) - 1)
    knots_w = np.concatenate([[0.0], np.cumsum(np.diff(knots_t) * rates)])
    tracks = []
    for track in score.tracks:
        out = []
        for n in track:
            s = float(np.interp(n.start, knots_t, knots_w))
            e = float(np.interp(n.end, knots_t, knots_w))
            if e > s:
                out.append(Note(s, e, n.pitch, n.velocity))
        tracks.append(out)
    return Score(tracks, score.bar)


def shape_velocities(score: Score, seed: int) -> Score:
    """Phrase dynamics: a slow swell plus per-note jitter (performance
    only; labels carry no velocity)."""
    rng = np.random.default_rng(seed ^ 0xD1CE)
    period = rng.uniform(6.0, 14.0)
    phase = rng.uniform(0, 2 * np.pi)
    depth = rng.uniform(0.25, 0.45)
    tracks = []
    for track in score.tracks:
        out = []
        for n in track:
            env = 1.0 - depth * 0.5 * (
                1 + np.sin(2 * np.pi * n.start / period + phase))
            jit = rng.uniform(0.85, 1.15)
            out.append(n._replace(
                velocity=int(np.clip(n.velocity * env * jit, 20, 127))))
        tracks.append(out)
    return Score(tracks, score.bar)


def synthesize(score: Score, fs: int) -> np.ndarray:
    """Additive rendering: a sine and two decaying harmonics a note, with
    a 5 ms attack and 20 ms fade, peak-normalised."""
    end = score.end_time()
    if end <= 0:
        return np.zeros(1, dtype=np.float32)
    out = np.zeros(int(np.ceil(end * fs)) + 1, dtype=np.float64)
    for track in score.tracks:
        for note in track:
            f0 = 440.0 * 2.0 ** ((note.pitch - 69) / 12.0)
            i0, i1 = int(note.start * fs), int(note.end * fs)
            if i1 <= i0:
                continue
            n = i1 - i0
            t = np.arange(n) / fs
            sig = np.zeros(n)
            for h in (1, 2, 3):
                if f0 * h < fs / 2:
                    sig += np.sin(2 * np.pi * f0 * h * t) / (h * h)
            env = np.minimum(1.0, np.arange(n) / max(1, int(0.005 * fs)))
            fade = np.minimum(1.0, (n - np.arange(n)) / max(1, int(0.02 * fs)))
            out[i0:i1] += sig * env * fade * (note.velocity / 127.0)
    peak = np.max(np.abs(out))
    if peak > 0:
        out = out / peak
    return out.astype(np.float32)


def _pink_noise(rng, n: int) -> np.ndarray:
    out = np.zeros(n, np.float32)
    for oct_ in range(6):
        step = 2 ** oct_
        m = (n + step - 1) // step
        out += np.repeat(rng.normal(0, 1, m).astype(np.float32), step)[:n]
    return out / max(np.sqrt(float(np.mean(out**2))), 1e-9)


def _reverb(y: np.ndarray, sr: int, rng) -> np.ndarray:
    rt60 = rng.uniform(0.3, 0.8)
    n_ir = int(rt60 * sr)
    t = np.arange(n_ir) / sr
    ir = rng.normal(0, 1, n_ir).astype(np.float32) * np.exp(
        -6.91 * t / rt60).astype(np.float32)
    ir[0] = 0.0
    ir /= max(np.sqrt(float(np.sum(ir**2))), 1e-9)
    n_fft = 1 << int(np.ceil(np.log2(len(y) + n_ir)))
    wet = np.fft.irfft(np.fft.rfft(y, n_fft) * np.fft.rfft(ir, n_fft),
                       n_fft)[: len(y)].astype(np.float32)
    mix = rng.uniform(0.2, 0.35)
    return (1 - mix) * y + mix * wet


def _vocal_stem(score: Score, sr: int, rng) -> np.ndarray:
    n = int((score.end_time() + 1.0) * sr)
    y = np.zeros(n, np.float32)
    f1, f2 = rng.uniform(550, 850), rng.uniform(1100, 1700)
    for note in score.tracks[0]:
        i0, i1 = int(note.start * sr), min(int(note.end * sr), n)
        if i1 <= i0:
            continue
        t = np.arange(i1 - i0) / sr
        f0 = 440.0 * 2 ** ((note.pitch - 69) / 12)
        vib = 1.0 + 0.01 * np.sin(2 * np.pi * rng.uniform(4.5, 6.5) * t)
        phase = np.cumsum(f0 * vib) / sr
        saw = 2 * (phase % 1.0) - 1.0
        env = np.minimum(1.0, t / 0.04) * np.minimum(
            1.0, (t[-1] - t + 1e-3) / 0.08)
        y[i0:i1] += (saw * env).astype(np.float32) * (note.velocity / 127.0)
    n_fft = 1 << int(np.ceil(np.log2(max(len(y), 2))))
    freqs = np.fft.rfftfreq(n_fft, 1 / sr)
    shape = (np.exp(-0.5 * ((freqs - f1) / 120.0) ** 2)
             + 0.7 * np.exp(-0.5 * ((freqs - f2) / 180.0) ** 2)
             + 0.1 * np.exp(-freqs / 300.0))
    y = np.fft.irfft(np.fft.rfft(y, n_fft) * shape, n_fft)[: len(y)]
    return y.astype(np.float32)


def _drum_stem(duration: float, bar: float, sr: int, rng) -> np.ndarray:
    n = int((duration + 1.0) * sr)
    y = np.zeros(n, np.float32)
    beat = bar / 4.0

    def hit(t0, sig):
        i0 = int(t0 * sr)
        i1 = min(i0 + len(sig), n)
        if i0 < n:
            y[i0:i1] += sig[: i1 - i0]

    t_k = np.arange(int(0.12 * sr)) / sr
    f_k = rng.uniform(55, 70)
    kick = (np.sin(2 * np.pi * f_k * t_k * (1 - 2 * t_k))
            * np.exp(-t_k / 0.04)).astype(np.float32)
    t_s = np.arange(int(0.08 * sr)) / sr
    t_h = np.arange(int(0.03 * sr)) / sr
    k = 0
    t0 = 0.0
    while t0 < duration:
        snare = (rng.normal(0, 1, len(t_s))
                 * np.exp(-t_s / 0.02)).astype(np.float32)
        hat = (rng.normal(0, 1, len(t_h))
               * np.exp(-t_h / 0.008)).astype(np.float32) * 0.35
        if k % 4 in (0, 2):
            hit(t0, kick * rng.uniform(0.8, 1.0))
        else:
            hit(t0, snare * rng.uniform(0.5, 0.8))
        hit(t0 + beat / 2, hat)
        hit(t0, hat)
        k += 1
        t0 += beat
    peak = float(np.abs(y).max())
    return y / peak if peak > 0 else y


def _bass_stem(score: Score, sr: int, rng) -> np.ndarray:
    n = int((score.end_time() + 1.0) * sr)
    y = np.zeros(n, np.float32)
    step = 0.25
    for m in [m for m in score.tracks[-1] if m.pitch < 52]:
        f0 = 440.0 * 2.0 ** ((m.pitch - 12 - 69) / 12.0)
        t0 = m.start
        while t0 < m.end - 1e-3:
            dur = min(step * rng.uniform(0.7, 0.95), m.end - t0)
            t = np.arange(int(dur * sr)) / sr
            env = np.minimum(1.0, t / 0.005) * np.exp(-t / 0.35)
            saw = 2.0 * ((f0 * t) % 1.0) - 1.0
            sig = (np.sin(2 * np.pi * f0 * t)
                   + 0.35 * np.tanh(2.5 * saw)) * env
            i0 = int(t0 * sr)
            i1 = min(i0 + len(sig), n)
            if i0 < n:
                y[i0:i1] += sig[: i1 - i0].astype(np.float32)
            t0 += step
    peak = float(np.abs(y).max())
    return y / peak if peak > 0 else y


def _pad_stem(score: Score, sr: int, rng) -> np.ndarray:
    n = int((score.end_time() + 1.0) * sr)
    y = np.zeros(n, np.float64)
    nyq = 0.45 * sr
    for m in [m for m in score.tracks[-1] if m.pitch >= 52]:
        f0 = 440.0 * 2.0 ** ((m.pitch - 12 - 69) / 12.0)
        dur = (m.end - m.start) * 1.6
        t = np.arange(int(dur * sr)) / sr
        sig = np.zeros(len(t))
        for det in (-1.0, 1.0):
            f = f0 * (1.0 + det * rng.uniform(2e-3, 5e-3))
            for k in range(1, 7):
                if k * f >= nyq:
                    break
                sig += np.sin(2 * np.pi * k * f * t
                              + rng.uniform(0, 2 * np.pi)) / k
        env = np.minimum(1.0, t / 0.25) * np.minimum(
            1.0, (t[-1] - t + 1e-3) / 0.4)
        i0 = int(m.start * sr)
        i1 = min(i0 + len(t), n)
        if i0 < n:
            y[i0:i1] += (sig * env)[: i1 - i0]
    peak = float(np.abs(y).max())
    return (y / peak if peak > 0 else y).astype(np.float32)


def _bus_compress(y: np.ndarray, sr: int, thresh_db: float = -18.0,
                  ratio: float = 4.0, attack_s: float = 0.005,
                  release_s: float = 0.12) -> np.ndarray:
    hop = 256
    n_frames = max(1, int(np.ceil(len(y) / hop)))
    pad = np.pad(y, (0, n_frames * hop - len(y)))
    rms = np.sqrt(np.mean(pad.reshape(n_frames, hop) ** 2, axis=1) + 1e-12)
    over = np.maximum(0.0, 20.0 * np.log10(rms) - thresh_db)
    want_gr = over * (1.0 - 1.0 / ratio)
    a_att = float(np.exp(-hop / (attack_s * sr)))
    a_rel = float(np.exp(-hop / (release_s * sr)))
    gr = np.empty(n_frames)
    g = 0.0
    for i in range(n_frames):
        a = a_att if want_gr[i] > g else a_rel
        g = a * g + (1.0 - a) * want_gr[i]
        gr[i] = g
    gain = 10.0 ** (-gr / 20.0)
    t_frames = (np.arange(n_frames) + 0.5) * hop
    gain_full = np.interp(np.arange(len(y)), t_frames, gain)
    return (y * gain_full * 2.0).astype(np.float32)


def render_fullmix(performed: Score, sr: int, rng) -> np.ndarray:
    """The produced-track mix of ``performed`` (module doc)."""
    piano = synthesize(performed, sr)
    dur = performed.end_time()
    bass = _bass_stem(performed, sr, rng)
    pad_ = _pad_stem(performed, sr, rng)
    drums = _drum_stem(dur, performed.bar, sr, rng)
    vocal = _vocal_stem(performed, sr, rng)
    vpeak = float(np.abs(vocal).max())
    if vpeak > 0:
        vocal /= vpeak
    n = len(piano)

    def fit(x):
        return np.pad(x, (0, max(0, n - len(x))))[:n]

    mix = (rng.uniform(0.55, 0.85) * piano
           + rng.uniform(0.45, 0.8) * fit(bass)
           + rng.uniform(0.25, 0.5) * fit(pad_)
           + rng.uniform(0.3, 0.55) * fit(drums)
           + rng.uniform(0.0, 0.3) * fit(vocal))
    mix = _reverb(mix, sr, rng)
    mix = mix + rng.uniform(0.005, 0.02) * _pink_noise(rng, n)
    mix = _bus_compress(mix, sr)
    return np.tanh(mix).astype(np.float32)


def fullmix_song(entropy: Sequence[int], duration: float, sr: int,
                 bar: Optional[float] = None):
    """-> (waveform (S,) float32 on the 16-bit grid, peak 0.8, exactly
    ``duration`` seconds; notes (N, 4) of (onset_s, offset_s, pitch,
    velocity) as performed).  Every draw comes from ``entropy``."""
    song_seed = int(np.random.SeedSequence(list(entropy)).generate_state(1)[0])
    rng = np.random.default_rng(list(entropy) + [1])
    score = compose_song(song_seed, duration, bar)
    performed = shape_velocities(warp_notes(score, song_seed, 0.12),
                                 song_seed)
    y = render_fullmix(performed, sr, rng)
    n = int(round(duration * sr))
    y = np.pad(y, (0, max(0, n - len(y))))[:n]
    peak = float(np.abs(y).max())
    if peak > 0:
        y = y * (0.8 / peak)
    # a 16-bit recording: the values of an int16 WAV, as uploads arrive
    y = np.clip(np.round(y * 32768.0), -32768, 32767) / 32768.0
    notes = np.array([[n.start, n.end, n.pitch, n.velocity]
                      for t in performed.tracks for n in t], np.float64)
    return y.astype(np.float32), notes.reshape(-1, 4)
