"""Prep stage 0 (offline alternative): synthesize a self-contained corpus.

``python3 -m music2midi_tpu_torch.data.synthesize_corpus DATA_DIR
[--songs 20 --duration 40 --seed 0 --profile clean|hard|piano|fullmix]``:
the port of the repository's ``data/synthesize_corpus.py``, writing the
same bytes for the same arguments (``--config`` takes a YAML or JSON
config, as every CLI of the port does).

The reference's data source is YouTube piano covers (reference
data/download_youtube.py) — unusable in an offline environment and
unusable in CI.  This stage generates a fully synthetic but *musically
structured* corpus in the exact layout stage 1 expects (reference
dataset.md:1-22): for each song

    audio/{id}.wav      the "cover recording": the composition rendered at
                        22050 Hz through the additive synth, under a random
                        piecewise tempo warp (+-5%) and optional noise —
                        so align_audio_midi has real work to do
    midi/{id}.mid       the unaligned 2-track score (melody + accompaniment,
                        passing generate_split's 2-track filter)
    metadata/{id}.yaml  {piano: {id, genre, difficulty}} as the downloader
                        writes (reference data/download_youtube.py:69)

Compositions are seeded and tonal (diatonic progression, chord-tone melody,
root-fifth bass) so that melody chroma accuracy on a model trained on this
corpus is a meaningful signal rather than noise.

After this stage, run the chain (each ``python3 -m
music2midi_tpu_torch.<module>``):

    data.align_audio_midi DATA_DIR
    data.midi_to_numpy    DATA_DIR
    data.compute_metrics  DATA_DIR
    data.generate_split   DATA_DIR
    train DATA_DIR ...
    evaluate DATA_DIR --ckpt ...
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..audio import write_wav
from ..config import resolve_config
from ..midi import Instrument, MidiFile, Note
from .metadata import dump_metadata

MAJOR = np.array([0, 2, 4, 5, 7, 9, 11])
# diatonic triads on scale degrees used by the progression pool
PROGRESSIONS = [
    [0, 4, 5, 3],   # I  V  vi IV
    [0, 3, 4, 4],   # I  IV V  V
    [5, 3, 0, 4],   # vi IV I  V
    [0, 5, 3, 4],   # I  vi IV V
]


def _triad(root_degree: int, key_root: int, octave: int) -> list:
    """Pitches of the diatonic triad on `root_degree` of the major key."""
    out = []
    for step in (0, 2, 4):
        d = root_degree + step
        out.append(key_root + 12 * (octave + d // 7) + int(MAJOR[d % 7]))
    return out


def compose_song(seed: int, duration: float) -> MidiFile:
    """One seeded 2-track composition: melody (chord tones + passing notes,
    2-4 notes/s) over block-chord accompaniment with a root-fifth bass."""
    rng = np.random.default_rng(seed)
    key_root = int(rng.integers(0, 12))
    prog = PROGRESSIONS[int(rng.integers(len(PROGRESSIONS)))]
    bar = float(rng.choice([1.6, 2.0, 2.4]))  # 100-150 bpm, 4/4
    n_bars = int(np.ceil(duration / bar))

    melody = Instrument(program=0, name="melody")
    accomp = Instrument(program=0, name="accompaniment")

    for b in range(n_bars):
        t0 = b * bar
        degree = prog[b % len(prog)]
        chord = _triad(degree, key_root, octave=5)
        # accompaniment: block chord each half bar + root-fifth bass
        for half in (0.0, 0.5):
            s = t0 + half * bar
            for p in _triad(degree, key_root, octave=4):
                accomp.notes.append(
                    Note(start=s, end=s + 0.45 * bar, pitch=p,
                         velocity=int(rng.integers(55, 75)))
                )
        bass_root = key_root + 36 + int(MAJOR[degree % 7])
        accomp.notes.append(Note(start=t0, end=t0 + 0.5 * bar,
                                 pitch=bass_root,
                                 velocity=int(rng.integers(70, 90))))
        accomp.notes.append(Note(start=t0 + 0.5 * bar, end=t0 + bar,
                                 pitch=bass_root + 7,
                                 velocity=int(rng.integers(60, 80))))
        # melody: one note per beat-ish slot, chord tone or diatonic
        # neighbour, held 60-95% of the slot
        slots = int(rng.integers(2, 5))
        for k in range(slots):
            s = t0 + k * bar / slots
            if rng.random() < 0.7:
                p = int(rng.choice(chord))
            else:
                p = key_root + 60 + int(MAJOR[int(rng.integers(7))])
            melody.notes.append(
                Note(start=s, end=s + bar / slots * rng.uniform(0.6, 0.95),
                     pitch=p + 12, velocity=int(rng.integers(75, 105)))
            )

    midi = MidiFile()
    midi.instruments = [melody, accomp]
    midi.bar_duration = bar  # consumed by render_hard's drum stem
    return midi


def shape_velocities(midi: MidiFile, seed: int) -> MidiFile:
    """Phrase-level dynamics: a slow crescendo/decrescendo envelope plus
    per-note jitter, applied to the PERFORMANCE only (velocity never
    reaches the token targets — the tokenizer writes default_velocity —
    so this hardens the audio without touching labels)."""
    rng = np.random.default_rng(seed ^ 0xD1CE)
    end = max(midi.get_end_time(), 1.0)
    period = rng.uniform(6.0, 14.0)
    phase = rng.uniform(0, 2 * np.pi)
    depth = rng.uniform(0.25, 0.45)
    for inst in midi.instruments:
        for n in inst.notes:
            env = 1.0 - depth * 0.5 * (
                1 + np.sin(2 * np.pi * n.start / period + phase)
            )
            jit = rng.uniform(0.85, 1.15)
            n.velocity = int(np.clip(n.velocity * env * jit, 20, 127))
    return midi


def _pink_noise(rng: np.random.Generator, n: int) -> np.ndarray:
    """Approximate 1/f noise: sum of white noise at octave decimations
    (Voss-McCartney-style), normalized to unit RMS."""
    out = np.zeros(n, np.float32)
    for oct_ in range(6):
        step = 2 ** oct_
        m = (n + step - 1) // step
        out += np.repeat(rng.normal(0, 1, m).astype(np.float32), step)[:n]
    return out / max(np.sqrt(float(np.mean(out**2))), 1e-9)


def _reverb(y: np.ndarray, sr: int, rng: np.random.Generator) -> np.ndarray:
    """Small-room reverb: exponentially decaying noise IR (RT60 0.3-0.8 s),
    FFT convolution, mixed ~20-35% wet."""
    rt60 = rng.uniform(0.3, 0.8)
    n_ir = int(rt60 * sr)
    t = np.arange(n_ir) / sr
    ir = rng.normal(0, 1, n_ir).astype(np.float32) * np.exp(
        -6.91 * t / rt60
    ).astype(np.float32)
    ir[0] = 0.0
    ir /= max(np.sqrt(float(np.sum(ir**2))), 1e-9)
    n_fft = 1 << int(np.ceil(np.log2(len(y) + n_ir)))
    wet = np.fft.irfft(
        np.fft.rfft(y, n_fft) * np.fft.rfft(ir, n_fft), n_fft
    )[: len(y)].astype(np.float32)
    mix = rng.uniform(0.2, 0.35)
    return (1 - mix) * y + mix * wet


def _vocal_stem(
    midi: MidiFile, sr: int, rng: np.random.Generator
) -> np.ndarray:
    """A vocal-like lead doubling the melody: sawtooth source with
    vibrato, shaped by two formant resonances (band-passed via FFT
    weighting) — the 'original song bleeding through the cover' stem."""
    n = int((midi.get_end_time() + 1.0) * sr)
    y = np.zeros(n, np.float32)
    melody = midi.instruments[0]
    f1, f2 = rng.uniform(550, 850), rng.uniform(1100, 1700)
    for note in melody.notes:
        i0, i1 = int(note.start * sr), min(int(note.end * sr), n)
        if i1 <= i0:
            continue
        t = np.arange(i1 - i0) / sr
        f0 = 440.0 * 2 ** ((note.pitch - 69) / 12)
        vib = 1.0 + 0.01 * np.sin(2 * np.pi * rng.uniform(4.5, 6.5) * t)
        phase = np.cumsum(f0 * vib) / sr
        saw = 2 * (phase % 1.0) - 1.0  # harmonic-rich source
        env = np.minimum(1.0, t / 0.04) * np.minimum(
            1.0, (t[-1] - t + 1e-3) / 0.08
        )
        y[i0:i1] += (saw * env).astype(np.float32) * (note.velocity / 127.0)
    # formant shaping in the frequency domain
    n_fft = 1 << int(np.ceil(np.log2(max(len(y), 2))))
    freqs = np.fft.rfftfreq(n_fft, 1 / sr)
    shape = (
        np.exp(-0.5 * ((freqs - f1) / 120.0) ** 2)
        + 0.7 * np.exp(-0.5 * ((freqs - f2) / 180.0) ** 2)
        + 0.1 * np.exp(-freqs / 300.0)  # glottal low end
    )
    y = np.fft.irfft(np.fft.rfft(y, n_fft) * shape, n_fft)[: len(y)]
    return y.astype(np.float32)


def _drum_stem(
    duration: float, bar: float, sr: int, rng: np.random.Generator
) -> np.ndarray:
    """Percussive transients NOT in the score: kick (decaying 55-70 Hz
    sine) on beats 1/3, snare-ish noise burst on 2/4, closed-hat ticks
    on eighths."""
    n = int((duration + 1.0) * sr)
    y = np.zeros(n, np.float32)
    beat = bar / 4.0

    def hit(t0, sig):  # hit length is len(sig)
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
        b = k % 4
        if b in (0, 2):
            hit(t0, kick * rng.uniform(0.8, 1.0))
        else:
            hit(t0, snare * rng.uniform(0.5, 0.8))
        hit(t0 + beat / 2, hat)
        hit(t0, hat)
        k += 1
        t0 += beat
    peak = float(np.abs(y).max())
    return y / peak if peak > 0 else y


def render_hard(
    performed: MidiFile,
    bar: float,
    sr: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Mix-realism rendering (a harder case than clean tones): piano + vocal-like lead doubling the melody + a drum
    stem that is NOT in the score, through a room reverb, over a pink
    noise floor.  Only the piano's notes are in the label MIDI — the
    rest is interference the model must see through, approximating the
    real-mix conditions the reference trains on
    (reference music2midi/dataset.py:124-133)."""
    piano = performed.synthesize(fs=sr).astype(np.float32)
    peak = float(np.abs(piano).max())
    if peak > 0:
        piano /= peak
    dur = performed.get_end_time()
    vocal = _vocal_stem(performed, sr, rng)
    vpeak = float(np.abs(vocal).max())
    if vpeak > 0:
        vocal /= vpeak
    drums = _drum_stem(dur, bar, sr, rng)
    n = len(piano)

    def fit(x):
        return np.pad(x, (0, max(0, n - len(x))))[:n]

    mix = (
        piano
        + rng.uniform(0.25, 0.5) * fit(vocal)
        + rng.uniform(0.15, 0.35) * fit(drums)
    )
    mix = _reverb(mix, sr, rng)
    mix = mix + rng.uniform(0.005, 0.02) * _pink_noise(rng, n)
    return np.tanh(mix * 1.2).astype(np.float32)  # gentle bus saturation


def _bass_stem(
    performed: MidiFile, sr: int, rng: np.random.Generator
) -> np.ndarray:
    """A produced synth-bass line an octave below the score's bass notes,
    re-grooved to eighth notes: harmonically consistent with the labels
    (same roots) but rhythmically and timbrally OFF-score — the
    'bass louder than the piano' element of a real mix (the house-loop
    probe's dominant energy).  Sine sub + soft-clipped saw layer."""
    end = performed.get_end_time()
    n = int((end + 1.0) * sr)
    y = np.zeros(n, np.float32)
    accomp = performed.instruments[-1]
    bass_notes = [m for m in accomp.notes if m.pitch < 52]
    step = 0.25  # eighth notes at ~120 bpm; fixed groove is fine
    for m in bass_notes:
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


def _pad_stem(
    performed: MidiFile, sr: int, rng: np.random.Generator
) -> np.ndarray:
    """Sustained detuned-saw chord pad (low-passed) under the mix: the
    'chords' element of a produced track.  Follows the score's block
    chords (pitches 52..70 of the accompaniment) but legato-sustained,
    so its note boundaries do not match any label onset."""
    end = performed.get_end_time()
    n = int((end + 1.0) * sr)
    y = np.zeros(n, np.float64)
    accomp = performed.instruments[-1]
    chord_notes = [m for m in accomp.notes if m.pitch >= 52]
    nyq = 0.45 * sr
    for m in chord_notes:
        f0 = 440.0 * 2.0 ** ((m.pitch - 12 - 69) / 12.0)
        dur = (m.end - m.start) * 1.6  # legato overlap past the block chord
        t = np.arange(int(dur * sr)) / sr
        sig = np.zeros(len(t))
        for det in (-1.0, 1.0):
            f = f0 * (1.0 + det * rng.uniform(2e-3, 5e-3))
            # band-limited-ish saw: first 6 harmonics, 1/k rolloff (the
            # low-pass), keeps it pad-like instead of buzzy
            for k in range(1, 7):
                if k * f >= nyq:
                    break
                sig += np.sin(2 * np.pi * k * f * t
                              + rng.uniform(0, 2 * np.pi)) / k
        env = np.minimum(1.0, t / 0.25) * np.minimum(
            1.0, (t[-1] - t + 1e-3) / 0.4
        )
        i0 = int(m.start * sr)
        i1 = min(i0 + len(t), n)
        if i0 < n:
            y[i0:i1] += (sig * env)[: i1 - i0]
    peak = float(np.abs(y).max())
    return (y / peak if peak > 0 else y).astype(np.float32)


def _bus_compress(
    y: np.ndarray, sr: int, thresh_db: float = -18.0, ratio: float = 4.0,
    attack_s: float = 0.005, release_s: float = 0.12,
) -> np.ndarray:
    """Frame-based mix-bus compressor: RMS envelope on 256-sample hops,
    one-pole attack/release smoothing over FRAMES (a few thousand — the
    Python loop is cheap), gain upsampled by linear interp.  Produces the
    pumping loudness profile of produced music, which the clean corpora
    never exhibit and real uploads almost always do."""
    hop = 256
    n_frames = max(1, int(np.ceil(len(y) / hop)))
    pad = np.pad(y, (0, n_frames * hop - len(y)))
    rms = np.sqrt(np.mean(pad.reshape(n_frames, hop) ** 2, axis=1) + 1e-12)
    lvl_db = 20.0 * np.log10(rms)
    over = np.maximum(0.0, lvl_db - thresh_db)
    want_gr = over * (1.0 - 1.0 / ratio)  # desired gain reduction, dB
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
    # ~6 dB makeup so the compressed mix sits hot, like a mastered track
    return (y * gain_full * 2.0).astype(np.float32)


def render_fullmix(
    performed: MidiFile,
    bar: float,
    sr: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Produced-track rendering (the real-recording transfer gap).  The hard profile buried the piano under a vocal lead
    and drums; the tracked real-loop probe (pygame house_lo.wav —
    bass/drums/chords with NO dominant melody instrument) fails
    differently: the model has never seen a mix where harmonically
    related bass+pad interference carries most of the energy under
    bus compression.  This profile renders exactly that: piano (labels)
    + sub-octave synth bass re-grooved to eighths + sustained detuned
    pad + dense drums, reverb, pink-noise floor, then frame-based
    mix-bus compression.  Labels untouched — only the piano's notes are
    in the label MIDI path (cf. reference music2midi/dataset.py:124-133,
    real-mix training conditions)."""
    piano = performed.synthesize(fs=sr).astype(np.float32)
    peak = float(np.abs(piano).max())
    if peak > 0:
        piano /= peak
    dur = performed.get_end_time()
    bass = _bass_stem(performed, sr, rng)
    pad_ = _pad_stem(performed, sr, rng)
    drums = _drum_stem(dur, bar, sr, rng)
    vocal = _vocal_stem(performed, sr, rng)
    vpeak = float(np.abs(vocal).max())
    if vpeak > 0:
        vocal /= vpeak
    n = len(piano)

    def fit(x):
        return np.pad(x, (0, max(0, n - len(x))))[:n]

    mix = (
        rng.uniform(0.55, 0.85) * piano        # piano NOT dominant
        + rng.uniform(0.45, 0.8) * fit(bass)   # bass carries the low end
        + rng.uniform(0.25, 0.5) * fit(pad_)
        + rng.uniform(0.3, 0.55) * fit(drums)
        + rng.uniform(0.0, 0.3) * fit(vocal)   # sometimes a lead double
    )
    mix = _reverb(mix, sr, rng)
    mix = mix + rng.uniform(0.005, 0.02) * _pink_noise(rng, n)
    mix = _bus_compress(mix, sr)
    return np.tanh(mix).astype(np.float32)  # brick-wall-ish bus limiter


def render_piano(
    midi: MidiFile, sr: int, rng: np.random.Generator
) -> np.ndarray:
    """Realistic-piano rendering (the timbre-generalization probe).

    The corpora train on the additive synth — three exact harmonics
    under a flat envelope (midi.py `synthesize`).  A real piano differs
    in exactly the dimensions this voice adds: inharmonically stretched
    partials (``f_k = k f0 sqrt(1 + B k^2)``, stiff-string dispersion,
    B rising bass->treble), velocity-dependent spectral brightness,
    per-partial exponential decay (treble notes and high partials die
    faster), two-string detuning beats, a hammer-noise transient, and a
    damper release tail.  Note TIMING is untouched — labels derived
    from a clean render of the same performance stay exactly valid
    (tools/make_timbre_eval.py depends on this).
    """
    end = midi.get_end_time()
    if end <= 0:
        return np.zeros(1, dtype=np.float32)
    tail = 0.25  # strings ring past key release until the damper kills them
    n = int(np.ceil((end + tail) * sr)) + 1
    out = np.zeros(n, np.float64)
    nyq = 0.45 * sr
    for inst in midi.instruments:
        if inst.is_drum:
            continue
        for note in inst.notes:
            f0 = 440.0 * 2.0 ** ((note.pitch - 69) / 12.0)
            held = note.end - note.start
            m = int(min(held + tail, 8.0) * sr)
            if f0 >= nyq or m <= 0:
                continue
            t = np.arange(m) / sr
            vel = note.velocity / 127.0
            # stiff-string inharmonicity, ~2 decades across the keyboard
            B = 2e-4 * 2.0 ** ((note.pitch - 60) / 15.0)
            k = np.arange(1, int(min(16, nyq // f0)) + 1, dtype=np.float64)
            fk = k * f0 * np.sqrt(1.0 + B * k * k)
            keep = fk < nyq
            k, fk = k[keep], fk[keep]
            if len(k) == 0:
                continue
            amp = k ** -(2.8 - 1.4 * vel)  # louder = brighter rolloff
            # bass rings for seconds, treble for fractions; partial k
            # decays ~(1 + 0.55 (k-1)) times faster than the fundamental
            tau0 = float(np.clip(4.5 * (261.6 / f0) ** 0.7, 0.18, 9.0))
            tau_k = tau0 / (1.0 + 0.55 * (k - 1.0))
            phase = rng.uniform(0.0, 2.0 * np.pi, len(k))
            # a second, slightly detuned string per note -> slow
            # amplitude beats (sin a + sin b = 2 sin(mid) cos(half-diff))
            df = fk * rng.normal(8e-4, 3e-4)
            sig = (
                amp[:, None]
                * np.exp(-t[None, :] / tau_k[:, None])
                * np.sin(
                    2 * np.pi * fk[:, None] * t[None, :] + phase[:, None]
                )
                * np.cos(np.pi * df[:, None] * t[None, :])
            ).sum(axis=0)
            sig *= np.minimum(1.0, t / 0.004)  # hammer attack ramp
            nh = min(int(0.012 * sr), m - 1)
            if nh > 1:  # high-passed (diff'd) hammer noise thump
                burst = np.diff(rng.normal(0.0, 1.0, nh + 1))
                sig[:nh] += (
                    0.25 * vel * burst
                    * np.exp(-np.arange(nh) / (0.004 * sr))
                )
            # damper: fast extra decay once the key is released
            sig *= np.exp(-np.maximum(0.0, t - held) / 0.045)
            i0 = int(note.start * sr)
            i1 = min(i0 + m, n)
            out[i0:i1] += (vel ** 1.3) * sig[: i1 - i0]
    peak = float(np.abs(out).max())
    return (out / peak if peak > 0 else out).astype(np.float32)


def warp_notes(midi: MidiFile, seed: int, max_dev: float = 0.05) -> MidiFile:
    """Piecewise-linear tempo warp: a smooth random time map with local
    rate in [1-max_dev, 1+max_dev] — the 'human performance' the aligner
    must recover (cf. the real covers the reference aligns,
    reference data/align_audio_midi.py:251-310)."""
    rng = np.random.default_rng(seed ^ 0x5EED)
    end = midi.get_end_time() + 1.0
    knots_t = np.linspace(0.0, end, max(3, int(end / 8.0) + 2))
    rates = rng.uniform(1.0 - max_dev, 1.0 + max_dev, len(knots_t) - 1)
    knots_w = np.concatenate([[0.0], np.cumsum(np.diff(knots_t) * rates)])

    def warp(t):
        return np.interp(t, knots_t, knots_w)

    out = MidiFile()
    for inst in midi.instruments:
        w = Instrument(program=inst.program, is_drum=inst.is_drum,
                       name=inst.name)
        for n in inst.notes:
            s, e = float(warp(n.start)), float(warp(n.end))
            if e > s:
                w.notes.append(Note(start=s, end=e, pitch=n.pitch,
                                    velocity=n.velocity))
        out.instruments.append(w)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data_dir", type=str)
    parser.add_argument("--songs", type=int, default=20)
    parser.add_argument("--duration", type=float, default=40.0,
                        help="approx seconds per song")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--config", type=str, default=None,
                        help="config file, YAML or JSON (default: the "
                             "repository's config.yaml)")
    parser.add_argument("--noise", type=float, default=0.003,
                        help="additive noise RMS in the rendered audio "
                             "(clean profile)")
    parser.add_argument("--sample_rate", type=int, default=22050)
    parser.add_argument(
        "--profile", choices=["clean", "hard", "piano", "fullmix"],
        default="clean",
        help="clean = additive synth + light noise (the r3 corpora); "
             "hard = mix realism: vocal-like formant "
             "lead doubling the melody, off-score drum transients, room "
             "reverb, pink-noise floor, phrase dynamics, and a stronger "
             "(+-12%%) tempo warp; piano = realistic solo-piano voice "
             "(inharmonic partials, velocity brightness, per-partial "
             "decay, hammer noise) with phrase dynamics and the clean "
             "warp — the timbre-generalization profile; fullmix = "
             "produced-track conditions: piano buried "
             "under sub-bass + chord pad + dense drums with mix-bus "
             "compression — the real-recording transfer profile",
    )
    args = parser.parse_args(argv)

    cfg = resolve_config(args.config)
    genres = list(cfg.conditioning.genre)
    difficulties = list(cfg.conditioning.difficulty)

    data_dir = Path(args.data_dir)
    for sub in ("audio", "midi", "metadata"):
        (data_dir / sub).mkdir(parents=True, exist_ok=True)

    for i in range(args.songs):
        pid = f"synth{i:03d}"
        wav_path = data_dir / "audio" / f"{pid}.wav"
        if wav_path.exists():  # skip-if-exists, like every prep stage
            print(f"{pid}: exists, skipped")
            continue
        # per-song rng (noise, genre, difficulty): a shared stream would
        # advance differently when songs are skipped, so a resumed run
        # would label/noise song i differently than a fresh run
        rng = np.random.default_rng([args.seed, i])
        song_seed = args.seed * 1000 + i
        score = compose_song(song_seed, args.duration)
        score.write(data_dir / "midi" / f"{pid}.mid")
        max_dev = 0.12 if args.profile in ("hard", "fullmix") else 0.05
        performed = warp_notes(score, song_seed, max_dev=max_dev)
        if args.profile == "hard":
            performed = shape_velocities(performed, song_seed)
            y = render_hard(
                performed, score.bar_duration, args.sample_rate, rng
            )
        elif args.profile == "fullmix":
            performed = shape_velocities(performed, song_seed)
            y = render_fullmix(
                performed, score.bar_duration, args.sample_rate, rng
            )
        elif args.profile == "piano":
            performed = shape_velocities(performed, song_seed)
            y = render_piano(performed, args.sample_rate, rng)
            if args.noise > 0:
                y = y + rng.normal(
                    0.0, args.noise, len(y)).astype(np.float32)
        else:
            y = performed.synthesize(fs=args.sample_rate).astype(np.float32)
            if args.noise > 0:
                y = y + rng.normal(
                    0.0, args.noise, len(y)).astype(np.float32)
        peak = float(np.abs(y).max())
        if peak > 0:
            y *= 0.8 / peak
        write_wav(wav_path, y, args.sample_rate)
        (data_dir / "metadata" / f"{pid}.yaml").write_text(dump_metadata(
            {"piano": {
                "id": pid,
                "genre": genres[int(rng.integers(len(genres)))],
                "difficulty": difficulties[
                    int(rng.integers(len(difficulties)))],
            }}))
        print(f"{pid}: {len(score.instruments[0].notes)} melody notes, "
              f"{score.get_end_time():.1f}s")
    print(f"synthesized {args.songs} songs -> {data_dir}")


if __name__ == "__main__":
    main()
