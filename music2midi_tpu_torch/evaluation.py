"""Melody chroma accuracy — the quality metric of record.

The port's own copy of ``music2midi_tpu/evaluation.py`` (numpy and the
port's ``midi`` only).

Behavior-equivalent reimplementation of the reference evaluation
(reference music2midi/evaluation.py:10-75), which chains librosa/mir_eval:
piano roll at fs=100 -> highest active pitch per frame -> Hz -> cents ->
mir_eval raw chroma accuracy.  mir_eval/librosa are not dependencies here;
the math is implemented directly with their documented semantics:

  * hz2cents: 1200 * log2(f / 10)                      (base_frequency=10)
  * voicing: frequency > 0
  * raw chroma accuracy: fraction of REF-VOICED frames whose chroma
    difference (|cent diff| folded to the nearest octave) is <= 50 cents

Deliberate deviation, documented per SURVEY.md §2: the reference's numba
kernel hits undefined behavior on frames with no active pitch (writes NaN
into an int array, then reads `onset_pitches[-1]` of an empty array —
evaluation.py:15-18).  Here an empty frame yields pitch 0 deterministically,
which is consistent between target and output and therefore counts silent
frames as agreement when both are silent.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

from .midi import MidiFile


def midi_to_hz(pitch: np.ndarray) -> np.ndarray:
    return 440.0 * 2.0 ** ((np.asarray(pitch, dtype=np.float64) - 69) / 12.0)


def hz_to_cents(freq: np.ndarray, base_frequency: float = 10.0) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    out = np.zeros_like(freq)
    voiced = freq > 0
    out[voiced] = 1200.0 * np.log2(freq[voiced] / base_frequency)
    return out


def get_highest_pitches_from_piano_roll(piano_roll: np.ndarray) -> np.ndarray:
    """Highest active pitch per frame; 0 for silent frames (see module
    docstring for the deliberate deviation from the reference's UB)."""
    active = piano_roll > 0
    any_active = active.any(axis=0)
    # argmax over reversed pitch axis finds the highest active pitch
    highest = piano_roll.shape[0] - 1 - np.argmax(active[::-1], axis=0)
    return np.where(any_active, highest, 0).astype(np.int64)


def extract_midi_melody(
    target: MidiFile, output: MidiFile, fs: int = 100
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame highest pitch for both files over the longer of the two
    (reference evaluation.py:23-44)."""
    end_time = max(target.get_end_time(), output.get_end_time())
    times = np.arange(0, end_time, 1 / fs)
    target_roll = target.get_piano_roll(fs=fs, times=times)
    output_roll = output.get_piano_roll(fs=fs, times=times)
    t = get_highest_pitches_from_piano_roll(target_roll)
    o = get_highest_pitches_from_piano_roll(output_roll)
    if len(t) == 0 and len(o) > 0:
        t = np.zeros_like(o)
    if len(o) == 0 and len(t) > 0:
        o = np.zeros_like(t)
    return t, o


def raw_chroma_accuracy(
    ref_voicing: np.ndarray,
    ref_cent: np.ndarray,
    est_voicing: np.ndarray,
    est_cent: np.ndarray,
    cent_tolerance: float = 50.0,
) -> float:
    """mir_eval.melody.raw_chroma_accuracy semantics: octave-folded cent
    distance <= tolerance, averaged over ref-voiced frames."""
    ref_voicing = np.asarray(ref_voicing, dtype=bool)
    if ref_voicing.sum() == 0:
        return 0.0
    cent_diff = np.abs(ref_cent - est_cent)
    octave = 1200.0 * np.floor(cent_diff / 1200.0 + 0.5)
    matches = np.abs(cent_diff - octave) <= cent_tolerance
    return float(np.sum(matches & ref_voicing) / np.sum(ref_voicing))


def melody_chroma_accuracy(
    ref_pitch: np.ndarray, est_pitch: np.ndarray, fs: int = 100
) -> float:
    """MIDI-pitch frame series -> chroma accuracy (reference
    evaluation.py:47-61; both series share a uniform timebase so mir_eval's
    resampling step is the identity)."""
    assert ref_pitch.shape == est_pitch.shape
    ref_freq = midi_to_hz(ref_pitch)
    est_freq = midi_to_hz(est_pitch)
    ref_voicing = ref_freq > 0
    est_voicing = est_freq > 0
    return raw_chroma_accuracy(
        ref_voicing,
        hz_to_cents(ref_freq),
        est_voicing,
        hz_to_cents(est_freq),
    )


def evaluate_batch(
    targets: Iterable[MidiFile], outputs: Iterable[MidiFile]
) -> float:
    """Concatenate per-song frame columns, then score once (reference
    evaluation.py:64-75)."""
    data = [
        extract_midi_melody(t, o) for t, o in zip(targets, outputs)
    ]
    if not data:
        return 0.0
    t = np.concatenate([d[0] for d in data])
    o = np.concatenate([d[1] for d in data])
    if len(t) == 0:
        return 0.0
    return melody_chroma_accuracy(t, o)
