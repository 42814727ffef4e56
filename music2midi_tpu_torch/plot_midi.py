"""Piano-roll plots with matplotlib: the port's own copy of
``music2midi_tpu/plot_midi.py``.

  * plot_midi_sequence: piano roll of one MidiFile
  * plot_midi_evaluation: TP / FN / FP diff roll between a target and a
    prediction, optionally melody-only
  * extract_melody_from_piano_roll: keep only the highest active pitch per
    frame
  * piano_roll_to_notes: roll -> note tuples

matplotlib is imported inside the two plotting functions only; without it
they raise ``ImportError`` and the rest of the module works.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

from .midi import MidiFile


def extract_melody_from_piano_roll(roll: np.ndarray) -> np.ndarray:
    """Zero out everything but the highest active pitch per frame."""
    active = roll > 0
    any_active = active.any(axis=0)
    highest = roll.shape[0] - 1 - np.argmax(active[::-1], axis=0)
    out = np.zeros_like(roll)
    cols = np.nonzero(any_active)[0]
    out[highest[cols], cols] = roll[highest[cols], cols]
    return out


def piano_roll_to_notes(roll: np.ndarray, fs: int = 100) -> np.ndarray:
    """roll (128, T) -> (N, 4) note tuples by run-length encoding each
    pitch row (reference piano-roll -> instrument reconstruction)."""
    notes = []
    for pitch in range(roll.shape[0]):
        row = roll[pitch] > 0
        if not row.any():
            continue
        edges = np.diff(row.astype(np.int8), prepend=0, append=0)
        starts = np.nonzero(edges == 1)[0]
        ends = np.nonzero(edges == -1)[0]
        for s, e in zip(starts, ends):
            velocity = float(roll[pitch, s:e].max())
            notes.append([s / fs, e / fs, pitch, min(127.0, velocity)])
    notes.sort()
    return np.asarray(notes) if notes else np.zeros((0, 4))


def _setup_axes(ax, roll, fs):
    ax.set_xlabel("time (s)")
    ax.set_ylabel("MIDI pitch")
    active = np.nonzero(roll.sum(axis=1))[0]
    if len(active):
        ax.set_ylim(max(0, active.min() - 4), min(128, active.max() + 4))
    n = roll.shape[1]
    ax.set_xlim(0, n / fs)


def plot_midi_sequence(
    midi: MidiFile,
    fs: int = 100,
    path: Optional[Union[str, Path]] = None,
    title: str = "",
):
    """Piano-roll plot; saves to `path` if given, returns the figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    roll = midi.get_piano_roll(fs=fs)
    fig, ax = plt.subplots(figsize=(12, 4))
    pitches, frames = np.nonzero(roll > 0)
    ax.scatter(frames / fs, pitches, s=4, marker="s", c="#3b82f6",
               linewidths=0)
    _setup_axes(ax, roll, fs)
    ax.set_title(title or "piano roll")
    fig.tight_layout()
    if path is not None:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def plot_midi_evaluation(
    target: MidiFile,
    output: MidiFile,
    fs: int = 100,
    melody_only: bool = False,
    path: Optional[Union[str, Path]] = None,
):
    """TP (target ∩ output), FN (target only), FP (output only) diff roll
    (reference plot_midi.py:102-135)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    end = max(target.get_end_time(), output.get_end_time())
    times = np.arange(0, end, 1 / fs)
    t_roll = target.get_piano_roll(fs=fs, times=times)
    o_roll = output.get_piano_roll(fs=fs, times=times)
    if melody_only:
        t_roll = extract_melody_from_piano_roll(t_roll)
        o_roll = extract_melody_from_piano_roll(o_roll)
    t_on = t_roll > 0
    o_on = o_roll > 0
    fig, ax = plt.subplots(figsize=(12, 4))
    for mask, color, label in (
        (t_on & o_on, "#22c55e", "TP"),
        (t_on & ~o_on, "#f59e0b", "FN (missed)"),
        (~t_on & o_on, "#ef4444", "FP (extra)"),
    ):
        pitches, frames = np.nonzero(mask)
        ax.scatter(frames / fs, pitches, s=4, marker="s", c=color,
                   linewidths=0, label=label)
    _setup_axes(ax, (t_on | o_on).astype(float), fs)
    ax.legend(loc="upper right")
    ax.set_title("target vs prediction" + (" (melody)" if melody_only else ""))
    fig.tight_layout()
    if path is not None:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig
