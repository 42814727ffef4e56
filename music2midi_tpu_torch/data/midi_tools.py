"""MIDI retiming/transposition tools for the alignment pipeline
(reference data/align_audio_midi.py:33-117,146-152): the port's own copy
of ``music2midi_tpu/data/midi_tools.py``."""

from __future__ import annotations

import copy

import numpy as np

from ..midi import MidiFile


def transpose_midi(midi: MidiFile, shift: int) -> MidiFile:
    for inst in midi.instruments:
        for note in inst.notes:
            note.pitch += shift
    return midi


def simple_adjust_times(
    midi: MidiFile, original_times: np.ndarray, new_times: np.ndarray
) -> MidiFile:
    """Retime all notes/pitch bends/CCs by linear interpolation over the
    warp path; drop events outside the original time range; remove
    now-invalid notes (reference simple_adjust_times semantics)."""
    original_times = np.asarray(original_times)
    new_times = np.asarray(new_times)
    for inst in midi.instruments:
        inst.notes = [
            copy.copy(n)
            for n in inst.notes
            if n.start >= original_times[0] and n.end <= original_times[-1]
        ]
        starts = np.interp(
            [n.start for n in inst.notes], original_times, new_times
        )
        ends = np.interp(
            [n.end for n in inst.notes], original_times, new_times
        )
        for n, s, e in zip(inst.notes, starts, ends):
            n.start = float(s) if s > 0 else 0.0
            n.end = float(e) if e > 0 else 0.0
        for events in (inst.pitch_bends, inst.control_changes):
            events.sort(key=lambda e: e.time)
            times = np.interp(
                [e.time for e in events], original_times, new_times
            )
            for e, t in zip(events, times):
                e.time = float(t)
            # keep the final event at exactly new_times[0], then strictly
            # inside the range
            at_start = [e for e in events if e.time == new_times[0]]
            kept = at_start[-1:] if at_start else []
            kept.extend(
                e for e in events
                if new_times[0] < e.time < new_times[-1]
            )
            events[:] = kept
    midi.remove_invalid_notes()
    return midi
