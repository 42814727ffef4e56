"""Small shared helpers: the port's own copy of ``music2midi_tpu/utils.py``."""

from __future__ import annotations

import numpy as np

from .midi import Instrument, MidiFile, Note


def numpy_to_midi(notes: np.ndarray) -> MidiFile:
    """(N, 4) array of (onset_s, offset_s, pitch, velocity) -> MidiFile:
    resolution 384, tempo 120, program 0 "Piano", invalid (end <= start)
    notes removed."""
    midi = MidiFile(resolution=384, initial_tempo=120.0)
    inst = Instrument(program=0, name="Piano")
    inst.notes = [
        Note(onset, offset, int(pitch), int(velocity))
        for onset, offset, pitch, velocity in np.asarray(notes)
    ]
    midi.instruments.append(inst)
    midi.remove_invalid_notes()
    return midi
