"""The serving pitch-calibration gate: fixture and verdict.

The port's own copy of ``music2midi_tpu/calibration.py``'s
``render_fixture`` / ``check_midi``.  The fixture is a sparse A4 figure
(four 1.5 s notes on a 3 s grid) rendered by the MIDI synthesizer at
22050 Hz; pushed through ``Music2MIDI.generate(audio_path=...)`` (which
resamples to 16 kHz), a sound model of record must return pitch 69 at
three or more onset bins.  It catches a broken resample or mel frame
(everything shifted ~5.5 semitones) and models that return no notes on
digitally clean audio.
"""

from __future__ import annotations

import numpy as np

from .utils import numpy_to_midi


def render_fixture() -> tuple:
    """-> (float32 waveform, 22050): the pinned A4 figure."""
    notes = np.array(
        [[k * 3.0, k * 3.0 + 1.5, 69, 90] for k in range(4)], np.float64
    )
    wav = numpy_to_midi(notes).synthesize(fs=22050).astype(np.float32)
    return wav, 22050


def check_midi(mf) -> tuple:
    """Apply the pinned assertions to a generated MidiFile -> (ok, detail)."""
    got = mf.instruments[0].notes if mf.instruments else []
    a4 = [n for n in got if n.pitch == 69]
    onset_bins = {int(round(n.start / 3.0)) for n in a4}
    shifted = sum(1 for n in got if n.pitch in (74, 75))
    ok = (len(got) > 0 and len(a4) >= 3 and len(onset_bins) >= 3
          and shifted <= len(a4) // 2)
    detail = (f"notes={len(got)} a4={len(a4)} onset_bins={len(onset_bins)} "
              f"shifted={shifted} pitches={sorted({n.pitch for n in got})}")
    return ok, detail
