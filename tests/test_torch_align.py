"""The port's aligner (``music2midi_tpu_torch/data/align.py``), MIDI tools
(``data/midi_tools.py``) and ``utils.midi_to_numpy_notes`` against the JAX
package's.

The inputs are made here from seeds: a two-track score through the
MIDI synthesizer at 22050 Hz as the "MIDI audio", and as the "song" the
same score slowed by 6 % (and, for the chroma shift, transposed up three
semitones), both under a little noise.  Each alignment test runs twice:
with the banded DTW in the C++ library, and with it forced off on both
sides (the numpy DTW).  Bars: the chroma and onset features, the tuning,
the chroma shift, the warp path and every DTW path equal (``0`` tolerance:
the two packages run the same numpy on the same inputs); the MIDI tools'
notes, bends and control changes equal.
"""

import copy

import numpy as np
import pytest

from _jax_native import loaded as jax_native
from music2midi_tpu import native as jnative
from music2midi_tpu import utils as jutils
from music2midi_tpu.data import align as jalign
from music2midi_tpu.data import midi_tools as jtools
from music2midi_tpu.midi import MidiFile as JMidiFile
from music2midi_tpu_torch import native as pnative
from music2midi_tpu_torch import utils as putils
from music2midi_tpu_torch.data import align as palign
from music2midi_tpu_torch.data import midi_tools as ptools
from music2midi_tpu_torch.midi import Instrument, MidiFile, Note, TimedEvent

SR = 22050


def _score(seed: int, seconds: float = 10.0, stretch: float = 1.0,
           transpose: int = 0) -> MidiFile:
    rng = np.random.default_rng(seed)
    melody, bass = Instrument(name="melody"), Instrument(name="bass")
    t = 0.0
    while t < seconds - 1.0:
        dur = float(rng.uniform(0.2, 0.6))
        melody.notes.append(Note(t * stretch, (t + dur) * stretch,
                                 int(rng.integers(60, 80)) + transpose, 90))
        t += float(rng.choice([0.25, 0.5]))
    for b in np.arange(0.0, seconds - 1.0, 1.0):
        bass.notes.append(Note(b * stretch, (b + 0.8) * stretch,
                               36 + transpose + int(rng.integers(0, 5)), 70))
    midi = MidiFile()
    midi.instruments = [melody, bass]
    return midi


def _audio(midi: MidiFile, seed: int) -> np.ndarray:
    y = midi.synthesize(fs=SR).astype(np.float32)
    y += 0.003 * np.random.default_rng(seed).normal(size=len(y)).astype(
        np.float32)
    return (0.8 * y / np.abs(y).max()).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(song audio, MIDI audio, transposed song audio)."""
    return (_audio(_score(0, stretch=1.06), 1), _audio(_score(0), 2),
            _audio(_score(0, stretch=1.06, transpose=3), 3))


@pytest.fixture(params=["native", "numpy"])
def dtw(request, monkeypatch):
    """The banded DTW's route, the same on both sides."""
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(pnative, "available", lambda: False)
    else:
        assert pnative.available(), pnative.build_log()
        jax_native()
    return request.param


def test_features_equal_jax(pair):
    song, midi_audio, _ = pair
    for y in (song, midi_audio):
        tune = palign.estimate_tuning(y, SR)
        assert tune == jalign.estimate_tuning(y, SR)
        ca = palign.chroma_features(y, SR, 50, tune * 100)
        np.testing.assert_array_equal(
            ca, jalign.chroma_features(y, SR, 50, tune * 100))
        assert ca.shape[0] == 12 and np.isfinite(ca).all()
        np.testing.assert_array_equal(palign.onset_features(ca),
                                      jalign.onset_features(ca))


def test_chroma_shift_equals_jax(pair, dtw):
    song, midi_audio, transposed = pair
    cb = palign.chroma_features(midi_audio, SR)
    for y in (song, transposed):
        ca = palign.chroma_features(y, SR)
        shift = palign.compute_optimal_chroma_shift(ca, cb)
        assert shift == jalign.compute_optimal_chroma_shift(ca, cb)
        np.testing.assert_array_equal(palign.shift_chroma(cb, shift),
                                      jalign.shift_chroma(cb, shift))
    assert palign.compute_optimal_chroma_shift(
        palign.chroma_features(transposed, SR), cb) == 3


def test_align_features_equals_jax(pair, dtw):
    song, midi_audio, _ = pair
    wp, shift = palign.align_features(song, midi_audio, SR, 50)
    jwp, jshift = jalign.align_features(song, midi_audio, SR, 50)
    assert shift == jshift == 0
    assert wp.dtype == jwp.dtype
    np.testing.assert_array_equal(wp, jwp)
    # strictly monotonic, and the 6 % slower song maps onto the score
    assert (np.diff(wp, axis=1) > 0).all()
    slope = np.polyfit(wp[1], wp[0], 1)[0]
    assert abs(slope - 1.06) < 0.03, slope


def test_dtw_paths_equal_jax(dtw):
    rng = np.random.default_rng(5)
    fa = rng.random((24, 90))
    fb = rng.random((24, 110))
    fa /= np.linalg.norm(fa, axis=0)
    fb /= np.linalg.norm(fb, axis=0)
    np.testing.assert_array_equal(palign.multiscale_dtw(fa, fb, 10, 15),
                                  jalign.multiscale_dtw(fa, fb, 10, 15))
    cost = palign._cost_matrix(fa[:, :30], fb[:, :40])
    mask = np.abs(np.arange(30)[:, None] * 40 / 30
                  - np.arange(40)[None, :]) < 8
    np.testing.assert_array_equal(palign.dtw_path(cost),
                                  jalign.dtw_path(cost))
    np.testing.assert_array_equal(palign.dtw_path_fast(cost, mask),
                                  jalign.dtw_path_fast(cost, mask))
    path = palign.dtw_path(cost)
    np.testing.assert_array_equal(
        palign.make_path_strictly_monotonic(path),
        jalign.make_path_strictly_monotonic(path))


def _events_midi() -> MidiFile:
    midi = _score(7, seconds=8.0)
    inst = midi.instruments[0]
    inst.pitch_bends = [TimedEvent(t, v) for t, v in
                        ((0.0, 0), (1.2, 512), (3.3, -300), (7.9, 0))]
    inst.control_changes = [TimedEvent(t, v, 64) for t, v in
                            ((0.0, 127), (2.0, 0), (5.5, 127))]
    return midi


def _dump(midi) -> list:
    return [([(n.start, n.end, n.pitch, n.velocity) for n in inst.notes],
             [(e.time, e.value) for e in inst.pitch_bends],
             [(e.time, e.value, e.number) for e in inst.control_changes])
            for inst in midi.instruments]


def test_midi_tools_equal_jax(tmp_path):
    path = tmp_path / "events.mid"
    _events_midi().write(path)
    p, j = MidiFile(path), JMidiFile(path)
    assert _dump(p) == _dump(j)
    assert _dump(ptools.transpose_midi(p, -2)) == \
        _dump(jtools.transpose_midi(j, -2))
    orig = np.linspace(0.0, 8.0, 41)
    new = orig * 1.05 + 0.2 * np.sin(orig)
    got = ptools.simple_adjust_times(copy.deepcopy(p), orig, new)
    want = jtools.simple_adjust_times(copy.deepcopy(j), orig, new)
    assert _dump(got) == _dump(want)
    assert got.instruments[0].notes and got.instruments[0].pitch_bends
    got.write(tmp_path / "p.mid")
    want.write(tmp_path / "j.mid")
    assert (tmp_path / "p.mid").read_bytes() == \
        (tmp_path / "j.mid").read_bytes()


def test_midi_to_numpy_notes_equals_jax(tmp_path):
    path = tmp_path / "events.mid"
    _events_midi().write(path)
    got = putils.midi_to_numpy_notes(MidiFile(path))
    want = jutils.midi_to_numpy_notes(JMidiFile(path))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert putils.midi_to_numpy_notes(MidiFile()).shape == (0, 4)
