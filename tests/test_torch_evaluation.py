"""The port's tokenizer encoder, piano roll and chroma evaluation against
the JAX package's.

Bars: token ids exactly equal (``encode``, ``__call__``'s PAD padding,
``cutoff_time``), ``to_string`` equal; piano rolls exactly equal;
``evaluate_batch`` within 1e-12 (float64 on both sides).
"""

import numpy as np
import pytest

from music2midi_tpu import evaluation as jev
from music2midi_tpu.tokenizer import MidiTokenizer as JTokenizer
from music2midi_tpu.utils import numpy_to_midi as jax_numpy_to_midi
from music2midi_tpu_torch import evaluation as pev
from music2midi_tpu_torch.midi import Instrument, MidiFile, Note
from music2midi_tpu_torch.tokenizer import MidiTokenizer
from music2midi_tpu_torch.utils import numpy_to_midi


def _notes(rng, n, seconds=3.0):
    onsets = rng.uniform(0, seconds, n)
    return np.stack([onsets, onsets + rng.uniform(0.0, 1.5, n),
                     rng.integers(21, 109, n), np.full(n, 80)], 1)


def test_encoder_matches_jax():
    rng = np.random.default_rng(0)
    port, jax_tok = MidiTokenizer(), JTokenizer()
    batch = [_notes(rng, n) for n in (0, 1, 7, 40, 90)]
    batch.append(np.array([[0.0249, 0.0251, 60, 80], [9.99, 12.0, 61, 80],
                           [0.025, 0.02, 62, 80]]))  # rounding edges
    for notes in batch:
        for cutoff in (None, 1.5):
            got = port.encode(notes, cutoff)
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, jax_tok.encode(notes, cutoff))
    np.testing.assert_array_equal(port(batch), jax_tok(batch))
    ids = port.encode(batch[3])
    assert port.to_string(ids) == jax_tok.to_string(ids)
    with pytest.raises(ValueError):
        port.to_string([4, -1])


def test_piano_roll_matches_jax():
    rng = np.random.default_rng(1)
    for n in (0, 5, 30):
        notes = _notes(rng, n, seconds=4.0)
        a, b = numpy_to_midi(notes), jax_numpy_to_midi(notes)
        np.testing.assert_array_equal(a.get_piano_roll(), b.get_piano_roll())
        times = np.arange(0, 5.0, 0.01)
        np.testing.assert_array_equal(a.get_piano_roll(times=times),
                                      b.get_piano_roll(times=times))
    drum = MidiFile()
    inst = Instrument(is_drum=True)
    inst.notes = [Note(0.0, 1.0, 36, 100)]
    drum.instruments.append(inst)
    assert not drum.get_piano_roll().any()


def test_evaluate_batch_matches_jax():
    rng = np.random.default_rng(2)
    targets = [_notes(rng, n) for n in (12, 3, 25, 0)]
    outputs = []
    for t in targets:
        o = t.copy()
        if len(o):
            o[:, 2] += rng.choice([0, 0, 12, 1], size=len(o))
            o[:, :2] += rng.normal(0, 0.03, size=(len(o), 2))
        outputs.append(o)
    got = pev.evaluate_batch([numpy_to_midi(n) for n in targets],
                             [numpy_to_midi(n) for n in outputs])
    want = jev.evaluate_batch([jax_numpy_to_midi(n) for n in targets],
                              [jax_numpy_to_midi(n) for n in outputs])
    assert 0.0 < got < 1.0
    assert abs(got - want) <= 1e-12
    assert pev.evaluate_batch([], []) == jev.evaluate_batch([], []) == 0.0
