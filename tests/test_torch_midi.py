"""Port MIDI output against the JAX package: the serving path's
``numpy_to_midi`` -> ``write`` / ``synthesize``.

Notes are drawn with numpy from a seed, overlapping and including
invalid (end <= start) ones.  The written Standard MIDI File must be
byte-identical to the JAX package's and carry every valid note when the
JAX package's parser reads it back, and the synthesized audio must
equal the JAX package's within 1e-6.
"""

import numpy as np

from music2midi_tpu.midi import MidiFile as JaxMidiFile
from music2midi_tpu.utils import numpy_to_midi as jax_numpy_to_midi
from music2midi_tpu_torch.utils import numpy_to_midi


def _notes(seed: int, n: int = 200) -> np.ndarray:
    rng = np.random.default_rng(seed)
    onset = np.sort(rng.uniform(0.0, 30.0, n))
    dur = rng.uniform(-0.05, 2.0, n)  # a few invalid notes
    return np.stack([onset, onset + dur, rng.integers(21, 109, n),
                     rng.integers(1, 128, n)], axis=1)


def test_write_is_byte_identical_to_jax(tmp_path):
    notes = _notes(0)
    numpy_to_midi(notes).write(tmp_path / "port.mid")
    jax_numpy_to_midi(notes).write(tmp_path / "jax.mid")
    port_bytes = (tmp_path / "port.mid").read_bytes()
    assert port_bytes == (tmp_path / "jax.mid").read_bytes()

    # and it carries every valid note
    back = JaxMidiFile(tmp_path / "port.mid").instruments[0].notes
    assert len(back) == int((notes[:, 1] > notes[:, 0]).sum())


def test_synthesize_matches_jax():
    notes = _notes(1, n=40)
    got = numpy_to_midi(notes).synthesize(fs=16000)
    want = jax_numpy_to_midi(notes).synthesize(fs=16000)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)
