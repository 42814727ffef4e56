"""The port's ``plot_interactive.py`` and ``plot_midi.py`` against the JAX
package's.

Bars: the interactive HTML is byte-identical to the JAX package's for the
same MidiFile (several instruments, an empty one, a title that needs
escaping, the TP/FN/FP diff with and without ``melody_only``);
``piano_roll_to_notes`` and ``extract_melody_from_piano_roll`` equal
exactly; the matplotlib plots write a PNG where matplotlib is installed,
and both packages raise ``ImportError`` when it is blocked.
"""

import sys

import numpy as np
import pytest

from music2midi_tpu import midi as jm
from music2midi_tpu import plot_interactive as jpi
from music2midi_tpu import plot_midi as jpm
from music2midi_tpu.utils import numpy_to_midi as jax_numpy_to_midi
from music2midi_tpu_torch import midi as pm
from music2midi_tpu_torch import plot_interactive as ppi
from music2midi_tpu_torch import plot_midi as ppm
from music2midi_tpu_torch.utils import numpy_to_midi


def _notes(seed, n=60, span=10.0):
    rng = np.random.default_rng(seed)
    onset = np.sort(rng.uniform(0, span, n))
    return np.stack([onset, onset + rng.uniform(0.05, 1.5, n),
                     rng.integers(30, 100, n), rng.integers(1, 128, n)], 1)


def _two_instruments(mod, to_midi):
    midi = to_midi(_notes(0))
    extra = mod.Instrument(program=33, name="")
    extra.notes = [mod.Note(s, e, int(p), int(v)) for s, e, p, v in _notes(1)]
    midi.instruments.append(extra)
    return midi


def test_sequence_html_byte_identical(tmp_path):
    cases = [
        (numpy_to_midi(_notes(2)), jax_numpy_to_midi(_notes(2)), "roll"),
        (_two_instruments(pm, numpy_to_midi),
         _two_instruments(jm, jax_numpy_to_midi), "<b>two</b> & \"more\""),
        (pm.MidiFile(), jm.MidiFile(), "empty"),
        (numpy_to_midi(np.zeros((0, 4))), jax_numpy_to_midi(np.zeros((0, 4))),
         "no notes </script>"),
    ]
    for i, (port, jax, title) in enumerate(cases):
        got = ppi.plot_midi_sequence_html(port, path=tmp_path / f"{i}.html",
                                          title=title)
        assert got == jpi.plot_midi_sequence_html(jax, title=title)
        assert (tmp_path / f"{i}.html").read_text() == got


@pytest.mark.parametrize("melody_only", [False, True])
def test_evaluation_html_byte_identical(melody_only):
    target, output = _notes(3), _notes(4)
    got = ppi.plot_midi_evaluation_html(
        numpy_to_midi(target), numpy_to_midi(output), melody_only=melody_only)
    want = jpi.plot_midi_evaluation_html(
        jax_numpy_to_midi(target), jax_numpy_to_midi(output),
        melody_only=melody_only)
    assert got == want
    # an empty prediction against a target
    assert ppi.plot_midi_evaluation_html(
        numpy_to_midi(target), numpy_to_midi(np.zeros((0, 4)))) == \
        jpi.plot_midi_evaluation_html(jax_numpy_to_midi(target),
                                      jax_numpy_to_midi(np.zeros((0, 4))))


def test_roll_helpers_equal_jax():
    roll = numpy_to_midi(_notes(5)).get_piano_roll(fs=100)
    np.testing.assert_array_equal(ppm.extract_melody_from_piano_roll(roll),
                                  jpm.extract_melody_from_piano_roll(roll))
    for fs in (50, 100):
        np.testing.assert_array_equal(ppm.piano_roll_to_notes(roll, fs=fs),
                                      jpm.piano_roll_to_notes(roll, fs=fs))
    empty = np.zeros((128, 40))
    np.testing.assert_array_equal(ppm.piano_roll_to_notes(empty),
                                  jpm.piano_roll_to_notes(empty))
    np.testing.assert_array_equal(ppm.extract_melody_from_piano_roll(empty),
                                  empty)


def test_matplotlib_plots_write_png(tmp_path):
    midi = numpy_to_midi(_notes(6))
    ppm.plot_midi_sequence(midi, path=tmp_path / "seq.png", title="t")
    ppm.plot_midi_evaluation(midi, numpy_to_midi(_notes(7)),
                             melody_only=True, path=tmp_path / "eval.png")
    for name in ("seq.png", "eval.png"):
        assert (tmp_path / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_without_matplotlib_both_raise(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    errors = []
    for plot, midi in ((ppm.plot_midi_sequence, numpy_to_midi(_notes(8))),
                       (jpm.plot_midi_sequence, jax_numpy_to_midi(_notes(8)))):
        with pytest.raises(ImportError) as e:
            plot(midi)
        errors.append(type(e.value))
    assert errors[0] is errors[1]
    with pytest.raises(ImportError):
        ppm.plot_midi_evaluation(numpy_to_midi(_notes(8)),
                                 numpy_to_midi(_notes(9)))
