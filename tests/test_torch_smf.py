"""The port's Standard MIDI File reader and the containers it fills, against
the JAX package's ``midi.py``.

Bars: every note, tempo change, beat and time-signature change equal
exactly across the two packages in both directions (each reads what the
other wrote, including hypothesis-drawn note sets); each case of
``tests/test_midi.py`` (pitch bends whole, fractional and negative, the
sustain pedal, a mid-file tempo change, same-pitch overlaps, beats, rolls
with and without ``times``) gives the JAX result, rolls equal with
``assert_array_equal``; the writer is byte-identical with control changes,
pitch bends and a tempo map; running status and SMPTE division behave
alike.
"""

import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from music2midi_tpu import midi as jm
from music2midi_tpu.utils import numpy_to_midi as jax_numpy_to_midi
from music2midi_tpu_torch import midi as pm
from music2midi_tpu_torch.utils import numpy_to_midi


def _notes(midi):
    return [[(n.start, n.end, n.pitch, n.velocity) for n in inst.notes]
            for inst in midi.instruments]


def _events(midi):
    return [([(e.time, e.value) for e in inst.pitch_bends],
             [(e.time, e.value, e.number) for e in inst.control_changes],
             (inst.program, inst.is_drum, inst.name))
            for inst in midi.instruments]


def _assert_same(port, jax):
    assert _notes(port) == _notes(jax)
    assert _events(port) == _events(jax)
    assert port.resolution == jax.resolution
    for a, b in zip(port.get_tempo_changes(), jax.get_tempo_changes()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.get_beats(), jax.get_beats())
    assert port.time_signature_changes == jax.time_signature_changes
    assert port.get_end_time() == jax.get_end_time()


def _varint(v):
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    return bytes(reversed(out))


def _smf(tracks, res=480, fmt=1, division=None):
    data = b"MThd" + struct.pack(">IHHH", 6, fmt, len(tracks),
                                 res if division is None else division)
    for body in tracks:
        data += b"MTrk" + struct.pack(">I", len(body)) + body
    return data


def _tempo_file(tmp_path):
    """The file of test_midi.py::test_tempo_change_parse, plus a time
    signature, a track name, running status, a CC64 pedal, a pitch bend, a
    program change and a drum note."""
    conductor = b"".join([
        _varint(0), bytes([0xFF, 0x51, 0x03]), (500000).to_bytes(3, "big"),
        _varint(0), bytes([0xFF, 0x58, 0x04, 3, 2, 24, 8]),
        _varint(480), bytes([0xFF, 0x51, 0x03]), (1000000).to_bytes(3, "big"),
        _varint(0), bytes([0xFF, 0x2F, 0x00]),
    ])
    piano = b"".join([
        _varint(0), bytes([0xFF, 0x03, 0x05]), b"piano",
        _varint(0), bytes([0xC0, 5]),
        _varint(0), bytes([0x90, 60, 100]),
        _varint(0), bytes([64, 90]),  # running status: a second note-on
        _varint(120), bytes([0xB0, 64, 127]),
        _varint(120), bytes([0xE0, 0x00, 0x50]),
        _varint(720), bytes([0x80, 60, 64]),
        _varint(0), bytes([0x90, 64, 0]),  # velocity 0 = note-off
        _varint(480), bytes([0xB0, 64, 0]),
        _varint(0), bytes([0x99, 38, 70]),
        _varint(96), bytes([0x89, 38, 0]),
        _varint(0), bytes([0xFF, 0x2F, 0x00]),
    ])
    path = tmp_path / "tempo.mid"
    path.write_bytes(_smf([conductor, piano]))
    return path


def test_hand_built_file_reads_as_jax(tmp_path):
    path = _tempo_file(tmp_path)
    port, jax = pm.MidiFile(path), jm.MidiFile(path)
    _assert_same(port, jax)
    note = port.instruments[0].notes[0]
    assert (note.start, note.end) == (0.0, 1.5)
    assert len(port.instruments) == 2 and port.instruments[1].is_drum
    for fs in (50, 100):
        for pedal in (64, None):
            np.testing.assert_array_equal(
                port.get_piano_roll(fs=fs, pedal_threshold=pedal),
                jax.get_piano_roll(fs=fs, pedal_threshold=pedal))


def test_writer_byte_identical_with_tempo_map_ccs_and_bends(tmp_path):
    path = _tempo_file(tmp_path)
    pm.MidiFile(path).write(tmp_path / "port.mid")
    jm.MidiFile(path).write(tmp_path / "jax.mid")
    assert (tmp_path / "port.mid").read_bytes() == \
        (tmp_path / "jax.mid").read_bytes()
    _assert_same(pm.MidiFile(tmp_path / "jax.mid"),
                 jm.MidiFile(tmp_path / "port.mid"))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_reads_what_the_other_wrote(tmp_path, writer):
    rng = np.random.default_rng(7)
    n = 200
    onset = np.sort(rng.uniform(0, 60, n))
    notes = np.stack([onset, onset + rng.uniform(0.05, 3.0, n),
                      rng.integers(21, 109, n), rng.integers(1, 128, n)], 1)
    make = numpy_to_midi if writer == "port" else jax_numpy_to_midi
    make(notes).write(tmp_path / "x.mid")
    _assert_same(pm.MidiFile(tmp_path / "x.mid"),
                 jm.MidiFile(tmp_path / "x.mid"))


_note = st.tuples(st.floats(0.0, 20.0), st.floats(0.001, 4.0),
                  st.integers(0, 127), st.integers(1, 127))


@settings(max_examples=40, deadline=None, database=None)
@given(st.lists(_note, min_size=0, max_size=40))
def test_drawn_note_sets_round_trip_as_jax(tmp_path_factory, drawn):
    tmp = tmp_path_factory.mktemp("smf")
    notes = np.array([[s, s + d, p, v] for s, d, p, v in drawn]
                     ).reshape(-1, 4)
    numpy_to_midi(notes).write(tmp / "port.mid")
    jax_numpy_to_midi(notes).write(tmp / "jax.mid")
    assert (tmp / "port.mid").read_bytes() == (tmp / "jax.mid").read_bytes()
    port, jax = pm.MidiFile(tmp / "port.mid"), jm.MidiFile(tmp / "port.mid")
    _assert_same(port, jax)
    np.testing.assert_array_equal(port.get_piano_roll(fs=100),
                                  jax.get_piano_roll(fs=100))


def test_same_pitch_overlap_closes_every_open_note(tmp_path):
    for mod in (pm, jm):
        midi = mod.MidiFile(resolution=384, initial_tempo=120.0)
        inst = mod.Instrument(program=0)
        inst.notes = [mod.Note(0.0, 1.0, 60, 80), mod.Note(0.5, 1.0, 60, 80)]
        midi.instruments.append(inst)
        midi.write(tmp_path / f"{mod.__name__}.mid")
    port = pm.MidiFile(tmp_path / "music2midi_tpu_torch.midi.mid")
    jax = jm.MidiFile(tmp_path / "music2midi_tpu.midi.mid")
    _assert_same(port, jax)
    assert len(port.instruments[0].notes) == 2
    # a bare same-tick on/off pair gives no note, in both
    body = b"".join([_varint(0), bytes([0x90, 60, 80]),
                     _varint(0), bytes([0x80, 60, 0]),
                     _varint(0), bytes([0xFF, 0x2F, 0x00])])
    (tmp_path / "bare.mid").write_bytes(_smf([body], fmt=0))
    assert pm.MidiFile(tmp_path / "bare.mid").instruments == []
    assert jm.MidiFile(tmp_path / "bare.mid").instruments == []


def _roll_case(name, mod, to_midi):
    notes = {"bend_whole": [[0.0, 1.0, 60, 80]],
             "bend_frac": [[0.0, 1.0, 60, 80]],
             "bend_neg": [[0.0, 1.0, 60, 80]],
             "pedal": [[0.0, 0.5, 60, 80]],
             "plain": [[0.0, 0.5, 60, 80], [0.25, 0.75, 64, 90]]}[name]
    midi = to_midi(np.array(notes))
    inst = midi.instruments[0]
    if name == "bend_whole":
        inst.pitch_bends.append(mod.TimedEvent(0.5, 4096))
    elif name == "bend_frac":
        inst.pitch_bends.append(mod.TimedEvent(0.0, 2048))
    elif name == "bend_neg":
        inst.pitch_bends.append(mod.TimedEvent(0.0, -4096))
    elif name == "pedal":
        inst.control_changes.append(mod.TimedEvent(0.25, 100, 64))
        inst.control_changes.append(mod.TimedEvent(0.9, 0, 64))
    return midi


@pytest.mark.parametrize("name", ["bend_whole", "bend_frac", "bend_neg",
                                  "pedal", "plain"])
def test_piano_roll_cases_equal_jax(tmp_path, name):
    port = _roll_case(name, pm, numpy_to_midi)
    jax = _roll_case(name, jm, jax_numpy_to_midi)
    times = np.arange(0, 1.0, 0.01)
    for kw in ({}, {"pedal_threshold": None}, {"times": times}):
        got = port.get_piano_roll(fs=100, **kw)
        np.testing.assert_array_equal(got, jax.get_piano_roll(fs=100, **kw))
    if name == "bend_whole":
        roll = port.get_piano_roll(fs=100)
        assert (roll[61, 50:] == 80).all() and (roll[60, 50:] == 0).all()
    if name == "pedal":
        assert (port.get_piano_roll(fs=100)[60, :90] == 80).all()
    # the written file carries the bends and CCs, byte for byte
    port.write(tmp_path / "port.mid")
    jax.write(tmp_path / "jax.mid")
    assert (tmp_path / "port.mid").read_bytes() == \
        (tmp_path / "jax.mid").read_bytes()
    _assert_same(pm.MidiFile(tmp_path / "port.mid"),
                 jm.MidiFile(tmp_path / "jax.mid"))


def test_get_beats_equal_jax():
    notes = np.array([[0.0, 2.0, 60, 80]])
    got = numpy_to_midi(notes).get_beats()
    np.testing.assert_array_equal(got, jax_numpy_to_midi(notes).get_beats())
    np.testing.assert_allclose(got, [0.0, 0.5, 1.0, 1.5, 2.0])


def test_smpte_and_garbage_rejected_alike(tmp_path):
    body = _varint(0) + bytes([0xFF, 0x2F, 0x00])
    (tmp_path / "smpte.mid").write_bytes(
        _smf([body], division=0xE728))  # -25 fps, 40 ticks a frame
    (tmp_path / "junk.mid").write_bytes(b"RIFF0000WAVE")
    for name, match in (("smpte.mid", "SMPTE"), ("junk.mid", "MThd")):
        for mod in (pm, jm):
            with pytest.raises(ValueError, match=match):
                mod.MidiFile(tmp_path / name)
