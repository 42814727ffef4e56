"""An in-memory MIDI container, a Standard MIDI File writer and a
synthesizer.

The port's own copy of the parts of ``music2midi_tpu/midi.py`` that the
serving path and the evaluation need (pure numpy and ``struct``): Note /
Instrument / MidiFile containers for one constant tempo, ``write`` (SMF
format 1, byte-identical to the JAX package's writer for the same notes),
``synthesize`` and ``get_piano_roll`` with pretty_midi's documented
semantics.  The containers hold notes only: the SMF reader, beats, pitch
bends and control changes (and so the roll's sustain pedal and bends) are
not ported yet.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np


class Note:
    __slots__ = ("start", "end", "pitch", "velocity")

    def __init__(self, start: float, end: float, pitch: int, velocity: int):
        self.start = float(start)
        self.end = float(end)
        self.pitch = int(pitch)
        self.velocity = int(velocity)

    def __repr__(self):
        return (
            f"Note(start={self.start:.4f}, end={self.end:.4f}, "
            f"pitch={self.pitch}, velocity={self.velocity})"
        )


class Instrument:
    def __init__(self, program: int = 0, is_drum: bool = False, name: str = ""):
        self.program = int(program)
        self.is_drum = bool(is_drum)
        self.name = name
        self.notes: List[Note] = []

    def get_end_time(self) -> float:
        return max((n.end for n in self.notes), default=0.0)

    def remove_invalid_notes(self) -> None:
        self.notes = [n for n in self.notes if n.end > n.start]

    def get_piano_roll(self, fs: int = 100,
                       times: Optional[np.ndarray] = None) -> np.ndarray:
        """Velocity piano roll with pretty_midi Instrument.get_piano_roll
        semantics (the reference consumes pretty_midi's defaults at
        music2midi/evaluation.py:34-35): notes stamped as velocity over
        [int(start*fs), int(end*fs)); drum instruments produce zeros; with
        ``times``, column n is the mean over [round(times[n]*fs),
        round(times[n+1]*fs)) and the final column stays zero, exactly like
        pretty_midi."""
        if not self.notes:
            return np.zeros((128, 0))
        end_time = self.get_end_time()
        if times is not None and len(times) and times[-1] > end_time:
            end_time = float(times[-1])
        roll = np.zeros((128, int(fs * end_time)))
        if not self.is_drum:
            for note in self.notes:
                roll[note.pitch, int(note.start * fs):int(note.end * fs)] += (
                    note.velocity
                )
        return roll if times is None else _integrate_roll(roll, fs, times)


def _integrate_roll(roll: np.ndarray, fs: int, times: np.ndarray) -> np.ndarray:
    """pretty_midi semantics for get_piano_roll(times=...): column n is the
    mean of roll columns in [round(times[n]*fs), round(times[n+1]*fs));
    the final column is left zero (pretty_midi iterates pairs only)."""
    times = np.array(np.round(np.asarray(times) * fs), dtype=np.int64)
    out = np.zeros((roll.shape[0], times.shape[0]))
    for n in range(len(times) - 1):
        start, end = times[n], times[n + 1]
        if start < roll.shape[1]:
            if start == end:
                end = start + 1
            out[:, n] = np.mean(roll[:, start:end], axis=1)
    return out


class MidiFile:
    """In-memory MIDI: instruments with absolute-seconds notes at one
    constant tempo."""

    def __init__(self, resolution: int = 384, initial_tempo: float = 120.0):
        self.resolution = int(resolution)
        self.instruments: List[Instrument] = []
        self._sec_per_tick = 60.0 / (initial_tempo * self.resolution)

    def get_end_time(self) -> float:
        return max((i.get_end_time() for i in self.instruments), default=0.0)

    def remove_invalid_notes(self) -> None:
        for inst in self.instruments:
            inst.remove_invalid_notes()

    def get_piano_roll(self, fs: int = 100,
                       times: Optional[np.ndarray] = None) -> np.ndarray:
        """Sum of instrument rolls, padded to the longest (pretty_midi
        PrettyMIDI.get_piano_roll).  With ``times`` the result always has
        len(times) columns, even when every instrument is empty, as the JAX
        package's does (pretty_midi returns (128, 0) there)."""
        n_cols = 0 if times is None else len(times)
        rolls = [inst.get_piano_roll(fs=fs, times=times)
                 for inst in self.instruments]
        if rolls:
            n_cols = max(n_cols, max(r.shape[1] for r in rolls))
        out = np.zeros((128, n_cols))
        for r in rolls:
            out[:, : r.shape[1]] += r
        return out

    def synthesize(self, fs: int = 44100) -> np.ndarray:
        """Additive-sine rendering (pretty_midi.synthesize analogue): each
        note is a sine at its fundamental plus decaying harmonics, with a
        short linear fade-out; used only for alignment features, not audio
        quality (reference data/align_audio_midi.py:274-276)."""
        end = self.get_end_time()
        if end <= 0:
            return np.zeros(1, dtype=np.float32)
        out = np.zeros(int(np.ceil(end * fs)) + 1, dtype=np.float64)
        for inst in self.instruments:
            if inst.is_drum:
                continue
            for note in inst.notes:
                f0 = 440.0 * 2.0 ** ((note.pitch - 69) / 12.0)
                i0, i1 = int(note.start * fs), int(note.end * fs)
                if i1 <= i0:
                    continue
                n = i1 - i0
                t = np.arange(n) / fs
                sig = np.zeros(n)
                for h in (1, 2, 3):
                    if f0 * h < fs / 2:
                        sig += np.sin(2 * np.pi * f0 * h * t) / (h * h)
                env = np.minimum(1.0, np.arange(n) / max(1, int(0.005 * fs)))
                fade = np.minimum(
                    1.0, (n - np.arange(n)) / max(1, int(0.02 * fs))
                )
                out[i0:i1] += sig * env * fade * (note.velocity / 127.0)
        peak = np.max(np.abs(out))
        if peak > 0:
            out = out / peak
        return out.astype(np.float32)

    def _time_to_tick(self, time: float) -> int:
        return int(round(max(time, 0.0) / self._sec_per_tick))

    def write(self, path: Union[str, Path]) -> None:
        """Write SMF format 1: tempo track + one track per instrument."""
        chunks = [self._tempo_track_bytes()]
        for inst in self.instruments:
            chunks.append(self._instrument_track_bytes(inst))
        header = b"MThd" + struct.pack(">IHHH", 6, 1, len(chunks), self.resolution)
        with open(path, "wb") as f:
            f.write(header)
            for body in chunks:
                f.write(b"MTrk" + struct.pack(">I", len(body)) + body)

    def _tempo_track_bytes(self) -> bytes:
        usec_per_quarter = int(round(self._sec_per_tick * self.resolution
                                     * 1e6))
        return (_varint(0) + bytes([0xFF, 0x51, 0x03])
                + struct.pack(">I", usec_per_quarter)[1:]
                + _varint(0) + bytes([0xFF, 0x2F, 0x00]))

    def _instrument_track_bytes(self, inst: Instrument) -> bytes:
        channel = 9 if inst.is_drum else 0
        events: List[Tuple[int, int, bytes]] = []  # (tick, order, payload)
        events.append((0, 0, bytes([0xC0 | channel, inst.program & 0x7F])))
        for note in inst.notes:
            on_tick = self._time_to_tick(note.start)
            off_tick = self._time_to_tick(note.end)
            # order: note-offs (2) before note-ons (3) at equal ticks
            events.append(
                (off_tick, 2, bytes([0x80 | channel, note.pitch & 0x7F, 64]))
            )
            events.append(
                (
                    on_tick,
                    3,
                    bytes([0x90 | channel, note.pitch & 0x7F,
                           note.velocity & 0x7F]),
                )
            )
        events.sort(key=lambda e: (e[0], e[1]))
        out = bytearray()
        last_tick = 0
        for tick, _, payload in events:
            out += _varint(tick - last_tick) + payload
            last_tick = tick
        out += _varint(0) + bytes([0xFF, 0x2F, 0x00])
        return bytes(out)


def _varint(value: int) -> bytes:
    if value < 0:
        raise ValueError(f"negative delta time {value}")
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(out))
