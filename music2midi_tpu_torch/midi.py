"""Standard MIDI File I/O and an in-memory MIDI container.

The port's own copy of ``music2midi_tpu/midi.py`` (pure numpy and
``struct``):

  * Note / TimedEvent / Instrument / MidiFile containers
  * SMF (format 0/1) parsing, ``MidiFile(path)``, with a tempo map for
    tick -> seconds and pretty_midi-compatible note on/off pairing (a
    note-off closes every open note of that pitch whose onset tick differs
    from the off tick); SMPTE time division is rejected
  * SMF writing (format 1, tempo track + one track per instrument),
    byte-identical to the JAX package's writer
  * get_end_time / remove_invalid_notes / get_piano_roll (sustain pedal
    and pitch bends) / get_beats / get_tempo_changes / synthesize, with
    pretty_midi's documented semantics where the reference depends on them
"""

from __future__ import annotations

import struct
from bisect import bisect_right
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


class TimedEvent:
    """A pitch bend or control change: (time, value[, number])."""

    __slots__ = ("time", "value", "number")

    def __init__(self, time: float, value: int, number: Optional[int] = None):
        self.time = float(time)
        self.value = int(value)
        self.number = number

    def __repr__(self):
        return (f"TimedEvent(time={self.time:.4f}, value={self.value}, "
                f"number={self.number})")


class Instrument:
    def __init__(self, program: int = 0, is_drum: bool = False, name: str = ""):
        self.program = int(program)
        self.is_drum = bool(is_drum)
        self.name = name
        self.notes: List[Note] = []
        self.pitch_bends: List[TimedEvent] = []
        self.control_changes: List[TimedEvent] = []

    def get_end_time(self) -> float:
        times = (
            [n.end for n in self.notes]
            + [e.time for e in self.pitch_bends]
            + [e.time for e in self.control_changes]
        )
        return max(times) if times else 0.0

    def remove_invalid_notes(self) -> None:
        self.notes = [n for n in self.notes if n.end > n.start]

    def get_piano_roll(
        self,
        fs: int = 100,
        times: Optional[np.ndarray] = None,
        pedal_threshold: Optional[int] = 64,
    ) -> np.ndarray:
        """Velocity piano roll with pretty_midi Instrument.get_piano_roll
        semantics (the reference consumes pretty_midi's defaults at
        music2midi/evaluation.py:34-35 and music2midi/plot_midi.py:118-119):

          * notes stamped as velocity over [int(start*fs), int(end*fs))
          * CC64 sustain pedal (value >= pedal_threshold) holds the running
            per-pitch maximum until release; None disables
          * pitch bends shift the roll by whole semitones plus a linear
            interpolation for the fractional part (2-semitone full range)
          * drum instruments produce zeros
          * times integration: column n is the mean over
            [round(times[n]*fs), round(times[n+1]*fs)); the final column
            stays zero, exactly like pretty_midi
        """
        if not self.notes:
            return np.zeros((128, 0))
        end_time = self.get_end_time()
        if times is not None and len(times) and times[-1] > end_time:
            end_time = float(times[-1])
        n_cols = int(fs * end_time)
        roll = np.zeros((128, n_cols))
        if self.is_drum:
            return roll if times is None else _integrate_roll(roll, fs, times)
        for note in self.notes:
            roll[note.pitch, int(note.start * fs):int(note.end * fs)] += (
                note.velocity
            )

        if pedal_threshold is not None:
            CC_SUSTAIN = 64
            time_pedal_on = 0
            is_pedal_on = False
            for cc in (
                e for e in self.control_changes if e.number == CC_SUSTAIN
            ):
                time_now = int(cc.time * fs)
                is_current_on = cc.value >= pedal_threshold
                if not is_pedal_on and is_current_on:
                    time_pedal_on = time_now
                    is_pedal_on = True
                elif is_pedal_on and not is_current_on:
                    sub = roll[:, time_pedal_on:time_now]
                    roll[:, time_pedal_on:time_now] = np.maximum.accumulate(
                        sub, axis=1
                    )
                    is_pedal_on = False

        ordered_bends = sorted(self.pitch_bends, key=lambda b: b.time)
        end_sentinel = TimedEvent(end_time, 0)
        for bend, nxt in zip(
            ordered_bends, ordered_bends[1:] + [end_sentinel]
        ):
            if abs(bend.value) < 1:
                continue
            semitones = 2.0 * bend.value / 8192.0
            bend_int = int(np.sign(semitones) * np.floor(np.abs(semitones)))
            bend_frac = float(np.abs(semitones - bend_int))
            lo, hi = int(bend.time * fs), int(nxt.time * fs)
            bent = np.zeros((128, max(hi - lo, 0)))
            if bend.value >= 0:
                if bend_int != 0:
                    bent[bend_int:] = roll[:-bend_int, lo:hi]
                else:
                    bent = roll[:, lo:hi].copy()
                bent[1:] = (1 - bend_frac) * bent[1:] + bend_frac * bent[:-1]
            else:
                if bend_int != 0:
                    bent[:bend_int] = roll[-bend_int:, lo:hi]
                else:
                    bent = roll[:, lo:hi].copy()
                bent[:-1] = (1 - bend_frac) * bent[:-1] + bend_frac * bent[1:]
            roll[:, lo:hi] = bent

        if times is None:
            return roll
        return _integrate_roll(roll, fs, times)


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
    """In-memory MIDI: instruments with absolute-seconds events + a tempo map.

    The tempo map is a list of (tick, seconds, seconds_per_tick) breakpoints.
    """

    def __init__(
        self,
        path: Optional[Union[str, Path]] = None,
        resolution: int = 384,
        initial_tempo: float = 120.0,
    ):
        self.resolution = int(resolution)
        self.instruments: List[Instrument] = []
        # (tick, time_s, sec_per_tick); constant tempo unless parsed otherwise
        self._tempo_map: List[Tuple[int, float, float]] = [
            (0, 0.0, 60.0 / (initial_tempo * self.resolution))
        ]
        self.time_signature_changes: List[Tuple[float, int, int]] = []
        if path is not None:
            self._parse(Path(path).read_bytes())

    # ------------------------------------------------------------------ #
    # queries                                                             #
    # ------------------------------------------------------------------ #

    def get_end_time(self) -> float:
        return max((i.get_end_time() for i in self.instruments), default=0.0)

    def remove_invalid_notes(self) -> None:
        for inst in self.instruments:
            inst.remove_invalid_notes()

    def get_piano_roll(
        self,
        fs: int = 100,
        times: Optional[np.ndarray] = None,
        pedal_threshold: Optional[int] = 64,
    ) -> np.ndarray:
        """Sum of instrument rolls, padded to the longest (pretty_midi
        PrettyMIDI.get_piano_roll: per-instrument pedal + pitch-bend
        processing happens before summation).

        With `times` given the result always has len(times) columns, even
        when every instrument is empty — an untrained model emitting zero
        notes must still produce a roll the evaluation/diff-plot consumers
        can compare against a non-empty target (pretty_midi itself returns
        (128, 0) here and crashes those consumers)."""
        n_cols = 0 if times is None else len(times)
        rolls = [
            inst.get_piano_roll(
                fs=fs, times=times, pedal_threshold=pedal_threshold
            )
            for inst in self.instruments
        ]
        if rolls:
            n_cols = max(n_cols, max(r.shape[1] for r in rolls))
        out = np.zeros((128, n_cols))
        for r in rolls:
            out[:, : r.shape[1]] += r
        return out

    def get_beats(self) -> np.ndarray:
        """Quarter-note beat times from the tempo map, starting at 0."""
        end_tick = self._time_to_tick(self.get_end_time())
        beats = []
        tick = 0
        while tick <= end_tick:
            beats.append(self._tick_to_time(tick))
            tick += self.resolution
        return np.array(beats)

    def get_tempo_changes(self) -> Tuple[np.ndarray, np.ndarray]:
        times = np.array([t for _, t, _ in self._tempo_map])
        tempi = np.array(
            [60.0 / (spt * self.resolution) for _, _, spt in self._tempo_map]
        )
        return times, tempi

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

    # ------------------------------------------------------------------ #
    # tick <-> time                                                       #
    # ------------------------------------------------------------------ #

    def _tick_to_time(self, tick: int) -> float:
        ticks = [t for t, _, _ in self._tempo_map]
        i = bisect_right(ticks, tick) - 1
        t0, s0, spt = self._tempo_map[i]
        return s0 + (tick - t0) * spt

    def _time_to_tick(self, time: float) -> int:
        """Seconds -> tick over the tempo map; a negative time is tick 0."""
        time = max(time, 0.0)
        times = [s for _, s, _ in self._tempo_map]
        i = bisect_right(times, time) - 1
        i = max(i, 0)
        t0, s0, spt = self._tempo_map[i]
        return int(round(t0 + (time - s0) / spt))

    # ------------------------------------------------------------------ #
    # parsing                                                             #
    # ------------------------------------------------------------------ #

    def _parse(self, data: bytes) -> None:
        if data[:4] != b"MThd":
            raise ValueError("not a Standard MIDI File (missing MThd)")
        hlen, fmt, ntracks, division = struct.unpack(">IHHH", data[4:14])
        if division & 0x8000:
            raise ValueError("SMPTE time division is not supported")
        self.resolution = division
        pos = 8 + hlen

        raw_tracks = []
        for _ in range(ntracks):
            if data[pos:pos + 4] != b"MTrk":
                raise ValueError("corrupt MIDI: missing MTrk chunk")
            tlen = struct.unpack(">I", data[pos + 4:pos + 8])[0]
            raw_tracks.append(data[pos + 8:pos + 8 + tlen])
            pos += 8 + tlen

        # pass 1: tempo map from all tracks (merged by tick)
        tempo_events: List[Tuple[int, float]] = []  # (tick, sec_per_tick)
        parsed_tracks = [list(_iter_events(t)) for t in raw_tracks]
        for events in parsed_tracks:
            for tick, ev in events:
                if ev[0] == "tempo":
                    tempo_events.append((tick, ev[1] / 1e6 / self.resolution))
        tempo_events.sort(key=lambda x: x[0])
        tempo_map: List[Tuple[int, float, float]] = []
        cur_spt = 60.0 / (120.0 * self.resolution)
        cur_tick, cur_time = 0, 0.0
        tempo_map.append((0, 0.0, cur_spt))
        for tick, spt in tempo_events:
            cur_time += (tick - cur_tick) * cur_spt
            cur_tick = tick
            cur_spt = spt
            if tempo_map and tempo_map[-1][0] == tick:
                tempo_map[-1] = (tick, cur_time, spt)
            else:
                tempo_map.append((tick, cur_time, spt))
        self._tempo_map = tempo_map

        # pass 2: notes / events per (track, channel, program)
        instruments: dict = {}

        def get_inst(track_i: int, channel: int, program: int, name: str
                     ) -> Instrument:
            key = (track_i, channel, program)
            if key not in instruments:
                inst = Instrument(
                    program=program, is_drum=(channel == 9), name=name
                )
                instruments[key] = inst
            return instruments[key]

        for track_i, events in enumerate(parsed_tracks):
            channel_program = [0] * 16
            track_name = ""
            # (channel, pitch) -> list of (start_tick, velocity, program)
            open_notes: dict = {}
            for tick, ev in events:
                kind = ev[0]
                if kind == "track_name":
                    track_name = ev[1]
                elif kind == "program":
                    channel_program[ev[1]] = ev[2]
                elif kind == "time_signature":
                    self.time_signature_changes.append(
                        (self._tick_to_time(tick), ev[1], ev[2])
                    )
                elif kind == "note_on":
                    _, channel, pitch, velocity = ev
                    open_notes.setdefault((channel, pitch), []).append(
                        (tick, velocity, channel_program[channel])
                    )
                elif kind == "note_off":
                    _, channel, pitch = ev
                    key = (channel, pitch)
                    if key not in open_notes:
                        continue
                    to_close = [
                        n for n in open_notes[key] if n[0] != tick
                    ]
                    to_keep = [n for n in open_notes[key] if n[0] == tick]
                    for start_tick, velocity, program in to_close:
                        inst = get_inst(track_i, channel, program, track_name)
                        inst.notes.append(
                            Note(
                                self._tick_to_time(start_tick),
                                self._tick_to_time(tick),
                                pitch,
                                velocity,
                            )
                        )
                    # pretty_midi semantics: keep the same-tick opens
                    # only when something was also closed; a bare
                    # same-tick on/off pair produces NO note
                    if to_close and to_keep:
                        open_notes[key] = to_keep
                    else:
                        del open_notes[key]
                elif kind == "pitch_bend":
                    _, channel, value = ev
                    inst = get_inst(
                        track_i, channel, channel_program[channel], track_name
                    )
                    inst.pitch_bends.append(
                        TimedEvent(self._tick_to_time(tick), value)
                    )
                elif kind == "control_change":
                    _, channel, number, value = ev
                    inst = get_inst(
                        track_i, channel, channel_program[channel], track_name
                    )
                    inst.control_changes.append(
                        TimedEvent(self._tick_to_time(tick), value, number)
                    )
        self.instruments = [
            inst for inst in instruments.values()
            if inst.notes or inst.pitch_bends or inst.control_changes
        ]
        for inst in self.instruments:
            inst.notes.sort(key=lambda n: (n.start, n.end, n.pitch))

    # ------------------------------------------------------------------ #
    # writing                                                             #
    # ------------------------------------------------------------------ #

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
        out = bytearray()
        last_tick = 0
        for tick, _, spt in self._tempo_map:
            usec_per_quarter = int(round(spt * self.resolution * 1e6))
            out += _varint(tick - last_tick)
            out += bytes([0xFF, 0x51, 0x03])
            out += struct.pack(">I", usec_per_quarter)[1:]
            last_tick = tick
        out += _varint(0) + bytes([0xFF, 0x2F, 0x00])
        return bytes(out)

    def _instrument_track_bytes(self, inst: Instrument) -> bytes:
        channel = 9 if inst.is_drum else 0
        events: List[Tuple[int, int, bytes]] = []  # (tick, order, payload)
        events.append((0, 0, bytes([0xC0 | channel, inst.program & 0x7F])))
        for cc in inst.control_changes:
            events.append(
                (
                    self._time_to_tick(cc.time),
                    1,
                    bytes([0xB0 | channel, cc.number & 0x7F, cc.value & 0x7F]),
                )
            )
        for pb in inst.pitch_bends:
            v = pb.value + 8192
            events.append(
                (
                    self._time_to_tick(pb.time),
                    1,
                    bytes([0xE0 | channel, v & 0x7F, (v >> 7) & 0x7F]),
                )
            )
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


# ---------------------------------------------------------------------- #
# SMF event iterator                                                      #
# ---------------------------------------------------------------------- #


def _varint(value: int) -> bytes:
    if value < 0:
        raise ValueError(f"negative delta time {value}")
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(out))


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value, pos


def _iter_events(track: bytes):
    """Yield (abs_tick, event_tuple) from one MTrk body, handling running
    status.  Event tuples:
      ("note_on", ch, pitch, vel) / ("note_off", ch, pitch)
      ("program", ch, program) / ("control_change", ch, number, value)
      ("pitch_bend", ch, value-8192) / ("tempo", usec_per_quarter)
      ("time_signature", num, den) / ("track_name", str)
    """
    pos = 0
    tick = 0
    status = 0
    n = len(track)
    while pos < n:
        delta, pos = _read_varint(track, pos)
        tick += delta
        b = track[pos]
        if b >= 0x80:
            status = b
            pos += 1
        if status == 0xFF:  # meta
            mtype = track[pos]
            mlen, pos = _read_varint(track, pos + 1)
            mdata = track[pos:pos + mlen]
            pos += mlen
            if mtype == 0x51 and mlen == 3:
                yield tick, ("tempo", int.from_bytes(mdata, "big"))
            elif mtype == 0x58 and mlen >= 2:
                yield tick, ("time_signature", mdata[0], 1 << mdata[1])
            elif mtype == 0x03:
                yield tick, ("track_name", mdata.decode("latin-1", "replace"))
            elif mtype == 0x2F:
                return
        elif status in (0xF0, 0xF7):  # sysex
            slen, pos = _read_varint(track, pos)
            pos += slen
        else:
            kind = status & 0xF0
            ch = status & 0x0F
            if kind == 0x90:
                pitch, vel = track[pos], track[pos + 1]
                pos += 2
                if vel == 0:
                    yield tick, ("note_off", ch, pitch)
                else:
                    yield tick, ("note_on", ch, pitch, vel)
            elif kind == 0x80:
                pitch = track[pos]
                pos += 2
                yield tick, ("note_off", ch, pitch)
            elif kind == 0xB0:
                yield tick, ("control_change", ch, track[pos], track[pos + 1])
                pos += 2
            elif kind == 0xE0:
                value = track[pos] | (track[pos + 1] << 7)
                pos += 2
                yield tick, ("pitch_bend", ch, value - 8192)
            elif kind == 0xC0:
                yield tick, ("program", ch, track[pos])
                pos += 1
            elif kind in (0xA0,):
                pos += 2
            elif kind in (0xD0,):
                pos += 1
            else:
                raise ValueError(f"unknown MIDI status byte 0x{status:02x}")
