"""The MIDI event vocabulary: notes to training labels, and served tokens
back to notes.

A frozen copy of ``music2midi_tpu_torch/tokenizer.py`` (``encode`` and the
decode state machine, the reference tokenizer's semantics): PAD 0, BOS 1,
EOS 2, ONSET 3, OFFSET 4, pitch tokens [5, 133), time tokens [133, 333) of
50 ms; any token >= 133 acts as a time token, an OFFSET closes every open
note of its pitch with an earlier onset, and notes left open are dropped.
Times here are whole 50-ms steps.
"""

from __future__ import annotations

from typing import List

import numpy as np

PAD, BOS, EOS, ONSET, OFFSET = 0, 1, 2, 3, 4
PITCH_OFFSET = 5
TIME_OFFSET = 133
NUM_TIME_TOKENS = 200
TIME_STEP = 0.05


def encode(notes: np.ndarray) -> np.ndarray:
    """(N, 4) notes, seconds from the window's start -> int64 tokens
    ending in EOS: per quantised time (ascending) [time][ONSET p...]
    [OFFSET p...], pitches in row order."""
    notes = np.asarray(notes, dtype=np.float64)
    if notes.size == 0:
        return np.array([EOS], dtype=np.int64)
    notes = notes.copy()
    notes[:, 1] = np.maximum(notes[:, 1], notes[:, 0] + TIME_STEP)
    q = notes[:, :2] / TIME_STEP
    q = np.rint(np.nextafter(q, q + 1))
    q = np.minimum(q, NUM_TIME_TOKENS - 1)
    pitch_tok = (notes[:, 2] + PITCH_OFFSET).astype(np.int64)
    tokens: List[int] = []
    for t in np.unique(q):
        tokens.append(int(t) + TIME_OFFSET)
        on = pitch_tok[q[:, 0] == t]
        if len(on):
            tokens.append(ONSET)
            tokens.extend(int(p) for p in on)
        off = pitch_tok[q[:, 1] == t]
        if len(off):
            tokens.append(OFFSET)
            tokens.extend(int(p) for p in off)
    tokens.append(EOS)
    return np.array(tokens, dtype=np.int64)


def decode_steps(tokens, start_idx: int = 0) -> List[tuple]:
    """Served tokens of one chunk -> [(onset_step, offset_step, pitch)] of
    its closed notes, times offset by ``start_idx`` steps."""
    rows: List[list] = []
    cur_time = cur_on = cur_pitch = -1
    for token in np.asarray(tokens).reshape(-1):
        token = int(token)
        if token == EOS:
            break
        if token in (BOS, PAD):
            continue
        if token == ONSET:
            cur_on = 1
        if token == OFFSET:
            cur_on = 0
        if token >= TIME_OFFSET:
            cur_time = start_idx + token - TIME_OFFSET
            cur_on = cur_pitch = -1
        elif token >= PITCH_OFFSET:
            cur_pitch = token - PITCH_OFFSET
        if cur_time == -1 or cur_on == -1 or cur_pitch == -1:
            continue
        if cur_on == 1:
            rows.append([cur_time, -1, cur_pitch])
        else:
            for row in rows:
                if row[0] < cur_time and row[1] == -1 and row[2] == cur_pitch:
                    row[1] = cur_time
        cur_pitch = -1
    return [tuple(r) for r in rows if r[1] != -1]
