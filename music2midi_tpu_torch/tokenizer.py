"""MIDI event tokenizer: note tuples <-> event-token sequences.

The port's own copy of ``music2midi_tpu/tokenizer.py``: the encoder
(``__call__``, ``encode``: the training labels) and the decoder.

Behavior-equivalent to the reference tokenizer (reference:
music2midi/tokenizer.py:18-267) but implemented as pure NumPy on the
host — the device-side batch detokenizer with identical semantics lives
in `music2midi_tpu_torch.ops.detokenize`; this one is its cross-check
(``Music2MIDI(device_detokenize=False)``).

Vocabulary layout (reference tokenizer.py:11-24, config.yaml:32-38):
  PAD=0, BOS=1, EOS=2, ONSET=3, OFFSET=4,
  pitch tokens  [5, 133)   — 128 MIDI pitches,
  time tokens   [133, 333) — 200 steps of 50 ms = 10 s addressable,
  tokens >= 333 are unused by the encoder; the decoder state machine treats
  ANY token >= 133 as a time token (reference tokenizer.py:187-189), so an
  invalid token t in [333, 400) acts as time index t-133 in [200, 267).

Deliberately preserved reference quirks (needed for token/note parity):
  * An OFFSET event closes *every* open note of that pitch whose onset is
    strictly earlier — not just the first.  (In the reference this arises
    from fancy-indexing with the whole np.where result,
    tokenizer.py:256-265.)
  * Notes still open at end of sequence (offset == -1) are dropped
    (reference tokenizer.py:157).
  * "sequential" decode mode decodes each chunk independently (open notes do
    NOT carry across chunk boundaries) and offsets chunk k's time indices by
    k * round(duration_per_batch / time_step) (reference tokenizer.py:71-83).
"""

from __future__ import annotations

from typing import Iterable, List, Literal, Optional, Sequence, Union

import numpy as np

from .config import ConfigNode, resolve_config

PAD = 0
BOS = 1
EOS = 2
ONSET = 3
OFFSET = 4


class MidiTokenizer:
    """notes[(onset_s, offset_s, pitch, velocity)] <-> event tokens."""

    def __init__(self, config: Optional[Union[str, ConfigNode]] = None):
        cfg = resolve_config(config)
        tok_cfg = cfg.tokenizer
        self.config = tok_cfg
        self.time_step: float = tok_cfg.midi_quantize_ms / 1000.0
        self.pitch_token_offset: int = int(tok_cfg.vocab_size.special)
        self.time_token_offset: int = self.pitch_token_offset + int(
            tok_cfg.vocab_size.pitch
        )
        self.num_time_tokens: int = int(tok_cfg.vocab_size.time)
        self.default_velocity: int = int(tok_cfg.default_velocity)
        self.vocab_size: int = (
            self.time_token_offset + self.num_time_tokens
        )  # 333 used; model vocab is padded to 400 (config.yaml:25)

    # ------------------------------------------------------------------ #
    # encode                                                              #
    # ------------------------------------------------------------------ #

    def __call__(
        self,
        notes_batch: Iterable[np.ndarray],
        cutoff_time: Optional[float] = None,
    ) -> np.ndarray:
        """Tokenize a batch of note arrays -> int64 [B, L] padded with PAD
        (reference tokenizer.py:86-96, which pads with pad_sequence)."""
        if not isinstance(notes_batch, Iterable):
            raise TypeError("notes should be passed in batch")
        seqs = [self.encode(notes, cutoff_time) for notes in notes_batch]
        max_len = max(len(s) for s in seqs)
        out = np.full((len(seqs), max_len), PAD, dtype=np.int64)
        for i, s in enumerate(seqs):
            out[i, : len(s)] = s
        return out

    def encode(
        self, notes: np.ndarray, cutoff_time: Optional[float] = None
    ) -> np.ndarray:
        """Single note array -> int64 token sequence ending in EOS.

        Semantics of reference tokenizer.py:98-141 + _get_tokens (202-222):
        per unique quantized time index (ascending), emit
        [time][ONSET p...][OFFSET p...], pitches in input row order.
        """
        notes = np.asarray(notes, dtype=np.float64)
        if notes.size == 0:
            return np.array([EOS], dtype=np.int64)

        notes = notes.copy()
        if cutoff_time is not None:
            notes = notes[notes[:, 0] < cutoff_time]

        # clamp min note length to one step (in seconds, pre-quantization)
        notes[:, 1] = np.maximum(notes[:, 1], notes[:, 0] + self.time_step)
        # quantize: half-up rounding, then clip to the time vocab
        q = notes[:, :2] / self.time_step
        q = np.rint(np.nextafter(q, q + 1))
        q = np.minimum(q, self.num_time_tokens - 1)
        onset_idx = q[:, 0]
        offset_idx = q[:, 1]
        # torch .long() truncates toward zero; pitches are ints in practice
        pitch_tok = (notes[:, 2] + self.pitch_token_offset).astype(np.int64)

        tokens: List[int] = []
        for t in np.unique(q):
            tokens.append(int(t) + self.time_token_offset)
            on = pitch_tok[onset_idx == t]
            if len(on) > 0:
                tokens.append(ONSET)
                tokens.extend(int(p) for p in on)
            off = pitch_tok[offset_idx == t]
            if len(off) > 0:
                tokens.append(OFFSET)
                tokens.extend(int(p) for p in off)
        tokens.append(EOS)
        return np.array(tokens, dtype=np.int64)

    # ------------------------------------------------------------------ #
    # decode                                                              #
    # ------------------------------------------------------------------ #

    def decode(
        self,
        tokens_batch: Iterable[Union[np.ndarray, Sequence[int]]],
        mode: Literal["batched", "sequential"] = "batched",
        duration_per_batch: Optional[float] = None,
        cutoff_time: Optional[float] = None,
    ) -> Union[List[np.ndarray], np.ndarray]:
        """Decode token sequences back to note arrays.

        mode="batched":    each sequence independently -> list of (N_i, 4)
        mode="sequential": chunked outputs of one song stitched in token time
                           -> single (N, 4) array (reference tokenizer.py:71-83)
        """
        if mode == "batched":
            return [self._decode(tokens, 0, cutoff_time) for tokens in tokens_batch]
        if mode == "sequential":
            if duration_per_batch is None:
                raise ValueError(
                    'duration_per_batch is required for mode="sequential"'
                )
            n_steps = round(duration_per_batch / self.time_step)
            parts = [
                self._decode(tokens, i * n_steps, cutoff_time)
                for i, tokens in enumerate(tokens_batch)
            ]
            if not parts:
                return np.zeros((0, 4), dtype=np.float64)
            return np.concatenate(parts)
        raise ValueError(f"Invalid argument mode={mode}")

    def _decode(
        self,
        tokens: Union[np.ndarray, Sequence[int]],
        start_idx: int = 0,
        cutoff_time: Optional[float] = None,
    ) -> np.ndarray:
        notes = self._run_state_machine(np.asarray(tokens).reshape(-1), start_idx)
        # drop notes that were never closed
        notes = notes[notes[:, 1] != -1]
        notes[:, :2] = notes[:, :2] * self.time_step
        if cutoff_time is not None:
            notes = notes[notes[:, 0] < cutoff_time]
            notes[:, 1] = np.minimum(notes[:, 1], cutoff_time)
        return notes

    def _run_state_machine(self, tokens: np.ndarray, start_idx: int) -> np.ndarray:
        """The reference decode state machine (tokenizer.py:169-200,242-267).

        State: (cur_time_idx, cur_note_on, cur_note); a pitch token with full
        state emits an onset (appends an open note) or an offset (closes all
        open notes of that pitch with strictly earlier onset).
        """
        rows: List[List[float]] = []  # [onset_idx, offset_idx, pitch, velocity]
        cur_time = -1
        cur_on = -1  # 1 after ONSET, 0 after OFFSET, -1 after a time token
        cur_pitch = -1
        for token in tokens:
            token = int(token)
            if token == EOS:
                break
            if token in (BOS, PAD):
                continue
            if token == ONSET:
                cur_on = 1
            if token == OFFSET:
                cur_on = 0
            if token >= self.time_token_offset:
                # any token >= 133 acts as a time token — including the
                # unused ids [333, 400) a model may emit
                cur_time = start_idx + token - self.time_token_offset
                cur_on = -1
                cur_pitch = -1
            elif token >= self.pitch_token_offset:
                cur_pitch = token - self.pitch_token_offset

            if cur_time == -1 or cur_on == -1 or cur_pitch == -1:
                continue
            if cur_on == 1:
                rows.append(
                    [float(cur_time), -1.0, float(cur_pitch),
                     float(self.default_velocity)]
                )
            else:
                # close ALL open notes of this pitch with earlier onset
                for row in rows:
                    if row[0] < cur_time and row[1] == -1 and row[2] == cur_pitch:
                        row[1] = float(cur_time)
            cur_pitch = -1
        if not rows:
            return np.zeros((0, 4), dtype=np.float64)
        return np.array(rows, dtype=np.float64)

    # ------------------------------------------------------------------ #
    # introspection                                                       #
    # ------------------------------------------------------------------ #

    def to_string(self, tokens: Iterable[int]) -> List[str]:
        """Human-readable token names (reference tokenizer.py:26-44)."""
        names = {PAD: "PAD", BOS: "BOS", EOS: "EOS", ONSET: "ONSET",
                 OFFSET: "OFFSET"}

        def _one(token: int) -> str:
            token = int(token)
            if token in names:
                return names[token]
            if token >= self.time_token_offset:
                return f"time_{token - self.time_token_offset}"
            if token >= self.pitch_token_offset:
                return f"note_{token - self.pitch_token_offset}"
            raise ValueError(f"Invalid token '{token}'")

        return [_one(t) for t in tokens]
