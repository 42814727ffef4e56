"""Batch detokenizer on the device: event tokens -> note arrays.

Port of ``music2midi_tpu/ops/detokenize.py``: the host tokenizer's serial
state machine re-expressed as data-parallel tensor ops, with the same
semantics (pinned against ``tokenizer.MidiTokenizer`` in the tests):

  1. running state (time index, onset/offset mode, pending pitch) is
     "the last value set at or before position i", with time tokens as
     segment resets: a running max over the positions where it was set;
  2. a pitch token emits at itself once a marker was seen in its
     segment; otherwise the LAST pending pitch of the segment emits at
     the segment's FIRST marker;
  3. an offset event closes EVERY still-open note of its pitch with a
     strictly earlier time index, the first such offset in token order
     winning.  The JAX package runs this as a length-L scan; here it is
     one (B, L, L) comparison and a first-match argmax.

Output is fixed-shape: slot i of (B, L, 4) holds the note whose onset was
emitted at token position i (velocity 80), with a validity mask.

Ids at or past ``EVENT_VOCAB`` (the model of record's 400) are no event:
they read as PAD, which changes no state, as the host tokenizer skips
them.  A decoder whose head covers more ids (the hybrid's 100,352) may
emit them.  Ids in [333, 400), outside the tokenizer's vocabulary but
inside the model's, keep the reference tokenizer's reading as time
tokens.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..tokenizer import EOS, EVENT_VOCAB, OFFSET, ONSET, PAD

PITCH_OFFSET = 5
TIME_OFFSET = 133
DEFAULT_VELOCITY = 80


def _last_set(vals: torch.Tensor, is_set: torch.Tensor) -> torch.Tensor:
    """Per row: v[i] = vals[j] for the last j <= i with is_set[j]; -1 if
    there is none."""
    B, L = vals.shape
    pos = torch.arange(L, device=vals.device).expand(B, L)
    idx = torch.where(is_set, pos, torch.full_like(pos, -1))
    last = torch.cummax(idx, dim=1).values
    got = torch.gather(vals, 1, last.clamp(min=0))
    return torch.where(last >= 0, got, torch.full_like(got, -1))


def _shift_right(x: torch.Tensor, fill: int) -> torch.Tensor:
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


@torch.no_grad()
def detokenize(tokens: torch.Tensor, start_idx: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, L), start_idx (B,) time offset per row ->
    (notes (B, L, 4) float32 [onset_idx, offset_idx, pitch, velocity],
     valid (B, L) bool).  Times are in 50 ms steps."""
    tokens = tokens.to(torch.int64)
    tokens = torch.where(tokens >= EVENT_VOCAB, PAD, tokens)
    B, L = tokens.shape
    dev = tokens.device
    pos = torch.arange(L, device=dev).expand(B, L)
    neg = torch.full_like(tokens, -1)

    # validity: strictly before the first EOS
    eos_mask = tokens == EOS
    has_eos = eos_mask.any(dim=1, keepdim=True)
    first_eos = eos_mask.to(torch.int8).argmax(dim=1, keepdim=True)
    valid = torch.where(has_eos, pos < first_eos, torch.ones_like(eos_mask))

    is_time = valid & (tokens >= TIME_OFFSET)
    is_pitch = valid & (tokens >= PITCH_OFFSET) & (tokens < TIME_OFFSET)
    is_on_m = valid & (tokens == ONSET)
    is_off_m = valid & (tokens == OFFSET)
    is_marker = is_on_m | is_off_m

    time_val = start_idx.to(torch.int64)[:, None] + tokens - TIME_OFFSET
    cur_time = _last_set(torch.where(is_time, time_val, neg), is_time)
    on_val = torch.where(is_on_m, 1, torch.where(is_off_m, 0, neg))
    cur_on = _last_set(on_val, is_marker | is_time)

    pend_val = torch.where(is_pitch, tokens - PITCH_OFFSET, neg)
    incl_pending = _last_set(pend_val, is_pitch | is_time | is_marker)
    excl_pending = _shift_right(incl_pending, -1)

    marker_flag = torch.where(is_marker, 1, 0)
    incl_marker = _last_set(marker_flag, is_marker | is_time)
    excl_marker = _shift_right(incl_marker, -1)
    first_marker_of_seg = is_marker & (excl_marker != 1)

    emit_pitch = is_pitch & (cur_time >= 0) & (cur_on >= 0)
    emit_marker = first_marker_of_seg & (excl_pending >= 0) & (cur_time >= 0)
    e_emit = emit_pitch | emit_marker
    e_pitch = torch.where(emit_pitch, tokens - PITCH_OFFSET,
                          torch.where(emit_marker, excl_pending, neg))
    e_on = torch.where(emit_pitch, cur_on,
                       torch.where(is_on_m, 1, 0))
    e_time = cur_time

    # pairing: slot i is closed by the first offset event j > i of the same
    # pitch with a strictly later time
    open_slot = e_emit & (e_on == 1)
    off_event = e_emit & (e_on == 0)
    closes = (
        open_slot[:, :, None]
        & off_event[:, None, :]
        & (pos[:, None, :] > pos[:, :, None])
        & (e_pitch[:, :, None] == e_pitch[:, None, :])
        & (e_time[:, :, None] < e_time[:, None, :])
    )  # (B, i, j)
    closed = closes.any(dim=2)
    first_j = closes.to(torch.int8).argmax(dim=2)
    offsets = torch.where(closed, torch.gather(e_time, 1, first_j), neg)

    note_valid = open_slot & (offsets != -1)
    notes = torch.stack(
        [
            e_time.to(torch.float32),
            offsets.to(torch.float32),
            e_pitch.to(torch.float32),
            torch.full((B, L), float(DEFAULT_VELOCITY), dtype=torch.float32,
                       device=dev),
        ],
        dim=-1,
    )
    return notes, note_valid


def detokenize_to_host(
    tokens: torch.Tensor,
    start_idx: torch.Tensor,
    time_step: float = 0.05,
    cutoff_time: Optional[float] = None,
) -> List[np.ndarray]:
    """Device detokenize + host trim: one (N_i, 4) float64 note array in
    seconds per row, as ``MidiTokenizer.decode`` gives per chunk."""
    notes, valid = detokenize(tokens, start_idx)
    notes = notes.cpu().numpy().astype(np.float64)
    valid = valid.cpu().numpy()
    out = []
    for b in range(notes.shape[0]):
        row = notes[b][valid[b]]
        row[:, :2] *= time_step
        if cutoff_time is not None:
            row = row[row[:, 0] < cutoff_time]
            row[:, 1] = np.minimum(row[:, 1], cutoff_time)
        out.append(row)
    return out
