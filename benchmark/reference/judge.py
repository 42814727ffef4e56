"""The comparisons that decide ``correct``, against the plain reference.

Serving (``logit_gap_mean``, ``note_mismatches``): the reference runs
once over each sampled chunk's audio with the tokens the program served,
teacher forced, and reads by how much each served token's logit lies
below the reference's best at its position, averaged over every served
position.  Every
served song's notes are decoded again from its served tokens by the
reference tokenizer, stitched in token time (chunk k starts at k * 60
steps), and compared as a multiset with the notes of the MIDI the program
returned for it.

Training (``train_gaps``): the reference takes the same three batches
from the same initial weights, with the step's dropout generator, and
gives each step's loss, each leaf's gradient norm at step 1 and each
leaf's change after step 3.  The program's numbers are compared by the
worst leaf, each gap measured against the reference's norm of that leaf or
of the median leaf, whichever is larger.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..frozen.tokenizer import decode_steps
from . import model as ref
from .adafactor import Adafactor

BLOCK_ROWS = 16  # chunks a block of the reference's forward


def song_notes(chunk_tokens: Sequence[np.ndarray], steps_per_chunk: int
               ) -> Counter:
    """A song's served tokens (one array a chunk) -> Counter of its notes
    (onset_step, offset_step, pitch)."""
    out: Counter = Counter()
    for k, toks in enumerate(chunk_tokens):
        out.update(decode_steps(toks, k * steps_per_chunk))
    return out


def note_mismatches(want: Counter, got: Counter) -> int:
    """Notes in one multiset and not the other."""
    return sum(((want - got) + (got - want)).values())


@torch.no_grad()
def mean_logit_gap(p: ref.Params, m: dict, mel_cfg: dict,
                   waves: np.ndarray, conds: np.ndarray,
                   tokens: Sequence[np.ndarray], device) -> float:
    """The mean over every served position of the given chunks of the
    reference's best logit above the served token's.  ``waves`` (n,
    S) float32 chunks, ``conds`` (n, n_cond), ``tokens``: per chunk the
    served sequence from the start token through EOS (or the cap)."""
    total, count = 0.0, 0
    order = np.argsort([len(t) for t in tokens])
    for lo in range(0, len(order), BLOCK_ROWS):
        rows = order[lo:lo + BLOCK_ROWS]
        T = max(len(tokens[i]) for i in rows)
        ids = np.zeros((len(rows), T), np.int64)
        valid = np.zeros((len(rows), T - 1), bool)
        for j, i in enumerate(rows):
            ids[j, :len(tokens[i])] = tokens[i]
            valid[j, :len(tokens[i]) - 1] = True
        wave = torch.from_numpy(waves[rows]).to(device)
        cond = torch.from_numpy(conds[rows]).long().to(device)
        mel = ref.log_mel(wave, **mel_cfg)
        drop = ref.Dropout(0.0, None)
        enc = ref.encode(p, m, ref.encoder_inputs(p, mel, cond), drop)
        ids_t = torch.from_numpy(ids).to(device)
        logits = ref.decode_logits(p, m, ids_t[:, :-1], enc, drop)
        served = torch.gather(logits, -1, ids_t[:, 1:, None])[..., 0]
        gap = (logits.max(-1).values - served)[
            torch.from_numpy(valid).to(device)]
        total += float(gap.double().sum())
        count += gap.numel()
    return total / max(count, 1)


def train_reference(p: ref.Params, m: dict, mel_cfg: dict,
                    batches: List[dict], generators: list) -> dict:
    """Three reference steps from ``p`` (float32 leaves, changed in place)
    -> {"loss": [3 floats], "grad_norm": {leaf: norm at step 1},
    "change_norm": {leaf: norm of the change after step 3}}."""
    start = {k: v.clone() for k, v in p.items()}
    for v in p.values():
        v.requires_grad_(True)
    opt = Adafactor(p)
    losses, grad_norm = [], {}
    for k, (batch, gen) in enumerate(zip(batches, generators)):
        for v in p.values():
            v.grad = None
        loss = ref.train_loss(p, m, mel_cfg, batch["wave"], batch["cond"],
                              batch["labels"], gen)
        loss.backward()
        grads = {n: v.grad for n, v in p.items()}
        if k == 0:
            grad_norm = {n: float(g.norm()) for n, g in grads.items()}
        opt.step(grads)
        losses.append(float(loss.detach()))
    change = {n: float((v.detach() - start[n]).norm()) for n, v in p.items()}
    return {"loss": losses, "grad_norm": grad_norm, "change_norm": change}


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   leaves: Sequence[str]) -> float:
    """max over ``leaves`` of |got - want| / max(want[leaf], median of
    want over ``leaves``)."""
    med = float(np.median([want[n] for n in leaves]))
    gaps = [abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in leaves]
    return float("inf") if any(np.isnan(gaps)) else max(gaps)


def moving_leaves(grad_norm: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move by round-off alone."""
    med = float(np.median(list(grad_norm.values())))
    return sorted(n for n, g in grad_norm.items() if g >= 1e-3 * med)
