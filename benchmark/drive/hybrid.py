"""The serving run of a hybrid-decoder configuration (``kinds/
songs_closed_loop_hybrid.py``): its engine, its run and its check.

The engine is the program's ``Music2MIDI`` with the configuration's
``port_config``, whose ``model.decoder`` block names the hybrid decoder:
the tower (mel, T5 encoder, conditioning) from the configuration's
weights file, the projector and decoder random from the run's seed (set
into the block's ``seed``).  A program without that decoder builds a T5
engine from the same config; the run refuses it before any work.

The recorder keeps the prefix the tower gave each batch (the engine's
``_encoder`` output: the program has no public hook for it), and after
the window (and the traced slice) the last call's decode state is read
from the engine's newest decode program (nor for that): the first Mamba
layer's final SSM state of every row of the call. Then the program is
freed, and the check (``judge``) holds the decoder to the float32
reference (``reference/granite_hybrid.py``), fed each sampled row's
served prefix (in float32: the tower is the model of record's, which the
record cells check) and its fed tokens: the mean gap of each served
token's logit below the reference's best over the sampled rows
(``logit_gap_mean``), and the relative distance of the program's final
SSM state from the reference's over the 16 slowest-decaying heads of the
first Mamba layer (``state_gap``: the norm of the difference over every
row of the call over that of the reference's; the reference runs that
layer's mixer input alone for it). That layer's state sees the prefix
and the embeddings alone, so its gap is the state's own precision and
the bfloat16 rounding of its inputs, not the routing of later layers; in
a slow head a state kept in bfloat16 stops decaying (a decay within half
an ulp of 1 rounds back to 1) and drifts, where in float32 the many
bfloat16 roundings of its inputs average out. The bfloat16 logits'
rounding sets the floor of ``logit_gap_mean`` (their spread is ~0.008),
so it holds a served token far from the reference's best, and
``state_gap`` is the check a lower precision of the state fails. Every
answer's notes are checked against its served tokens, ids past the MIDI
vocabulary read as no event (as the program reads them), and every
answer due must be present.
"""

from __future__ import annotations

import copy
import gc
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import generate
from ..frozen import tokenizer
from ..reference import granite_hybrid as href
from ..reference import judge
from . import serve
from .common import TracedSlice, checkpoint_path, sync

EVENT_VOCAB = 400  # ids at or past it are no event
SLOW_HEADS = 16  # the heads ``state_gap`` reads: an eighth of 128


def build_engine(root: Path, config: dict, device, serving: dict, seed: int):
    from music2midi_tpu_torch.infer import Music2MIDI

    port = copy.deepcopy(config["port_config"])
    block = port["model"]["decoder"]
    block["seed"] = int(seed)
    block["state_dtype"] = serving["state_dtype"]
    engine = Music2MIDI.from_npz(
        checkpoint_path(root, config), config=port,
        dtype=getattr(torch, serving["dtype"]), device=device,
        decode_max_length=int(serving["decode_max_length"]))
    if getattr(engine, "decoder", None) is None:
        raise RuntimeError("the program built no hybrid decoder for "
                           "model.decoder: it cannot serve this "
                           "configuration")
    engine.unroll = int(serving["unroll"])
    return engine


def final_state(engine, rows: int, heads: torch.Tensor) -> torch.Tensor:
    """The first Mamba layer's final SSM state over ``heads`` of the
    engine's last generation (its newest decode program), batch rows
    0..rows-1, float32 (rows, len(heads), P, N)."""
    from music2midi_tpu_torch.infer.decode import decode_programs

    prog = next(reversed(decode_programs(engine.decoder).values()))
    state = prog.state.ssm[0]
    return state[:rows].index_select(1, heads.to(state.device)).float()


def fed_tokens(row: np.ndarray, steps: int, pad: int) -> np.ndarray:
    """The tokens a row fed the loop in ``steps`` steps: its served tokens
    (start token through EOS or the cap), then PAD."""
    out = np.full(steps, pad, np.int64)
    out[:min(steps, len(row))] = row[:steps]
    return out


def slowest_heads(m: dict, seed: int, device) -> torch.Tensor:
    """The ``SLOW_HEADS`` heads of the first Mamba layer whose state decays
    slowest: by softplus(dt_bias) exp(A_log), the decay rate a step at a
    zero input, from the reference's weights."""
    i = list(m["layer_types"][:int(m["num_hidden_layers"])]).index("mamba")
    H = int(m["mamba_n_heads"])
    a_log = href.draw(f"layers.{i}.A_log", (H,), "A_log", seed, device)
    dt_bias = href.draw(f"layers.{i}.dt_bias", (H,), "dt_bias", seed, device)
    rate = torch.nn.functional.softplus(dt_bias) * torch.exp(a_log)
    return rate.argsort()[:min(SLOW_HEADS, H)]


def judge_hybrid(cell, device, served: List[tuple], last: Optional[dict],
                 seed: int) -> Dict[str, dict]:
    """The checks.  ``served``: per answer due, (song index, chunk tokens
    or None, MIDI or None); ``last``: the last call's ``rows`` (sampled
    batch rows), ``tokens`` (every row's served tokens), ``steps`` (the
    loop's steps), ``prefix`` (every row's served prefix), ``heads``
    (``slowest_heads``) and ``state`` (the program's final state of every
    row over those heads, ``final_state``)."""
    limits = cell.spec["check"]["limits"]
    config = cell.config
    href.strict_fp32()
    unanswered = sum(1 for _, toks, midi in served
                     if toks is None or midi is None)
    mismatches = sum(
        judge.note_mismatches(judge.song_notes(
            [np.where(t >= EVENT_VOCAB, tokenizer.PAD, t) for t in toks],
            serve.steps_per_chunk(config)), serve.midi_notes(midi))
        for _, toks, midi in served if toks is not None and midi is not None)
    gap = state_gap = float("inf")
    if last is not None and last["rows"]:
        prefix = last["prefix"].to(device).float()
        pad = int(config["port_config"]["model"]["t5"]["pad_token_id"])
        ids = torch.from_numpy(np.stack([fed_tokens(t, last["steps"], pad)
                                         for t in last["tokens"]])).to(device)
        rows = last["rows"]
        weight_dtype = getattr(torch, config["serving"]["dtype"])
        served_next = [torch.from_numpy(np.asarray(last["tokens"][r][1:],
                                                   np.int64)) for r in rows]
        gaps, _ = href.teacher_forced(config["model"], seed, weight_dtype,
                                      prefix[rows], ids[rows], served_next)
        gap = float(torch.cat(gaps).double().mean())
        want = href.first_mamba_state(config["model"], seed, weight_dtype,
                                      prefix, ids, last["heads"].to(device))
        got = last["state"].to(device)
        state_gap = float((got - want).norm() / want.norm())
    return {"logit_gap_mean": {"value": gap,
                               "limit": limits["logit_gap_mean"]},
            "state_gap": {"value": state_gap, "limit": limits["state_gap"]},
            "note_mismatches": {"value": mismatches, "limit": 0},
            "unanswered": {"value": unanswered, "limit": 0}}


def _sample_last(engine, recorder_call: dict, prefix: torch.Tensor,
                 counts: List[int], sample: int, seed: int,
                 model: dict) -> dict:
    """The last call's sampled batch rows, and of every row its served
    tokens and prefix (``prefix``: the call's batch's), the loop's steps,
    the slowest heads and the final state over them."""
    eos = int(engine.t5_config.eos_token_id)
    per_song = serve.song_tokens(recorder_call, counts, eos)
    where = [(j, k) for j, chunks in enumerate(per_song)
             for k in range(len(chunks))]
    stats = recorder_call["stats"]
    if len(stats) != 1:  # one batch a call: its rows are the call's chunks
        return {"rows": []}
    rng = np.random.default_rng([int(seed), 13])
    rows = sorted(rng.choice(len(where), min(sample, len(where)),
                             replace=False).tolist())
    heads = slowest_heads(model, seed, prefix.device)
    return {"rows": rows, "tokens": [per_song[j][k] for j, k in where],
            "steps": int(stats[0]["steps"]), "prefix": prefix[:len(where)],
            "heads": heads, "state": final_state(engine, len(where), heads)}


def run(root: Path, cell, seed: int, seconds: float, traced: bool, device,
        serving_override: Optional[dict], *, widths, window) -> dict:
    """One run of the cell -> its result (see run.py); ``widths`` and
    ``window`` as ``serve.run`` takes them."""
    config, traffic = cell.config, cell.traffic
    serving = {**config["serving"], **(serving_override or {})}
    sr = int(config["port_config"]["model"]["sample_rate"])
    n_categories = [len(v) for v in
                    config["port_config"]["conditioning"].values()]
    t_setup = time.perf_counter()
    try:  # a program without the hybrid decoder fails here, at once
        import music2midi_tpu_torch.models.granite_hybrid  # noqa: F401
    except ImportError as e:
        raise RuntimeError("the program has no hybrid decoder: it cannot "
                           "serve this configuration") from e
    job = generate.song_pool(traffic, seed, sr, n_categories, cell.pkg)
    engine = build_engine(root, config, device, serving, seed)
    counts = [serve.chunk_count(config, int(round(s * sr)))
              for s in generate.song_lengths(traffic)]
    serve._warm(engine, widths(engine, traffic, counts),
                serve.chunk_samples(config))
    songs = job.result()
    recorder = serve.Recorder(engine)
    encode = engine._encoder
    prefixes: List[torch.Tensor] = []

    def recorded(*args, **kwargs):  # the last batch's prefix is kept
        out = encode(*args, **kwargs)
        prefixes[:] = [out.detach().clone()]
        return out

    engine._encoder = recorded
    sync(device)
    setup_s = time.perf_counter() - t_setup

    out = window(engine, recorder, songs, cell, seed, seconds)
    out["setup_s"] = setup_s
    last_call = recorder.calls[-1] if recorder.calls else None
    if traced:
        sliced = TracedSlice()
        recorder_calls = len(recorder.calls)
        with sliced.run(device):
            window(engine, recorder, songs, cell, seed, seconds,
                   trace_slice=cell.spec["trace"])
        out["trace"] = {"slice": sliced,
                        "calls": recorder.calls[recorder_calls:]}
        if len(recorder.calls) > recorder_calls:
            last_call = recorder.calls[-1]
        recorder.calls = recorder.calls[:recorder_calls]
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    last = None
    if last_call is not None and prefixes:
        last = _sample_last(engine, last_call, prefixes[0], counts,
                            int(cell.spec["check"]["chunks"]), seed,
                            config["model"])
    out["ctx"] = {
        "calls": [{k: c[k] for k in ("t0", "t1", "stats", "keys")}
                  for c in recorder.calls],
        "requests": out.get("requests", []),
        "window_s": out["window_s"],
        "enc_len": engine.encoder_len,
        "model": config["model"],
        "peak_flops": float(config["peak_flops"]),
        "on_card": device.type == "cuda",
        "trace": out.get("trace"),
    }
    served = out.pop("served")
    del engine, recorder, recorded, prefixes
    gc.collect()  # the recorder and the engine refer to each other
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = judge_hybrid(cell, device, served, last, seed)
    return out
