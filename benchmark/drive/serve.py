"""What the serving kinds share (``kinds/songs_closed_loop.py``,
``kinds/songs_open_loop.py``): the engine, the recorder around it, the
run's set-up and the check of what the window served.

The engine is the program's, built from the configuration's ``serving``
block.  A recorder around the engine keeps, for every ``generate_batch``
call, its host times, its songs, the tokens each chunk batch served (a
copy on the card, taken as the batch returns) and the engine's
``last_decode_stats``.  After the window the program is freed and the
reference judges what the window served (``reference/judge.py``).
"""

from __future__ import annotations

import time
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import generate
from ..frozen import tokenizer
from ..reference import judge
from ..reference import model as ref
from .common import TracedSlice, checkpoint_path, sync

#: where the recorder reads a chunk batch's served tokens: the engine's
#: method that turns a batch into its tokens on the card (the engine has
#: no public hook for them)
TOKENS_AT = "_run_batch"


class Recorder:
    """Records every ``generate_batch`` call made through it."""

    def __init__(self, engine):
        self.engine = engine
        self.calls: List[dict] = []
        self._current: Optional[dict] = None
        run_batch = getattr(engine, TOKENS_AT, None)
        if run_batch is None:
            raise RuntimeError(
                f"the engine has no {TOKENS_AT}: the recorder cannot read "
                "the served tokens")

        def recorded(*args, **kwargs):
            tokens = run_batch(*args, **kwargs)
            self._current["tokens"].append(tokens.clone())
            return tokens

        setattr(engine, TOKENS_AT, recorded)

    def call(self, waves, conds, keys) -> list:
        """``generate_batch(waves, cond_indices=conds)``; ``keys`` names
        each song (its pool index, or its request)."""
        rec = {"keys": list(keys), "tokens": []}
        self._current = rec
        rec["t0"] = time.perf_counter()
        midis = self.engine.generate_batch(waves, cond_indices=conds)
        rec["t1"] = time.perf_counter()
        rec["stats"] = list(self.engine.last_decode_stats)
        rec["midis"] = midis
        self.calls.append(rec)
        return midis


def build_engine(root: Path, config: dict, device, serving: dict):
    from music2midi_tpu_torch.infer import Music2MIDI

    dtype = getattr(torch, serving["dtype"])
    engine = Music2MIDI.from_npz(
        checkpoint_path(root, config), config=config["port_config"],
        dtype=dtype, device=device,
        decode_max_length=int(serving["decode_max_length"]))
    engine.int8_kv = serving["int8_kv"]
    engine.kv_bits = int(serving["kv_bits"])
    engine.int8_weights = bool(serving["int8_weights"])
    engine.pallas_cross = bool(serving["pallas_cross"])
    engine.unroll = int(serving["unroll"])
    return engine


def chunk_samples(config: dict) -> int:
    """Samples per chunk of a song, as the configuration states them."""
    pc = config["port_config"]
    return int(pc["model"]["sample_rate"]
               * float(pc["dataset"]["segment_duration"]))


def steps_per_chunk(config: dict) -> int:
    """Token time steps per chunk: a chunk's offset in its song."""
    return round(float(config["port_config"]["dataset"]["segment_duration"])
                 / tokenizer.TIME_STEP)


def chunk_count(config: dict, n_samples: int) -> int:
    return max(1, -(-n_samples // chunk_samples(config)))


def _warm(engine, widths, split: int) -> None:
    """One ``generate_batch`` on silence at each batch width the traffic
    will use: builds the kernels and captures each width's decode
    program."""
    for b in sorted(set(widths)):
        engine.generate_batch([np.zeros(b * split, np.float32)])


def call_widths(engine, chunk_counts) -> set:
    """The batch widths of one call over songs of these chunk counts, by
    the engine's own bucketing."""
    max_bs = int(engine.config.inference.batch_size)
    total = int(sum(chunk_counts))
    widths = {engine._width(max_bs)} if total >= max_bs else set()
    if total % max_bs:
        widths.add(engine._width(total % max_bs))
    return widths


def song_tokens(call: dict, chunk_counts: List[int], eos: int
                 ) -> List[List[np.ndarray]]:
    """Per song of a recorded call: per chunk the served tokens from the
    start token through EOS (or the cap)."""
    rows = []
    for t in call["tokens"]:
        for row in t.cpu().numpy():
            hit = np.nonzero(row == eos)[0]
            rows.append(row[:hit[0] + 1] if len(hit) else row)
    out, at = [], 0
    for n in chunk_counts:
        out.append(rows[at:at + n])
        at += n
    return out


def midi_notes(midi) -> Counter:
    """The program's MIDI -> Counter of (onset_step, offset_step, pitch)."""
    return Counter((int(round(n.start / 0.05)), int(round(n.end / 0.05)),
                    int(n.pitch)) for inst in midi.instruments
                   for n in inst.notes)


def judge_served(root: Path, cell, device, songs,
                 served: List[tuple], seed: int) -> Dict[str, dict]:
    """The checks of a serving window.  ``served``: per answer due, (song
    index into ``songs``, its chunk tokens or None if no answer came, its
    MIDI or None)."""
    limits = cell.spec["check"]["limits"]
    split = chunk_samples(cell.config)
    ref.strict_fp32()
    unanswered = sum(1 for _, toks, midi in served
                     if toks is None or midi is None)
    mismatches = sum(
        judge.note_mismatches(
            judge.song_notes(toks, steps_per_chunk(cell.config)),
            midi_notes(midi))
        for _, toks, midi in served if toks is not None and midi is not None)
    answered = [i for i, (_, toks, m) in enumerate(served)
                if toks is not None and m is not None]
    gap = float("inf")
    if answered:
        longest = max(answered,
                      key=lambda i: max(len(t) for t in served[i][1]))
        rng = np.random.default_rng([int(seed), 11])
        others = [i for i in answered if i != longest]
        k = min(len(others), int(cell.spec["check"]["songs"]) - 1)
        sample = [longest] + list(rng.choice(others, k, replace=False))
        p = ref.load_params(checkpoint_path(root, cell.config), device)
        waves, conds, toks = [], [], []
        for i in sample:
            song = songs[served[i][0]]
            n = len(served[i][1])
            padded = np.zeros(n * split, np.float32)
            padded[:len(song.wave)] = song.wave
            waves.append(padded.reshape(n, split))
            conds.append(np.repeat(song.cond[None], n, axis=0))
            toks.extend(served[i][1])
        gap = judge.mean_logit_gap(
            p, cell.config["model"], cell.config["mel"],
            np.concatenate(waves), np.concatenate(conds), toks, device)
    return {"logit_gap_mean": {"value": gap,
                               "limit": limits["logit_gap_mean"]},
            "note_mismatches": {"value": mismatches, "limit": 0},
            "unanswered": {"value": unanswered, "limit": 0}}


Window = Callable[..., dict]


def run(root: Path, cell, seed: int, seconds: float, traced: bool,
        device, serving_override: Optional[dict], *,
        widths: Callable[[object, dict, List[int]], set],
        window: Window) -> dict:
    """One run of a serving cell -> its result (see run.py).  The kind
    gives ``widths(engine, traffic, chunk counts of the pool's songs)``,
    the batch widths to warm, and ``window(engine, recorder, songs, cell,
    seed, seconds, trace_slice=None)``, which drives the window (or, with
    ``trace_slice``, the traced slice) and returns ``window_s``, ``e2e``,
    ``attempted``, ``failed``, ``served`` and what else the run reports
    (``requests``, ``generator_late_s``)."""
    config, traffic = cell.config, cell.traffic
    serving = {**config["serving"], **(serving_override or {})}
    sr = int(config["port_config"]["model"]["sample_rate"])
    n_categories = [len(v) for v in
                    config["port_config"]["conditioning"].values()]
    t_setup = time.perf_counter()
    job = generate.song_pool(traffic, seed, sr, n_categories, cell.pkg)
    engine = build_engine(root, config, device, serving)
    counts = [chunk_count(config, int(round(s * sr)))
              for s in generate.song_lengths(traffic)]
    _warm(engine, widths(engine, traffic, counts), chunk_samples(config))
    songs = job.result()
    recorder = Recorder(engine)
    sync(device)
    setup_s = time.perf_counter() - t_setup

    out = window(engine, recorder, songs, cell, seed, seconds)
    out["setup_s"] = setup_s
    if traced:
        sliced = TracedSlice()
        recorder_calls = len(recorder.calls)
        with sliced.run(device):
            window(engine, recorder, songs, cell, seed, seconds,
                   trace_slice=cell.spec["trace"])
        out["trace"] = {"slice": sliced,
                        "calls": recorder.calls[recorder_calls:]}
        recorder.calls = recorder.calls[:recorder_calls]
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
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
    del engine, recorder
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = judge_served(root, cell, device, songs, served, seed)
    return out
