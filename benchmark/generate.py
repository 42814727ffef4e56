"""The one traffic generator: every cell's inputs, from a traffic mix's
parameters and ``--seed``.

A mix (``benchmark/traffic/<mix>.json``) names its runner by ``kind``
(``benchmark/kinds/<kind>.py``), the renderer of its songs by ``profile``
(``benchmark/profiles/<profile>.py``) and, for an open loop, its arrival
process by ``arrivals`` (``benchmark/arrivals/<arrivals>.py``); the rest
are parameters:

* a pool of ``songs`` songs of ``seconds_min`` to ``seconds_max``
  seconds (``song_pool``);
* requests one song each at the arrival process's times, the songs in a
  seeded round-robin over the pool (``arrivals``);
* ``windows`` windows of ``window_seconds`` cut from the pool, labelled
  by the frozen tokenizer, in batches of ``batch`` (``train_batches``).

Every seed gets the same work: song i of a pool has the same length (the
pool's lengths are ``songs`` points evenly spaced over [``seconds_min``,
``seconds_max``]), the same tempo (bar ``bars[i % len(bars)]`` seconds)
and the same conditioning (genre i mod the genres, difficulty
(i + i // genres) mod the difficulties) for every seed, and each batch
holds the same number of windows.  The seed draws the music (key,
progression, melody, dynamics, the mix) and the order of requests and
windows.  Songs are rendered on a pool of spawned processes, one a host
core, longest first.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import List, NamedTuple

import numpy as np

from . import spec
from .frozen import tokenizer


class Song(NamedTuple):
    wave: np.ndarray  # (S,) float32 at the model rate
    notes: np.ndarray  # (N, 4) performed notes, seconds
    cond: np.ndarray  # (n_cond,) int64 conditioning indices


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), *stream])


def _render(pkg: str, profile: str, entropy: tuple, seconds: float,
            sr: int, bar: float):
    return spec.load("profiles", profile, Path(pkg)).render(
        entropy, seconds, sr, bar)


class SongJob:
    """Songs rendering on a process pool; ``result()`` waits for them."""

    def __init__(self, profile: str, seed: int, lengths: List[float],
                 bars: List[float], conds: np.ndarray, sr: int,
                 pkg: Path = spec.PKG):
        self.conds = conds
        workers = max(1, min(len(lengths), os.cpu_count() or 1))
        self._pool = ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"))
        order = np.argsort(lengths, kind="stable")[::-1]
        self._futures = {int(i): self._pool.submit(
            _render, str(pkg), profile, (int(seed), 7, int(i)), float(lengths[i]), sr,
            float(bars[i])) for i in order}

    def result(self) -> List[Song]:
        out = []
        try:
            for i in range(len(self._futures)):
                wave, notes = self._futures[i].result()
                # unpickled arrays keep a dtype object equal to float32 but
                # not numpy's own, and np.asarray(view, np.float32) then
                # makes a new view: copy into an array of numpy's own
                own = np.empty(wave.shape, np.float32)
                own[:] = wave
                out.append(Song(own, notes, self.conds[i]))
            return out
        finally:
            self._pool.shutdown(wait=True, cancel_futures=True)


def song_lengths(traffic: dict) -> np.ndarray:
    return np.round(np.linspace(float(traffic["seconds_min"]),
                                float(traffic["seconds_max"]),
                                int(traffic["songs"])), 3)


def pool_conds(n: int, n_categories: List[int]) -> np.ndarray:
    """(n, 2) conditioning indices of a pool's songs: every genre in turn,
    each difficulty against each genre in turn."""
    genres, levels = n_categories
    i = np.arange(n)
    return np.stack([i % genres, (i + i // genres) % levels],
                    axis=1).astype(np.int64)


def song_pool(traffic: dict, seed: int, sr: int,
              n_categories: List[int], pkg: Path = spec.PKG) -> SongJob:
    """Start rendering the mix's pool of songs."""
    lengths = song_lengths(traffic)
    bars = [traffic["bars"][i % len(traffic["bars"])]
            for i in range(len(lengths))]
    return SongJob(traffic["profile"], seed, list(lengths), bars,
                   pool_conds(len(lengths), n_categories), sr, pkg)


def arrivals(traffic: dict, seed: int, seconds: float,
             pkg: Path = spec.PKG):
    """-> (scheduled times (n,), pool index per request (n,)) for the
    requests due in [0, seconds): the times from the mix's arrival
    process, the songs in a seeded round-robin over the pool."""
    times = np.asarray(spec.load("arrivals", traffic["arrivals"], pkg)
                       .schedule(traffic, seed, seconds), np.float64)
    n = len(times)
    pool = int(traffic["songs"])
    which = np.concatenate([_rng(seed, 4, k).permutation(pool)
                            for k in range(-(-n // pool))])[:n]
    return times, which


class TrainBatch(NamedTuple):
    wave: np.ndarray  # (B, S) float32
    labels: np.ndarray  # (B, L) int64, -100 past each row's EOS
    cond: np.ndarray  # (B, n_cond) int64


def train_batches(traffic: dict, songs: List[Song], seed: int, sr: int
                  ) -> List[TrainBatch]:
    """``windows`` of the ``window_seconds`` windows of the songs whose
    notes (by onset) number 1 to ``max_notes``, drawn by the seed, each
    labelled by the frozen tokenizer from the notes with onsets inside
    it, in batches of ``batch``."""
    seg = float(traffic["window_seconds"])
    n_seg = int(round(seg * sr))
    windows = []
    for song in songs:
        for k in range(int(len(song.wave) // n_seg)):
            t0 = k * seg
            on = song.notes[:, 0]
            notes = song.notes[(on >= t0) & (on < t0 + seg)].copy()
            if not 0 < len(notes) <= int(traffic["max_notes"]):
                continue
            notes[:, :2] -= t0
            windows.append((song.wave[k * n_seg:(k + 1) * n_seg],
                            tokenizer.encode(notes), song.cond))
    want = int(traffic["windows"])
    if len(windows) < want:
        raise RuntimeError(f"{len(windows)} windows with notes; the mix "
                           f"asks for {want}")
    order = _rng(seed, 5).permutation(len(windows))[:want]
    b = int(traffic["batch"])
    out = []
    for lo in range(0, want - b + 1, b):
        rows = [windows[i] for i in order[lo:lo + b]]
        width = max(len(r[1]) for r in rows)
        labels = np.full((b, width), -100, np.int64)
        for j, r in enumerate(rows):
            labels[j, :len(r[1])] = r[1]
        out.append(TrainBatch(np.stack([r[0] for r in rows]), labels,
                              np.stack([r[2] for r in rows])))
    return out
