"""Training/validation data pipeline.

Port of ``music2midi_tpu/data/dataset.py`` (the host-side equivalent of
the reference runtime dataset, reference music2midi/dataset.py:15-167),
feeding the port's train step:

  * per-song metadata YAML -> conditioning indices
  * __getitem__: rejection-sample a random 3-s window until it holds
    0 < notes <= max_notes_per_second * 3, load that window, 50% peak
    normalize, random transpose in [-6, +5] semitones (waveform via phase
    vocoder, pitches via integer shift)
  * NOTE (preserved reference quirk, SURVEY.md §2): windows are loaded at
    config.dataset.sample_rate (22050), not the model rate (16000) —
    training mel windows are therefore 259 frames vs 188 at inference,
    exactly as the reference trains (dataset.py:124-129 vs config.yaml:16)
  * DataLoader: prefetching workers, collating to the train step's Batch
    (labels tokenized + -100 padded), with the JAX loader's seeding, so
    one seed gives the same batches in both packages.

The port has no yaml: ``metadata.py::read_metadata`` reads what the
prep stages write (a mapping of scalars and of mappings of scalars) and
raises on any other YAML.  The pitch shift is the C++ phase vocoder of
``native.py`` where that library builds, which releases the interpreter
lock, so the loader's workers are threads, as the JAX loader's are with
its C++ library; without it ``dsp.py``'s numpy phase vocoder holds the
lock, and with augmentation on the workers are spawned processes (never
forked, since the parent may hold a CUDA context).
"""

from __future__ import annotations

import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, List, Mapping, Optional, Sequence, Union

import numpy as np

from .. import native
from ..audio import get_duration, load, normalize
from ..config import ConfigNode, resolve_config
from ..dsp import pitch_shift
from ..tokenizer import MidiTokenizer
from ..train.loop import Batch, pad_labels
from .metadata import read_metadata


def _warn(msg: str) -> None:
    """Loader-configuration warning (lazy logging import keeps the module
    import path free of it)."""
    import logging

    logging.getLogger(__name__).warning(msg)


class MetadataDict:
    """piano_id -> conditioning indices from per-song metadata YAMLs
    (reference dataset.py:15-39), read by ``read_metadata``."""

    def __init__(
        self,
        piano_ids: Sequence[str],
        data_dir: Union[str, Path],
        config: Union[ConfigNode, Mapping, None] = None,
    ):
        self.data_dir = Path(data_dir)
        cfg = resolve_config(config)
        self.key_dict = {
            key: {item: i for i, item in enumerate(cfg.conditioning[key])}
            for key in cfg.conditioning.keys()
        }
        self.meta = {}
        for pid in piano_ids:
            path = self.data_dir / "metadata" / f"{pid}.yaml"
            self.meta[pid] = read_metadata(path.read_text())

    def get(self, piano_id: str) -> List[int]:
        piano = self.meta[piano_id]["piano"]
        return [v[piano[k]] for k, v in self.key_dict.items()]


def get_notes_segment(
    notes: np.ndarray,
    start_time: float,
    end_time: float,
    shift_to_start_time: bool = False,
) -> np.ndarray:
    """Notes whose ONSET falls inside [start, end) (reference
    dataset.py:145-154 — offsets may extend past the window)."""
    ret = notes[(notes[:, 0] >= start_time) & (notes[:, 0] < end_time)].copy()
    if shift_to_start_time:
        ret[:, :2] -= start_time
    return ret


class Music2MIDIDataset:
    def __init__(
        self,
        data_dir: Union[str, Path],
        piano_ids: Sequence[str],
        config: Union[ConfigNode, Mapping, None] = None,
    ):
        self.config = resolve_config(config)
        self.data_dir = Path(data_dir)
        self.piano_ids = list(piano_ids)
        self.metadata = MetadataDict(self.piano_ids, data_dir, self.config)
        self.audio_paths = [
            str(self.data_dir / "audio" / f"{pid}.wav")
            for pid in self.piano_ids
        ]
        self.midi_notes = [
            np.load(self.data_dir / "midi_numpy" / f"{pid}.npy")
            for pid in self.piano_ids
        ]
        self.cond_indices = [self.metadata.get(pid) for pid in self.piano_ids]
        self._durations = [None] * len(self.piano_ids)
        # dataset.cache_audio: true -> decode each song ONCE at
        # dataset.sample_rate and slice windows from RAM, which collapses
        # the per-window load + resample to a memcpy.  Off by default:
        # per-window loading is the reference behavior (reference
        # dataset.py:124-129) and full-song decode trades RAM for it
        # (~230 MB per hour of 16 kHz audio).
        self._cache_audio = bool(self.config.dataset.get("cache_audio",
                                                         False))
        self._waveforms = [None] * len(self.piano_ids)
        # dataset.cache_augment_mb: > 0 -> memoize AUGMENTED windows.
        # The window grid is discrete (start times on a segment_duration
        # grid, transpose an integer in [-6, +5], normalize a coin flip),
        # so (song, window, normalize?, semitones) is a finite key space
        # and the phase vocoder — the dominant host op per sample —
        # recomputes the same shifted window over and over.  Entries store
        # the exact
        # uncached result (normalize-then-shift order preserved), so a
        # cached epoch is bit-identical to an uncached one; FIFO eviction
        # bounds RAM at ~cache_augment_mb.  Off by default: the reference
        # recomputes per window, and per-process caches under spawn
        # workers multiply RAM (prefer num_workers=0, as with
        # cache_audio).
        self._aug_cache_cap = int(
            float(self.config.dataset.get("cache_augment_mb", 0)) * 2**20
        )
        self._aug_cache = {} if self._aug_cache_cap > 0 else None
        self._aug_cache_bytes = 0
        self._aug_cache_lock = threading.Lock()
        self.aug_cache_hits = 0
        self.aug_cache_misses = 0
        # the pitch shift's route, fixed here and pickled to spawned
        # workers, so the batches do not depend on the kind of worker
        self.native_dsp = (bool(self.config.dataset.get("augment", True))
                           and native.available())

    def __len__(self) -> int:
        return len(self.piano_ids)

    def __getstate__(self):
        # spawn workers pickle the dataset: the lock is unpicklable and the
        # augment cache would ship a copy per worker — send it empty.  The
        # decoded-audio cache is likewise scrubbed: a populated corpus
        # (~230 MB per hour of 16 kHz audio) would otherwise be serialized
        # to every worker on every epoch's pool spawn; workers re-decode
        # lazily instead (the documented cache_audio × spawn caveat).
        state = self.__dict__.copy()
        state["_aug_cache_lock"] = None
        state["_aug_cache"] = {} if self._aug_cache is not None else None
        state["_aug_cache_bytes"] = 0
        state["_waveforms"] = [None] * len(self._waveforms)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._aug_cache_lock = threading.Lock()

    def _duration(self, index: int) -> float:
        if self._durations[index] is None:
            if self._cache_audio:
                sr = int(self.config.dataset.sample_rate)
                self._durations[index] = len(self._waveform(index)) / sr
            else:
                self._durations[index] = get_duration(self.audio_paths[index])
        return self._durations[index]

    def _waveform(self, index: int) -> np.ndarray:
        if self._waveforms[index] is None:
            w, _ = load(self.audio_paths[index],
                        sr=int(self.config.dataset.sample_rate))
            self._waveforms[index] = np.asarray(w, dtype=np.float32)
        return self._waveforms[index]

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None):
        """-> (waveform f32, notes (N,4), cond list[int]).  Randomness uses
        the passed Generator (reproducible across worker processes)."""
        if rng is None:
            rng = np.random.default_rng()
        cfg = self.config.dataset
        seg = float(cfg.segment_duration)
        max_notes = int(cfg.max_notes_per_second) * seg
        duration = self._duration(index)
        starts = np.arange(0, duration - seg, seg)
        if len(starts) == 0:
            starts = np.array([0.0])
        # rejection-sample a window with 0 < notes <= max (reference
        # dataset.py:110-121; bounded here to avoid the reference's
        # unbounded while-loop on empty songs)
        for _ in range(256):
            start_time = float(rng.choice(starts))
            notes_segment = get_notes_segment(
                self.midi_notes[index], start_time, start_time + seg,
                shift_to_start_time=True,
            )
            if 0 < len(notes_segment) <= max_notes:
                break
        else:
            raise RuntimeError(
                f"no valid {seg}s window in {self.piano_ids[index]}"
            )
        sr = int(cfg.sample_rate)
        if self._cache_audio:
            # window = RAM slice of the once-decoded song.  When the file
            # needs resampling this differs from per-window load by the
            # resampler's window-edge transient only (training windows are
            # augmentation fodder, not a parity surface).
            full = self._waveform(index)
            i0 = int(round(start_time * sr))
            waveform = full[i0:i0 + int(round(seg * sr))].copy()
        else:
            waveform, sr = load(
                self.audio_paths[index],
                sr=sr,
                offset=start_time,
                duration=seg,
            )
        target_len = int(round(seg * int(cfg.sample_rate)))
        if len(waveform) < target_len:
            waveform = np.pad(waveform, (0, target_len - len(waveform)))
        waveform = waveform[:target_len]
        # augment: true (reference default; dataset.py:122-135) applies
        # 50% peak-normalize + random transpose.  augment: false is for
        # eval-style corpora / dress-rehearsal runs where the phase
        # vocoder is the dominant host cost and transposition only slows
        # convergence on a tiny corpus.
        if bool(cfg.get("augment", True)):
            do_norm = rng.random() < 0.5
            step = int(rng.integers(-6, 6))
            cached = None
            key = (index, int(round(start_time * sr)), do_norm, step)
            # step == 0 windows skip the cache: no phase vocoder ran, so
            # memoizing them only spends capacity (and two full-window
            # copies) on entries that are nearly free to recompute.
            use_cache = self._aug_cache is not None and step != 0
            if use_cache:
                with self._aug_cache_lock:
                    cached = self._aug_cache.get(key)
                    if cached is not None:
                        self.aug_cache_hits += 1
                    else:
                        self.aug_cache_misses += 1
            if cached is not None:
                waveform = cached.copy()
            else:
                if do_norm:
                    waveform = normalize(waveform)
                if step != 0:
                    waveform = pitch_shift(waveform, sr, step,
                                           prefer_native=self.native_dsp)
                if use_cache:
                    entry = waveform.copy()
                    with self._aug_cache_lock:
                        prev = self._aug_cache.pop(key, None)
                        if prev is not None:  # concurrent double-miss
                            self._aug_cache_bytes -= prev.nbytes
                        self._aug_cache[key] = entry
                        self._aug_cache_bytes += entry.nbytes
                        while (self._aug_cache_bytes > self._aug_cache_cap
                               and len(self._aug_cache) > 1):
                            old = next(iter(self._aug_cache))
                            self._aug_cache_bytes -= (
                                self._aug_cache.pop(old).nbytes
                            )
            if step != 0:
                notes_segment[:, 2] += step
        return waveform, notes_segment, self.cond_indices[index]


_WORKER_DATASET = None  # set per worker process by _worker_init


def _worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_fetch(args):
    """Process-pool task: (index, seed) — the dataset itself is shipped
    once per worker via the initializer, not re-pickled per job."""
    index, seed = args
    rng = np.random.default_rng(seed)
    return _WORKER_DATASET.__getitem__(index, rng)


class DataLoader:
    """Prefetching loader over __getitem__, collated to the train step's
    Batch (reference DataLoader(batch=16, workers=4) + collate_fn,
    dataset.py:64-78,163-167).

    Workers are THREADS by default: the C++ pitch shift, rfft/irfft,
    scipy's resample_poly and file reads release the interpreter lock.
    Without the C++ library the pitch shift (numpy's phase vocoder) holds
    the lock, so with augmentation on and workers asked for, the loader
    then uses a spawn-context process pool, as the JAX loader does; so it
    does with ``use_processes=True``.  Spawn, never fork, because the
    parent may already hold a CUDA context.  Every job's randomness comes
    from a seed of its own and the dataset fixes its pitch-shift route,
    so the batches do not depend on the kind or number of workers."""

    def __init__(
        self,
        dataset: Music2MIDIDataset,
        batch_size: int = 16,
        num_workers: int = 4,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        use_processes: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(0, num_workers)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        augment = bool(dataset.config.dataset.get("augment", True))
        if (self.num_workers > 0 and not use_processes and augment
                and not dataset.native_dsp):
            _warn(
                "native DSP library not built (native.build_log(): "
                f"{native.build_log()[-500:]!r}): thread workers would "
                "serialize pitch_shift on the GIL; switching DataLoader to "
                "spawn process workers"
            )
            use_processes = True
        if use_processes and dataset._cache_audio:
            _warn(
                "dataset.cache_audio with process workers: the audio cache "
                "is per-worker and rebuilt every epoch (pools are "
                "re-spawned per __iter__) — expect RAM x num_workers and "
                "full re-decodes; prefer thread workers (or num_workers=0) "
                "when caching"
            )
        if use_processes and dataset._aug_cache is not None:
            _warn(
                "dataset.cache_augment_mb with process workers: the "
                "dataset pickles its augment cache EMPTY and worker pools "
                "are re-spawned per epoch, so the cache never warms and "
                "every window re-runs the phase vocoder; prefer thread "
                "workers (the native DSP built) or num_workers=0 when "
                "memoizing augmented windows"
            )
        self.use_processes = use_processes
        self.tokenizer = MidiTokenizer(dataset.config)
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        return order

    def __iter__(self) -> Iterator[Batch]:
        order = self._index_order()
        base_seed = (self.seed * 100003 + self.epoch) & 0x7FFFFFFF
        jobs = [(int(i), base_seed + k) for k, i in enumerate(order)]
        if self.num_workers > 0 and self.use_processes:
            import multiprocessing

            with ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_worker_init,
                initargs=(self.dataset,),
            ) as pool:
                yield from self._pooled(pool, _worker_fetch, jobs,
                                        chunksize=4)
        else:
            def fetch(job):
                index, seed = job
                return self.dataset.__getitem__(
                    index, np.random.default_rng(seed)
                )

            if self.num_workers > 0:
                with ThreadPoolExecutor(
                    max_workers=self.num_workers
                ) as pool:
                    yield from self._pooled(pool, fetch, jobs)
            else:
                yield from self._collate_stream(map(fetch, jobs))
        self.epoch += 1

    def _pooled(self, pool, fn, jobs, **kw) -> Iterator[Batch]:
        """Batches from ``pool``.  An epoch left early (the consumer stops
        iterating, as at ``--max_steps``) cancels the jobs not yet started,
        where the pool's exit would otherwise wait for the whole epoch."""
        try:
            yield from self._collate_stream(pool.map(fn, jobs, **kw))
        finally:
            pool.shutdown(cancel_futures=True)

    def _collate_stream(self, results) -> Iterator[Batch]:
        buf = []
        for item in results:
            buf.append(item)
            if len(buf) == self.batch_size:
                yield self._collate(buf)
                buf = []
        if buf and not self.drop_last:
            yield self._collate(buf)

    def _collate(self, items) -> Batch:
        waveforms = np.stack([w for w, _, _ in items]).astype(np.float32)
        tokens = [
            self.tokenizer.encode(notes) for _, notes, _ in items
        ]
        labels = pad_labels(tokens)
        cond = np.asarray([c for _, _, c in items], dtype=np.int32)
        return Batch(waveforms, labels, cond)
