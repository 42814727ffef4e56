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

The port has no yaml: ``read_metadata`` reads what
``data/synthesize_corpus.py`` and the downloader write with
``yaml.safe_dump`` (a mapping of scalars and of mappings of scalars) and
raises on any other YAML.  The pitch shift is ``dsp.py``'s numpy phase
vocoder (the JAX package's optional C++ one is not ported), which holds
the interpreter lock, so with augmentation on the loader's workers are
spawned processes, as the JAX loader's are without its C++ library;
never forked, since the parent may hold a CUDA context.
"""

from __future__ import annotations

import re
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, List, Mapping, Optional, Sequence, Union

import numpy as np

from ..audio import get_duration, load, normalize
from ..config import ConfigNode, resolve_config
from ..dsp import pitch_shift
from ..tokenizer import MidiTokenizer
from ..train.loop import Batch, pad_labels


def _warn(msg: str) -> None:
    """Loader-configuration warning (lazy logging import keeps the module
    import path free of it)."""
    import logging

    logging.getLogger(__name__).warning(msg)


# YAML 1.1 plain-scalar resolution, as PyYAML's SafeLoader resolves it,
# for the forms yaml.safe_dump writes (null, bools, decimal ints, floats);
# a plain scalar of another resolvable form (octal, hex, binary or
# sexagesimal numbers, timestamps, merge keys) raises
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_DECIMAL = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"""^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$""", re.X)
_INF_NAN = re.compile(r"^(?:[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_UNSUPPORTED = re.compile(r"""^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+
                          |[-+]?0x[0-9a-fA-F_]+
                          |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?
                          |[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=)$""", re.X)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _plain_scalar(text: str):
    """A plain scalar -> None / bool / int / float / str (YAML 1.1)."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _DECIMAL.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF_NAN.match(text):
        return float(text.lower().replace(".", ""))
    if _UNSUPPORTED.match(text):
        raise ValueError(f"unsupported YAML scalar {text!r}")
    return text


def _double_quoted(body: str) -> str:
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        code = body[i + 1]
        if code in _HEX_ESCAPES:
            n = _HEX_ESCAPES[code]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        elif code in _ESCAPES:
            out.append(_ESCAPES[code])
            i += 2
        else:
            raise ValueError(f"unsupported YAML escape \\{code}")
    return "".join(out)


def _fold(lines: List[str], quote: str) -> str:
    """Join a scalar's lines by YAML line folding: a line break is a
    space, each empty line a newline; in double quotes a break after an
    unescaped backslash joins the lines."""
    text, breaks = lines[0], 0
    for line in lines[1:]:
        if not line:
            breaks += 1
            continue
        trailing = len(text) - len(text.rstrip("\\"))
        if quote == '"' and not breaks and trailing % 2 == 1:
            text = text[:-1] + line
        else:
            text += "\n" * breaks if breaks else " "
            text += line
        breaks = 0
    return text


def _scalar(lines: List[str]):
    """The lines of one scalar (the first after ``key:``, then its
    continuation lines, stripped; "" for an empty line) -> its value."""
    first = lines[0]
    quote = first[0] if first[0] in "'\"" else ""
    text = _fold(lines, quote)
    if quote:
        if len(text) < 2 or not text.endswith(quote):
            raise ValueError(f"unterminated YAML scalar {text!r}")
        body = text[1:-1]
        return body.replace("''", "'") if quote == "'" \
            else _double_quoted(body)
    if text == "{}":
        return {}
    if first[0] in "[{|>&*!%@`#" or first in ("-", "?") \
            or first.startswith(("- ", "? ")) or " #" in text \
            or any(line.startswith("#") for line in lines):
        raise ValueError(f"unsupported YAML value {text!r}")
    return _plain_scalar(text)


_ENTRY = re.compile(r"""^('(?:[^']|'')*'   # single-quoted key
                     |"(?:[^"\\]|\\.)*"    # double-quoted key
                     |[^'"\s#](?:[^:]|:(?=\S))*?)  # plain key
                     :(?:\s+(.*))?$""", re.X)


def read_metadata(text: str) -> dict:
    """A metadata file as ``yaml.safe_dump`` writes it -> the same value
    ``yaml.safe_load`` gives: a mapping whose values are scalars or
    mappings of scalars (``{}`` for an empty one).  Raises ValueError on
    any other YAML (sequences, flow collections, block scalars, anchors,
    tags, deeper nesting)."""
    rows = [(len(line) - len(line.lstrip(" ")), line.strip())
            for line in text.splitlines()]
    while rows and not rows[-1][1]:
        rows.pop()
    while rows and not rows[0][1]:
        rows.pop(0)
    if [r[1] for r in rows] == ["{}"]:
        return {}

    def entries(i: int, indent: int, into: dict, depth: int) -> int:
        while i < len(rows) and rows[i][0] == indent and rows[i][1]:
            m = _ENTRY.match(rows[i][1])
            if m is None:
                raise ValueError(f"unsupported YAML line {rows[i][1]!r}")
            key = m.group(1)
            key = _scalar([key]) if key[0] in "'\"" else key
            value = (m.group(2) or "").strip()
            i += 1
            j = i  # the value's continuation lines (and empty lines)
            while j < len(rows) and (not rows[j][1] or rows[j][0] > indent):
                j += 1
            while j > i and not rows[j - 1][1]:
                j -= 1
            if value:
                into[key] = _scalar([value] + [r[1] for r in rows[i:j]])
                i = j
            elif j > i:
                if depth == 2:
                    raise ValueError("YAML nested deeper than two levels")
                into[key] = {}
                i = entries(i, rows[i][0], into[key], depth + 1)
            else:
                into[key] = None
        return i

    out: dict = {}
    if entries(0, 0, out, 1) != len(rows):
        raise ValueError("unsupported YAML layout")
    return out


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
                    waveform = pitch_shift(waveform, sr, step)
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

    Workers are THREADS by default.  The pitch shift (numpy's phase
    vocoder) holds the interpreter lock, so with augmentation on and
    workers asked for, the loader uses a spawn-context process pool, as
    the JAX loader does without its C++ DSP; spawn, never fork, because
    the parent may already hold a CUDA context.  Every job's randomness
    comes from a seed of its own, so the batches do not depend on the
    kind or number of workers."""

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
        if self.num_workers > 0 and not use_processes and augment:
            _warn(
                "the numpy pitch shift holds the interpreter lock: thread "
                "workers would serialize it; switching DataLoader to spawn "
                "process workers"
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
                "every window re-runs the phase vocoder; prefer "
                "num_workers=0 when memoizing augmented windows"
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
