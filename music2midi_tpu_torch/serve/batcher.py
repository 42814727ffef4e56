"""Dynamic request batching for serving: concurrent song -> MIDI requests
coalesce into one engine batch.

The port's own copy of ``music2midi_tpu/serve/batcher.py``, with the same
semantics.  Requests enqueue; a single dispatcher thread drains the queue
(waiting up to ``max_wait_ms`` for stragglers once one request is
present), runs ONE ``generate_batch`` over all collected songs, and
resolves per-request futures.  A future the client cancelled before the
dispatcher claims it is dropped; a path that fails to decode fails only its
own future; an exception of the batch fails that batch's live futures;
nothing is enqueued behind ``close()``.

The dispatcher is the only thread that calls the engine, which is not safe
for two: its launch plans (``ops/decode_attention.py::Int8AttentionPlan``)
own their output and staging buffers, and ``last_decode_stats`` is shared.
It runs the engine under ``torch.no_grad()`` (grad mode is per thread, so
the web server's threads need not set it) on the default stream (the
launch plans read the current stream at each call; nothing here sets
another).  A cold process builds the CUDA kernels at their first launch,
on this thread, under ``ops/_build.py``'s lock; ``engine.warmup()`` builds
them before serving.

Usage:
    batcher = DynamicBatcher(engine)          # starts the thread
    midi = batcher.submit(waveform).result()  # or audio_path=...
    batcher.close()
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
import torch


class _Request:
    __slots__ = ("waveform", "audio_path", "cond_index", "future")

    def __init__(self, waveform, audio_path, cond_index):
        self.waveform = waveform
        self.audio_path = audio_path
        self.cond_index = cond_index
        self.future: Future = Future()


class DynamicBatcher:
    def __init__(
        self,
        engine,
        max_batch_songs: int = 16,
        max_wait_ms: float = 50.0,
    ):
        """engine: a Music2MIDI instance (owned by the batcher's thread
        from now on).  max_batch_songs bounds songs per dispatch batch;
        max_wait_ms is how long the dispatcher waits for more requests
        after the first one arrives (latency/throughput knob)."""
        from concurrent.futures import ThreadPoolExecutor

        self.engine = engine
        self.max_batch_songs = max_batch_songs
        self.max_wait_ms = max_wait_ms
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()  # orders submit() vs close(): no
        # request may be enqueued behind the close sentinel
        self._loader = ThreadPoolExecutor(max_workers=4)  # concurrent
        # audio decode for path-based requests
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(
        self,
        waveform: Optional[np.ndarray] = None,
        audio_path: Optional[Union[str, Path]] = None,
        cond_index: Optional[Sequence[int]] = None,
    ) -> Future:
        """-> Future resolving to a MidiFile.  Pass a 16 kHz waveform or
        an audio path (decoded concurrently on a small loader pool)."""
        if (waveform is None) == (audio_path is None):
            raise ValueError("pass exactly one of waveform / audio_path")
        req = _Request(waveform, audio_path, cond_index)
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.put(req)
        return req.future

    def close(self) -> None:
        """Drain outstanding requests, then stop the dispatcher."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._thread.join()
        self._loader.shutdown(wait=False)

    # ------------------------------------------------------------------ #

    def _collect(self):
        """Block for the first request, then wait up to max_wait_ms for
        more (or until the batch is full)."""
        first = self._queue.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_wait_ms / 1e3
        while len(batch) < self.max_batch_songs:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if req is None:  # close() sentinel: stop after this batch
                self._queue.put(None)
                break
            batch.append(req)
        return batch

    def _run(self) -> None:
        from ..audio import load as audio_load

        model_sr = int(self.engine.config.model.sample_rate)
        while True:
            batch = self._collect()
            if batch is None:
                return
            # claim each future; a client that already cancel()ed a
            # pending request is dropped here (set_result on a cancelled
            # future raises InvalidStateError and would kill this thread)
            batch = [
                r for r in batch
                if r.future.set_running_or_notify_cancel()
            ]
            # per-request decode (paths fan out on the loader pool): a
            # bad path fails only ITS future
            decode = {
                id(r): self._loader.submit(
                    audio_load, r.audio_path, sr=model_sr
                )
                for r in batch if r.audio_path is not None
            }
            waves, live = [], []
            for r in batch:
                try:
                    if r.waveform is not None:
                        waves.append(np.asarray(r.waveform, np.float32))
                    else:
                        waves.append(decode[id(r)].result()[0])
                    live.append(r)
                except Exception as e:  # noqa: BLE001
                    r.future.set_exception(e)
            if not live:
                continue
            try:
                with torch.no_grad():
                    midis = self.engine.generate_batch(
                        waves, cond_indices=[r.cond_index for r in live]
                    )
                for r, m in zip(live, midis):
                    r.future.set_result(m)
            except Exception as e:  # noqa: BLE001 — batch-level failure
                for r in live:
                    if not r.future.done():
                        r.future.set_exception(e)
