"""Kind ``songs_open_loop``: web UI uploads.  One song a request, at the
times of the mix's arrival process (``arrivals/<arrivals>.py``), through
the program's ``DynamicBatcher`` with the mix's settings, in front of the
engine; the end-to-end metric is ``upload_latency_p50_s``, from each
request's scheduled arrival to its MIDI, over every request due in the
window.  The batcher is handed a proxy of the engine that calls through
the recorder and names each song by its request."""

from __future__ import annotations

import threading
import time
from typing import Dict

import numpy as np

from benchmark import generate
from benchmark.drive import serve

WAIT_GRACE_S = 60.0  # how long past the window an answer may come


def widths(engine, traffic, counts) -> set:
    """The mix's ``warm_widths``: the batcher's batches take any width."""
    return set(traffic["warm_widths"])


class BatcherEngine:
    """What the ``DynamicBatcher`` sees of the engine: its config, and a
    ``generate_batch`` through the recorder that names each song by its
    request."""

    def __init__(self, recorder: serve.Recorder, request_of: Dict[int, int]):
        self.config = recorder.engine.config
        self._recorder = recorder
        self._request_of = request_of

    def generate_batch(self, waveforms, cond_indices=None):
        keys = [self._request_of[id(w)] for w in waveforms]
        return self._recorder.call(waveforms, cond_indices, keys)


def window(engine, recorder, songs, cell, seed, seconds,
           trace_slice=None) -> dict:
    """Requests at their scheduled times through a ``DynamicBatcher``
    with the traffic's settings; each request's latency runs from its
    scheduled arrival to its MIDI.  A traced slice sends the first
    ``trace_slice["requests"]`` requests of the schedule."""
    from music2midi_tpu_torch.serve.batcher import DynamicBatcher

    traffic = cell.traffic
    times, which = generate.arrivals(traffic, seed, seconds, cell.pkg)
    if trace_slice is not None:
        n = min(len(times), int(trace_slice["requests"]))
        times, which = times[:n], which[:n]
    views = [songs[w].wave[:] for w in which]  # one object a request
    request_of = {id(v): k for k, v in enumerate(views)}
    batcher = DynamicBatcher(BatcherEngine(recorder, request_of),
                             max_batch_songs=int(traffic["max_batch_songs"]),
                             max_wait_ms=float(traffic["max_wait_ms"]))
    done = np.full(len(times), np.nan)
    lock = threading.Lock()
    futures = []
    late = []
    first = len(recorder.calls)
    t0 = time.perf_counter()
    try:
        for k, (t, w) in enumerate(zip(times, which)):
            delay = t0 + t - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            late.append(time.perf_counter() - (t0 + t))
            fut = batcher.submit(waveform=views[k],
                                 cond_index=list(songs[w].cond))

            def finished(f, k=k):
                if f.exception() is None:
                    with lock:
                        done[k] = time.perf_counter()

            fut.add_done_callback(finished)
            futures.append(fut)
        deadline = t0 + seconds + WAIT_GRACE_S
        for fut in futures:
            try:
                fut.result(timeout=max(0.0, deadline - time.perf_counter()))
            except Exception:  # noqa: BLE001 - a failed request is missing
                pass
    finally:
        batcher.close()
    window_s = time.perf_counter() - t0
    if trace_slice is not None:
        return {}
    lat = done - (t0 + times)
    ok = np.isfinite(lat)
    # a request that never answered counts as waiting the whole grace
    lat_all = np.where(ok, lat, seconds + WAIT_GRACE_S)
    calls = recorder.calls[first:]
    call_of = {}
    for c, call in enumerate(calls):
        for j, key in enumerate(call["keys"]):
            call_of[key] = (c, j)
    requests = [{"latency": float(lat_all[k]),
                 "call": call_of.get(k, (None,))[0]}
                for k in range(len(times))]
    # each answer is judged against the tokens its own call served for
    # its own song: found by the MIDI object the request was handed
    counts = [serve.chunk_count(cell.config, len(s.wave)) for s in songs]
    per_call = [serve.song_tokens(call, [counts[which[k]] for k in call["keys"]],
                             engine.t5_config.eos_token_id)
                for call in calls]
    by_midi = {id(m): (c, j) for c, call in enumerate(calls)
               for j, m in enumerate(call["midis"])}
    served = []
    for k, fut in enumerate(futures):
        midi = fut.result() if fut.done() and fut.exception() is None \
            else None
        c, j = by_midi.get(id(midi), (None, None))
        if c is None or calls[c]["keys"][j] != k:
            served.append((int(which[k]), None, None))
        else:
            served.append((int(which[k]), per_call[c][j], midi))
    return {"window_s": window_s,
            "e2e": {"upload_latency_p50_s": float(np.percentile(lat_all,
                                                                50))},
            "attempted": len(times), "failed": int((~ok).sum()),
            "generator_late_s": {"p50": float(np.median(late)),
                                 "max": float(np.max(late))},
            "requests": requests, "served": served}


def run(root, cell, seed, seconds, traced, device, override=None) -> dict:
    return serve.run(root, cell, seed, seconds, traced, device, override,
                     widths=widths, window=window)
