"""Kind ``songs_closed_loop``: a catalogue job.  ``generate_batch`` over
the mix's whole pool of songs, call after call, through the window; the
end-to-end metric is ``songs_per_min``, the audio of every call started
in the window, in 3-minute songs, over the window to the last call's
end."""

from __future__ import annotations

import time

from benchmark.drive import serve

SONG_SECONDS = 180.0  # the unit of songs_per_min: a 3-minute song


def widths(engine, traffic, counts) -> set:
    """The widths of one call over the pool."""
    return serve.call_widths(engine, counts)


def window(engine, recorder, songs, cell, seed, seconds,
           trace_slice=None) -> dict:
    """Calls over the whole pool, back to back, until the window has
    passed; every call started in the window is finished and counted.
    A traced slice makes ``trace_slice["calls"]`` calls."""
    waves = [s.wave for s in songs]
    conds = [s.cond for s in songs]
    keys = list(range(len(songs)))
    first = len(recorder.calls)
    t0 = time.perf_counter()
    if trace_slice is not None:
        for _ in range(int(trace_slice["calls"])):
            recorder.call(waves, conds, keys)
        return {}
    while time.perf_counter() - t0 < seconds:
        recorder.call(waves, conds, keys)
    window_s = time.perf_counter() - t0
    calls = len(recorder.calls) - first
    sr = int(engine.config.model.sample_rate)
    audio_s = sum(len(s.wave) for s in songs) / sr * calls
    counts = [serve.chunk_count(cell.config, len(s.wave)) for s in songs]
    served = []
    for call in recorder.calls[first:]:
        per_song = serve.song_tokens(call, counts,
                                     engine.t5_config.eos_token_id)
        served.extend((key, per_song[j], call["midis"][j])
                      for j, key in enumerate(call["keys"]))
    return {"window_s": window_s,
            "e2e": {"songs_per_min": audio_s / SONG_SECONDS
                    / (window_s / 60.0)},
            "attempted": calls * len(songs),
            "failed": 0, "served": served}


def run(root, cell, seed, seconds, traced, device, override=None) -> dict:
    return serve.run(root, cell, seed, seconds, traced, device, override,
                     widths=widths, window=window)
