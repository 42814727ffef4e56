"""Median time a request waited outside the ``generate_batch`` call that
served it (its latency from scheduled arrival, less that call's host
time): the batcher's collect wait and the queue behind the batch in
flight (``serve/batcher.py``)."""

import numpy as np


def read(ctx):
    calls, reqs = ctx["calls"], ctx.get("requests")
    if not reqs:
        return None
    waits = [r["latency"] - (calls[r["call"]]["t1"] - calls[r["call"]]["t0"])
             for r in reqs if r["call"] is not None]
    return float(np.median(waits)) if waits else None
