"""Mean ``collect`` span of the traced requests' batches, in ms: from the
first request the dispatcher takes until its batch is dispatched
(``serve/batcher.py``: at most ``max_wait_ms`` for stragglers)."""

from benchmark.frozen.spans import named, slice_spans


def read(ctx):
    spans = slice_spans(ctx)
    if spans is None:
        return None
    collects = named(spans, "collect")
    if not collects:
        return None
    return sum(c["t1"] - c["t0"] for c in collects) / len(collects) / 1e3
