"""Share of the traced requests' time (``request`` spans, ``submit()`` to
the future's result; ``serve/batcher.py``) spent before the ``dispatch``
that served each began: the collect wait and the batch in flight, over
the whole, in %."""

from benchmark.frozen.spans import named, slice_spans


def read(ctx):
    spans = slice_spans(ctx)
    if spans is None:
        return None
    dispatch_of = {rid: d for d in named(spans, "dispatch")
                   for rid in d["attrs"].get("requests", [])}
    waited = total = 0.0
    for r in named(spans, "request"):
        d = dispatch_of.get(r["attrs"].get("request"))
        if d is not None:
            waited += d["t0"] - r["t0"]
            total += r["t1"] - r["t0"]
    return 100.0 * waited / total if total > 0 else None
