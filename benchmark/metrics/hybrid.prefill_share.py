"""The hybrid decoder's prefill as a share of the serving call, in %: the
``prefill`` spans' time (the decode loop's prologue over the audio
prefix) over the ``batch`` spans' time in the traced call."""

from benchmark.frozen.spans import named, slice_spans


def read(ctx):
    spans = slice_spans(ctx)
    if spans is None:
        return None
    batch = sum(s["t1"] - s["t0"] for s in named(spans, "batch"))
    prefill = sum(s["t1"] - s["t0"] for s in named(spans, "prefill"))
    if batch <= 0 or prefill <= 0:
        return None
    return 100.0 * prefill / batch
