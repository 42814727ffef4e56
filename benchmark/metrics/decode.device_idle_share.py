"""Share of the ``decode`` spans' time (``infer/decode.py``
``DecodeProgram``: a batch's prologue, captured steps and lengths) in
which the card ran no kernel, copy or set, over the traced call, in %."""

from benchmark.frozen.spans import covered, idle_us, length, named, \
    slice_spans


def read(ctx):
    spans = slice_spans(ctx)
    if spans is None:
        return None
    sl = ctx["trace"]["slice"]
    decode = covered(named(spans, "decode"), sl.window)
    if not length(decode):
        return None
    return 100.0 * idle_us(decode, sl.events, sl.window) / length(decode)
