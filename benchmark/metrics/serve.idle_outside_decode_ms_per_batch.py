"""Card-idle time inside the traced ``generate_batch`` calls but outside
every ``decode`` span, per batch, in ms: what the card waits on in the
serving call's other stages (staging, upload, mel, encoder, the lengths
read back, detokenize, MIDI; ``infer/pipeline.py``)."""

from benchmark.frozen.spans import covered, idle_us, named, slice_spans, \
    subtract


def read(ctx):
    spans = slice_spans(ctx)
    if spans is None:
        return None
    sl = ctx["trace"]["slice"]
    roots = named(spans, "generate_batch")
    ids = {r["id"] for r in roots}
    batches = [b for b in named(spans, "batch") if b["parent"] in ids]
    if not batches:
        return None
    outside = subtract(covered(roots, sl.window),
                       covered(named(spans, "decode"), sl.window))
    return idle_us(outside, sl.events, sl.window) / 1e3 / len(batches)
