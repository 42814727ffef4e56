"""Host reads of the device per decode step (``infer/decode.py``
``DecodeProgram``: the ``decode`` spans' ``syncs`` over their ``steps``)
in the traced call."""

from benchmark.frozen.spans import named, slice_spans


def read(ctx):
    spans = slice_spans(ctx)
    if spans is None:
        return None
    decode = [s["attrs"] for s in named(spans, "decode")
              if "steps" in s["attrs"]]
    steps = sum(a["steps"] for a in decode)
    if not steps:
        return None
    return sum(a["syncs"] for a in decode) / steps
