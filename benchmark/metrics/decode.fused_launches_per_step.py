"""Launches of the decode step's fused glue per decode step
(``infer/decode.py`` ``DecodeProgram``: the ``decode`` spans'
``fused_launches`` over their ``steps``; kernels 7-10 of
``ops/decode_fused.py``) in the traced call.  A program without the
counter gives nothing to read."""

from benchmark.frozen.spans import named, slice_spans


def read(ctx):
    spans = slice_spans(ctx)
    if spans is None:
        return None
    decode = [s["attrs"] for s in named(spans, "decode")
              if "steps" in s["attrs"] and "fused_launches" in s["attrs"]]
    steps = sum(a["steps"] for a in decode)
    if not steps:
        return None
    return sum(a["fused_launches"] for a in decode) / steps
