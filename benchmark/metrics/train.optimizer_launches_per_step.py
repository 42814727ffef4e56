"""Kernel launches of ``Adafactor.step`` per traced train step
(``train/loop.py`` ``make_train_step``: the ``optimizer`` spans'
``launches`` over their number) in the traced slice."""

from benchmark.frozen.spans import named, slice_spans


def read(ctx):
    spans = slice_spans(ctx)
    if spans is None:
        return None
    steps = [s["attrs"] for s in named(spans, "optimizer")
             if "launches" in s["attrs"]]
    if not steps:
        return None
    return sum(a["launches"] for a in steps) / len(steps)
