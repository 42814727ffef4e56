"""Mean self time of the ``backward`` span (autograd's backward) per
traced train step (``train/loop.py`` ``make_train_step``), in ms: the
host's time in it, whether the card is busy or not."""

from benchmark.frozen.spans import part_self_ms, slice_spans


def read(ctx):
    spans = slice_spans(ctx)
    return None if spans is None else part_self_ms(spans, "train.step",
                                                   "backward")
