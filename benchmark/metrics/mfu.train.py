"""The train step's share of the card's fp32 peak outside the tensor
cores, in %: the model-required FLOPs of the window's steps (frozen
``train_step_flops``, each row at its own label length) over the
window's host time."""

from benchmark.frozen.flops import sizes, train_step_flops


def read(ctx):
    if not ctx["on_card"]:
        return None  # a share of the card's peak needs the card's time
    steps = ctx.get("steps")
    if not steps:
        return None
    cfg = sizes(ctx["model"])
    flops = sum(train_step_flops(cfg, 1, ctx["enc_len"], n)
                for k in steps for n in ctx["label_lens"][k])
    return 100.0 * flops / ctx["window_s"] / ctx["peak_flops"]
