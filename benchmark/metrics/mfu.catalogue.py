"""The serving call's share of the card's dense bf16 peak, in %: the
model-required FLOPs of the window's batches (each real row decoded to
its own length, frozen ``decode_flops``) over the window's host time."""

from benchmark.frozen.flops import decode_flops, sizes


def read(ctx):
    if not ctx["on_card"]:
        return None  # a share of the card's peak needs the card's time
    stats = [s for c in ctx["calls"] for s in c["stats"]]
    if not stats:
        return None
    cfg = sizes(ctx["model"])
    flops = sum(decode_flops(cfg, 1, ctx["enc_len"], max(1, int(r)))
                for s in stats for r in s["row_steps"])
    return 100.0 * flops / ctx["window_s"] / ctx["peak_flops"]
