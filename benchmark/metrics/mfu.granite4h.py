"""The hybrid serving call's share of the card's dense bf16 peak, in %:
the model-required FLOPs of the window's batches (each real row's
prefill over the audio prefix and its own decode steps, the routed top-k
experts and the shared MLP: frozen ``hybrid_counts.row_flops``) over the
window's host time."""

from benchmark.frozen.hybrid_counts import row_flops


def read(ctx):
    if not ctx["on_card"]:
        return None  # a share of the card's peak needs the card's time
    stats = [s for c in ctx["calls"] for s in c["stats"]]
    if not stats:
        return None
    flops = sum(row_flops(ctx["model"], ctx["enc_len"], max(1, int(r)))
                for s in stats for r in s["row_steps"])
    return 100.0 * flops / ctx["window_s"] / ctx["peak_flops"]
