"""The MoE's routing balance in the traced call: the busiest expert's
routed tokens over the mean (rows x top-k over the experts), per layer
step, averaged: from the ``decode`` spans' counters (``expert_max_sum``,
``moe_layer_steps``, ``routed_per_layer_step``, ``expert_tokens``), which
the program adds up on the card and reads once a batch."""

from benchmark.frozen.spans import named, slice_spans


def read(ctx):
    spans = slice_spans(ctx)
    if spans is None:
        return None
    decode = [s["attrs"] for s in named(spans, "decode")
              if s["attrs"].get("moe_layer_steps")]
    if not decode:
        return None
    layer_steps = sum(a["moe_layer_steps"] for a in decode)
    busiest = sum(a["expert_max_sum"] for a in decode)
    mean = sum(a["routed_per_layer_step"] * a["moe_layer_steps"]
               / len(a["expert_tokens"]) for a in decode)
    return busiest / mean if mean else None
