"""Kernel 3 (``csrc/decode_attention.cu``, the int8 decode attention) as a
share of its roofline, in %: the summed least time of the calls the
traced call made (frozen ``decode_attention_bound_s``: per batch, each
step's causal call over n = step + 1 keys and cross call over the
encoder's positions, in every decoder layer) over their device time in
the trace."""

from benchmark.frozen.flops import decode_attention_bound_s, sizes
from benchmark.frozen.trace import kernel_us

KERNEL = "decode_attention_int8_kernel"


def read(ctx):
    tr = ctx.get("trace")
    if not ctx["on_card"]:
        return None
    if not tr or not tr.get("calls"):
        return None
    sl = tr["slice"]
    device_us, count = kernel_us(sl.events, KERNEL, sl.window)
    if not count or device_us <= 0:
        return None
    cfg = sizes(ctx["model"])
    bound = sum(decode_attention_bound_s(cfg, s["batch_width"], s["steps"],
                                         ctx["enc_len"])
                for c in tr["calls"] for s in c["stats"])
    return 100.0 * bound / (device_us / 1e6)
