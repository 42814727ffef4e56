"""Kernel 6 (``csrc/ssm_state_update.cu``, the Mamba-2 decode state
update) as a share of its roofline, in %: the summed least time of the
launches the traced call made (frozen ``state_update_bound_s``: per
batch, one launch a Mamba layer a step, each bound by the float32
state's bytes read and written once at 3.35 TB/s) over their device time
in the trace."""

from benchmark.frozen.hybrid_counts import state_update_bound_s
from benchmark.frozen.trace import kernel_us

KERNEL = "ssm_state_update_kernel"


def read(ctx):
    tr = ctx.get("trace")
    if not ctx["on_card"] or not tr or not tr.get("calls"):
        return None
    sl = tr["slice"]
    device_us, count = kernel_us(sl.events, KERNEL, sl.window)
    if not count or device_us <= 0:
        return None
    bound = sum(state_update_bound_s(ctx["model"], s["batch_width"],
                                     s["steps"])
                for c in tr["calls"] for s in c["stats"])
    return 100.0 * bound / (device_us / 1e6)
