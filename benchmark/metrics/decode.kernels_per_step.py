"""Device kernels per decode step (``infer/decode.py`` ``DecodeProgram``)
in the traced call: the kernels launched by host calls made while a
``decode`` span runs (matched by correlation id: a kernel launch, or the
graph launch of a replayed step), over those spans' ``steps``; the
prologue's kernels included, copies and sets left out.  Only spans
inside the traced slice count."""

import bisect

from benchmark.frozen.spans import covered, named, slice_spans

_NOT_KERNELS = ("Memcpy", "Memset")


def read(ctx):
    spans = slice_spans(ctx)
    if spans is None:
        return None
    sl = ctx["trace"]["slice"]
    lo, hi = sl.window
    decode = [s for s in named(spans, "decode")
              if "steps" in s["attrs"] and lo <= s["t0"] and s["t1"] <= hi]
    steps = sum(s["attrs"]["steps"] for s in decode)
    if not steps:
        return None
    runs = covered(decode, sl.window)
    starts = [s for s, _ in runs]

    def inside(ts):
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts < runs[i][1]

    ids = {ev["corr"] for ev in sl.events
           if ev["cat"] == "runtime" and inside(ev["ts"])}
    kernels = sum(1 for ev in sl.events
                  if ev["cat"] == "device" and ev["corr"] in ids
                  and not ev["name"].startswith(_NOT_KERNELS))
    return kernels / steps
