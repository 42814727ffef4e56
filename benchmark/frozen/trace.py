"""Reading a ``torch.profiler`` trace: device busy time, idle gaps, and
kernel time by name.

The arithmetic is a frozen copy of the port's
(``music2midi_tpu_torch/profiling.py``: ``device_busy_us``,
``device_idle_share``, ``launch_ids``, ``device_kernels``), over a list of
plain event dicts ``{"name", "cat", "ts", "dur", "corr"}`` (microseconds)
that ``events_of`` takes from a finished profiler in memory, without
writing a Chrome trace.  ``cat`` is ``"device"`` for the card's kernels,
copies and sets, ``"runtime"`` for the host's CUDA runtime and driver
calls, and ``"host"`` for the host's operators and annotations.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

_LOOK_BACK = 256  # host events searched backwards for a gap's name


def events_of(prof) -> List[dict]:
    """The finished profiler's events as plain dicts (see module doc)."""
    raw = list(prof.profiler.kineto_results.events())
    on_device = [str(ev.device_type()).rsplit(".", 1)[-1].upper() == "CUDA"
                 for ev in raw]
    host_names = {ev.name() for ev, dev in zip(raw, on_device) if not dev}
    out = []
    for ev, dev in zip(raw, on_device):
        name = ev.name()
        if dev:
            # a host span (record_function) is mirrored on the device's
            # timeline under its own name: it is no device activity
            if name in host_names or getattr(
                    ev, "is_user_annotation", lambda: False)():
                continue
            cat = "device"
        elif name.startswith("cu"):
            cat = "runtime"
        else:
            cat = "host"
        out.append({"name": name, "cat": cat,
                    "ts": ev.start_ns() / 1e3, "dur": ev.duration_ns() / 1e3,
                    "corr": ev.correlation_id()})
    return out


def _inside(ev: dict, window: Optional[Tuple[float, float]]) -> bool:
    return window is None or window[0] <= ev["ts"] < window[1]


def launch_ids(events: List[dict], window=None) -> set:
    """Correlation ids of the host's runtime calls starting in ``window``:
    a kernel carries the id of the call that launched it (a kernel launch,
    or for a graph's replay its graph launch)."""
    return {ev["corr"] for ev in events
            if ev["cat"] == "runtime" and _inside(ev, window)}


def busy_intervals(events: List[dict], window: Tuple[float, float]
                   ) -> List[Tuple[float, float]]:
    """The union of the device's activity, cut to ``window``, as sorted
    disjoint (start, end) intervals."""
    spans = []
    for ev in events:
        if ev["cat"] != "device":
            continue
        s, e = max(ev["ts"], window[0]), min(ev["ts"] + ev["dur"], window[1])
        if e > s:
            spans.append((s, e))
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def busy_us(events: List[dict], window: Tuple[float, float]) -> float:
    """Microseconds of ``window`` in which some kernel, copy or set runs."""
    return sum(e - s for s, e in busy_intervals(events, window))


def idle_share(events: List[dict], window: Tuple[float, float]) -> float:
    """The share of ``window`` in which the device runs nothing."""
    return 1.0 - busy_us(events, window) / (window[1] - window[0])


def kernel_us(events: List[dict], substring: str, window=None
              ) -> Tuple[float, int]:
    """(summed device microseconds, count) of the kernels whose name holds
    ``substring`` and whose launching host call started in ``window``
    (matched by correlation id, not by the kernels' own timestamps: the
    device's clock in a trace can stray from the host's)."""
    ids = None if window is None else launch_ids(events, window)
    total, count = 0.0, 0
    for ev in events:
        if ev["cat"] == "device" and substring in ev["name"] and (
                ids is None or ev["corr"] in ids):
            total += ev["dur"]
            count += 1
    return total, count


def top_device_ops(events: List[dict], window: Tuple[float, float],
                   n: int = 10) -> List[list]:
    """[[name, seconds], ...]: the device operations that took most time in
    ``window``, summed by name."""
    agg: Dict[str, float] = {}
    for ev in events:
        if ev["cat"] == "device" and _inside(ev, window):
            agg[ev["name"]] = agg.get(ev["name"], 0.0) + ev["dur"] / 1e6
    return [[k, v] for k, v in sorted(agg.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events: List[dict], window: Tuple[float, float],
              n: int = 10) -> List[list]:
    """[[name, seconds], ...]: the device's idle time in ``window``, summed
    by what the host was doing in each gap (the innermost host operator,
    annotation or runtime call spanning the gap's middle, else
    ``"host:untraced"``), longest first."""
    host = sorted((ev for ev in events if ev["cat"] != "device"),
                  key=lambda ev: ev["ts"])
    starts = [ev["ts"] for ev in host]
    gaps = []
    last = window[0]
    for s, e in busy_intervals(events, window) + [(window[1], window[1])]:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    agg: Dict[str, float] = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        name = "host:untraced"
        # the latest-starting host event that still spans mid; a bounded
        # look back keeps this linear in the trace's length
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - _LOOK_BACK), -1):
            if host[j]["ts"] + host[j]["dur"] >= mid:
                name = host[j]["name"]
                break
        agg[name] = agg.get(name, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(agg.items(), key=lambda kv: -kv[1])[:n]]
