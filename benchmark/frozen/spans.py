"""Reading the program's spans over a traced slice: a span's self time,
and the device's idle time under spans.

The program records spans (``music2midi_tpu_torch.profiling.span``) while
a profiler records, so the traced slice holds them with no edit here;
``profiling.spans()`` returns them as plain dicts ``{name, id, parent,
thread, t0_ns, t1_ns, attrs}`` stamped on the clock of the profiler's host
events.  ``slice_spans`` takes those of the slice's window, with ``t0``
and ``t1`` in microseconds, the unit of ``frozen/trace.py``; it is the
one function here that reads the program, and returns None where the
program keeps no spans.  The rest is interval arithmetic over sorted,
disjoint (start, end) lists, such as ``trace.busy_intervals``.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from . import trace

Intervals = List[Tuple[float, float]]


def slice_spans(ctx: dict) -> Optional[List[dict]]:
    """The program's spans that overlap the traced slice's window, each
    with ``t0`` and ``t1`` in microseconds; None without a card, without a
    traced slice, or where the program recorded none there (a program
    without spans among them)."""
    if not ctx.get("on_card") or not ctx.get("trace"):
        return None
    from music2midi_tpu_torch import profiling

    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    lo, hi = ctx["trace"]["slice"].window
    out = []
    for s in read():
        if s["t1_ns"] is None:
            continue
        t0, t1 = s["t0_ns"] / 1e3, s["t1_ns"] / 1e3
        if t1 > lo and t0 < hi:
            out.append({**s, "t0": t0, "t1": t1})
    return out or None


def named(spans: Iterable[dict], name: str) -> List[dict]:
    return [s for s in spans if s["name"] == name]


def union(intervals: Iterable[Tuple[float, float]]) -> Intervals:
    """Sorted disjoint intervals covering ``intervals`` (empty ones
    dropped)."""
    merged: Intervals = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def length(intervals: Intervals) -> float:
    return sum(e - s for s, e in intervals)


def subtract(a: Intervals, b: Intervals) -> Intervals:
    """The parts of ``a`` outside ``b`` (both sorted and disjoint)."""
    out: Intervals = []
    j = 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if e > s:
            out.append((s, e))
    return out


def clip(intervals: Intervals, window: Tuple[float, float]) -> Intervals:
    return [(max(s, window[0]), min(e, window[1])) for s, e in intervals
            if min(e, window[1]) > max(s, window[0])]


def covered(spans: Iterable[dict], window: Tuple[float, float]
            ) -> Intervals:
    """The union of the spans' intervals, cut to ``window``."""
    return clip(union((s["t0"], s["t1"]) for s in spans), window)


def self_us(span: dict, spans: Iterable[dict]) -> float:
    """The span's duration less the part its children cover."""
    kids = union((max(c["t0"], span["t0"]), min(c["t1"], span["t1"]))
                 for c in spans if c["parent"] == span["id"])
    return (span["t1"] - span["t0"]) - length(kids)


def idle_us(intervals: Intervals, events: List[dict],
            window: Tuple[float, float]) -> float:
    """Microseconds of ``intervals`` (sorted, disjoint, inside ``window``)
    in which the device runs nothing."""
    return length(subtract(intervals, trace.busy_intervals(events, window)))


def part_self_ms(spans: List[dict], root: str, part: str
                 ) -> Optional[float]:
    """The summed self time of the ``part`` spans under ``root`` spans,
    per ``root`` span, in ms; None without a ``root`` span."""
    roots = named(spans, root)
    ids = {r["id"] for r in roots}
    if not roots:
        return None
    return sum(self_us(p, spans) for p in named(spans, part)
               if p["parent"] in ids) / len(roots) / 1e3
