"""Spans of the program's own layers, trace helpers over ``torch.profiler``,
and analytic model-FLOPs accounting (MFU) with the card's bf16 peak.

Spans: ``span(name, **attrs)`` marks a stretch of the program's work
(the serving call's stages on the calling and the card threads, the
batcher's requests, collects and dispatches, the train step's parts) with
its name, start, end, thread, its own id, its parent's (the innermost
span open on the same thread, or ``parent=``) and integer attributes, the
counters of the work it did (``Span.set``).  A span records only while a
``torch.profiler`` is recording, or inside ``recording()``: otherwise
``span`` costs one flag check and returns a span that records nothing.
Records are stamped with ``time.time_ns()``, the clock of the profiler's
host events (Unix-epoch nanoseconds), so a trace's events and the spans
of the same stretch of time line up; while the profiler records, a span
also enters ``torch.profiler.record_function`` (recorded on the thread
that started the profiler), so a Chrome trace shows it beside the
kernels.  ``spans()`` returns the finished spans, oldest first, as plain
dicts; the buffer keeps the newest ``SPAN_CAPACITY`` and counts what it
dropped (``spans_dropped``); ``clear_spans`` empties it.

The trace helpers port ``music2midi_tpu/profiling.py``'s ``trace``,
``annotate`` (here ``span``) and ``summarize_trace`` from ``jax.profiler``
to ``torch.profiler``: ``trace`` records the host's calls and, on a card,
the device's kernels and copies, and writes a Chrome trace into its
directory; ``summarize_trace`` aggregates the device activity of the
traces there into the same (total_ms, count, name) rows.  What the decode
loop's measurement reads besides: ``host_launches`` (the host's kernel
and graph launches, ``cudaLaunchKernel`` and ``cudaGraphLaunch``, in a
window) and ``device_idle_share`` (the share of a window in which no
kernel, copy or set runs on the device), over the window of a ``span``
(``annotation_window``), ``device_kernels`` (the
kernels of given names the device ran, launched in a window, matched to
their launch by correlation id), and ``device_clock_past`` (how far the
device's clock in the trace strays past the host's).  The JAX module's
``timeit_slope`` is not ported: it works around JAX's dispatch through a
remote TPU (one jit program of K calls, timed at two K), which has no
counterpart on a card, where CUDA events time the device
(``chip_smoke.py``).

The FLOPs half is a copy of the JAX module's: the matmul FLOPs the MODEL
requires (2 M N K per dot; causal attention at its true triangular
cost), not the FLOPs the implementation executes.  Padding, lockstep
decode past a row's EOS and recomputation are overheads that MFU charges
against utilization.  Embedding gathers, norms and elementwise ops are
left out (well under 1 % here).  ``device_peak_flops`` replaces the JAX
package's TPU table with NVIDIA's dense bf16 tensor-core peaks, looked up
by ``torch.cuda.get_device_name``.
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import itertools
import json
import os
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

import torch
import torch.autograd.profiler as _autograd_profiler

#: Chrome-trace categories of the device's own activity
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: Chrome-trace categories of the host's CUDA runtime and driver calls
HOST_API_CATEGORIES = ("cuda_runtime", "cuda_driver")
#: host calls that launch work on the device: a kernel, or a CUDA graph
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")


@contextlib.contextmanager
def trace(log_dir: Union[str, Path] = "m2m_trace"
          ) -> Iterator["torch.profiler.profile"]:
    """Record a ``torch.profiler`` trace of the block (the host's calls;
    the device's activity too when CUDA is available) and write it to
    ``log_dir`` as a Chrome trace (``*.trace.json``, viewable in Perfetto):

        with profiling.trace("m2m_trace"):
            engine.generate(audio_y=wave, sr=16000)

    Yields the profiler.  The device is synchronized before the trace
    stops, so that work the block queued is in it."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            str(log_dir / f"{os.getpid()}.{time.time_ns()}.trace.json"))


#: finished spans the buffer keeps: the newest (a long-running server
#: traced for hours keeps this many and counts the rest as dropped)
SPAN_CAPACITY = 16384


class SpanLog:
    """A bounded buffer of finished spans, safe for every thread: it keeps
    the newest ``capacity`` and counts the older ones it dropped."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self._lock = threading.Lock()
        self._spans: "collections.deque[Span]" = collections.deque(
            maxlen=capacity)
        self.dropped = 0

    def add(self, sp: "Span") -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(sp)

    def records(self) -> List["Span"]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0


_LOG = SpanLog()
_IDS = itertools.count(1)
_OPEN = threading.local()  # .stack: ids of the spans open on this thread
_RECORDING = 0  # recording() blocks open, in every thread
_RECORDING_LOCK = threading.Lock()


def _open_stack() -> List[int]:
    try:
        return _OPEN.stack
    except AttributeError:
        _OPEN.stack = []
        return _OPEN.stack


class Span:
    """One recorded stretch of work (see the module docstring); made by
    ``span``.  As a context manager it is the innermost open span of its
    thread until it exits; ``end()`` ends one that is not used as a
    context manager (a request's span, ended when its future resolves)."""

    __slots__ = ("name", "id", "parent", "thread", "t0_ns", "t1_ns",
                 "attrs", "_annotation")

    def __init__(self, name: str, parent: Optional[int], attrs: dict):
        self.name = name
        self.id = next(_IDS)
        if parent is None:
            stack = _open_stack()
            parent = stack[-1] if stack else None
        self.parent = parent
        self.thread = threading.current_thread().name
        self.attrs = attrs
        self.t1_ns: Optional[int] = None
        self._annotation = None
        self.t0_ns = time.time_ns()

    def set(self, **attrs) -> None:
        """Set attributes (counters) of the span."""
        self.attrs.update(attrs)

    def end(self) -> None:
        """Stamp the end and keep the span (once)."""
        if self.t1_ns is None:
            self.t1_ns = time.time_ns()
            _LOG.add(self)

    def __enter__(self) -> "Span":
        _open_stack().append(self.id)
        if _autograd_profiler._is_profiler_enabled:
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
            self.t0_ns = time.time_ns()  # inside its annotation
        return self

    def __exit__(self, *exc) -> bool:
        _open_stack().pop()
        self.end()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        return False


class _Off:
    """The span ``span`` returns while nothing records: no-ops."""

    __slots__ = ()
    id = None

    def set(self, **attrs) -> None:
        pass

    def end(self) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, parent=None, **attrs):
    """A span of the work in a ``with`` block (or up to ``end()``), with
    integer attributes ``attrs``; ``parent`` (a span or its id) in place of
    the innermost span open on this thread.  Records only while a
    ``torch.profiler`` records or inside ``recording()``; otherwise returns
    a span that does nothing, at the cost of one flag check:

        with profiling.span("decode") as sp:
            ...
            sp.set(steps=steps)
    """
    if not (_RECORDING or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return Span(name, getattr(parent, "id", parent), attrs)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans in every thread for the block, with no profiler."""
    global _RECORDING
    with _RECORDING_LOCK:
        _RECORDING += 1
    try:
        yield
    finally:
        with _RECORDING_LOCK:
            _RECORDING -= 1


def spans() -> List[dict]:
    """The finished spans kept, oldest first: ``{name, id, parent, thread,
    t0_ns, t1_ns, attrs}`` (``time.time_ns()`` stamps)."""
    return [{"name": s.name, "id": s.id, "parent": s.parent,
             "thread": s.thread, "t0_ns": s.t0_ns, "t1_ns": s.t1_ns,
             "attrs": dict(s.attrs)}
            for s in sorted(_LOG.records(), key=lambda s: s.t0_ns)]


def spans_dropped() -> int:
    """Finished spans the bounded buffer dropped, oldest first, since the
    last ``clear_spans``."""
    return _LOG.dropped


def clear_spans() -> None:
    """Empty the span buffer (and its count of dropped spans)."""
    _LOG.clear()


def load_trace(log_dir: Union[str, Path]) -> List[dict]:
    """Every complete ("X") event of the Chrome traces under ``log_dir``
    (``*.trace.json``, or gzipped), in one list."""
    events: List[dict] = []
    root = Path(log_dir)
    for fn in sorted(list(root.rglob("*.trace.json"))
                     + list(root.rglob("*.trace.json.gz"))):
        opener = gzip.open if fn.suffix == ".gz" else open
        with opener(fn, "rt") as f:
            data = json.load(f)
        events.extend(ev for ev in data.get("traceEvents", [])
                      if ev.get("ph") == "X" and "dur" in ev)
    return events


def summarize_trace(log_dir: Union[str, Path] = "m2m_trace", top: int = 30,
                    device_only: bool = True) -> list:
    """Aggregate the traces under ``log_dir`` into (total_ms, count, name)
    rows, most expensive first: the device's kernels, copies and sets
    (``device_only``), or every event.

        with profiling.trace(d):
            run()
        for ms, n, name in profiling.summarize_trace(d):
            print(f"{ms:9.1f} ms x{n:6d}  {name}")

    Capture into a fresh directory per run: the traces there add up."""
    agg: Dict[str, list] = {}
    for ev in load_trace(log_dir):
        if device_only and ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        entry = agg.setdefault(ev["name"], [0.0, 0])
        entry[0] += float(ev["dur"])
        entry[1] += 1
    rows = sorted(((dur / 1e3, cnt, name) for name, (dur, cnt) in agg.items()),
                  reverse=True)
    return rows[:top]


def annotation_window(events: List[dict], name: str) -> Tuple[float, float]:
    """(start, end) in microseconds of the host's first ``span(name)``
    (recorded on the thread that started the trace)."""
    for ev in events:
        if ev.get("cat") == "user_annotation" and ev["name"] == name:
            return float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
    raise KeyError(f"no annotation {name!r} in the trace")


def _inside(ev: dict, window: Optional[Tuple[float, float]]) -> bool:
    return window is None or window[0] <= float(ev["ts"]) < window[1]


def host_launches(events: List[dict],
                  window: Optional[Tuple[float, float]] = None
                  ) -> Dict[str, int]:
    """The host's calls that launch device work (``LAUNCH_CALLS``: kernel
    launches and graph launches) starting in ``window``, by name."""
    out: Dict[str, int] = {}
    for ev in events:
        if ev["name"] in LAUNCH_CALLS and _inside(ev, window):
            out[ev["name"]] = out.get(ev["name"], 0) + 1
    return out


def launch_ids(events: List[dict],
               window: Optional[Tuple[float, float]] = None) -> set:
    """The correlation ids of the host's calls starting in ``window``: a
    kernel the device ran carries the id of the call that launched it (a
    kernel launch, or for a graph's replay its ``cudaGraphLaunch``)."""
    return {ev["args"]["correlation"] for ev in events
            if ev.get("cat") in HOST_API_CATEGORIES
            and "correlation" in ev.get("args", {}) and _inside(ev, window)}


def device_kernels(events: List[dict], names,
                   window: Optional[Tuple[float, float]] = None
                   ) -> Dict[str, int]:
    """The device's kernels launched in ``window`` (by a host call starting
    there, matched by correlation id) whose name holds each of ``names``
    (a substring, such as a ``__global__`` function's name), counted by
    that substring: what the device ran, where the wrappers' counts say
    what the host asked for (a graph's replay runs kernels no wrapper
    launches).  The kernels' own timestamps are not compared with the
    window: the device's clock in a trace can stray from the host's by
    milliseconds (``device_clock_past``)."""
    ids = None if window is None else launch_ids(events, window)
    out = {n: 0 for n in names}
    for ev in events:
        if ev.get("cat") != "kernel" or (
                ids is not None
                and ev.get("args", {}).get("correlation") not in ids):
            continue
        for n in names:
            if n in ev["name"]:
                out[n] += 1
    return out


def device_clock_past(events: List[dict],
                      window: Tuple[float, float]) -> float:
    """Microseconds by which the last of the device's activity launched in
    ``window`` ends after the window, on the trace's clocks (0 if before).
    When the block synchronized the device before the window closed, this
    is the device clock's stray from the host's, and bounds how far a
    share over the window (``device_idle_share``) is off."""
    ids = launch_ids(events, window)
    ends = [float(ev["ts"]) + float(ev["dur"]) for ev in events
            if ev.get("cat") in DEVICE_CATEGORIES
            and ev.get("args", {}).get("correlation") in ids]
    return max([0.0] + [e - window[1] for e in ends])


def device_busy_us(events: List[dict],
                   window: Optional[Tuple[float, float]] = None) -> float:
    """Microseconds of ``window`` in which some kernel, copy or set runs on
    the device (the union of their intervals, cut to the window; all of
    the trace's device activity when None)."""
    spans = []
    for ev in events:
        if ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        s, e = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        if window is not None:
            s, e = max(s, window[0]), min(e, window[1])
        if e > s:
            spans.append((s, e))
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_idle_share(events: List[dict],
                      window: Tuple[float, float]) -> float:
    """The share of ``window`` (microseconds) in which the device runs
    nothing: 1 - ``device_busy_us`` / its length."""
    return 1.0 - device_busy_us(events, window) / (window[1] - window[0])


#: dense bf16 tensor-core FLOP/s by card-name substring, from NVIDIA's
#: H100 data sheets; more specific substrings first (the lookup scans in
#: order).  An H100 SXM5 names itself "NVIDIA H100 80GB HBM3".
PEAK_FLOPS_BF16 = {
    "h100 nvl": 835e12,
    "h100 pcie": 756e12,
    "h100 sxm": 989.4e12,
    "h100 80gb hbm3": 989.4e12,
}


def peak_flops_for_name(name: str) -> Optional[float]:
    """bf16 peak FLOP/s of the card called ``name``, or None when the
    table does not know it."""
    name = name.lower()
    for sub, peak in PEAK_FLOPS_BF16.items():
        if sub in name:
            return peak
    return None


def device_peak_flops(device=None) -> Optional[float]:
    """bf16 peak FLOP/s of ``device`` (default: the current CUDA device),
    or None for a CPU or a card the table does not know."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return peak_flops_for_name(torch.cuda.get_device_name(dev))


def _attn_proj_flops(cfg, tokens: int) -> float:
    """Q+K+V+O projections for `tokens` positions in one attention block."""
    inner = cfg.num_heads * cfg.d_kv
    return 4 * 2.0 * tokens * cfg.d_model * inner


def _ffn_flops(cfg, tokens: int) -> float:
    """Gated-GELU FFN: wi_0, wi_1, wo — three d_model x d_ff matmuls."""
    return 3 * 2.0 * tokens * cfg.d_model * cfg.d_ff


def encoder_fwd_flops(cfg, batch: int, enc_len: int) -> float:
    """Forward matmul FLOPs of the T5 encoder stack (no lm_head)."""
    inner = cfg.num_heads * cfg.d_kv
    per_layer = (
        _attn_proj_flops(cfg, enc_len)
        # scores (L x L) + attn-weighted values: 2 dots of L*L*inner
        + 2 * 2.0 * enc_len * enc_len * inner
        + _ffn_flops(cfg, enc_len)
    )
    return batch * cfg.num_layers * per_layer


def decoder_fwd_flops(cfg, batch: int, enc_len: int, dec_len: int) -> float:
    """Teacher-forced decoder forward (training shape), incl. cross-attn
    K/V projections over the encoder sequence and the untied lm_head.
    Causal self-attention counted at its true triangular cost."""
    inner = cfg.num_heads * cfg.d_kv
    causal_pairs = dec_len * (dec_len + 1) / 2.0
    per_layer = (
        _attn_proj_flops(cfg, dec_len)
        + 2 * 2.0 * causal_pairs * inner  # causal self-attn scores+values
        # cross-attn: Q,O on dec tokens; K,V on enc tokens
        + 2 * 2.0 * dec_len * cfg.d_model * inner
        + 2 * 2.0 * enc_len * cfg.d_model * inner
        + 2 * 2.0 * dec_len * enc_len * inner  # cross scores+values
        + _ffn_flops(cfg, dec_len)
    )
    lm_head = 2.0 * dec_len * cfg.d_model * cfg.vocab_size
    return batch * (cfg.num_decoder_layers * per_layer + lm_head)


def train_step_flops(cfg, batch: int, enc_len: int, dec_len: int) -> float:
    """One fwd+bwd step: the standard 3x-forward matmul approximation
    (each forward dot spawns two same-shape backward dots)."""
    return 3.0 * (
        encoder_fwd_flops(cfg, batch, enc_len)
        + decoder_fwd_flops(cfg, batch, enc_len, dec_len)
    )


def decode_flops(cfg, batch: int, enc_len: int, steps: int) -> float:
    """Model FLOPs for KV-cached greedy decode of `steps` tokens per row:
    encoder forward + one-time cross-K/V projections + per-token decoder
    work (self-attn over the causal prefix, cross-attn over enc_len,
    FFN, lm_head)."""
    inner = cfg.num_heads * cfg.d_kv
    nl = cfg.num_decoder_layers
    cross_kv_init = nl * 2 * 2.0 * enc_len * cfg.d_model * inner
    causal_pairs = steps * (steps + 1) / 2.0
    per_layer = (
        _attn_proj_flops(cfg, steps)
        + 2 * 2.0 * causal_pairs * inner
        + 2 * 2.0 * steps * cfg.d_model * inner  # cross Q,O
        + 2 * 2.0 * steps * enc_len * inner  # cross scores+values
        + _ffn_flops(cfg, steps)
    )
    lm_head = 2.0 * steps * cfg.d_model * cfg.vocab_size
    return (
        encoder_fwd_flops(cfg, batch, enc_len)
        + batch * (cross_kv_init + nl * per_layer + lm_head)
    )
