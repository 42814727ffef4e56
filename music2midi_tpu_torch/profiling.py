"""Trace helpers over ``torch.profiler``, and analytic model-FLOPs
accounting (MFU) with the card's bf16 peak.

The trace helpers port ``music2midi_tpu/profiling.py``'s ``trace``,
``timed``, ``annotate`` and ``summarize_trace`` from ``jax.profiler`` to
``torch.profiler``: ``trace`` records the host's calls and, on a card,
the device's kernels and copies, and writes a Chrome trace into its
directory; ``summarize_trace`` aggregates the device activity of the
traces there into the same (total_ms, count, name) rows.  What the decode
loop's measurement reads besides: ``host_launches`` (the host's kernel
and graph launches, ``cudaLaunchKernel`` and ``cudaGraphLaunch``, in a
window) and ``device_idle_share`` (the share of a window in which no
kernel, copy or set runs on the device), over the window of an
``annotate`` region (``annotation_window``), ``device_kernels`` (the
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

import contextlib
import gzip
import json
import os
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

import torch

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


@contextlib.contextmanager
def timed(label: str, results: Optional[dict] = None) -> Iterator[None]:
    """Wall-clock timer; stores seconds into ``results[label]`` if given.
    Where CUDA is in use the device is synchronized at both ends, so that
    the time is of the work and not of its enqueueing."""
    sync = torch.cuda.is_available() and torch.cuda.is_initialized()
    if sync:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if results is not None:
            results[label] = dt
        print(f"[timed] {label}: {dt * 1000:.1f} ms")


def annotate(name: str):
    """Named region for profiler traces (``torch.profiler.record_function``,
    the counterpart of ``jax.profiler.TraceAnnotation``)."""
    return torch.profiler.record_function(name)


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
    """(start, end) in microseconds of the host's first ``annotate(name)``
    region."""
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
