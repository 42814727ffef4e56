"""Drive the PyTorch/CUDA port (music2midi_tpu_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing one line with its own seconds; any failure raises
and exits non-zero, and nothing is caught and passed over:

  1. environment: card name, ``nvidia-smi`` name and power limit, torch
     and nvcc versions (no card: exit 1 before anything else);
  2. build: ``music2midi_tpu_torch/csrc/*.cu``, one nvcc per source in
     parallel, then one link;
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     card at the shapes the serving path gives it, then the kernel, the
     plain version and a library yardstick timed with CUDA events:
     - the FFT and the direct-DFT log-mel kernels at the serving shape of
       a 3-minute song (64 chunks of 48000 samples: noise, a 440 Hz tone
       and silence, plus the bucket's zero rows) and at a ragged length
       (41234 samples), with the TPU kernel's bars: noise within 1e-3 in
       the log domain, silence on log(1e-6) within 1e-4, the tone's
       argmax mel bin equal; yardstick: a torch.stft chain; bound: the
       function's (a real FFT's operations) for both kernels, and for the
       direct-DFT one also its algorithm's (``algorithm_bound_ms``: 3xTF32
       over the folded K at the dense TF32 rate);
     - the int8 decode-attention kernel at B = 64, H = 8, D = 64 over a
       1024-long int8 cache, causal at steps 0, 63, 127 and 1022, and
       cross at enc_len 190 = L and 150 on K/V laid out as
       ``precompute_cross_kv`` lays them out, with ``round_pv`` off (the
       TPU kernel's arithmetic) and on (the serving route's); its launch
       plan (``Int8AttentionPlan``) equal to it bit for bit; the
       transposed-cross kernel at (64, 8, 64, 190) on the padded rows of
       ``transpose_cross_entry``, enc_len 190 and 150; bar 2e-2 on the bf16
       outputs; yardstick: ``F.scaled_dot_product_attention`` over K/V
       dequantized to bf16 before the timed region; timed over six
       inputs in turn, as the decode loop's six layers come: kernel 3 at
       causal n = 32, 128 and 1023 and cross L = 190, ``round_pv`` on and
       off, through the public function and through the launch plan, each
       with its host-inclusive time beside sdpa's; then kernel 3's f32
       instance (a float32 query and output, an fp32 engine with int8 KV)
       at the same causal n and cross L, bar 1e-5 relative to the largest
       output, f32 sdpa beside it; and kernel 3 on the +-7-level entries
       of ``kv_bits=4`` (int8 storage), bar 2e-2 on the bf16 outputs;
  4. serving path: ``Music2MIDI.from_npz(model of record, bf16)`` on the
     card, ``generate(audio_path=...)`` on the calibration fixture, the
     pinned ``check_midi`` gate, and the launch counts of this run (the
     mel kernel, the int8 decode-attention kernel); then the same with
     ``pallas_cross = True`` (the transposed-cross kernel);
  5. DFT mel path: the direct-DFT log-mel entry point on the song's chunk
     batch (no engine path calls it), against the serving mel;
  6. fp32 parity: the same fixture's greedy tokens through fp32 engines
     on the card and on the CPU, agreement >= 0.99;
  7. song timing: a synthetic 3-minute song through serving ``generate``,
     one warm-up (its kernel launches counted) and three timed runs, a
     per-stage breakdown, and the
     decode stage with the attention kernels off and on (in turns) on
     the same encoder output, and the greedy tokens of the two routes
     (the kernel with ``round_pv``, and plain ``_attention_int8``);
  8. batch serving: ``warmup([128])``, then ``generate_batch`` over four
     synthetic 3-minute songs, one warm-up (its kernel launches counted)
     and two timed runs;
  9. engine options on the calibration fixture with the model of record,
     each from a fresh engine: bf16 with ``int8_weights``, ``kv_bits=4``,
     ``unroll=8`` (tokens equal to default serving's), sampling at
     ``temperature=1.0, top_k=10`` twice with one ``sample_seed`` (equal
     tokens), and fp32 with ``int8_kv=True`` (kernel 3's f32 instance);
     each prints its notes, launch counts and greedy-token agreement with
     default serving, and its decode stage time on the song's batch;
  10. bench: ``music2midi_tpu_torch.bench``'s workload cut to 2 of its 8
     songs, 1 group of 1 trial and 1 latency trial, then its secondary
     forced-256 run on the same songs: songs/min, p50 latency, ``mfu``
     (required non-null on an H100), ``mfu_executed``, tokens, notes;
  11. the ``kernels`` JSON line.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Only ``nvcc`` and ``nvidia-smi`` are started as subprocesses; no threads.
"""

from __future__ import annotations

import itertools
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RECORD = ROOT / "checkpoints" / "model_of_record.npz"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM, dense TF32 on the tensor cores
ATTN_BAR = 2e-2  # decode-attention kernels vs plain, bf16 outputs
F32_BAR = 1e-5  # kernel 3's f32 instance vs plain, relative to max |out|
B_SERVE, HEADS, D_KV = 64, 8, 64  # the song's bucket; the model's heads
SELF_LEN, ENC_LEN = 1024, 190  # decode_max_length; 188 frames + 2 cond
N_LAYERS = 6  # decoder layers: timed inputs taken in turn


def require(ok: bool, what) -> None:
    """A check of the run; raises (and so fails the script) when false."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


class Phase:
    """Prints one flushed line per phase with its seconds."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.info = ""
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            dt = time.perf_counter() - self.t0
            print(f"[phase] {self.name}: ok in {dt:.3f} s {self.info}",
                  flush=True)
        return False


def timed_s(fn) -> tuple:
    """(fn's result, host seconds around it), ending in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over `iters` back-to-back calls, CUDA
    events: the time of the device or of the host's launches, whichever
    is longer (a stage's latency)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_SPIN = {}


def spin_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` per millisecond, measured once."""
    import torch

    if "cycles_per_ms" not in _SPIN:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        torch.cuda.synchronize()
        _SPIN["cycles_per_ms"] = 10_000_000 / start.elapsed_time(end)
    return _SPIN["cycles_per_ms"]


def device_ms(fn, iters: int, warmup: int = 3) -> tuple:
    """-> (device ms per call, host-inclusive ms per call).  The calls
    are queued behind a spin kernel that outlasts their enqueueing, so
    the events around them time the device alone and not the host's
    launch rate; the second number is ``cuda_ms``'s."""
    import torch

    host = cuda_ms(fn, iters, warmup)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((1.5 * iters * host + 5.0) * spin_cycles_per_ms()))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host


def stft_log_mel(wave, cfg):
    """The same log-mel through torch.stft (cuFFT), the library yardstick."""
    import torch

    from music2midi_tpu_torch.ops.mel import filterbank_for, hann_window

    window = torch.from_numpy(hann_window(cfg.n_fft)).to(wave.device)
    spec = torch.stft(wave, cfg.n_fft, cfg.hop_length, window=window,
                      center=True, pad_mode="reflect", return_complex=True)
    power = spec.real.square() + spec.imag.square()  # (B, n_freqs, F)
    fb = torch.from_numpy(filterbank_for(cfg)).to(wave.device)
    mel = torch.matmul(power.transpose(1, 2), fb)
    return torch.log(torch.clamp(mel, min=cfg.log_floor))


def _bound(nbytes: float, ops: float) -> tuple:
    """-> (ms, "bytes" or "operations", bytes, ops): the larger of bytes
    over the HBM rate and fp32 operations over the fp32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def mel_bound(B: int, S: int, cfg) -> tuple:
    """Least time on the card for the log-mel of (B, S): bytes (wave read
    once, mels written once) over HBM rate vs fp32 operations over the
    fp32 rate.  The function needs, per frame, an n_fft-point real FFT,
    2.5 N log2 N flops (half a complex FFT of the same length), plus the
    window, the power of N/2 + 1 bins and the multiply-adds of the nonzero
    mel weights: this is the bound of both mel kernels."""
    from music2midi_tpu_torch.ops.mel import num_frames
    from music2midi_tpu_torch.ops.mel_cuda import mel_nnz

    F = num_frames(S, cfg)
    n = cfg.n_fft
    nbytes = 4 * B * S + 4 * B * F * cfg.n_mels
    per_frame = (2.5 * n * math.log2(n) + n + 3 * (n // 2 + 1)
                 + 2 * mel_nnz(cfg))
    return _bound(nbytes, B * F * per_frame)


def dft_algorithm_bound(B: int, S: int, cfg) -> tuple:
    """Least time of the direct-DFT kernel's own algorithm, not of the
    function: three TF32 tensor-core passes (3xTF32) of a (B F) x (N/2) x N
    product, the frames folded to K = N/2 against the cos and sin columns
    of N/2 bins each, at the dense TF32 rate -> (ms, flops)."""
    from music2midi_tpu_torch.ops.mel import num_frames

    n = cfg.n_fft
    ops = 3 * 2 * B * num_frames(S, cfg) * (n // 2) * n
    return ops / TF32_FLOPS_PER_S * 1e3, ops


def attention_bound(B: int, H: int, D: int, n: int, causal: bool,
                    q_bytes: int = 2) -> tuple:
    """Least time on the card for one decode-attention call over n visible
    keys: each input read once (n int8 K and V rows, key `step`'s from the
    fresh row in the causal case, their f32 scales, the bias row, q of
    `q_bytes` an element) and the output (q's type) written once, vs
    4 B H n D fp32 flops (q.k and p.v)."""
    nbytes = 2 * B * H * n * (D + 4) + 2 * B * H * D * q_bytes
    if causal:
        nbytes += H * n * 4
    return _bound(nbytes, 4 * B * H * n * D)


def synthetic_song(seconds: float, sr: int, seed: int):
    """A piano-like song from the port's synthesizer: random chords and
    melody notes, made from `seed`."""
    import numpy as np

    from music2midi_tpu_torch.utils import numpy_to_midi

    rng = np.random.default_rng(seed)
    notes = []
    t = 0.0
    while t < seconds - 1.0:
        for p in rng.choice(np.arange(48, 84), size=rng.integers(1, 4),
                            replace=False):
            dur = float(rng.uniform(0.2, 1.0))
            notes.append([t, min(t + dur, seconds), int(p),
                          int(rng.integers(60, 110))])
        t += float(rng.choice([0.25, 0.5, 0.75]))
    wave = numpy_to_midi(np.array(notes)).synthesize(fs=sr)
    out = np.zeros(int(seconds * sr), np.float32)
    out[:min(len(out), len(wave))] = wave[:len(out)]
    return out / max(1e-6, float(np.abs(out).max())) * 0.8


def int8_attention_inputs(L: int, causal: bool, n_sets: int,
                          bits: int = 8) -> list:
    """`n_sets` seeded decode-attention inputs on the card at the serving
    widths, laid out as the decode loop lays them out: q bf16 (B, H, 1, D);
    int8 K/V (B, H, L, D) through the port's ``_quantize_kv`` at ``bits``
    (+-127 or +-7 levels), for the
    causal kernel of a contiguous cache buffer (as ``init_kv_cache``) with
    the fresh int8 rows and a (1, H, 1, L) bias row, for the cross one of
    a ``_split_heads`` view of a bf16 (B, L, H*D) projection (as
    ``precompute_cross_kv``: keys H*D bytes apart)."""
    import torch

    from music2midi_tpu_torch.models.t5 import _quantize_kv, _split_heads

    g = torch.Generator(device="cuda").manual_seed(L + int(causal) + bits)

    def normal(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    B, H, D = B_SERVE, HEADS, D_KV
    sets = []
    for _ in range(n_sets):
        one = [normal(B, H, 1, D).to(torch.bfloat16)]
        if causal:
            one += [_quantize_kv(normal(B, H, L, D), bits),
                    _quantize_kv(normal(B, H, L, D), bits),
                    _quantize_kv(normal(B, H, 1, D), bits),
                    _quantize_kv(normal(B, H, 1, D), bits),
                    normal(1, H, 1, L)]
        else:
            one += [_quantize_kv(_split_heads(
                normal(B, L, H * D).to(torch.bfloat16), H, D), bits)
                for _ in range(2)]
            require(one[1][0].stride(2) == H * D,
                    "cross inputs not in the decode loop's layout")
        sets.append(one)
    return sets


def dequantized(entry, n: int, dtype=None):
    """The first n positions of an int8 (values, scales) entry as `dtype`
    (default bf16)."""
    import torch

    vals, scales = entry
    return (vals[:, :, :n].float() * scales[..., :n].transpose(-1, -2)).to(
        dtype or torch.bfloat16).contiguous()


def rotating(calls: list):
    """One call per invocation, taking `calls` in turn (as the decode
    loop's layers come, so a timed input is not the one just read)."""
    it = itertools.cycle(calls)
    return lambda: next(it)()


def time_three(kernel_calls, plain_calls, library_calls, iters=200) -> tuple:
    """((device, host-inclusive) ms per call) of the kernel, the plain
    version and the library call (``device_ms``); few enough calls that
    the launches queued behind the spin kernel stay under the stream's
    queue depth."""
    return (device_ms(rotating(kernel_calls), iters),
            device_ms(rotating(plain_calls), iters // 5),
            device_ms(rotating(library_calls), iters))


def attention_phase(smi: str) -> tuple:
    """Check and time the two decode-attention kernels -> (int8 entry,
    cross_t entry) of the kernels line, launches still to fill (the int8
    entry's ``f32_instance`` too)."""
    import torch
    import torch.nn.functional as F

    from music2midi_tpu_torch.ops import decode_attention as da

    bf16, f32 = torch.bfloat16, torch.float32

    def check(got, ref, what) -> float:
        torch.cuda.synchronize()
        require(got.shape == ref.shape and got.dtype == torch.bfloat16,
                f"{what}: {got.shape} {got.dtype} vs {ref.shape}")
        require(bool(torch.isfinite(got.float()).all()),
                f"{what}: non-finite kernel output")
        err = float((got.float() - ref.float()).abs().max())
        require(err <= ATTN_BAR, f"{what}: kernel vs plain {err} > {ATTN_BAR}")
        return err

    def check_f32(got, ref, what) -> float:
        """The f32 instance: max |diff| over max |plain| within F32_BAR."""
        torch.cuda.synchronize()
        require(got.shape == ref.shape and got.dtype == f32,
                f"{what}: {got.shape} {got.dtype} vs {ref.shape}")
        require(bool(torch.isfinite(got).all()),
                f"{what}: non-finite kernel output")
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        require(err <= F32_BAR, f"{what}: kernel vs plain {err} > {F32_BAR} "
                                "relative")
        return err

    sets = {8: (int8_attention_inputs(SELF_LEN, True, N_LAYERS),
                int8_attention_inputs(ENC_LEN, False, N_LAYERS)),
            4: (int8_attention_inputs(SELF_LEN, True, N_LAYERS, bits=4),
                int8_attention_inputs(ENC_LEN, False, N_LAYERS, bits=4))}
    self_sets, cross_sets = sets[8]
    # f32 queries for the f32 instance: the bf16 ones plus f32 detail
    g = torch.Generator(device="cuda").manual_seed(32)
    q32 = {id(one[0]): one[0].float() + 1e-2 * torch.randn(
        one[0].shape, generator=g, device="cuda")
        for bits in sets for group in sets[bits] for one in group}
    cross_t_sets = [(q, da.transpose_cross_entry(k),
                     da.transpose_cross_entry(v)) for q, k, v in cross_sets]
    errs = {"int8": 0.0, "cross_t": 0.0, "f32": 0.0}
    for bits in (8, 4):
        q, k, v, kn, vn, bias = sets[bits][0][0]
        for step, rp in itertools.product((0, 63, 127, SELF_LEN - 2),
                                          (False, True)):
            errs["int8"] = max(errs["int8"], check(
                da.decode_attention_int8(q, k, v, bias, step, kn, vn, True,
                                         round_pv=rp),
                da.decode_attention_int8_plain(q, k, v, bias, step, kn, vn,
                                               True, round_pv=rp),
                f"int8 causal {bits}-bit step {step} round_pv {rp}"))
    q, k, v, kn, vn, bias = self_sets[0]
    for step in (31, 127, SELF_LEN - 2):
        qf = q32[id(q)]
        errs["f32"] = max(errs["f32"], check_f32(
            da.decode_attention_int8(qf, k, v, bias, step, kn, vn, True,
                                     round_pv=True),
            da.decode_attention_int8_plain(qf, k, v, bias, step, kn, vn,
                                           True, round_pv=True),
            f"int8 causal f32 step {step}"))
    q, k, v = cross_sets[0]
    qt, kt, vt = cross_t_sets[0]
    require(kt[0].stride(2) == 192, "transposed cross rows not padded")
    for enc_len in (ENC_LEN, 150):
        for rp, (q4, k4, v4) in itertools.product((False, True),
                                                  (sets[8][1][0],
                                                   sets[4][1][0])):
            errs["int8"] = max(errs["int8"], check(
                da.decode_attention_int8(q4, k4, v4, None, None, None, None,
                                         False, enc_len, round_pv=rp),
                da.decode_attention_int8_plain(q4, k4, v4, None, None, None,
                                               None, False, enc_len,
                                               round_pv=rp),
                f"int8 cross enc_len {enc_len} round_pv {rp}"))
        qf = q32[id(q)]
        errs["f32"] = max(errs["f32"], check_f32(
            da.decode_attention_int8(qf, k, v, None, None, None, None, False,
                                     enc_len, round_pv=True),
            da.decode_attention_int8_plain(qf, k, v, None, None, None, None,
                                           False, enc_len, round_pv=True),
            f"int8 cross f32 enc_len {enc_len}"))
        errs["cross_t"] = max(errs["cross_t"], check(
            da.decode_attention_cross_t(qt, kt, vt, enc_len),
            da.decode_attention_cross_t_plain(qt, kt, vt, enc_len),
            f"cross_t enc_len {enc_len}"))

    def plans(rp, bits=8, dtype=bf16):
        """One launch plan a decode layer, over its self cache, bias rows
        and cross-KV, as ``generate_tokens`` builds them."""
        ss, cs = sets[bits]
        return [da.Int8AttentionPlan([(k, v)], bias[0, :, 0, :], [(ck, cv)],
                                     ENC_LEN, round_pv=rp, dtype=dtype)
                for (_, k, v, _, _, bias), (_, ck, cv) in zip(ss, cs)]

    def query(q, dtype):
        return q if dtype == bf16 else q32[id(q)]

    def self_calls(step, rp, bits=8, dtype=bf16):
        """The views the decode loop passes at `step`: the visible prefix
        of the cache and the bias rows' window (the engine's bias rows
        (H, L): key j of step s at column L - s - 1 + j), no copies; and
        the same call through each layer's launch plan."""
        n = step + 1
        out = {"kernel": [], "plan": [], "plain": [], "library": []}
        for (q, k, v, kn, vn, bias), plan in zip(sets[bits][0],
                                                 plans(rp, bits, dtype)):
            q = query(q, dtype)
            r = bias[0, :, 0, :]
            args = (q, (k[0][:, :, :n], k[1][..., :n]),
                    (v[0][:, :, :n], v[1][..., :n]), r[:, SELF_LEN - n:],
                    step, kn, vn, True, 0, rp)
            out["kernel"].append(lambda a=args: da.decode_attention_int8(*a))
            out["plan"].append(
                lambda p=plan, q=q, kn=kn, vn=vn: p.causal(0, q, kn, vn, step))
            out["plain"].append(
                lambda a=args: da.decode_attention_int8_plain(*a))
            kd, vd = dequantized(k, n, dtype), dequantized(v, n, dtype)
            # contiguous: sdpa's kernels fault on a mask view whose start
            # is not 16-byte aligned (an f32 window at an odd column)
            mask = r[None, :, None, SELF_LEN - n:].to(dtype).contiguous()
            out["library"].append(
                lambda q=q, kd=kd, vd=vd, m=mask:
                F.scaled_dot_product_attention(q, kd, vd, attn_mask=m,
                                               scale=1.0))
        return out

    def cross_calls(transposed, rp=False, bits=8, dtype=bf16):
        out = {"kernel": [], "plan": [], "plain": [], "library": []}
        for (q, k, v), (_, kt, vt), plan in zip(sets[bits][1], cross_t_sets,
                                                plans(rp, bits, dtype)):
            q = query(q, dtype)
            if transposed:
                args = (q, kt, vt, ENC_LEN)
                out["kernel"].append(
                    lambda a=args: da.decode_attention_cross_t(*a))
                out["plain"].append(
                    lambda a=args: da.decode_attention_cross_t_plain(*a))
            else:
                args = (q, k, v, None, None, None, None, False, ENC_LEN, rp)
                out["kernel"].append(
                    lambda a=args: da.decode_attention_int8(*a))
                out["plan"].append(lambda p=plan, q=q: p.cross(0, q))
                out["plain"].append(
                    lambda a=args: da.decode_attention_int8_plain(*a))
            kd = dequantized(k, ENC_LEN, dtype)
            vd = dequantized(v, ENC_LEN, dtype)
            out["library"].append(
                lambda q=q, kd=kd, vd=vd:
                F.scaled_dot_product_attention(q, kd, vd, scale=1.0))
        return out

    # the launch plan runs the same kernel: equal bit for bit to the public
    # function on the same operands, in both instances
    for calls in (self_calls(700, True), cross_calls(False, True),
                  self_calls(700, True, dtype=f32),
                  cross_calls(False, True, dtype=f32)):
        got, want = calls["plan"][0]().clone(), calls["kernel"][0]()
        require(torch.equal(got, want), "launch plan vs decode_attention_int8")

    # kernel 3 with round_pv (the serving route's arithmetic) first; most
    # chunks end by step 110, so n = 32 is the common step
    timings = {"int8": [], "cross_t": [], "f32": []}
    rows = [("int8", "causal step 31 round_pv", self_calls(31, True), 32,
             True),
            ("int8", "causal step 127 round_pv", self_calls(127, True), 128,
             True),
            ("int8", "causal step 1022 round_pv",
             self_calls(SELF_LEN - 2, True), SELF_LEN - 1, True),
            ("int8", "cross L 190 round_pv", cross_calls(False, True),
             ENC_LEN, False),
            ("int8", "causal step 31", self_calls(31, False), 32, True),
            ("int8", "causal step 127", self_calls(127, False), 128, True),
            ("int8", "causal step 1022", self_calls(SELF_LEN - 2, False),
             SELF_LEN - 1, True),
            ("int8", "cross L 190", cross_calls(False), ENC_LEN, False),
            ("cross_t", "cross L 190", cross_calls(True), ENC_LEN, False)]
    for n in (32, 128, SELF_LEN - 1):
        rows.append(("f32", f"f32 causal step {n - 1}",
                     self_calls(n - 1, True, dtype=f32), n, True))
        rows.append(("int8", f"4-bit causal step {n - 1} round_pv",
                     self_calls(n - 1, True, bits=4), n, True))
    rows.append(("f32", "f32 cross L 190", cross_calls(False, True, dtype=f32),
                 ENC_LEN, False))
    rows.append(("int8", "4-bit cross L 190 round_pv",
                 cross_calls(False, True, bits=4), ENC_LEN, False))
    for name, what, calls, n, causal in rows:
        (ms, host_ms), (plain_ms, plain_host), (library_ms, lib_host) = \
            time_three(calls["kernel"], calls["plain"], calls["library"])
        plan_ms = plan_host = None
        if calls["plan"]:
            plan_ms, plan_host = device_ms(rotating(calls["plan"]), 200)
        bound_ms, bound_by, nbytes, ops = attention_bound(
            B_SERVE, HEADS, D_KV, n, causal, 4 if name == "f32" else 2)
        timings[name].append({
            "shape": f"{what}: B {B_SERVE}, H {HEADS}, D {D_KV}, {n} keys",
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "flops": ops, "host_ms": host_ms, "plain_host_ms": plain_host,
            "library_host_ms": lib_host, "plan_ms": plan_ms,
            "plan_host_ms": plan_host})
        plan = ("" if plan_ms is None else
                f" plan: device ms={plan_ms:.5f} host-inclusive ms="
                f"{plan_host:.5f};")
        lib = "f32" if name == "f32" else "bf16"
        print(f"  {name} {what}: device ms={ms:.5f} plain_ms={plain_ms:.5f} "
              f"library_ms(sdpa, {lib} K/V)={library_ms:.5f} "
              f"bound_ms={bound_ms:.5f} ({bound_by}; {nbytes} B, {ops} flop)"
              f";{plan} host-inclusive ms: public function={host_ms:.5f} "
              f"plain={plain_host:.5f} library={lib_host:.5f} [{smi}]",
              flush=True)

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def entry(name, source, replaces, head):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": 0,
                "max_abs_err": errs[name], **{k: head[k] for k in keys},
                "shape": head["shape"], "timings": timings[name]}

    head = next(t for t in timings["int8"]
                if t["shape"].startswith("causal step 1022 round_pv"))
    f32_head = next(t for t in timings["f32"]
                    if t["shape"].startswith("f32 causal step 1022"))
    int8 = entry("int8", "music2midi_tpu_torch/csrc/decode_attention.cu",
                 "music2midi_tpu/ops/decode_attention.py:155", head)
    int8["timings"] += timings["f32"]
    # the f32 query instance (an fp32 engine with int8 KV): its launches
    # are those of that engine's run in engine_options
    int8["f32_instance"] = {"launches": 0, "max_rel_err": errs["f32"],
                            **{k: f32_head[k] for k in keys},
                            "plan_host_ms": f32_head["plan_host_ms"],
                            "shape": f32_head["shape"]}
    return (int8,
            entry("cross_t", "music2midi_tpu_torch/csrc/decode_attention.cu",
                  "music2midi_tpu/ops/decode_attention.py:288",
                  timings["cross_t"][0]))


def _wrappers() -> list:
    from music2midi_tpu_torch.ops import decode_attention as da
    from music2midi_tpu_torch.ops import mel_cuda

    return [mel_cuda.log_mel_spectrogram_cuda,
            mel_cuda.log_mel_spectrogram_dft_cuda,
            da.decode_attention_int8, da.decode_attention_cross_t]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from music2midi_tpu_torch.audio import resample, write_wav
    from music2midi_tpu_torch.bench import card_name_and_power_limit
    from music2midi_tpu_torch.calibration import check_midi, render_fixture
    from music2midi_tpu_torch.infer import Music2MIDI
    from music2midi_tpu_torch.infer.decode import generate_tokens
    from music2midi_tpu_torch.ops import _build
    from music2midi_tpu_torch.ops.detokenize import detokenize
    from music2midi_tpu_torch.ops.mel import LogMelConfig, log_mel_spectrogram
    from music2midi_tpu_torch.ops.mel_cuda import (
        log_mel_spectrogram_cuda,
        log_mel_spectrogram_dft_cuda,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = _wrappers()

    def launches_of(fn) -> dict:
        """Counts to 0, run fn, read every count just after."""
        for w in wrappers:
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {w.__name__: w.launches for w in wrappers}

    with Phase("environment") as ph:
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = card_name_and_power_limit()
        nvcc_ver = subprocess.run(
            [_build.find_nvcc(), "--version"], capture_output=True,
            text=True, check=True,
        ).stdout.strip().splitlines()[-1]
        print(smi, flush=True)
        ph.info = (f"device={kind!r} count={count} torch={torch.__version__} "
                   f"cuda={torch.version.cuda} nvcc={nvcc_ver!r}")

    with Phase("build") as ph:
        info = _build.build()
        for line in info.ptxas_lines():
            print(f"  ptxas: {line}", flush=True)
        ph.info = (f"nvcc_seconds={info.seconds:.2f} cached={info.cached} "
                   f"lib={info.path.name}")
        _build.load()

    cfg = LogMelConfig()
    mel_entries = {}
    with Phase("kernel_vs_plain_mel") as ph:
        rng = np.random.default_rng(0)
        S, B, n_real = 48000, 64, 60
        t = np.arange(S) / cfg.sample_rate
        wave = np.zeros((B, S), np.float32)
        for i in range(n_real):
            if i % 3 == 0:
                wave[i] = rng.normal(size=S) * 0.3
            elif i % 3 == 1:
                wave[i] = np.sin(2 * np.pi * 440.0 * t)
        ragged = (rng.normal(size=(4, 41234)) * 0.3).astype(np.float32)
        noise_rows = list(range(0, n_real, 3))
        x = torch.from_numpy(wave).cuda()
        ref = log_mel_spectrogram(x, cfg)
        lib = stft_log_mel(x, cfg)
        lib_err = float((lib - ref).abs().max())
        plain_ms = device_ms(lambda: log_mel_spectrogram(x, cfg), 20)[0]
        library_ms = device_ms(lambda: stft_log_mel(x, cfg), 20)[0]
        infos = [f"stft_vs_plain={lib_err:.2e} plain_ms={plain_ms:.4f} "
                 f"library_ms={library_ms:.4f}"]
        for name, fn, source, replaces, dft in (
                ("log_mel_fft", log_mel_spectrogram_cuda,
                 "music2midi_tpu_torch/csrc/mel_fft.cu",
                 "music2midi_tpu/ops/mel_pallas.py:148", False),
                ("log_mel_dft", log_mel_spectrogram_dft_cuda,
                 "music2midi_tpu_torch/csrc/mel_dft.cu",
                 "music2midi_tpu/ops/mel_pallas.py:342", True)):
            max_err = 0.0
            for w, rows in ((wave, noise_rows), (ragged, [0, 1, 2, 3])):
                xw = torch.from_numpy(w).cuda()
                got = fn(xw, cfg)
                torch.cuda.synchronize()
                refw = log_mel_spectrogram(xw, cfg)
                require(got.shape == refw.shape,
                        f"{name}: shapes {got.shape} vs {refw.shape}")
                require(bool(torch.isfinite(got).all()),
                        f"{name}: non-finite kernel output")
                err = float((got[rows] - refw[rows]).abs().max())
                require(err <= 1e-3,
                        f"{name}: kernel vs plain max |diff| {err} > 1e-3")
                max_err = max(max_err, err)
            got = fn(x, cfg)
            silence = float((got[2:n_real:3] - math.log(1e-6)).abs().max())
            require(silence <= 1e-4,
                    f"{name}: silence off the log floor by {silence}")
            tone_k = int(got[1].mean(0).argmax())
            tone_p = int(ref[1].mean(0).argmax())
            require(tone_k == tone_p,
                    f"{name}: tone argmax bin {tone_k} vs {tone_p}")
            # tone rows: near-silent mel bins sit at fp32 round-off, so
            # they are held by argmax only (as the JAX package's tests
            # hold them)
            tone_err = float((got[1:n_real:3] - ref[1:n_real:3]).abs().max())
            ms = device_ms(lambda: fn(x, cfg), 50 if not dft else 10)[0]
            bound_ms, bound_by, nbytes, ops = mel_bound(B, S, cfg)
            mel_entries[name] = {
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": 0, "max_abs_err": max_err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
                "shape": f"wave ({B}, {S}) f32 -> ({B}, 188, {cfg.n_mels})"}
            algo = ""
            if dft:
                algo_ms, algo_ops = dft_algorithm_bound(B, S, cfg)
                mel_entries[name]["algorithm_bound_ms"] = algo_ms
                algo = (f" algorithm_bound_ms(3xTF32 over the folded K at "
                        f"{TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s dense TF32)="
                        f"{algo_ms:.4f} ({algo_ops:.4g} flop)")
            infos.append(
                f"{name}: max_abs_err(noise)={max_err:.3e} "
                f"silence_err={silence:.2e} tone_bin={tone_k} "
                f"tone: kernel-plain={tone_err:.3e} ms={ms:.4f} "
                f"bound_ms={bound_ms:.4f} ({bound_by}; {nbytes} B, "
                f"{ops:.4g} flop){algo}")
        ph.info = f"shape=({B},{S}) " + " | ".join(infos) + f" [{smi}]"

    with Phase("kernel_vs_plain_attention") as ph:
        int8_entry, cross_t_entry = attention_phase(smi)
        ph.info = (f"max_abs_err int8={int8_entry['max_abs_err']:.3e} "
                   f"cross_t={cross_t_entry['max_abs_err']:.3e} "
                   f"(bar {ATTN_BAR})")

    fixture, fixture_sr = render_fixture()
    with Phase("serving_path") as ph:
        engine = Music2MIDI.from_npz(RECORD, dtype=torch.bfloat16)
        require(engine.device.type == "cuda", "engine not on the card")
        cross_engine = Music2MIDI.from_npz(RECORD, dtype=torch.bfloat16)
        cross_engine.pallas_cross = True
        infos = []
        with tempfile.TemporaryDirectory() as td:
            path = str(Path(td) / "a4_22050.wav")
            write_wav(path, fixture, fixture_sr)
            for eng, label in ((engine, "serving"),
                               (cross_engine, "pallas_cross")):
                midi, n = launches_of(lambda: eng.generate(audio_path=path))
                ok, detail = check_midi(midi)
                require(ok, f"{label}: calibration gate failed on the card: "
                            f"{detail}")
                require(n["log_mel_spectrogram_cuda"] > 0,
                        f"{label}: the mel kernel was not launched")
                require(n["decode_attention_int8"] > 0,
                        f"{label}: the int8 decode-attention kernel was not "
                        "launched")
                if label == "serving":
                    mel_entries["log_mel_fft"]["launches"] = \
                        n["log_mel_spectrogram_cuda"]
                    int8_entry["launches"] = n["decode_attention_int8"]
                else:
                    require(n["decode_attention_cross_t"] > 0,
                            "pallas_cross: the transposed-cross kernel was "
                            "not launched")
                    cross_t_entry["launches"] = n["decode_attention_cross_t"]
                infos.append(
                    f"{label}: check_midi=pass ({detail}) "
                    f"notes={len(midi.instruments[0].notes)} "
                    f"decode={eng.last_decode_stats[0]['steps']} steps "
                    f"launches={n}")
        ph.info = " | ".join(infos)

    song = synthetic_song(180.0, 16000, seed=7)
    with Phase("dft_mel_path") as ph:
        # the direct-DFT entry point on the song's chunk batch: no engine
        # path calls it (as in the JAX package, where only tests do)
        batch, cond = engine._pad_batch(engine._chunk_waveform(song))
        wave = engine._device_wave(batch)
        mel_dft, n = launches_of(
            lambda: log_mel_spectrogram_dft_cuda(wave, cfg))
        require(n["log_mel_spectrogram_dft_cuda"] > 0,
                "the direct-DFT mel kernel was not launched")
        mel_entries["log_mel_dft"]["launches"] = \
            n["log_mel_spectrogram_dft_cuda"]
        mel_fft = engine._log_mel(wave)
        require(mel_dft.shape == mel_fft.shape, "DFT mel shape")
        diff = float((mel_dft - mel_fft).abs().max())
        diff_mean = float((mel_dft - mel_fft).abs().mean())
        ph.info = (f"song batch {tuple(wave.shape)} launches={n} "
                   f"dft_vs_serving_mel max={diff:.3e} mean={diff_mean:.3e}")

    with Phase("fp32_parity") as ph:
        chunks16 = resample(fixture, fixture_sr, 16000)
        toks = {}
        for dev in ("cuda", "cpu"):
            eng = Music2MIDI.from_npz(RECORD, device=dev)
            toks[dev] = eng.sample_tokens_batched(eng._chunk_waveform(chunks16))
        same = total = 0
        for a, b in zip(toks["cuda"], toks["cpu"]):
            n_tok = max(len(a), len(b))
            pa = np.zeros(n_tok, np.int64)
            pb = np.zeros(n_tok, np.int64)
            pa[:len(a)], pb[:len(b)] = a, b
            same += int((pa == pb).sum())
            total += n_tok
        agree = same / total
        require(agree >= 0.99, f"fp32 cuda-vs-cpu token agreement {agree}")
        ph.info = f"token_agreement={agree:.6f} ({same}/{total} tokens)"

    with Phase("song_timing") as ph:
        times = []
        n_notes = 0
        _, song_launches = launches_of(lambda: engine.generate(audio_y=song))
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            midi = engine.generate(audio_y=song)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            n_notes = len(midi.instruments[0].notes)
        require(n_notes > 0, "the 3-minute song gave no notes")
        p50 = float(np.median(times))
        stats = engine.last_decode_stats
        # per-stage time of the song's one batch through the engine's own
        # stage methods, CUDA events
        mel = engine._log_mel(wave)
        enc = engine._encoder(mel, cond)
        tokens, _ = engine._decode(enc)
        st_wave = cuda_ms(lambda: engine._device_wave(batch), 10)
        st_mel = cuda_ms(lambda: engine._log_mel(wave), 10)
        st_enc = cuda_ms(lambda: engine._encoder(mel, cond), 5)
        st_dec = cuda_ms(lambda: engine._decode(enc), 1, 0)
        start_idx = torch.zeros(len(batch), dtype=torch.long, device="cuda")
        st_det = cuda_ms(lambda: detokenize(tokens[:, :stats[0]["steps"] + 1],
                                            start_idx), 5)
        row_steps = stats[0]["row_steps"]
        at_cap = [i for i, s in enumerate(row_steps)
                  if s >= engine.decode_max_length - 1]
        # the decode stage with the attention kernels off and on, in turns
        # (off, on, on, off), on the same encoder output
        dec = {}
        for on in (False, True, True, False):
            dcfg = engine._dcfg()._replace(pallas_attention=on)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, lens = generate_tokens(engine.model, enc,
                                         engine.t5_config, dcfg)
            torch.cuda.synchronize()
            dec.setdefault(on, []).append(
                (time.perf_counter() - t0, toks, lens))
        (_, t_off, l_off), (_, t_on, l_on) = dec[False][0], dec[True][0]
        t_off, t_on = t_off.cpu().numpy(), t_on.cpu().numpy()
        l_off, l_on = l_off.cpu().numpy(), l_on.cpu().numpy()
        agree_n = agree_d = 0
        for r in range(stats[0]["real_rows"]):
            m = int(max(l_off[r], l_on[r]))
            agree_n += int((t_off[r, :m] == t_on[r, :m]).sum())
            agree_d += m
        ph.info = (f"p50_song_latency_s={p50:.4f} "
                   f"songs_per_min={60.0 / p50:.3f} runs_s={times} "
                   f"launches={song_launches} "
                   f"notes={n_notes} chunks={stats[0]['real_rows']} "
                   f"bucket={len(batch)} "
                   f"decode_steps={[s['steps'] for s in stats]} "
                   f"rows_at_cap={at_cap} row_steps={row_steps} "
                   f"stage_ms(transport={st_wave:.3f}, mel={st_mel:.3f}, "
                   f"encoder={st_enc:.3f}, "
                   f"decode={st_dec:.3f}, detokenize={st_det:.3f}) "
                   f"decode_kernels_off_s={[d[0] for d in dec[False]]} "
                   f"decode_kernels_on_s={[d[0] for d in dec[True]]} "
                   f"steps_off={int(l_off.max()) - 1} "
                   f"steps_on={int(l_on.max()) - 1} "
                   f"greedy_token_agreement_kernel_route_vs_attention_int8="
                   f"{agree_n / agree_d:.6f} ({agree_n}/{agree_d}) [{smi}]")

    with Phase("batch_serving") as ph:
        songs = [song] + [synthetic_song(180.0, 16000, seed=s)
                          for s in (8, 9, 10)]
        conds = [[0, 0], [1, 1], [2, 2], [3, 0]]
        t0 = time.perf_counter()
        engine.warmup([128])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        runs = []
        _, batch_launches = launches_of(
            lambda: engine.generate_batch(songs, cond_indices=conds))
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            midis = engine.generate_batch(songs, cond_indices=conds)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        notes = [len(m.instruments[0].notes) for m in midis]
        require(all(k > 0 for k in notes), f"a song gave no notes: {notes}")
        bstats = [{k: s[k] for k in ("batch_width", "real_rows", "steps",
                                     "tokens_real")}
                  for s in engine.last_decode_stats]
        med = float(np.median(runs))
        single = {(n.start, n.end, n.pitch)
                  for n in midi.instruments[0].notes}
        batched = {(n.start, n.end, n.pitch)
                   for n in midis[0].instruments[0].notes}
        ph.info = (f"warmup_s={warm_s:.3f} runs_s={runs} "
                   f"songs_per_min={4 * 60.0 / med:.3f} notes={notes} "
                   f"launches={batch_launches} "
                   f"last_decode_stats={bstats} "
                   f"song0_vs_generate: notes {len(batched)} vs "
                   f"{len(single)}, equal {len(batched & single)} [{smi}]")

    with Phase("engine_options") as ph:
        # each option from a fresh engine on the fixture: tokens (launches
        # counted), notes, agreement with default serving; then its decode
        # stage on the song's batch
        fixture16 = resample(fixture, fixture_sr, 16000)
        chunks = engine._chunk_waveform(fixture16)
        base = engine.sample_tokens_batched(chunks)

        def agreement(toks) -> tuple:
            same = total = 0
            for a, b in zip(toks, base):
                n_tok = max(len(a), len(b))
                pa, pb = np.zeros(n_tok, np.int64), np.zeros(n_tok, np.int64)
                pa[:len(a)], pb[:len(b)] = a, b
                same += int((pa == pb).sum())
                total += n_tok
            return same, total

        infos = []
        for label, dtype, knobs in (
                ("int8_weights", torch.bfloat16, {"int8_weights": True}),
                ("kv_bits=4", torch.bfloat16, {"kv_bits": 4}),
                ("unroll=8", torch.bfloat16, {"unroll": 8}),
                ("sampling temperature=1.0 top_k=10 seed=5", torch.bfloat16,
                 {"temperature": 1.0, "top_k": 10, "sample_seed": 5}),
                ("fp32 int8_kv", torch.float32, {"int8_kv": True})):
            eng = Music2MIDI.from_npz(RECORD, dtype=dtype)
            for k, val in knobs.items():
                setattr(eng, k, val)
            toks, n = launches_of(lambda: eng.sample_tokens_batched(chunks))
            steps = eng.last_decode_stats[0]["steps"]
            run = min(-(-steps // eng.unroll) * eng.unroll,
                      eng.decode_max_length - 1)
            require(n["decode_attention_int8"] == 12 * run,
                    f"{label}: {n['decode_attention_int8']} int8 kernel "
                    f"launches for {run} decode steps")
            if label == "unroll=8":
                require(all(np.array_equal(a, b) for a, b in zip(toks, base)),
                        "unroll=8 tokens differ from unroll=1's")
            if label.startswith("sampling"):
                again = eng.sample_tokens_batched(chunks)
                require(all(np.array_equal(a, b) for a, b in zip(toks, again)),
                        "one sample_seed gave two token sequences")
            if label == "fp32 int8_kv":
                int8_entry["f32_instance"]["launches"] = \
                    n["decode_attention_int8"]
            notes = eng.tokenizer.decode(toks, mode="sequential",
                                         duration_per_batch=3.0)
            same, total = agreement(toks)
            song_wave = eng._device_wave(batch)
            enc_o = eng._encoder(eng._log_mel(song_wave), cond)
            (_, lens), dec_s = timed_s(
                lambda: eng._decode(enc_o, eng._sample_rng(0)))
            infos.append(
                f"{label}: notes={len(notes)} decode_steps={steps} "
                f"launches={n} greedy_token_agreement_with_default_serving="
                f"{same / total:.6f} ({same}/{total}) song_decode_stage_s="
                f"{dec_s:.4f} song_decode_steps={int(lens.max()) - 1}")
            print(f"  {infos[-1]} [{smi}]", flush=True)
        ph.info = f"{len(infos)} options [{smi}]"

    with Phase("bench") as ph:
        import argparse

        from music2midi_tpu_torch import bench
        from music2midi_tpu_torch.profiling import device_peak_flops

        bargs = bench.parse_args([])
        bargs.ckpt = str(RECORD)
        beng = bench._load_engine(bargs, trained=True)
        bsongs = bench._songs(bargs, 16000)[:2]
        head, n_head = launches_of(
            lambda: bench._run_workload(beng, bsongs, 1, 1, lat_trials=1))
        require(n_head["log_mel_spectrogram_cuda"] > 0
                and n_head["decode_attention_int8"] > 0,
                f"bench: the kernels were not launched: {n_head}")
        sec_args = argparse.Namespace(**{**vars(bargs), "max_decode": None})
        seng = bench._load_engine(sec_args, trained=False)
        sec = bench._run_workload(seng, bsongs, 1, 1, lat_trials=1)
        peak = device_peak_flops()
        result = bench.build_result(bargs, True, head, peak, kind, smi, sec)
        if "H100" in kind:
            require(result["mfu"] is not None, "bench: mfu is null on an H100")
        require(result["n_notes"] > 0, "bench: no notes")
        sec_mfu = result["secondary_random_forced256"]["mfu"]
        ph.info = (
            f"songs=2x180s songs_per_min={head['songs_per_min']:.3f} "
            f"p50_song_latency_s={head['lat_sorted'][0]:.4f} "
            f"mfu={result['mfu']} mfu_executed={result['mfu_executed']} "
            f"decoded_tokens={head['tokens_real']} n_notes={head['n_notes']} "
            f"decode_steps={[s['steps'] for s in head['decode_stats']]} "
            f"rows_at_cap={head['rows_at_cap']} "
            f"launches={n_head} secondary_random_forced256: songs_per_min="
            f"{sec['songs_per_min']:.3f} p50_song_latency_s="
            f"{sec['lat_sorted'][0]:.4f} mfu={sec_mfu} "
            f"[{smi}]")

    with Phase("kernels"):
        print(json.dumps({"kernels": [
            mel_entries["log_mel_fft"], mel_entries["log_mel_dft"],
            int8_entry, cross_t_entry]}), flush=True)

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
