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
       plan (``Int8AttentionPlan``) equal to it bit for bit, and, with the
       step read from device memory, against the plain version at the
       key-group boundaries, bit for bit against a host step, and NaN for
       a step past the cache; the
       transposed-cross kernel at (64, 8, 64, 190) on the padded rows of
       ``transpose_cross_entry``, enc_len 190 and 150; bar 2e-2 on the bf16
       outputs; yardstick: ``F.scaled_dot_product_attention`` over K/V
       dequantized to bf16 before the timed region; timed over six
       inputs in turn, as the decode loop's six layers come: kernel 3 at
       causal n = 32, 128 and 1023 and cross L = 190, ``round_pv`` on and
       off, through the public function and through the launch plan (the
       kernels line's time: the public function also writes its step to
       the card), each with its host-inclusive time beside sdpa's; then
       kernel 3's f32
       instance (a float32 query and output, an fp32 engine with int8 KV)
       at the same causal n and cross L, bar 1e-5 relative to the largest
       output, f32 sdpa beside it; and kernel 3 on the +-7-level entries
       of ``kv_bits=4`` (int8 storage), bar 2e-2 on the bf16 outputs;
     - the multi-tensor Adafactor kernel (``csrc/adafactor.cu``, no TPU
       kernel: the JAX package leaves optax's Adafactor to XLA) on the
       model of record's 146 fp32 leaves with seeded gradients: one step
       against the plain version on the card from the same state, with a
       fixed lr of 1e-2 and with the recipe's relative step (moments
       within ``ADAFACTOR_BARS[0]`` relative, the parameter change within
       ``ADAFACTOR_BARS[1]`` relative beside an ulp of the parameter, and
       the elements not equal counted), a second kernel run bit-equal, 4
       launches a step; a step's device
       and host-inclusive ms, the plain version's, the bounds (the
       function's bytes, and the kernel's four passes'), and the host's
       kernel launches a step of each under ``torch.profiler``;
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
     (the kernel with ``round_pv``, and plain ``_attention_int8``), their
     agreement at least ``C1_BAR`` (ROADMAP C1); and the captured loop's
     tokens against the same loop with the step's glue as its ATen chains
     (``parent_glue``: the decode loop before kernels 7-10), every token
     equal;
  8. decode graph: the decode loop as one captured program
     (``infer/decode.py``) against its eager twin on the song's batch, in
     every route (bf16 serving through kernel 3, ``pallas_cross`` through
     kernel 4, ``int8_weights``, ``kv_bits=4``, ``unroll=8``,
     ``suppress_tokens``, seeded sampling, fp32 parity): tokens and
     lengths equal bit for bit, the kernels' counts 12 a step under
     replay; ms a step at widths 64 and 128 (EOS suppressed, 1023 steps),
     captured and eager; host launches a step and the device's idle share
     under ``torch.profiler``; capture seconds;
  9. batch serving: a fresh engine's ``warmup()`` over every bucket (each
     bucket's capture seconds, the memory the engine keeps with every
     bucket captured and its peak), then ``generate_batch`` (the
     dispatcher thread and staged upload) over four synthetic 3-minute
     songs, one warm-up (its kernel launches counted) and two timed runs;
  10. engine options on the calibration fixture with the model of record,
     each from a fresh engine: bf16 with ``int8_weights``, ``kv_bits=4``,
     ``unroll=8`` (tokens equal to default serving's), sampling at
     ``temperature=1.0, top_k=10`` twice with one ``sample_seed`` (equal
     tokens), and fp32 with ``int8_kv=True`` (kernel 3's f32 instance);
     each prints its notes, launch counts and greedy-token agreement with
     default serving, and its decode stage time on the song's batch;
  11. bench: ``music2midi_tpu_torch.bench``'s workload cut to 2 of its 8
     songs, 1 group of 1 trial and 1 latency trial, then its secondary
     forced-256 run on the same songs: songs/min, p50 latency, ``mfu``
     (required non-null on an H100), ``mfu_executed``, tokens, notes;
  12. data prep, with the port alone in a temporary directory, each stage
     a ``python3 -m music2midi_tpu_torch.<module>`` subprocess: the chain
     (``data.synthesize_corpus``: 8 songs of 40 s, the clean profile;
     ``data.align_audio_midi``, ``data.midi_to_numpy``,
     ``data.compute_metrics``, ``data.generate_split``: at least 3 songs
     pass the filters), each stage's seconds, the split's sizes; the C++
     DSP library built (``native.available()``); the loader over the
     train split with augmentation on, 4 workers, 64 windows an epoch:
     thread workers (required: the loader's own choice) against spawned
     processes, windows/s, the first batch's seconds and their difference
     (the spawn), and one process's windows/s with the C++ and the numpy
     pitch shift; the train CLI for 4 bf16 steps from the model of record
     (its loader on threads), ``tools.export_npz`` of its checkpoint,
     ``tools.calibration_check`` on the model of record and the export
     (both PASS); ``evaluate``'s ``main`` (what ``-m`` runs) on the test
     split in bf16, kernels 1 and 3 launched, its mean score and chunks
     at the cap, and a test song's transcription with notes.  The
     training and entry-point phases read this corpus;
  13. training (``music2midi_tpu_torch.train``: kernel 5, the Adafactor
     kernel, on its path and no other; each counted run on the card
     launches kernel 5 exactly 4 times a step and kernels 1-4 never, the
     fp32 run's count the kernels line's): data prep's train split, its
     songs in turn (an epoch
     holds 4 batches of 16 random 3-s windows), read through the port's
     dataset and loader with augmentation on (thread workers, the C++
     pitch shift);
     one fp32 step from the model of record with dropout 0 on the card
     and on the CPU (loss within 1e-4 relative, update cosine >= 0.999;
     fp32 matmuls without TF32, PyTorch's default); 3 warm-up and 20
     timed steps in fp32 and in bf16 mixed precision with dropout 0.1 and
     the reference's relative-step schedule (median step ms by host clock
     around steps that end in a synchronize, tokens/s, ``mfu`` against
     the bf16 peak, peak memory, first and last loss); a checkpoint saved
     and restored bit-equal; the bf16 npz export served by
     ``Music2MIDI.from_npz`` through the calibration gate; and the train
     CLI (``python3 -m music2midi_tpu_torch.train``'s ``main``) for 4
     bf16 steps from the model of record with ``--eval_in_train``
     (kernel 5 4 a step, and the glue of its scoring's greedy decode on a
     plain cache, kernels 7, 9 and 10 19, 6 and 1 a step; no other);
  14. entry points, in a temporary working directory, through what a user
     runs (the model of record, bf16 unless said): (a)
     ``music2midi_tpu_torch.serve_batch``'s ``main`` on 4 synthetic 60-s
     songs written as 16-kHz WAVs: every song has notes, its MIDI file is
     byte-identical to ``generate_batch(waveforms=...)``'s on the loaded
     audio, kernels 1 and 3 launched; (b) the web UI (``webui.Handler`` on
     a ``ThreadingHTTPServer`` at 127.0.0.1, port 0, with a bf16 engine and
     its ``DynamicBatcher``) takes the 4 songs as concurrent uploads from
     4 threads: each gets the result page and an ``output.mid`` that the
     port's SMF reader parses, byte-identical to ``generate``'s on the
     same file; the batcher forms fewer engine batches than uploads;
     kernels 1 and 3 launched; the dispatcher thread's peak memory is at
     most 1.05x one main-thread ``generate_batch`` of all 4 songs; the
     latencies are printed; (c) ``music2midi_tpu_torch.evaluate``'s
     ``main`` on data prep's corpus in fp32 (no kernel launched,
     the parity mode) and bf16 (kernels 1 and 3): one CSV row per test
     id, scores in [0, 1], the mean score and the chunks at the token
     cap printed; (d) with ``ffmpeg`` on the machine, a FLAC made of a
     song's WAV loads equal to the WAV within 1/32768; without it,
     ``audio.load`` of an mp3 raises the JAX package's ``ValueError``;
  15. parallel, ``music2midi_tpu_torch/parallel`` on the one card, each
     group of ranks a ``python3 -m torch.distributed.run --standalone``
     subprocess whose ranks print their backend and device: (a) the
     train CLI for 2 fp32 steps from the model of record, batch 16 (data
     prep's train split repeated to one batch, no loader workers), in 4
     ranks at (dp, tp) = (2, 2) sharing the card over gloo against one
     process (kernel 5 on every rank, a tp rank's statistics all-reduced
     between its phases): losses within 1e-4 relative, the gathered
     checkpoint's parameters within 1e-4 of each element or its leaf's
     RMS; (b) the
     same ranks serving (this file with ``--parallel-worker serve``):
     ``Music2MIDI(mesh=...)`` in bf16 on the song, kernels 1 and 3
     launched on every rank at B/dp = 32, H/tp = 4, ``"captured":
     false``, the tp ranks' decode steps equal, the calibration gate on
     the fixture, greedy-token agreement with the one-device engine at
     least ``TP_BF16_BAR`` (ROADMAP C3) in bf16 and ``FP32_TOKEN_BAR``
     in fp32; (c) kernels 3 and 4 at B 32, H 4 against their plain
     versions (causal n = 32, 128, 1023, ``round_pv`` off and on, the
     launch plan bit-equal to the public function; cross; transposed
     cross); (d) one NCCL rank at world size 1 (``--parallel-worker
     nccl``): a dp-only engine, captured, its bf16 tokens equal the
     one-process engine's bit for bit.  No time here is a scaling
     number: the ranks share one card and every gloo collective goes
     through the host;
  16. configs, with the port alone in a temporary directory: the
     training recipe of record, ``configs/synth16k_aug_r5.yaml`` (YAML,
     16-kHz training windows, augmentation with its 64-GB cache cap),
     through the CLIs: the prep chain with ``--config`` (20 clean songs of
     24 s: a train split that fills one batch of the recipe's 16), the
     recipe's loader in a process of its own (``--loader-worker``: 128
     windows, windows/s, the augment cache's size and the process's peak
     RSS, far under the cap), ``python3 -m music2midi_tpu_torch.train
     --config <recipe> --max_steps 4`` from an initialisation (step ms of
     steps 3-4 from its log, its peak RSS), ``evaluate``'s ``main`` with
     ``--config <recipe>`` of the model of record in bf16 (kernels 1 and
     3 launched), and ``tools.realmix_check`` of the model of record in
     bf16 on a 21-s ``fullmix`` song (``n_notes``, ``overlap``; its exit
     code is its verdict);
  17. orbax, the JAX trainer's checkpoints read with the port alone, from
     ``tests/data/orbax_small`` (written by the JAX package, random
     weights, d_model 16): the zstd decoder (``csrc/zstd_decode.cpp``)
     built with this machine's ``g++``; the ``save_params`` export, the
     training root and its step dir read bit-equal to their npz twin;
     ``Music2MIDI.from_orbax`` in bf16 on the card generates the
     calibration fixture, kernels 1 and 3 launched, its tokens and notes
     equal ``from_npz``'s of the twin; ``restore_train_state`` of the JAX
     run (``MultiSteps`` mid-cycle) takes 2 fp32 steps on the card, the
     losses within ``ORBAX_LOSS_BAR`` relative of the JAX steps' stored
     losses; the decoder's MB/s on this host;
  18. kernels: kernel 6 (the hybrid decoder's Mamba-2 state update,
     which no T5 path runs) against its plain version on the same card
     inputs at granite-4.0-h's widths and serving batch (128 rows of a
     128 x 64 x 128 state), three steps in place: y and the float32 state
     within ``SSM_BAR`` of their largest, a bfloat16 state within one of
     its ulps; timed with its plain version against the state's bytes;
     kernels 7-10 (the T5 decode step's fused glue) at the serving shapes
     against their plain twins on the same card inputs (8-10 bit for bit,
     7's new x bit for bit and its norm at least ``NORM_BIT_SHARE``
     bit-equal and within one bf16 ulp, in its add form and in its
     embedding-gather form), each timed with its twin against its bytes;
     then the ``kernels`` JSON line.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The subprocesses are ``nvcc``, ``g++`` (the C++ DSP library and the zstd
decoder),
``nvidia-smi``, ``ffmpeg`` (where present), data prep's and configs'
``python3 -m`` stages, CLIs and tools, configs' loader process, and the
parallel phase's torchrun groups, each waited for; data prep's loader
spawns its worker processes once, the pool shut down when its epoch
ends.  The threads are the entry-point phase's (the HTTP server, its request threads, the upload
clients, the batcher's dispatcher and loader pool, ``generate_batch``'s
prefetch pool), each joined or shut down before the phase ends.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
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
# ROADMAP C1: the song's greedy-token agreement of the kernel route with
# plain _attention_int8 on the card, a floor just under its reading on an
# H100 (0.971503, tools/song_agreement.py); tests/test_torch_gpu.py holds
# the same bar
C1_BAR = 0.96
# kernel 7 vs its twin: the share of norm values bit-equal (the two may
# sum the squares in another order; none more than one bf16 ulp off)
NORM_BIT_SHARE = 0.999
# Adafactor kernel vs plain: moments relative; a step's parameter change
# relative, beside an ulp of the parameter (the sums run in other orders)
ADAFACTOR_BARS = (1e-6, 1e-5)
# kernel 6 vs plain, relative to the largest |y| or |state|: the two sum
# h * C in other orders and the kernel fuses the update's multiply-add
SSM_BAR = 1e-5


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


def synthetic_notes(seconds: float, seed: int):
    """(N, 4) notes of a piano-like song: random chords and melody notes
    every 0.25-0.75 s, made from `seed`."""
    import numpy as np

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
    return np.array(notes)


def synthetic_song(seconds: float, sr: int, seed: int, notes=None):
    """The song of ``synthetic_notes(seconds, seed)`` (or of `notes`)
    through the port's synthesizer, peak 0.8."""
    import numpy as np

    from music2midi_tpu_torch.utils import numpy_to_midi

    if notes is None:
        notes = synthetic_notes(seconds, seed)
    wave = numpy_to_midi(notes).synthesize(fs=sr)
    out = np.zeros(int(seconds * sr), np.float32)
    out[:min(len(out), len(wave))] = wave[:len(out)]
    return out / max(1e-6, float(np.abs(out).max())) * 0.8


TRAIN_SR, TRAIN_WINDOWS = 22050, 64  # an epoch: 4 batches of 16 windows
TRAIN_STEPS, TRAIN_WARMUP = 20, 3  # timed steps in each mode, after warm-up
CARD = "cuda"  # the device under test
# data_prep: songs of the synthesiser's default length, enough that at
# least 3 pass generate_split's filters; the train CLI's steps
PREP_SONGS, PREP_SONG_S, PREP_STEPS = 8, 40.0, 4
PREP_STAGES = ("synthesize_corpus", "align_audio_midi", "midi_to_numpy",
               "compute_metrics", "generate_split")


def run_module(module: str, argv: list, cwd: Path) -> tuple:
    """``python3 -m music2midi_tpu_torch.<module> argv`` in `cwd`; raises
    unless it exits 0.  -> (stdout, stderr, seconds)."""
    return run_python(["-m", f"music2midi_tpu_torch.{module}", *argv],
                      cwd)[:3]


def rss_mib(pid="self") -> float:
    """A process's resident set now (``VmRSS``), in MiB.  Peaks are the
    largest of such samples: the card's machine gives no ``VmHWM``, and a
    child's ``ru_maxrss`` keeps its forking parent's peak."""
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    raise RuntimeError(f"no VmRSS in /proc/{pid}/status")


def run_python(argv: list, cwd: Path, codes=(0,)) -> tuple:
    """``python3 argv`` in `cwd`, killed after 600 s; raises unless its exit
    code is one of `codes`.  -> (stdout, stderr, seconds, its peak RSS in
    MiB, of samples every 0.1 s while it ran, its exit code)."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [str(ROOT), os.environ.get("PYTHONPATH")]))}
    peak = 0.0
    with tempfile.TemporaryFile("w+") as fo, \
            tempfile.TemporaryFile("w+") as fe:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, *argv], cwd=cwd, stdout=fo,
                                stderr=fe, text=True, env=env)
        try:
            while proc.poll() is None:
                require(time.perf_counter() - t0 < 600,
                        f"{argv} ran past 600 s")
                try:
                    peak = max(peak, rss_mib(proc.pid))
                except (OSError, RuntimeError):
                    pass  # it exited between poll and read
                time.sleep(0.1)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        secs = time.perf_counter() - t0
        fo.seek(0)
        fe.seek(0)
        out, err = fo.read(), fe.read()
    require(proc.returncode in codes,
            f"{argv} exited {proc.returncode}:\n{out[-3000:]}\n"
            f"{err[-3000:]}")
    return out, err, secs, peak, proc.returncode


RECIPE = ROOT / "configs" / "synth16k_aug_r5.yaml"  # the recipe of record
# configs: a corpus prepared under the recipe, whose train split fills
# one batch of its 16 (20 songs: 16 train, 2 val, 2 test); the train CLI's
# steps, logged in pairs; the loader's windows in its own process; the
# fullmix song of realmix_check
CFG_SONGS, CFG_SONG_S, CFG_STEPS, CFG_WINDOWS = 20, 24.0, 4, 128
MIX_SONG_S = 21.0


def loader_worker(recipe: str, root: Path, out: Path) -> None:
    """The recipe's loader over `root`'s train split in a process of its
    own (``python3 chip_smoke.py --loader-worker RECIPE ROOT OUT``): its
    workers, batch and caches as the recipe sets them, CFG_WINDOWS
    windows; writes windows/s, the augment cache's size and the
    process's peak RSS (sampled every 20 ms) to OUT as JSON."""
    import threading

    sys.path.insert(0, str(ROOT))
    from music2midi_tpu_torch import native
    from music2midi_tpu_torch.config import load_config
    from music2midi_tpu_torch.data import DataLoader, Music2MIDIDataset

    cfg = load_config(recipe)
    dataset = Music2MIDIDataset(root, split_ids(root, "train_id"), cfg)
    rss = [rss_mib()]
    done = threading.Event()

    def sample():
        while not done.wait(0.02):
            rss.append(rss_mib())

    sampler = threading.Thread(target=sample)
    sampler.start()
    loader = DataLoader(dataset, batch_size=int(cfg.dataloader.batch_size),
                        num_workers=int(cfg.dataloader.num_workers),
                        shuffle=True, seed=0)
    epochs, n, first = [], 0, None  # epochs: (windows, seconds)
    t0 = time.perf_counter()
    while n < CFG_WINDOWS:
        te, ne = time.perf_counter(), n
        for batch in loader:
            if first is None:
                first = time.perf_counter() - t0
            n += len(batch.waveform)
        epochs.append((n - ne, time.perf_counter() - te))
    total = time.perf_counter() - t0
    done.set()
    sampler.join()
    rss.append(rss_mib())
    out.write_text(json.dumps({
        "windows": n, "seconds": total, "windows_per_s": n / total,
        "first_batch_s": first, "epochs": len(epochs),
        "last_epoch_windows_per_s": epochs[-1][0] / epochs[-1][1],
        "threads": not loader.use_processes, "native": native.available(),
        "cache_entries": len(dataset._aug_cache),
        "cache_mib": dataset._aug_cache_bytes / 2**20,
        "cache_cap_mib": dataset._aug_cache_cap / 2**20,
        "rss_after_dataset_mib": rss[0], "peak_rss_mib": max(rss)}))


def configs_phase(smi: str, launches_of, work: Path) -> str:
    """The training recipe of record (``configs/synth16k_aug_r5.yaml``,
    YAML) through every CLI that takes it, with the port alone; see the
    module docstring, item 16.  -> the phase's info; raises on any
    failure."""
    import numpy as np

    from music2midi_tpu_torch import evaluate
    from music2midi_tpu_torch.config import load_config

    recipe, name = str(RECIPE), RECIPE.name
    cfg = load_config(recipe)
    leaves = (cfg.dataset.sample_rate, cfg.dataset.augment,
              cfg.dataset.cache_augment_mb, cfg.spectrogram.f_min,
              cfg.dataloader.batch_size)
    require([type(x).__name__ for x in leaves]
            == ["int", "bool", "int", "float", "int"]
            and cfg.dataset.sample_rate == 16000,
            f"the recipe's leaves: {leaves}")
    root, lines, stage_s = work / "corpus", [], {}
    for stage in PREP_STAGES:
        argv = [str(root)]
        if stage == "synthesize_corpus":
            argv += ["--songs", str(CFG_SONGS), "--duration",
                     str(CFG_SONG_S), "--profile", "clean"]
        if stage != "midi_to_numpy":  # the one stage without --config
            argv += ["--config", recipe]
        out, _, stage_s[stage] = run_module(f"data.{stage}", argv, work)
    split_line = out.strip().splitlines()[-1]
    train, test = split_ids(root, "train_id"), split_ids(root, "test_id")
    batch = int(cfg.dataloader.batch_size)
    require(len(train) >= batch and test,
            f"split under the recipe: {split_line} (batch {batch})")
    lines.append(
        f"prep under {name} (s, each a python3 -m subprocess): "
        f"{ {k: round(v, 3) for k, v in stage_s.items()} }; "
        f"{CFG_SONGS} songs x {CFG_SONG_S:.0f} s (clean): {split_line} "
        f"(train {len(train)}, val {len(split_ids(root, 'val_id'))}, "
        f"test {len(test)}) [{smi}]")

    # the recipe's loader in a process of its own: its peak RSS is the
    # loader's (cache_augment_mb is a cap, not an allocation)
    _, _, loader_s, _, _ = run_python(
        [str(ROOT / "chip_smoke.py"), "--loader-worker", recipe,
         str(root), str(work / "loader.json")], work)
    ld = json.loads((work / "loader.json").read_text())
    require(ld["threads"] and ld["native"] and ld["windows"] >= CFG_WINDOWS,
            f"the recipe's loader: {ld}")
    require(ld["peak_rss_mib"] < 0.25 * ld["cache_cap_mib"],
            f"the loader's peak RSS {ld['peak_rss_mib']:.1f} MiB nears "
            f"the {ld['cache_cap_mib']:.0f}-MiB cap: {ld}")
    lines.append(
        f"loader ({name}: batch {batch}, {cfg.dataloader.num_workers} "
        f"thread workers, augment on, cache_audio on, cache_augment_mb "
        f"{cfg.dataset.cache_augment_mb}): {ld['windows']} windows in "
        f"{ld['epochs']} epochs, windows_per_s={ld['windows_per_s']:.2f} "
        f"(first batch {ld['first_batch_s']:.3f} s, last epoch "
        f"{ld['last_epoch_windows_per_s']:.2f}); augment cache "
        f"{ld['cache_entries']} windows, {ld['cache_mib']:.2f} MiB; peak "
        f"RSS {ld['peak_rss_mib']:.1f} MiB ({ld['rss_after_dataset_mib']:.1f}"
        f" after the dataset's build); process {loader_s:.3f} s [{smi}]")

    # the train CLI under the recipe, from an initialisation, as given
    out, err, train_s, train_rss, _ = run_python([
        "-m", "music2midi_tpu_torch.train", str(root), "--config",
        recipe, "--max_steps", str(CFG_STEPS),
        "--steps_per_dispatch", "2", "--out_dir", str(work / "runs"),
        "--name", "r5", "--device", CARD], work)
    records = [json.loads(x) for x in (work / "runs" / "r5" / "log.jsonl")
               .read_text().splitlines()]
    steps = [r for r in records if "train/loss" in r]
    require([r["step"] for r in steps] == [2, CFG_STEPS]
            and all(np.isfinite(r["train/loss"]) for r in steps)
            and any("val/loss" in r for r in records)
            and records[-1].get("done"),
            f"train CLI under the recipe: {records}")
    require("spawn process workers" not in err,
            f"the train CLI's loader spawned processes: {err[-2000:]}")
    step_ms = (steps[1]["time"] - steps[0]["time"]) / (CFG_STEPS - 2) * 1e3
    lines.append(
        f"train CLI ({name}, --max_steps {CFG_STEPS}, fp32 from an "
        f"initialisation, batch {batch}, thread workers): {train_s:.3f} s "
        f"with process start, validation and checkpoint; step_ms="
        f"{step_ms:.1f} (steps 3-4, loader included, by the log's clock); "
        f"train/loss {[r['train/loss'] for r in steps]}; peak RSS "
        f"{train_rss:.1f} MiB [{smi}]")

    # evaluate --config <the recipe> of the model of record, bf16, counted
    old_cwd = os.getcwd()
    os.chdir(work)
    try:
        (res, n), eval_s = timed_s(lambda: launches_of(lambda: evaluate.main(
            [str(root), "--ckpt", str(RECORD), "--config",
             recipe, "--dtype", "bfloat16", "--name", "r5",
             "--device", CARD])))
    finally:
        os.chdir(old_cwd)
    require(n["log_mel_spectrogram_cuda"] > 0
            and n["decode_attention_int8"] > 0,
            f"evaluate --config: kernels 1 and 3 not launched: {n}")
    with open(work / res["csv"]) as f:
        rows = [r.split(",") for r in f.read().splitlines()[1:]]
    require([r[0] for r in rows] == test
            and all(0.0 <= float(r[4]) <= 1.0 for r in rows),
            f"evaluate --config rows {rows}")
    lines.append(
        f"evaluate --config {name} (bf16, model of record, test split of "
        f"{len(test)}): {eval_s:.3f} s, mean_score={res['mean_score']:.6f}, "
        f"chunks_at_cap={res['chunks_at_cap']} of {res['chunks']}, "
        f"launches={n} [{smi}]")

    # realmix_check of the model of record, bf16, on a rendered fullmix song
    run_module("data.synthesize_corpus", [
        str(work / "mix"), "--songs", "1", "--duration", str(MIX_SONG_S),
        "--profile", "fullmix", "--seed", "7"], work)
    song = work / "mix" / "audio" / "synth000.wav"
    # its exit code is its verdict (1: a floor missed on this song), and
    # anything else a failure
    out, _, mix_s, _, code = run_python([
        "-m", "music2midi_tpu_torch.tools.realmix_check", str(RECORD),
        "--audio", str(song), "--dtype", "bfloat16", "--device", CARD], work,
        codes=(0, 1))
    verdict = out.strip().splitlines()[-1]
    require(verdict.startswith(("PASS " if code == 0 else "FAIL ")
                               + f"{RECORD}: n_notes="),
            f"realmix_check exited {code}: {out[-2000:]}")
    fields = dict(kv.split("=", 1) for kv in
                  verdict.split(": ", 1)[1].split(" ")[:2])
    lines.append(
        f"realmix_check (bf16, model of record, a {MIX_SONG_S:.0f}-s "
        f"fullmix song, seed 7): n_notes={fields['n_notes']} "
        f"overlap={fields['overlap']} ({verdict.split(':')[0].split()[0]}; "
        f"floors n_notes >= 30, overlap >= 1); {mix_s:.3f} s with process "
        f"start [{smi}]")
    for line in lines:
        print(f"  {line}", flush=True)
    return f"{len(lines)} checks [{smi}]"


def training_config():
    """The packaged defaults with the model of record's architecture."""
    from music2midi_tpu_torch.config import ConfigNode, default_config
    from music2midi_tpu_torch.weights import load_npz

    _, record_cfg = load_npz(RECORD)
    return ConfigNode({**default_config().to_dict(),
                       "model": record_cfg.model.to_dict()})


def split_ids(root: Path, key: str) -> list:
    import numpy as np

    split = np.load(root / "dataset_split.npz", allow_pickle=True)
    return [str(x) for x in split[key]]


def data_prep_phase(smi: str, launches_of, root: Path) -> str:
    """The data-prep chain into the card's training and evaluation paths,
    with the port alone; see the module docstring, item 12.  Writes the
    corpus into `root`, which the training and entry-point phases read.
    -> the phase's info; raises on any failure."""
    import numpy as np

    from music2midi_tpu_torch import evaluate, native
    from music2midi_tpu_torch.data import DataLoader, Music2MIDIDataset

    work = root.parent
    lines, stage_s = [], {}
    for stage in PREP_STAGES:
        argv = [str(root)]
        if stage == "synthesize_corpus":
            argv += ["--songs", str(PREP_SONGS), "--duration",
                     str(PREP_SONG_S), "--profile", "clean"]
        out, _, stage_s[stage] = run_module(f"data.{stage}", argv, work)
    split_line = out.strip().splitlines()[-1]  # "split N songs -> ..."
    n_pass = int(split_line.split()[1])
    train, test = split_ids(root, "train_id"), split_ids(root, "test_id")
    require(n_pass >= 3 and train and test, f"split: {split_line}")
    require(native.available(), f"the C++ DSP library did not build on "
            f"this machine:\n{native.build_log()}")
    lines.append(f"stages (s, each a python3 -m subprocess): "
                 f"{ {k: round(v, 3) for k, v in stage_s.items()} }; "
                 f"{PREP_SONGS} songs x {PREP_SONG_S:.0f} s (clean): "
                 f"{n_pass} pass the filters; {split_line} "
                 f"(train {len(train)}, val "
                 f"{len(split_ids(root, 'val_id'))}, test {len(test)}) "
                 f"[{smi}]")

    # the loader over the corpus's train split: thread workers with the
    # C++ pitch shift against spawned processes, each epoch 64 windows
    config = training_config()
    ids = (train * TRAIN_WINDOWS)[:TRAIN_WINDOWS]
    dataset = Music2MIDIDataset(root, ids, config)
    rates = {}
    for kind, procs in (("threads", False), ("processes", True)):
        loader = DataLoader(dataset, batch_size=16, num_workers=4,
                            shuffle=True, seed=0, use_processes=procs)
        require(loader.use_processes == procs,
                f"loader chose processes={loader.use_processes}")
        t0 = time.perf_counter()
        it = iter(loader)
        first = next(it)
        first_s = time.perf_counter() - t0
        n = len(first.waveform) + sum(len(b.waveform) for b in it)
        total = time.perf_counter() - t0
        require(n == TRAIN_WINDOWS, f"{kind}: {n} windows")
        rates[kind] = (n / total, total, first_s)
    require(dataset.native_dsp, "the dataset's pitch shift is not native")
    one = {}
    for route in (True, False):
        dataset.native_dsp = route
        rng = np.random.default_rng(1)
        _, one[route] = timed_s(lambda: [dataset.__getitem__(i, rng)
                                         for i in range(16)])
    dataset.native_dsp = True
    lines.append(
        f"loader (augment on, batch 16, 4 workers, {TRAIN_WINDOWS} windows "
        f"an epoch): threads {rates['threads'][0]:.1f} windows/s "
        f"({rates['threads'][1]:.3f} s, first batch "
        f"{rates['threads'][2]:.3f} s); spawned processes "
        f"{rates['processes'][0]:.1f} windows/s ({rates['processes'][1]:.3f}"
        f" s, first batch {rates['processes'][2]:.3f} s); spawn_s="
        f"{rates['processes'][2] - rates['threads'][2]:.3f} (first batch, "
        f"processes less threads); one process: "
        f"{16 / one[True]:.1f} windows/s C++ pitch shift, "
        f"{16 / one[False]:.1f} numpy [{smi}]")

    # the train CLI from the model of record (thread workers), its export,
    # the gate on the export and on the model of record
    cfg = config.to_dict()
    cfg["dataloader"] = {"batch_size": min(4, len(train)), "num_workers": 4}
    cfg["trainer"]["log_every_n_steps"] = 2
    (work / "prep_config.json").write_text(json.dumps(cfg))
    out, err, train_s = run_module("train", [
        str(root), "--init_from", str(RECORD), "--config",
        str(work / "prep_config.json"), "--out_dir", str(work / "runs"),
        "--name", "prep", "--max_steps", str(PREP_STEPS), "--dtype",
        "bfloat16", "--device", CARD], work)
    require("spawn process workers" not in err,
            f"the train CLI's loader spawned processes: {err[-2000:]}")
    records = [json.loads(x) for x in (work / "runs" / "prep" / "log.jsonl")
               .read_text().splitlines()]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    require(len(losses) == PREP_STEPS // 2 and all(np.isfinite(losses)),
            f"train CLI log {records}")
    export = work / "prep.npz"
    out, _, export_s = run_module("tools.export_npz", [
        str(export), str(work / "runs" / "prep" / "ckpt")], work)
    gate, _, gate_s = run_module(
        "tools.calibration_check",
        [str(RECORD), str(export), "--device", CARD], work)
    verdicts = gate.strip().splitlines()[-2:]
    require(verdicts[0].startswith(f"PASS {RECORD}:")
            and verdicts[1].startswith(f"PASS {export}:"),
            f"calibration gate: {verdicts}")
    lines.append(
        f"train CLI: {PREP_STEPS} bf16 steps from the model of record, "
        f"batch {cfg['dataloader']['batch_size']}, thread workers: "
        f"{train_s:.3f} s (process start, loader, validation and "
        f"checkpoints included), train/loss {losses}; tools.export_npz "
        f"{export_s:.3f} s ({out.strip()}); tools.calibration_check "
        f"{gate_s:.3f} s: {verdicts} [{smi}]")

    # evaluate of the model of record on the test split, bf16, counted
    old_cwd = os.getcwd()
    os.chdir(work)
    try:
        (res, n), eval_s = timed_s(lambda: launches_of(lambda: evaluate.main(
            [str(root), "--ckpt", str(RECORD), "--dtype", "bfloat16",
             "--name", "prep", "--device", CARD])))
    finally:
        os.chdir(old_cwd)
    require(n["log_mel_spectrogram_cuda"] > 0
            and n["decode_attention_int8"] > 0,
            f"evaluate bf16: kernels 1 and 3 not launched: {n}")
    with open(work / res["csv"]) as f:
        rows = [r.split(",") for r in f.read().splitlines()[1:]]
    require([r[0] for r in rows] == test, f"evaluate rows {rows}")
    require(all(0.0 <= float(r[4]) <= 1.0 for r in rows), f"rows {rows}")
    # the transcription of the first test song has notes
    engine = evaluate.load_engine(str(RECORD), None, "bfloat16", CARD)
    midi = engine.generate(audio_path=root / "audio" / f"{test[0]}.wav")
    n_notes = len(midi.instruments[0].notes) if midi.instruments else 0
    require(n_notes > 0, f"{test[0]}: the transcription has no notes")
    lines.append(
        f"evaluate (bf16, model of record, test split of {len(test)}): "
        f"{eval_s:.3f} s, mean_score={res['mean_score']:.6f}, "
        f"chunks_at_cap={res['chunks_at_cap']} of {res['chunks']}, "
        f"launches={n}; {test[0]} transcribed: n_notes={n_notes} [{smi}]")
    for line in lines:
        print(f"  {line}", flush=True)
    return f"{len(lines)} checks [{smi}]"


def training_phase(smi: str, launches_of, check_midi, fixture_path: str,
                   root: Path, adafactor_entry: dict) -> str:
    """The training path on the card, on data_prep's corpus at `root`; see
    the module docstring, item 13.  Sets ``adafactor_entry["launches"]``
    (the kernels line's) to the fp32 run's count.  -> the phase's info;
    raises on any failure."""
    import numpy as np
    import torch

    from music2midi_tpu_torch.data import DataLoader, Music2MIDIDataset
    from music2midi_tpu_torch.infer import Music2MIDI
    from music2midi_tpu_torch.models.t5 import t5_config_from
    from music2midi_tpu_torch.ops.mel import log_mel_config_from, num_frames
    from music2midi_tpu_torch.profiling import (
        device_peak_flops,
        train_step_flops,
    )
    from music2midi_tpu_torch.train import Adafactor, make_train_step
    from music2midi_tpu_torch.train.__main__ import main as train_main
    from music2midi_tpu_torch.train.checkpoint import (
        restore_train_state,
        save_params_npz,
        save_train_state,
    )
    from music2midi_tpu_torch.train.loop import TrainState, trainable_model
    from music2midi_tpu_torch.weights import load_npz

    record_sd, _ = load_npz(RECORD)
    config = training_config()
    mel_cfg = log_mel_config_from(config)
    lines = []

    def only_adafactor(k: int) -> dict:
        """The counts of a run that launched kernel 5 k times and no
        other kernel."""
        return {w.__name__: k if w.__name__ == "adafactor_kernel" else 0
                for w in _wrappers()}

    with tempfile.TemporaryDirectory() as td:
        # the train split's songs in turn, TRAIN_WINDOWS random windows an
        # epoch: 4 batches of 16
        train = split_ids(root, "train_id")
        dataset = Music2MIDIDataset(
            root, (train * TRAIN_WINDOWS)[:TRAIN_WINDOWS], config)
        loader = DataLoader(dataset, batch_size=16, num_workers=4,
                            shuffle=True, seed=0)
        require(not loader.use_processes,
                "the augmenting loader spawned processes (no C++ DSP)")
        (batches, n), load_s = timed_s(lambda: launches_of(
            lambda: list(loader)))
        B, S = batches[0].waveform.shape
        require(len(batches) == TRAIN_WINDOWS // 16
                and S == int(3 * TRAIN_SR), f"loader gave {len(batches)} "
                f"batches of {batches[0].waveform.shape}")
        enc_len = num_frames(S, mel_cfg) + len(config.conditioning)
        require(enc_len == 261, f"encoder length {enc_len}")
        rng = np.random.default_rng(1)
        _, item_s = timed_s(lambda: [dataset.__getitem__(i, rng)
                                     for i in range(16)])
        lines.append(
            f"corpus: data_prep's train split ({len(train)} songs x "
            f"{PREP_SONG_S:.0f} s at {TRAIN_SR} Hz); loader (augment on, 4 "
            f"thread workers): {len(batches) * B} windows in "
            f"{load_s:.3f} s = {len(batches) * B / load_s:.1f} windows/s; "
            f"one process: 16 windows in {item_s:.3f} s = "
            f"{16 / item_s:.1f} windows/s; batch "
            f"{batches[0].waveform.shape}, labels "
            f"{[b.labels.shape[1] for b in batches]}")

        def state_on(device, dtype, dropout, lr=None):
            cfg = t5_config_from(config, dtype)._replace(dropout_rate=dropout)
            model = trainable_model(record_sd, cfg, device)
            opt = Adafactor(list(model.parameters()), lr=lr,
                            warmup_init=lr is None)
            return cfg, TrainState(model, opt)

        # card vs CPU: one fp32 step, dropout 0, on the same batch; a fixed
        # lr, since the relative step's first lr (1e-6 x RMS) moves a
        # parameter by a few ulps, below what a cosine can resolve
        loss, update = {}, {}
        for dev in (CARD, "cpu"):
            cfg, st = state_on(dev, torch.float32, 0.0, lr=1e-2)
            before = torch.cat([p.detach().flatten().double().cpu()
                                for p in st.model.parameters()])
            (_, l), n = launches_of(
                lambda: make_train_step(cfg, mel_cfg)(st, batches[0], 0))
            require(n == only_adafactor(4 if dev == CARD else 0),
                    f"a {dev} train step launched {n}")
            loss[dev] = float(l)
            update[dev] = torch.cat([p.detach().flatten().double().cpu()
                                     for p in st.model.parameters()]) - before
        rel = abs(loss[CARD] - loss["cpu"]) / abs(loss["cpu"])
        cos = float(torch.nn.functional.cosine_similarity(
            update[CARD], update["cpu"], dim=0))
        require(np.isfinite(loss[CARD]) and rel <= 1e-4,
                f"train step loss card {loss[CARD]} vs cpu {loss['cpu']}")
        require(cos >= 0.999, f"update cosine card vs cpu {cos}")
        lines.append(
            f"card_vs_cpu (fp32, dropout 0, lr 1e-2, no TF32): loss "
            f"{loss[CARD]:.7f} vs {loss['cpu']:.7f} rel {rel:.3e} "
            f"(bar 1e-4), update cosine {cos:.7f} (bar 0.999)")

        peak = device_peak_flops()
        states = {}
        for mode, dtype in (("fp32", torch.float32),
                            ("bf16", torch.bfloat16)):
            cfg, st = state_on(CARD, dtype, 0.1)
            step = make_train_step(cfg, mel_cfg)
            torch.cuda.reset_peak_memory_stats()
            times, losses = [], []

            def run():
                for i in range(TRAIN_WARMUP + TRAIN_STEPS):
                    (_, l), dt = timed_s(
                        lambda: step(st, batches[i % len(batches)], 0))
                    times.append(dt)
                    losses.append(float(l))

            _, n = launches_of(run)
            require(n == only_adafactor(4 * (TRAIN_WARMUP + TRAIN_STEPS)),
                    f"{mode} training launched {n}")
            if mode == "fp32":
                adafactor_entry["launches"] = n["adafactor_kernel"]
            require(all(np.isfinite(losses)), f"{mode} losses {losses}")
            timed = times[TRAIN_WARMUP:]
            med = float(np.median(timed))
            dec = [b.labels.shape[1] for b in batches]
            tokens = float(np.mean([B * (enc_len + d) for d in dec]))
            flops = float(np.mean([train_step_flops(cfg, B, enc_len, d)
                                   for d in dec]))
            mfu = flops / med / peak if peak else None
            mem = torch.cuda.max_memory_allocated()
            states[mode] = (cfg, st)
            lines.append(
                f"{mode}: {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up, "
                f"median step_ms="
                f"{med * 1e3:.3f} (min {min(timed) * 1e3:.3f}, max "
                f"{max(timed) * 1e3:.3f}) tokens_per_s={tokens / med:.1f} "
                f"(B={B} x (enc {enc_len} + dec {dec})) "
                f"train_step_flops={flops:.4g} mfu={mfu} (against the "
                f"{peak} bf16 peak) peak_memory_bytes={mem} loss first="
                f"{losses[0]:.6f} last={losses[-1]:.6f} launches={n} [{smi}]")

        # checkpoint: save, restore into a fresh state, bit-equal
        cfg, st = states["bf16"]
        ck = save_train_state(Path(td) / "ckpt", st, config)
        _, fresh = state_on(CARD, torch.bfloat16, 0.1)
        fresh, _ = restore_train_state(Path(td) / "ckpt", fresh)
        require(fresh.step == st.step == TRAIN_WARMUP + TRAIN_STEPS,
                f"restored step {fresh.step}")
        for (k, a), b in zip(st.model.state_dict().items(),
                             fresh.model.state_dict().values()):
            require(torch.equal(a, b), f"restored parameter {k} differs")
        n_moments = 0
        for a, b in zip(st.optimizer.state.values(),
                        fresh.optimizer.state.values()):
            require(a["step"] == b["step"], "restored optimizer step")
            for k in ("row", "col", "v"):
                if k in a:
                    require(b[k].dtype == torch.float32
                            and torch.equal(a[k], b[k]),
                            f"restored moment {k} differs")
                    n_moments += 1
        export = Path(td) / "trained.npz"
        save_params_npz(export, st.model.state_dict(), config,
                        dtype="bfloat16")
        lines.append(f"checkpoint {ck.name}: parameters and {n_moments} "
                     f"moments restored bit-equal; export "
                     f"{export.stat().st_size} bytes (bf16)")

        # serve the export on the card through the calibration gate
        engine = Music2MIDI.from_npz(export, dtype=torch.bfloat16,
                                     device=CARD)
        require(engine.device.type == CARD, "engine not on the card")
        midi, n = launches_of(lambda: engine.generate(audio_path=fixture_path))
        ok, detail = check_midi(midi)
        require(ok, f"the exported npz fails the calibration gate: {detail}")
        lines.append(f"served export (bf16): calibration gate ok, {detail}, "
                     f"launches={n}")

        # the CLI, from the model of record, 4 bf16 steps
        cfg_json = Path(td) / "config.json"
        cli_cfg = config.to_dict()
        cli_cfg["trainer"]["log_every_n_steps"] = 2
        cli_cfg["dataloader"]["batch_size"] = min(16, len(train))
        cfg_json.write_text(json.dumps(cli_cfg))
        out = Path(td) / "runs"
        (_, n), cli_s = timed_s(lambda: launches_of(lambda: train_main([
            str(root), "--init_from", str(RECORD), "--config", str(cfg_json),
            "--out_dir", str(out), "--name", "smoke", "--max_steps", "4",
            "--dtype", "bfloat16", "--eval_in_train", "--device", CARD])))
        records = [json.loads(x) for x in
                   (out / "smoke" / "log.jsonl").read_text().splitlines()]
        cli_losses = [r["train/loss"] for r in records if "train/loss" in r]
        require(len(cli_losses) == 2 and all(np.isfinite(cli_losses)),
                f"CLI log {records}")
        require((out / "smoke" / "ckpt" / "step_00000004" / "state.pt")
                .exists(), "CLI checkpoint step_00000004 missing")
        # --eval_in_train scores by a greedy decode on a plain bf16 cache:
        # the step's glue, 19 norms, 6 gelu_mul and 1 greedy_commit a step
        steps = n["greedy_commit"]
        require(steps > 0 and n == {
            **only_adafactor(4 * 4), "add_rms_norm": 19 * steps,
            "gelu_mul": 6 * steps, "greedy_commit": steps},
            f"the CLI launched {n}")
        lines.append(
            f"cli: 4 bf16 steps in {cli_s:.3f} s (loader, validation, "
            f"checkpoints and eval_in_train included): train/loss "
            f"{cli_losses}, train/score "
            f"{[r['train/score'] for r in records if 'train/score' in r]}, "
            f"val/loss {[r['val/loss'] for r in records if 'val/loss' in r]}")
    for line in lines:
        print(f"  {line}", flush=True)
    return f"{len(lines)} checks [{smi}]"


ENTRY_SONGS, ENTRY_SONG_S = 4, 60.0  # songs of the entry-point phase


def _post_upload(url: str, path: Path) -> tuple:
    """POST one WAV to the web UI's /generate -> (result page, seconds)."""
    import urllib.request

    boundary = "smokeboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"url\""
            f"\r\n\r\n\r\n--{boundary}\r\nContent-Disposition: form-data; "
            f"name=\"file\"; filename=\"{path.name}\"\r\nContent-Type: "
            "audio/wav\r\n\r\n").encode() + path.read_bytes() + \
        f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(url + "/generate", data=body, headers={
        "Content-Type": f"multipart/form-data; boundary={boundary}"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        page = r.read().decode()
    return page, time.perf_counter() - t0


def entry_points_phase(smi: str, launches_of, engine, root: Path) -> str:
    """The serving and evaluation entry points on the card; see the module
    docstring, item 14.  `engine`: the bf16 engine of the model of record
    that the direct calls run on; `root`: data_prep's corpus.  Runs in a temporary working directory
    (the CLIs write ``scores/`` and the web UI ``static/uploads/`` there).
    -> the phase's info; raises on any failure."""
    import os
    import re
    import shutil
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from music2midi_tpu_torch import audio, evaluate, serve_batch, webui
    from music2midi_tpu_torch.infer import Music2MIDI
    from music2midi_tpu_torch.midi import MidiFile
    from music2midi_tpu_torch.serve.batcher import DynamicBatcher

    mel_k, attn_k = "log_mel_spectrogram_cuda", "decode_attention_int8"
    lines = []
    old_cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        os.chdir(td)
        try:
            songs = []
            for i in range(ENTRY_SONGS):
                songs.append(td / "songs" / f"song{i}.wav")
                songs[-1].parent.mkdir(exist_ok=True)
                audio.write_wav(songs[-1], synthetic_song(
                    ENTRY_SONG_S, 16000, seed=20 + i), 16000)
            waves = [audio.load(p, sr=16000)[0] for p in songs]

            # (a) serve_batch: its files are the direct call's, byte for byte
            summary, n = launches_of(lambda: serve_batch.main(
                [str(td / "out"), *map(str, songs), "--device", CARD]))
            require(n[mel_k] > 0 and n[attn_k] > 0,
                    f"serve_batch: kernels 1 and 3 not launched: {n}")
            direct = engine.generate_batch(waves)
            notes = []
            for i, (path, midi) in enumerate(zip(songs, direct)):
                notes.append(len(midi.instruments[0].notes))
                midi.write(td / f"direct{i}.mid")
                require((td / "out" / f"{path.stem}.mid").read_bytes()
                        == (td / f"direct{i}.mid").read_bytes(),
                        f"serve_batch: {path.stem}.mid differs from "
                        "generate_batch(waveforms=...)")
            require(all(k > 0 for k in notes), f"a song gave no notes: "
                    f"{notes}")
            lines.append(f"serve_batch: {summary} launches={n} notes per "
                         f"song={notes}, equal to generate_batch")

            # (b) the web UI: concurrent uploads through the batcher
            webui.engine = Music2MIDI.from_npz(RECORD, dtype=torch.bfloat16,
                                               device=CARD)
            formed = []
            batch_fn = webui.engine.generate_batch

            def recording(waveforms, cond_indices=None, **kw):
                formed.append(len(waveforms))
                return batch_fn(waveforms, cond_indices=cond_indices, **kw)

            webui.engine.generate_batch = recording
            webui.batcher = DynamicBatcher(webui.engine)
            (td / "static" / "uploads").mkdir(parents=True)
            webui.UPLOAD_DIR = Path("static/uploads")
            server = ThreadingHTTPServer(("127.0.0.1", 0), webui.Handler)
            url = f"http://127.0.0.1:{server.server_address[1]}"
            serving = threading.Thread(target=server.serve_forever)
            serving.start()
            results = [None] * len(songs)
            barrier = threading.Barrier(len(songs))

            def upload(i):
                barrier.wait()
                results[i] = _post_upload(url, songs[i])

            torch.cuda.reset_peak_memory_stats()
            try:
                def post_all():
                    clients = [threading.Thread(target=upload, args=(i,))
                               for i in range(len(songs))]
                    for t in clients:
                        t.start()
                    for t in clients:
                        t.join(timeout=600)
                        require(not t.is_alive(), "an upload hung")

                _, n = launches_of(post_all)
                thread_peak = torch.cuda.max_memory_allocated()
                pages = []
                for i, res in enumerate(results):
                    require(res is not None and "piano cover" in res[0],
                            f"upload {i}: no result page: {res}")
                    m = re.search(r'href="([^"]*output\.mid)"', res[0])
                    require(m is not None, f"upload {i}: no MIDI link")
                    with urllib.request.urlopen(url + m.group(1),
                                                timeout=60) as r:
                        pages.append(r.read())
            finally:
                server.shutdown()
                server.server_close()
                serving.join(timeout=60)
                webui.batcher.close()
            require(mel_k in n and n[mel_k] > 0 and n[attn_k] > 0,
                    f"web UI: kernels 1 and 3 not launched: {n}")
            require(len(formed) < len(songs),
                    f"the batcher formed {formed} for {len(songs)} uploads")
            torch.cuda.reset_peak_memory_stats()
            batch_fn(waves)
            main_peak = torch.cuda.max_memory_allocated()
            require(thread_peak <= 1.05 * main_peak,
                    f"dispatcher peak {thread_peak} B > main thread's "
                    f"{main_peak} B")
            ui_notes = []
            for i, (path, mid) in enumerate(zip(songs, pages)):
                (td / f"ui{i}.mid").write_bytes(mid)
                parsed = MidiFile(td / f"ui{i}.mid")
                ui_notes.append(len(parsed.instruments[0].notes))
                engine.generate(audio_path=path).write(td / f"gen{i}.mid")
                require(mid == (td / f"gen{i}.mid").read_bytes(),
                        f"web UI upload {i}: output.mid differs from "
                        "generate's")
            require(all(k > 0 for k in ui_notes), f"web UI notes {ui_notes}")
            lat = sorted(r[1] for r in results)
            lines.append(
                f"webui: {len(songs)} concurrent uploads of {ENTRY_SONG_S} s, "
                f"latency_s={lat} p50={float(np.median(lat)):.4f} "
                f"max={lat[-1]:.4f}, engine batches={formed} (songs each), "
                f"launches={n}, notes={ui_notes} equal to generate, peak "
                f"memory dispatcher={thread_peak} B main={main_peak} B")

            # (c) evaluate, fp32 and bf16, through the model of record
            ids = split_ids(root, "test_id")
            for dtype in ("float32", "bfloat16"):
                (res, n), secs = timed_s(lambda: launches_of(
                    lambda: evaluate.main(
                        [str(root), "--name", f"smoke-{dtype}",
                         "--dtype", dtype, "--device", CARD])))
                with open(td / res["csv"]) as f:
                    rows = [r.split(",") for r in f.read().splitlines()[1:]]
                scores = [float(r[4]) for r in rows]
                require([r[0] for r in rows] == ids,
                        f"evaluate {dtype}: rows {rows}")
                require(all(0.0 <= x <= 1.0 for x in scores),
                        f"evaluate {dtype}: scores {scores}")
                launched = n[mel_k] > 0 and n[attn_k] > 0
                require(launched == (dtype == "bfloat16"),
                        f"evaluate {dtype}: launches {n}")
                lines.append(
                    f"evaluate {dtype}: {secs:.3f} s, "
                    f"{secs / len(ids):.3f} s a song (engine load "
                    f"included), mean_score={res['mean_score']:.6f} "
                    f"scores={scores} chunks_at_cap={res['chunks_at_cap']} "
                    f"of {res['chunks']} launches={n}")

            # (d) ffmpeg: a FLAC of a song loads as its WAV, or load raises
            if shutil.which("ffmpeg"):
                flac = td / "song0.flac"
                subprocess.run(["ffmpeg", "-v", "error", "-i", str(songs[0]),
                                str(flac)], check=True)
                y, sr = audio.load(flac, sr=16000)
                err = float(np.abs(y - waves[0]).max())
                require(sr == 16000 and y.shape == waves[0].shape
                        and err <= 1 / 32768,
                        f"ffmpeg FLAC vs WAV: {y.shape} max |diff| {err}")
                lines.append(f"ffmpeg: present, FLAC vs WAV max |diff| "
                             f"{err:.3e}")
            else:
                try:
                    audio.load(td / "song.mp3", sr=16000)
                    raised = ""
                except ValueError as e:
                    raised = str(e)
                require(raised == "cannot decode .mp3 without ffmpeg; "
                        "provide a .wav", f"no ffmpeg: load raised {raised!r}")
                lines.append("ffmpeg: absent (load raises the JAX package's "
                             "ValueError)")
        finally:
            os.chdir(old_cwd)
    for line in lines:
        print(f"  {line}", flush=True)
    return f"{len(lines)} checks [{smi}]"


GRAPH_ROUTES = (  # decode_graph: label, dtype name, engine knobs
    ("bf16 serving (kernel 3)", "bfloat16", {}),
    ("pallas_cross (kernel 4)", "bfloat16", {"pallas_cross": True}),
    ("int8_weights", "bfloat16", {"int8_weights": True}),
    ("kv_bits=4", "bfloat16", {"kv_bits": 4}),
    ("unroll=8", "bfloat16", {"unroll": 8}),
    ("suppress_tokens", "bfloat16", {"suppress_tokens": (3, 131, 132)}),
    ("sampling temperature=1.0 top_k=10 seed=5", "bfloat16",
     {"temperature": 1.0, "top_k": 10, "sample_seed": 5}),
    ("fp32 parity", "float32", {}),
)
TRACE_STEPS = 128  # decode steps under the profiler, captured and eager


def decode_graph_phase(smi: str, launches_of, engine, batch, cond) -> str:
    """The decode loop as one captured program on the card: for every
    route of ``GRAPH_ROUTES`` (a fresh engine of the model of record but
    for the default one), the song's batch decoded by ``generate_tokens``
    (the first call captures, the second only replays) against
    ``generate_tokens_eager``, its plain twin: tokens and lengths equal
    bit for bit, and the kernels' counts under replay 12 a step (kernel 3
    in every attention block; 6 + 6 of kernels 3 and 4 under
    ``pallas_cross``; none in fp32).  Then, with EOS suppressed, ms a step
    at widths 64 and 128 (1023 steps), captured and eager; the host's
    launches a step and the device's idle share over ``TRACE_STEPS``
    steps of each (``profiling.trace``), where the kernels 3 and 4 the
    device ran, read off the trace by name and matched to the host calls
    that launched them in the window, must equal what the wrappers
    counted (a replay adds the counts its capture recorded), also for a
    replay of the ``pallas_cross`` route; and the capture's seconds.
    -> the phase's info; raises on any failure."""
    import numpy as np
    import torch

    from music2midi_tpu_torch import profiling
    from music2midi_tpu_torch.infer import Music2MIDI
    from music2midi_tpu_torch.infer.decode import (
        decode_programs,
        generate_tokens,
        generate_tokens_eager,
    )

    lines = []
    encs, engines = {}, {}
    for label, dtype, knobs in GRAPH_ROUTES:
        eng = engine
        if knobs or dtype != "bfloat16":
            eng = Music2MIDI.from_npz(RECORD, dtype=getattr(torch, dtype))
            for k, val in knobs.items():
                setattr(eng, k, val)
        engines[label] = eng
        if dtype not in encs:
            encs[dtype] = eng._encoder(eng._log_mel(eng._device_wave(batch)),
                                       cond)
        enc, dcfg = encs[dtype], eng._dcfg()

        def run(fn):
            return timed_s(lambda: launches_of(lambda: fn(
                eng.model, enc, eng.t5_config, dcfg, eng._sample_rng(0))))

        ((t_e, l_e), n_e), eager_s = run(generate_tokens_eager)
        ((t_c, l_c), n_c), first_s = run(generate_tokens)
        ((t_r, l_r), n_r), replay_s = run(generate_tokens)
        for what, (t, ln) in (("captured", (t_c, l_c)),
                              ("replayed", (t_r, l_r))):
            require(torch.equal(t, t_e) and torch.equal(ln, l_e),
                    f"decode_graph {label}: {what} tokens differ from the "
                    "eager twin's")
        steps = int(l_e.max()) - 1
        run_steps = steps_run(steps, dcfg)
        if dtype == "float32":
            want = {"decode_attention_int8": 0, "decode_attention_cross_t": 0}
        elif knobs.get("pallas_cross"):
            want = {"decode_attention_int8": 6 * run_steps,
                    "decode_attention_cross_t": 6 * run_steps}
        else:
            want = {"decode_attention_int8": 12 * run_steps,
                    "decode_attention_cross_t": 0}
        for name, n in (("eager", n_e), ("capturing", n_c), ("replay", n_r)):
            got = {k: n[k] for k in want}
            require(got == want, f"decode_graph {label}: {name} run "
                    f"launched {got}, want {want} ({run_steps} steps)")
        prog = decode_programs(eng.model)[
            (enc.shape[0], enc.shape[1], eng.t5_config, dcfg, enc.device)]
        lines.append(
            f"{label}: tokens equal to the eager twin bit for bit, "
            f"{steps} steps ({run_steps} run), launches a run={want}; "
            f"eager {eager_s:.4f} s ({eager_s / run_steps * 1e3:.3f} ms a "
            f"step), first captured {first_s:.4f} s (capture "
            f"{[round(c, 4) for c in prog.capture_seconds]} s over "
            f"{len(prog.graphs)} phase graphs), replayed {replay_s:.4f} s "
            f"({replay_s / run_steps * 1e3:.3f} ms a step) "
            f"sha256={sha16(t_e)}")

    # ms a step at widths 64 and 128, EOS suppressed: 1023 steps each
    forced = engine._dcfg()._replace(suppress_tokens=(2,))
    enc64 = encs["bfloat16"]
    for width, enc in ((64, enc64), (128, torch.cat([enc64, enc64]))):
        (_, l_c), cap_s = timed_s(lambda: generate_tokens(
            engine.model, enc, engine.t5_config, forced))
        (_, l_c), rep_s = timed_s(lambda: generate_tokens(
            engine.model, enc, engine.t5_config, forced))
        ((_, l_e), n_e), eag_s = timed_s(lambda: launches_of(
            lambda: generate_tokens_eager(engine.model, enc,
                                          engine.t5_config, forced)))
        steps = int(l_c.max()) - 1
        require(steps == forced.max_length - 1 and torch.equal(l_c, l_e),
                f"forced decode ran {steps} steps")
        lines.append(
            f"width {width}, {steps} steps (EOS suppressed): captured "
            f"{rep_s / steps * 1e3:.4f} ms a step ({rep_s:.4f} s; first call "
            f"with its capture {cap_s:.4f} s), eager "
            f"{eag_s / steps * 1e3:.4f} ms a step ({eag_s:.4f} s) [{smi}]")

    # launches a step and idle share, TRACE_STEPS steps of each; the
    # kernels 3 and 4 the device ran (matched to the host calls in the
    # window that launched them) against the wrappers' counts
    kernel_of = {"decode_attention_int8": "decode_attention_int8_kernel",
                 "decode_attention_cross_t": "decode_attention_cross_t_kernel"}
    cross_label = next(lb for lb, _, kn in GRAPH_ROUTES
                       if kn.get("pallas_cross"))
    for name, eng, fn in (
            ("captured", engine, generate_tokens),
            ("eager", engine, generate_tokens_eager),
            (f"captured {cross_label}", engines[cross_label],
             generate_tokens)):
        short = eng._dcfg()._replace(suppress_tokens=(2,),
                                     max_length=TRACE_STEPS + 1)
        if fn is generate_tokens:  # its capture, outside the trace
            fn(eng.model, enc64, eng.t5_config, short)
        with tempfile.TemporaryDirectory() as td:
            with profiling.trace(td):
                with profiling.span("decode_call"):
                    _, counted = launches_of(lambda: fn(
                        eng.model, enc64, eng.t5_config, short))
            events = profiling.load_trace(td)
        window = profiling.annotation_window(events, "decode_call")
        launches = profiling.host_launches(events, window)
        ran = profiling.device_kernels(events, kernel_of.values(), window)
        ran = {k: ran[v] for k, v in kernel_of.items()}
        counted = {k: counted[k] for k in kernel_of}
        require(ran == counted and sum(ran.values()) == 12 * TRACE_STEPS,
                f"decode_graph {name}: the device ran {ran} of kernels 3 "
                f"and 4, the wrappers counted {counted}, want "
                f"{12 * TRACE_STEPS} in all")
        kernels = sum(ev.get("cat") == "kernel" and
                      window[0] <= ev["ts"] < window[1] for ev in events)
        lines.append(
            f"{name}, width 64, {TRACE_STEPS} steps under torch.profiler: "
            f"host launches a step="
            f"{sum(launches.values()) / TRACE_STEPS:.3f} ({launches}), "
            f"device kernels a step={kernels / TRACE_STEPS:.2f}, "
            f"kernels 3 and 4 the device ran={ran} (the wrappers "
            f"counted the same), device idle share="
            f"{profiling.device_idle_share(events, window):.4f}, window "
            f"{(window[1] - window[0]) / 1e3:.3f} ms, the device's clock "
            f"past it {profiling.device_clock_past(events, window):.1f} us "
            f"[{smi}]")
    for line in lines:
        print(f"  {line}", flush=True)
    return f"{len(GRAPH_ROUTES)} routes, {len(lines)} lines [{smi}]"


def steps_run(steps: int, dcfg) -> int:
    """Decode steps a generation runs when its longest row takes `steps`:
    whole bodies of ``unroll`` steps, the last at most past max_length - 1
    by the body's padding."""
    u = max(1, dcfg.unroll)
    return min(-(-steps // u), -(-(dcfg.max_length - 1) // u)) * u


def sha16(t) -> str:
    """Short sha256 of a tensor's bytes (to compare runs)."""
    import hashlib

    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def check_attention(got, ref, what) -> float:
    """A decode-attention kernel's bf16 output against its plain version's
    -> max |diff|, within ``ATTN_BAR``."""
    import torch

    torch.cuda.synchronize()
    require(got.shape == ref.shape and got.dtype == torch.bfloat16,
            f"{what}: {got.shape} {got.dtype} vs {ref.shape}")
    require(bool(torch.isfinite(got.float()).all()),
            f"{what}: non-finite kernel output")
    err = float((got.float() - ref.float()).abs().max())
    require(err <= ATTN_BAR, f"{what}: kernel vs plain {err} > {ATTN_BAR}")
    return err


def int8_attention_inputs(L: int, causal: bool, n_sets: int,
                          bits: int = 8, batch: int = B_SERVE,
                          heads: int = HEADS) -> list:
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

    B, H, D = batch, heads, D_KV
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
    check = check_attention

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
            sd = torch.full((), step, dtype=torch.int32, device="cuda")
            out["plan"].append(
                lambda p=plan, q=q, kn=kn, vn=vn, sd=sd:
                p.causal(0, q, kn, vn, sd))
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

    # the causal launch reads its step from device memory: through a plan
    # over the whole cache, a device step at the key-group boundaries
    # against the plain version (and bit for bit against the host step
    # the plan writes to its own scalar); a step past the cache writes NaN
    q, k, v, kn, vn, bias = self_sets[0]
    rows = bias[0, :, 0, :]
    plan = da.Int8AttentionPlan([(k, v)], rows, round_pv=True)
    step_dev = torch.zeros((), dtype=torch.int32, device="cuda")
    for step in (0, 1, 63, 64, 127, 128, 255, 256, 511, 512, SELF_LEN - 2,
                 SELF_LEN - 1):
        n = step + 1
        step_dev.fill_(step)
        got = plan.causal(0, q, kn, vn, step_dev).clone()
        errs["int8"] = max(errs["int8"], check(
            got, da.decode_attention_int8_plain(
                q, (k[0][:, :, :n], k[1][..., :n]),
                (v[0][:, :, :n], v[1][..., :n]), rows[:, SELF_LEN - n:],
                step, kn, vn, True, round_pv=True),
            f"int8 causal device step {step}"))
        require(torch.equal(got, plan.causal(0, q, kn, vn, step)),
                f"device step {step} vs host step")
    step_dev.fill_(SELF_LEN)
    out = plan.causal(0, q, kn, vn, step_dev)
    torch.cuda.synchronize()
    require(bool(torch.isnan(out.float()).all()),
            "a step past the cache did not write NaN")

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

    def kernel_ms(head) -> dict:
        """The kernel's device time as the decode loop launches it (its
        launch plan, with the step already on the card), where there is
        one: the public function writes a host step to the card first, a
        second launch in its time."""
        if head.get("plan_ms") is None:
            return {}
        return {"ms": head["plan_ms"], "public_function_ms": head["ms"]}

    def entry(name, source, replaces, head):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": 0,
                "max_abs_err": errs[name], **{k: head[k] for k in keys},
                **kernel_ms(head), "shape": head["shape"],
                "timings": timings[name]}

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
                            **kernel_ms(f32_head),
                            "plan_host_ms": f32_head["plan_host_ms"],
                            "shape": f32_head["shape"]}
    return (int8,
            entry("cross_t", "music2midi_tpu_torch/csrc/decode_attention.cu",
                  "music2midi_tpu/ops/decode_attention.py:288",
                  timings["cross_t"][0]))


# parallel: 4 ranks on the one card over gloo at (dp, tp) = (2, 2); the
# train CLI's steps and batch; bars
PAR_DP, PAR_TP, PAR_STEPS, PAR_BATCH = 2, 2, 2, 16
PAR_TRAIN_RTOL = 1e-4  # losses; parameters: of each element or leaf RMS
FP32_TOKEN_BAR = 0.99  # fp32 greedy-token agreement, tp engine vs one
# ROADMAP C3: the bf16 engine at (2, 2) against one device, a floor just
# under its reading on an H100 (0.921127; tools/torch_mesh_agreement.py:
# tp moves bf16 roundings, dp alone and fp32 at every mesh agree 1.0)
TP_BF16_BAR = 0.91


def torchrun(nproc: int, argv: list, cwd: Path, backend=None) -> tuple:
    """``python3 -m torch.distributed.run --standalone --nproc_per_node
    nproc argv`` in `cwd` (``M2M_DIST_BACKEND=backend`` when given); raises
    unless every rank exits 0.  -> (stdout, stderr, seconds)."""
    env = {k: v for k, v in os.environ.items() if k != "M2M_DIST_BACKEND"}
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [str(ROOT), os.environ.get("PYTHONPATH")]))
    if backend is not None:
        env["M2M_DIST_BACKEND"] = backend
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), *argv],
        cwd=cwd, capture_output=True, text=True, timeout=600, env=env)
    secs = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"torchrun {nproc} x {argv} exited {proc.returncode}:\n"
            f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout, proc.stderr, secs


def token_agreement(toks, base) -> tuple:
    """(equal tokens, tokens) of two lists of token rows, each pair
    compared over the longer row (the shorter padded with 0)."""
    import numpy as np

    same = total = 0
    for a, b in zip(toks, base):
        n = max(len(a), len(b))
        pa, pb = np.zeros(n, np.int64), np.zeros(n, np.int64)
        pa[:len(a)], pb[:len(b)] = a, b
        same += int((pa == pb).sum())
        total += n
    return same, total


def parallel_worker(mode: str, out: Path, fixture_path: str) -> None:
    """One rank of the parallel phase's engine runs (``python3 -m
    torch.distributed.run ... chip_smoke.py --parallel-worker MODE OUT
    FIXTURE``): "serve" at (2, 2) over gloo (bf16 on the song with the
    kernels' counts, the calibration gate on the fixture, fp32 on the
    song), "nccl" at (1, 1) over NCCL (bf16 on the song, the captured
    program).  Writes ``OUT/<mode>_rank<r>.json``."""
    import torch

    sys.path.insert(0, str(ROOT))
    from music2midi_tpu_torch.calibration import check_midi
    from music2midi_tpu_torch.infer import Music2MIDI
    from music2midi_tpu_torch.parallel import (
        make_mesh,
        maybe_initialize_distributed,
    )
    from music2midi_tpu_torch.parallel.distributed import shutdown

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = maybe_initialize_distributed(device=CARD)
    want = "gloo" if mode == "serve" else "nccl"
    require(info and info.backend == want,
            f"rank backend {info and info.backend}, asked for {want}")
    dp, tp = (PAR_DP, PAR_TP) if mode == "serve" else (1, 1)
    mesh = make_mesh(dp, tp, CARD)
    wrappers = _wrappers()
    song = synthetic_song(180.0, 16000, seed=7)
    res = {"rank": info.rank, "backend": info.backend,
           "device": str(info.device)}
    eng = Music2MIDI.from_npz(RECORD, dtype=torch.bfloat16, mesh=mesh,
                              device=CARD)
    chunks = eng._chunk_waveform(song)
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = eng.sample_tokens_batched(chunks)
    torch.cuda.synchronize()
    res["bf16_s"] = time.perf_counter() - t0
    res["launches"] = {w.__name__: w.launches for w in wrappers}
    res["bf16_tokens"] = [t.tolist() for t in toks]
    res["stats"] = [{k: s[k] for k in ("batch_width", "steps", "loop_steps",
                                       "captured")}
                    for s in eng.last_decode_stats]
    res["local_heads"] = eng.t5_config.num_heads
    if mode == "serve":
        ok, detail = check_midi(eng.generate(audio_path=fixture_path))
        res["gate"] = [bool(ok), detail]
        eng32 = Music2MIDI.from_npz(RECORD, mesh=mesh, device=CARD)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res["fp32_tokens"] = [t.tolist()
                              for t in eng32.sample_tokens_batched(chunks)]
        torch.cuda.synchronize()
        res["fp32_s"] = time.perf_counter() - t0
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{mode}_rank{info.rank}.json").write_text(json.dumps(res))
    shutdown()


def dropout_draw_ms(data: Path, config) -> tuple:
    """(ms, ms) of one train step's dropout draws on the card, at the full
    shapes every rank of a (PAR_DP, PAR_TP) mesh draws and at the rank's
    share (1 / (dp tp) at the head and d_ff sites, 1 / dp elsewhere): the
    shapes are those a one-device forward of the CLI's first batch asks
    for (``models/t5.py::MaskShard``, logged), timed as ``torch.rand``
    calls of their sizes."""
    import numpy as np
    import torch

    from music2midi_tpu_torch.data import DataLoader, Music2MIDIDataset
    from music2midi_tpu_torch.models.t5 import MaskShard, t5_config_from
    from music2midi_tpu_torch.ops.mel import log_mel_config_from
    from music2midi_tpu_torch.train.loop import _loss, to_device
    from music2midi_tpu_torch.train.loop import trainable_model
    from music2midi_tpu_torch.weights import load_npz

    ids = np.load(data / "dataset_split.npz", allow_pickle=True)["train_id"]
    loader = DataLoader(Music2MIDIDataset(data, ids, config),
                        batch_size=PAR_BATCH, num_workers=0, shuffle=True)
    batch = to_device(next(iter(loader)), CARD)
    cfg = t5_config_from(config)
    model = trainable_model(load_npz(RECORD)[0], cfg, CARD)
    shapes = []

    class Logged(MaskShard):
        def keep(self, shape, split_dim, rate, device):
            shapes.append((math.prod(shape), split_dim))
            return super().keep(shape, split_dim, rate, device)

    gen = torch.Generator(device=CARD).manual_seed(0)
    with torch.no_grad():
        _loss(model, batch, Logged(gen, slice(None), PAR_BATCH), cfg,
              log_mel_config_from(config), False)

    def draws(share: bool):
        for n, split in shapes:
            if share:
                n //= PAR_DP * (PAR_TP if split is not None else 1)
            torch.rand(n, generator=gen, device=CARD)

    return cuda_ms(lambda: draws(False), 10), cuda_ms(lambda: draws(True), 10)


def parallel_phase(smi: str, engine, song, corpus: Path, fixture_path: str,
                   work: Path) -> str:
    """dp x tp on the one card; see the module docstring, item 15."""
    import numpy as np
    import torch

    from music2midi_tpu_torch.infer import Music2MIDI
    from music2midi_tpu_torch.ops import decode_attention as da
    from music2midi_tpu_torch.weights import restore_params

    lines = []
    # (a) the train CLI at (2, 2), 4 ranks over gloo, against one process:
    # data prep's corpus with its train split repeated to one batch
    data = work / "corpus"
    data.mkdir()
    for d in ("audio", "midi_numpy", "metadata"):
        (data / d).symlink_to(corpus / d)
    split = dict(np.load(corpus / "dataset_split.npz", allow_pickle=True))
    train = [str(x) for x in split["train_id"]]
    split["train_id"] = np.array((train * PAR_BATCH)[:PAR_BATCH])
    np.savez(data / "dataset_split.npz", **split)
    cfg = training_config().to_dict()
    cfg["dataloader"] = {"batch_size": PAR_BATCH, "num_workers": 0}
    cfg["trainer"]["log_every_n_steps"] = 1
    (work / "par_config.json").write_text(json.dumps(cfg))

    def cli(name):
        return [str(data), "--init_from", str(RECORD), "--config",
                str(work / "par_config.json"), "--out_dir",
                str(work / "runs"), "--name", name, "--max_steps",
                str(PAR_STEPS), "--device", CARD]

    _, _, one_s = run_module("train", cli("one"), work)
    out, _, mesh_s = torchrun(
        PAR_DP * PAR_TP, ["-m", "music2midi_tpu_torch.train", *cli("mesh"),
                          "--tp", str(PAR_TP)], work, backend="gloo")
    card = "cuda:0" if CARD == "cuda" else CARD
    for r in range(PAR_DP * PAR_TP):
        line = f"rank {r}/{PAR_DP * PAR_TP}: backend gloo device {card}"
        require(line in out, f"train CLI rank {r}: {out[-3000:]}")
        print(f"  train CLI {line}", flush=True)
    losses = {}
    for name in ("one", "mesh"):
        recs = [json.loads(x) for x in (work / "runs" / name / "log.jsonl")
                .read_text().splitlines()]
        losses[name] = [r["train/loss"] for r in recs if "train/loss" in r]
        require(len(losses[name]) == PAR_STEPS, f"{name} log: {recs}")
    np.testing.assert_allclose(losses["mesh"], losses["one"],
                               rtol=PAR_TRAIN_RTOL)
    one, _ = restore_params(work / "runs" / "one" / "ckpt")
    got, _ = restore_params(work / "runs" / "mesh" / "ckpt")
    require(sorted(one) == sorted(got), "parameter names differ")
    worst = 0.0
    for k, want in one.items():
        w, g = want.double(), got[k].double()
        scale = torch.maximum(w.abs(), w.square().mean().sqrt())
        worst = max(worst, float(((g - w).abs() / scale).max()))
    require(worst <= PAR_TRAIN_RTOL,
            f"(2, 2) parameters {worst} off one process's (relative)")
    full_ms, share_ms = dropout_draw_ms(data, training_config())
    lines.append(
        f"(a) train CLI {PAR_STEPS} fp32 steps from the model of record, "
        f"batch {PAR_BATCH} (dropout 0.1, full masks on every rank): one "
        f"process {one_s:.3f} s, 4 ranks at (2, 2) over gloo on one card "
        f"{mesh_s:.3f} s (process starts, loader, validation and the "
        f"gathered checkpoint included; not a scaling number); train/loss "
        f"one {losses['one']} mesh {losses['mesh']}; parameters' largest "
        f"difference {worst:.3e} of each element or its leaf's RMS "
        f"(bar {PAR_TRAIN_RTOL}); a step's dropout draws at the full shapes "
        f"every rank draws {full_ms:.4f} ms, at a rank's share "
        f"{share_ms:.4f} ms [{smi}]")

    # (b) the engine at (2, 2) over gloo, and (d) at (1, 1) over NCCL
    chunks = engine._chunk_waveform(song)
    base = [t.tolist() for t in engine.sample_tokens_batched(chunks)]
    base32 = [t.tolist() for t in Music2MIDI.from_npz(RECORD, device=CARD)
              .sample_tokens_batched(chunks)]
    quality = token_agreement(base, base32)
    res_dir = work / "engine"
    secs = {}
    for mode, nproc, backend in (("serve", PAR_DP * PAR_TP, "gloo"),
                                 ("nccl", 1, None)):
        _, _, secs[mode] = torchrun(
            nproc, [str(ROOT / "chip_smoke.py"), "--parallel-worker", mode,
                    str(res_dir), fixture_path], work, backend)
    ranks = [json.loads((res_dir / f"serve_rank{r}.json").read_text())
             for r in range(PAR_DP * PAR_TP)]
    for res in ranks:
        print(f"  engine rank {res['rank']}/{len(ranks)}: backend "
              f"{res['backend']} device {res['device']}", flush=True)
        require(res["backend"] == "gloo" and res["device"] == card,
                f"engine rank {res['rank']}: {res['backend']} "
                f"{res['device']}")
        n = res["launches"]
        require(n["decode_attention_int8"] > 0
                and n["log_mel_spectrogram_cuda"] > 0,
                f"engine rank {res['rank']}: kernels not launched: {n}")
        require(res["local_heads"] == HEADS // PAR_TP, "heads a rank")
        require(all(s["captured"] is False for s in res["stats"]),
                f"the tp engine captured: {res['stats']}")
        require(res["gate"][0], f"calibration gate on rank {res['rank']}: "
                                f"{res['gate'][1]}")
        require(res["bf16_tokens"] == ranks[0]["bf16_tokens"]
                and res["fp32_tokens"] == ranks[0]["fp32_tokens"],
                "the ranks returned different tokens")
    for d in range(PAR_DP):  # a dp rank's tp ranks left the loop together
        loops = {json.dumps([s["loop_steps"] for s in ranks[d * PAR_TP + t]
                             ["stats"]]) for t in range(PAR_TP)}
        require(len(loops) == 1, f"dp rank {d}'s tp ranks' steps {loops}")
    same, total = token_agreement(ranks[0]["bf16_tokens"], base)
    same32, total32 = token_agreement(ranks[0]["fp32_tokens"], base32)
    mesh_quality = token_agreement(ranks[0]["bf16_tokens"], base32)
    require(same / total >= TP_BF16_BAR,
            f"bf16 tp engine vs one device {same / total} < {TP_BF16_BAR}")
    require(same32 / total32 >= FP32_TOKEN_BAR,
            f"fp32 tp engine vs one device {same32 / total32} < "
            f"{FP32_TOKEN_BAR}")
    lines.append(
        f"(b) Music2MIDI(mesh=(2, 2)) bf16 on the 180-s song, 4 ranks over "
        f"gloo on one card: launches by rank "
        f"{[r['launches'] for r in ranks]} (kernel 3 at H/tp = "
        f"{HEADS // PAR_TP}, B/dp = {ranks[0]['stats'][0]['batch_width'] // PAR_DP}); "
        f"\"captured\": false; decode stats {ranks[0]['stats']}; greedy-token "
        f"agreement with one device, bf16 {same / total:.6f} ({same}/{total},"
        f" bar {TP_BF16_BAR}), fp32 {same32 / total32:.6f} ({same32}/"
        f"{total32}, bar {FP32_TOKEN_BAR}); with one device's fp32 tokens: "
        f"the mesh's bf16 {mesh_quality[0] / mesh_quality[1]:.6f}, one "
        f"device's bf16 {quality[0] / quality[1]:.6f}; calibration gate pass "
        f"({ranks[0]['gate'][1]}"
        f"); song s by rank bf16 {[r['bf16_s'] for r in ranks]} fp32 "
        f"{[r['fp32_s'] for r in ranks]} (eager loop, gloo all-reduces "
        f"through the host; not a scaling number); torchrun {secs['serve']:.3f}"
        f" s [{smi}]")

    # (c) kernels 3 and 4 at the tp engine's widths against their plain
    # versions
    B, H = B_SERVE // PAR_DP, HEADS // PAR_TP
    errs, times = [], []
    (q, k, v, kn, vn, bias), = int8_attention_inputs(
        SELF_LEN, True, 1, batch=B, heads=H)
    rows = bias[0, :, 0, :]
    plan = da.Int8AttentionPlan([(k, v)], rows, round_pv=True)
    for n in (32, 128, SELF_LEN - 1):
        step = n - 1
        args = (q, (k[0][:, :, :n], k[1][..., :n]),
                (v[0][:, :, :n], v[1][..., :n]), rows[:, SELF_LEN - n:],
                step, kn, vn, True)
        for rp in (False, True):
            errs.append(check_attention(
                da.decode_attention_int8(*args, round_pv=rp),
                da.decode_attention_int8_plain(*args, round_pv=rp),
                f"H={H} causal n {n} round_pv {rp}"))
        got = plan.causal(0, q, kn, vn, step).clone()
        require(torch.equal(got, da.decode_attention_int8(
            *args, round_pv=True)), f"H={H} plan vs public function n {n}")
        sd = torch.full((), step, dtype=torch.int32, device="cuda")
        times.append((n, device_ms(lambda: plan.causal(0, q, kn, vn, sd),
                                   200)[0]))
    (q, ck, cv), = int8_attention_inputs(ENC_LEN, False, 1, batch=B,
                                         heads=H)
    for rp in (False, True):
        errs.append(check_attention(
            da.decode_attention_int8(q, ck, cv, None, None, None, None,
                                     False, ENC_LEN, round_pv=rp),
            da.decode_attention_int8_plain(q, ck, cv, None, None, None, None,
                                           False, ENC_LEN, round_pv=rp),
            f"H={H} cross round_pv {rp}"))
    kt, vt = da.transpose_cross_entry(ck), da.transpose_cross_entry(cv)
    errs.append(check_attention(
        da.decode_attention_cross_t(q, kt, vt, ENC_LEN),
        da.decode_attention_cross_t_plain(q, kt, vt, ENC_LEN),
        f"H={H} cross_t"))
    lines.append(
        f"(c) kernels 3 and 4 at B {B}, H {H}: max |kernel - plain| "
        f"{max(errs):.3e} (bar {ATTN_BAR}; causal n 32/128/1023 round_pv "
        f"off/on, cross L {ENC_LEN}, transposed cross); kernel 3's plan "
        f"device ms by n {times} [{smi}]")

    # (d) NCCL at world size 1: the captured program, tokens bit for bit
    res = json.loads((res_dir / "nccl_rank0.json").read_text())
    print(f"  engine rank 0/1: backend {res['backend']} device "
          f"{res['device']}", flush=True)
    require(res["backend"] == "nccl", f"nccl rank: {res['backend']}")
    require(all(s["captured"] is True for s in res["stats"]),
            f"the dp-only engine did not capture: {res['stats']}")
    require(res["bf16_tokens"] == base,
            "NCCL world-1 engine tokens differ from one process's")
    lines.append(
        f"(d) NCCL at world size 1, mesh (1, 1): \"captured\": true, bf16 "
        f"tokens equal one process's bit for bit "
        f"({sum(len(t) for t in base)} tokens), song s {res['bf16_s']:.3f},"
        f" torchrun {secs['nccl']:.3f} s [{smi}]")
    for line in lines:
        print(f"  {line}", flush=True)
    return " | ".join(x.split(":")[0] for x in lines) + f" [{smi}]"


ORBAX_FIXTURE = ROOT / "tests" / "data" / "orbax_small"
ORBAX_LOSS_BAR = 1e-4  # the training phase's card-vs-CPU loss bar
ZSTD_REPEATS = 20  # passes over the fixture's chunks to time the decoder


def orbax_phase(smi: str, launches_of, fixture_path: str) -> str:
    """The JAX trainer's orbax checkpoints on the card; see the module
    docstring, item 17.  -> the phase's info; raises on any failure."""
    import hashlib

    import numpy as np
    import torch

    from music2midi_tpu_torch import orbax, zstd
    from music2midi_tpu_torch.audio import load as load_audio
    from music2midi_tpu_torch.infer import Music2MIDI
    from music2midi_tpu_torch.models.t5 import t5_config_from
    from music2midi_tpu_torch.ops.mel import log_mel_config_from
    from music2midi_tpu_torch.train.adafactor import MultiSteps
    from music2midi_tpu_torch.train.checkpoint import restore_train_state
    from music2midi_tpu_torch.train.loop import (
        Batch,
        TrainState,
        make_optimizer,
        make_train_step,
        pad_labels,
        trainable_model,
    )
    from music2midi_tpu_torch.weights import load_npz, restore_params

    fix = ORBAX_FIXTURE
    expected = json.loads((fix / "expected.json").read_text())
    lines = []

    # the decoder, built here with this machine's g++
    lib = zstd.library_path()
    found = lib.is_file()
    (_, build_s) = timed_s(zstd.get_lib)
    require(lib.is_file(), f"zstd decoder not built at {lib}")
    lines.append(f"zstd decoder: {lib.name} "
                 f"{'found built' if found else 'built with g++'} in "
                 f"{build_s:.3f} s (compiler output: "
                 f"{zstd.build_log().strip() or 'none'})")

    # both layouts, bit for bit against the npz twin
    twin, twin_cfg = load_npz(fix / "params.npz")
    for layout in ("export", "run", "run/step_00000003"):
        sd, cfg = restore_params(fix / layout)
        require(cfg is not None and cfg.to_dict() == twin_cfg.to_dict(),
                f"{layout}: config differs from the npz twin's")
        require(set(sd) == set(twin), f"{layout}: parameter names differ")
        for k, v in twin.items():
            require(sd[k].dtype == v.dtype and torch.equal(sd[k], v),
                    f"{layout}: {k} differs from the npz twin")
    lines.append(f"layouts export, run, run/step_00000003: {len(twin)} "
                 f"parameters bit-equal to the npz twin")

    # from_orbax in bf16 on the card, the calibration chunk
    engine = Music2MIDI.from_orbax(fix / "export", dtype=torch.bfloat16,
                                   device=CARD)
    twin_engine = Music2MIDI.from_npz(fix / "params.npz",
                                      dtype=torch.bfloat16, device=CARD)
    require(engine.device.type == CARD, "engine not on the card")
    midi, n = launches_of(lambda: engine.generate(audio_path=fixture_path))
    require(n["log_mel_spectrogram_cuda"] > 0,
            "from_orbax: the mel kernel was not launched")
    require(n["decode_attention_int8"] > 0,
            "from_orbax: the int8 decode-attention kernel was not launched")
    wave, _ = load_audio(fixture_path, int(engine.config.model.sample_rate))
    toks = [e.sample_tokens_batched(e._chunk_waveform(wave))
            for e in (engine, twin_engine)]
    require(len(toks[0]) == len(toks[1]) and all(
        np.array_equal(a, b) for a, b in zip(*toks)),
        "from_orbax tokens differ from from_npz's on the twin")
    twin_midi = twin_engine.generate(audio_path=fixture_path)
    notes = [[(x.start, x.end, x.pitch) for i in m.instruments
              for x in i.notes] for m in (midi, twin_midi)]
    require(notes[0] == notes[1], "from_orbax notes differ from from_npz's")
    lines.append(
        f"from_orbax(export, bf16) on the calibration fixture: "
        f"{len(toks[0])} chunks, {sum(len(t) for t in toks[0])} tokens equal "
        f"from_npz(twin)'s, {len(notes[0])} "
        f"notes (random weights), launches={n}")

    # the JAX run resumed on the card: 2 steps against JAX's losses
    sd, config = restore_params(fix / "run")
    cfg = t5_config_from(config)._replace(dropout_rate=0.0)
    mel_cfg = log_mel_config_from(config)
    model = trainable_model(sd, cfg, CARD)
    opt = make_optimizer(model, lr=expected["lr"], warmup_init=False)
    state = TrainState(model, MultiSteps(opt, expected["every_k"]))
    state, _ = restore_train_state(fix / "run", state)
    require(state.step == expected["saved_step"]
            and state.optimizer.mini_step == 1,
            f"restored step {state.step}, mini_step "
            f"{state.optimizer.mini_step}")
    rng = np.random.default_rng(expected["seed"])
    w = (rng.normal(size=(expected["batch"], int(
        expected["seconds"] * mel_cfg.sample_rate))) * 0.1).astype(np.float32)
    require(hashlib.sha256(w.tobytes()).hexdigest()
            == expected["wave_sha256"], "the fixture's batch differs here")
    batch = Batch(w, pad_labels([np.array(x) for x in expected["labels"]]),
                  np.array(expected["cond"]))
    step = make_train_step(cfg, mel_cfg)
    losses = []
    for _ in expected["losses_after_restore"]:
        state, loss = step(state, batch, 0)
        losses.append(float(loss))
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(losses, expected["losses_after_restore"]))
    require(rel <= ORBAX_LOSS_BAR, f"resumed losses {losses} vs JAX's "
            f"{expected['losses_after_restore']}")
    lines.append(f"restore_train_state(run) at step {expected['saved_step']}"
                 f" (MultiSteps mid-cycle), 2 fp32 steps on the card: losses "
                 f"{losses} vs JAX {expected['losses_after_restore']}, max "
                 f"rel {rel:.3e} (bar {ORBAX_LOSS_BAR})")

    # the decoder's rate on this host: every zarr chunk of the run's state
    kv = orbax.open_kvstore(fix / "run" / "step_00000003" / "state")
    chunks = [kv[k] for k in kv if not k.endswith(b".zarray")]
    frames = [c for c in chunks if c[:4] == b"\x28\xb5\x2f\xfd"]
    out_bytes = sum(len(zstd.decompress(c)) for c in frames)
    t0 = time.perf_counter()
    for _ in range(ZSTD_REPEATS):
        for c in frames:
            zstd.decompress(c)
    dt = time.perf_counter() - t0
    lines.append(f"zstd decode on this host: {len(frames)} zarr chunks, "
                 f"{out_bytes} bytes out x {ZSTD_REPEATS} in {dt:.4f} s = "
                 f"{out_bytes * ZSTD_REPEATS / dt / 1e6:.1f} MB/s (host "
                 f"clock, one thread)")
    for line in lines:
        print(f"  {line}", flush=True)
    return (f"{len(lines)} checks; launches kernel 1 "
            f"{n['log_mel_spectrogram_cuda']}, kernel 3 "
            f"{n['decode_attention_int8']} [{smi}]")


def adafactor_phase(smi: str) -> tuple:
    """Kernel 5, the multi-tensor Adafactor, on the model of record's
    leaves; see the module docstring, item 3.  -> (the phase's info, the
    kernels line's entry); raises on any failure."""
    import numpy as np
    import torch

    from music2midi_tpu_torch import profiling
    from music2midi_tpu_torch.train import Adafactor
    from music2midi_tpu_torch.train.adafactor import step_plain
    from music2midi_tpu_torch.weights import load_npz

    sd, _ = load_npz(RECORD)
    leaves = [v.float() for v in sd.values() if v.is_floating_point()]
    rng = np.random.default_rng(19)
    grads = [torch.from_numpy(rng.standard_normal(x.shape, np.float32)
                              * np.float32(10.0 ** rng.uniform(-4, 0))).cuda()
             for x in leaves]

    def fresh(lr=None):
        params = [torch.nn.Parameter(x.cuda()) for x in leaves]
        for p, g in zip(params, grads):
            p.grad = g
        return params, Adafactor(params, lr=lr, warmup_init=lr is None)

    # a fixed lr of 1e-2 (a change far above an ulp of p, so the relative
    # bar decides) and the recipe's relative step (a change of a few ulps),
    # whose optimizers the checks below go on with
    compare = {}
    for lr in (1e-2, None):
        kp, kopt = fresh(lr)
        pp, popt = fresh(lr)
        kopt.step()
        step_plain(popt)
        torch.cuda.synchronize()
        worst_m = worst_p = 0.0
        apart = 0  # elements not equal to the plain version's
        for a, b, x in zip(kp, pp, leaves):
            got, want, x = (a.detach().cpu().numpy(),
                            b.detach().cpu().numpy(), x.numpy())
            slack = np.spacing(np.maximum(np.abs(x), np.abs(want)))
            over = (np.abs(got - want) - slack) / np.maximum(
                np.abs(want - x), 1e-30)
            worst_p = max(worst_p, float(over.max()))
            apart += int(np.count_nonzero(got != want))
            for key, m in popt.state[b].items():
                if key != "step":
                    ref = m.cpu().numpy()
                    rel = np.abs(kopt.state[a][key].cpu().numpy() - ref) / ref
                    worst_m = max(worst_m, float(rel.max()))
        name = "relative step" if lr is None else f"lr {lr:g}"
        require(worst_m <= ADAFACTOR_BARS[0],
                f"adafactor, {name}: moments {worst_m:.3e} relative off the "
                f"plain version's (bar {ADAFACTOR_BARS[0]})")
        require(worst_p <= ADAFACTOR_BARS[1],
                f"adafactor, {name}: a parameter change {worst_p:.3e} "
                f"relative off the plain version's (bar {ADAFACTOR_BARS[1]})")
        compare[name] = (worst_m, worst_p, apart)
    again, aopt = fresh()
    aopt.step()
    require(all(torch.equal(a, b) for a, b in zip(kp, again)),
            "adafactor: two kernel runs differ")
    require(kopt.launches == 4 and kopt.tensors == len(leaves) == 146,
            f"adafactor: {kopt.launches} launches over {kopt.tensors} leaves")

    iters = 50
    n0 = kopt.launches
    ms, host_ms = device_ms(kopt.step, iters)
    per_step = (kopt.launches - n0) / (2 * iters + 3)
    plain_ms, plain_host_ms = device_ms(lambda: step_plain(popt), 5)
    launches = {}
    for name, fn in (("kernel", kopt.step), ("plain",
                                             lambda: step_plain(popt))):
        with tempfile.TemporaryDirectory() as td:
            with profiling.trace(td):
                with profiling.span("optimizer_step"):
                    fn()
            events = profiling.load_trace(td)
        window = profiling.annotation_window(events, "optimizer_step")
        launches[name] = sum(profiling.host_launches(events, window).values())
    require(launches["kernel"] == 4,
            f"adafactor: {launches['kernel']} host launches a kernel step")
    n = sum(x.numel() for x in leaves)
    moments = sum(sum(x.shape) if x.ndim == 2 else x.numel() for x in leaves)
    # the function: p and g read once, p written once, the moments read
    # and written; the kernel's passes: p, g | g | g, p and p written
    need, passes = 12 * n + 8 * moments, 24 * n + 8 * moments
    bound_ms, bound_by, _, _ = _bound(need, 20.0 * n)
    algo_ms = passes / HBM_BYTES_PER_S * 1e3
    entry = {"name": "adafactor", "route": "cuda",
             "source": "music2midi_tpu_torch/csrc/adafactor.cu",
             "replaces": None, "launches": 0,
             "max_rel_err": max(c[0] for c in compare.values()),
             "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
             "plain_host_ms": plain_host_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "algorithm_bound_ms": algo_ms,
             "library_ms": None,
             "shape": f"146 fp32 leaves, {n} parameters"}
    info = (f"adafactor (146 leaves, {n} parameters), against the plain "
            f"version: " + "; ".join(
                f"{name}: moments within {m:.3e} relative, parameter changes "
                f"{p:.3e} past an ulp, {u} of {n} elements apart"
                for name, (m, p, u) in compare.items()) +
            f" (bars {ADAFACTOR_BARS}); bit-equal twice; kernel ms a step="
            f"{ms:.4f} host-inclusive={host_ms:.4f} launches a step="
            f"{per_step:g} (profiler: {launches['kernel']}); plain ms="
            f"{plain_ms:.4f} host-inclusive={plain_host_ms:.4f} launches "
            f"a step={launches['plain']}; bound_ms={bound_ms:.4f} "
            f"({bound_by}: {need} B) passes_bound_ms={algo_ms:.4f} "
            f"({passes} B) [{smi}]")
    return info, entry


def ssm_state_update_phase(smi: str) -> tuple:
    """Kernel 6 at granite-4.0-h's widths (H 128, P 64, N 128, G 1) and
    128 rows; see the module docstring, item 18.  -> (the phase's info,
    the kernels line's entry); raises on any failure."""
    import torch

    from music2midi_tpu_torch.ops import ssm_state_update as su

    g = torch.Generator(device="cuda").manual_seed(6)
    B, H, P, N = 128, 128, 64, 128

    def normal(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    # the served step's operands: A = -exp(A_log) in [-16, -1], dt after
    # softplus, D = 1
    h0 = normal(B, H, P, N, scale=0.1)
    A = -(1.0 + 15.0 * torch.rand(H, generator=g, device="cuda"))
    D = torch.ones(H, device="cuda")
    steps = [(normal(B, H, P), torch.rand(B, H, generator=g, device="cuda")
              * 0.1, normal(B, 1, N), normal(B, 1, N)) for _ in range(3)]
    n0 = su.ssm_state_update.launches
    calls = 0
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        hk = h0.to(dtype)
        hp = hk.clone()
        err_y = err_h = ulps = 0.0
        for x, dt, Bm, Cm in steps:
            hp.copy_(hk)  # each step from the same state
            yk = su.ssm_state_update(hk, x, dt, A, Bm, Cm, D)
            yp = su.ssm_state_update_plain(hp, x, dt, A, Bm, Cm, D)
            torch.cuda.synchronize()
            calls += 1
            err_y = max(err_y, float((yk - yp).abs().max() / yp.abs().max()))
            diff = (hk.float() - hp.float()).abs()
            err_h = max(err_h, float(diff.max() / hp.float().abs().max()))
            # in ulps of the state's dtype, above a floor of float32
            # round-off where the update cancels
            ulp = torch.finfo(dtype).eps * torch.maximum(hk.float().abs(),
                                                         hp.float().abs()) \
                + 1e-6 * hp.float().abs().max()
            ulps = max(ulps, float((diff / ulp).max()))
        worst[dtype] = (err_y, err_h, ulps)
        require(err_y <= SSM_BAR,
                f"ssm_state_update {dtype}: y {err_y:.3e} relative off the "
                f"plain version's (bar {SSM_BAR})")
        if dtype == torch.float32:
            require(err_h <= SSM_BAR,
                    f"ssm_state_update: the state {err_h:.3e} relative off "
                    f"the plain version's (bar {SSM_BAR})")
        else:  # rounded from float32 values an ulp of float32 apart
            require(ulps <= 1.0,
                    f"ssm_state_update bfloat16: the state {ulps:.3g} ulps "
                    "off the plain version's (bar one)")
    x, dt, Bm, Cm = steps[0]
    h = h0.clone()
    iters = 50
    ms, host_ms = device_ms(
        lambda: su.ssm_state_update(h, x, dt, A, Bm, Cm, D), iters)
    calls += 2 * iters + 3
    plain_ms, plain_host_ms = device_ms(
        lambda: su.ssm_state_update_plain(h, x, dt, A, Bm, Cm, D), 5)
    launches = su.ssm_state_update.launches - n0
    require(launches == calls,
            f"ssm_state_update: {launches} launches for {calls} calls")
    # the state read and written once; 5 flops an element of it
    need = 2 * h.numel() * h.element_size()
    bound_ms, bound_by, _, _ = _bound(need, 5.0 * h.numel())
    err_y, err_h, _ = worst[torch.float32]
    entry = {"name": "ssm_state_update", "route": "cuda",
             "source": "music2midi_tpu_torch/csrc/ssm_state_update.cu",
             "replaces": None, "launches": launches,
             "max_rel_err": max(err_y, err_h), "ms": ms, "host_ms": host_ms,
             "plain_ms": plain_ms, "plain_host_ms": plain_host_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
             "shape": f"state ({B}, {H}, {P}, {N}) f32, G 1"}
    info = (f"ssm_state_update ({B} rows, {H} x {P} x {N}) against the plain "
            "version on the same inputs, 3 steps: " + "; ".join(
                f"{str(d).split('.')[-1]} state: y {e_y:.3e}, state {e_h:.3e}"
                f" relative, {u:.3g} ulps at most"
                for d, (e_y, e_h, u) in worst.items()) +
            f" (bar {SSM_BAR}); kernel ms={ms:.4f} host-inclusive="
            f"{host_ms:.4f}; plain ms={plain_ms:.4f} host-inclusive="
            f"{plain_host_ms:.4f}; bound_ms={bound_ms:.4f} ({bound_by}: "
            f"{need} B); launches={launches} for {calls} calls [{smi}]")
    return info, entry


def _wrappers() -> list:
    from music2midi_tpu_torch.ops import decode_attention as da
    from music2midi_tpu_torch.ops import decode_fused as df
    from music2midi_tpu_torch.ops import mel_cuda
    from music2midi_tpu_torch.ops import ssm_state_update as su
    from music2midi_tpu_torch.train import adafactor

    return [mel_cuda.log_mel_spectrogram_cuda,
            mel_cuda.log_mel_spectrogram_dft_cuda,
            da.decode_attention_int8, da.decode_attention_cross_t,
            adafactor.adafactor_kernel, su.ssm_state_update, *df.wrappers()]


@contextlib.contextmanager
def parent_glue():
    """The T5 decode step's glue as ATen chains, as the loop ran it before
    kernels 7-10: each of ``ops/decode_fused.py``'s wrappers replaced by
    its plain twin (counted by none) while the block runs.  A program
    made inside the block captures the chains."""
    from unittest import mock

    from music2midi_tpu_torch.ops import decode_fused as df

    with contextlib.ExitStack() as stack:
        for name in ("add_rms_norm", "embed_rms_norm", "quantize_write_kv",
                     "gelu_mul", "greedy_commit"):
            stack.enter_context(mock.patch.object(
                df, name, getattr(df, name + "_plain")))
        stack.enter_context(mock.patch.object(df, "wrappers", lambda: ()))
        yield


def decode_fused_phase(smi: str) -> tuple:
    """Kernels 7-10 at the serving shapes (128 rows of the model of record
    in bf16: d_model 384, 8 x 64 heads over a 1024-long int8 cache, d_ff
    1152, 400 ids) against their plain twins (the ATen chains) on the same
    card inputs: 8-10 bit for bit, 7's new x bit for bit and its norm at
    least ``NORM_BIT_SHARE`` bit-equal, within one bf16 ulp, after the add
    and after the gather from a (400, 384) table by int32 ids; each timed
    with its twin, against the bytes it must move.  -> (the phase's info,
    the kernels line's entries); raises on any failure."""
    import torch

    from music2midi_tpu_torch.ops import decode_fused as df

    g = torch.Generator(device="cuda").manual_seed(22)
    B, d, H, D, L, F, V = 128, 384, 8, 64, 1024, 1152, 400
    bf16 = torch.bfloat16

    def normal(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda")
                * scale).to(bf16)

    x, delta = normal(B, 1, d, scale=3.0), normal(B, 1, d)
    w = torch.rand(d, generator=g, device="cuda") + 0.5
    qkv = normal(B, 1, 3 * H * D, scale=4.0)
    gate_lin = normal(B, 1, 2 * F, scale=3.0)
    step = torch.tensor(517, dtype=torch.int32, device="cuda")

    def cache():
        return [(torch.zeros(B, H, L, D, dtype=torch.int8, device="cuda"),
                 torch.ones(B, H, 1, L, device="cuda")) for _ in range(2)]

    def loop_state():
        done = torch.zeros(B, dtype=torch.bool, device="cuda")
        done[::5] = True
        return [done, torch.zeros(B, L + 1, dtype=torch.int32, device="cuda"),
                torch.zeros(B, dtype=torch.int32, device="cuda"),
                torch.tensor(40, dtype=torch.int32, device="cuda")]

    logits = normal(B, V, scale=4.0)
    logits[1, 9] = logits[1, 300] = 99.0  # a tie
    # kernel 7's gather form (layer 0's ln1) against its twin: a (V, d)
    # table, int32 ids as the loop holds them
    table = normal(V, d, scale=2.0)
    ids = torch.randint(0, V, (B,), generator=g, device="cuda",
                        dtype=torch.int32)
    e0 = df.add_rms_norm.launches
    ek, enk = df.embed_rms_norm(table, ids, w, 1e-6)
    ep, enp = df.embed_rms_norm_plain(table, ids, w, 1e-6)
    torch.cuda.synchronize()
    e_ulps = ((enk.view(torch.int16).long() - enp.view(torch.int16).long())
              .abs())
    e_share = float((e_ulps == 0).float().mean())
    require(df.add_rms_norm.launches == e0 + 1 and torch.equal(ek, ep)
            and int(e_ulps.max()) <= 1 and e_share >= NORM_BIT_SHARE,
            f"embed_rms_norm: x equal {torch.equal(ek, ep)}, norm "
            f"{int(e_ulps.max())} ulps at most, {e_share:.6f} bit-equal, "
            f"{df.add_rms_norm.launches - e0} launches")
    # against the twins
    n0 = [wr.launches for wr in df.wrappers()]
    xk, xp = x.clone(), x.clone()
    hk = df.add_rms_norm(xk, delta, w, 1e-6)
    hp = df.add_rms_norm_plain(xp, delta, w, 1e-6)
    ck, cp = cache(), cache()
    fk = df.quantize_write_kv(qkv, *ck, step, 127.0)
    fp = df.quantize_write_kv_plain(qkv, *cp, step, 127.0)
    gk, gp = df.gelu_mul(gate_lin), df.gelu_mul_plain(gate_lin)
    sk, sp = loop_state(), loop_state()
    lk, lp = logits.clone(), logits.clone()
    df.greedy_commit(lk, None, *sk, 0, 2)
    df.greedy_commit_plain(lp, None, *sp, 0, 2)
    torch.cuda.synchronize()
    ulps = ((hk.view(torch.int16).long() - hp.view(torch.int16).long())
            .abs())
    share = float((ulps == 0).float().mean())
    require(torch.equal(xk, xp) and int(ulps.max()) <= 1
            and share >= NORM_BIT_SHARE,
            f"add_rms_norm: x equal {torch.equal(xk, xp)}, norm "
            f"{int(ulps.max())} ulps at most, {share:.6f} bit-equal")
    require(all(torch.equal(a, b) for pa, pb in zip(fk, fp)
                for a, b in zip(pa, pb))
            and all(torch.equal(a, b) for ea, eb in zip(ck, cp)
                    for a, b in zip(ea, eb)),
            "quantize_write_kv: the fresh rows or the cache differ from "
            "the twin's")
    require(torch.equal(gk, gp), "gelu_mul differs from the twin")
    require(torch.equal(lk, lp) and all(torch.equal(a, b)
                                        for a, b in zip(sk, sp)),
            "greedy_commit differs from the twin")
    # timed at the serving shapes; bytes each must move (bf16 unless said)
    iters = 200
    runs = [
        ("add_rms_norm", lambda: df.add_rms_norm(xk, delta, w, 1e-6),
         lambda: df.add_rms_norm_plain(xp, delta, w, 1e-6),
         2 * (2 * B * d * 2) + 4 * d,  # x, delta read; x, out written
         f"x, delta ({B}, 1, {d}) bf16, w f32"),
        ("quantize_write_kv",
         lambda: df.quantize_write_kv(qkv, *ck, step, 127.0),
         lambda: df.quantize_write_kv_plain(qkv, *cp, step, 127.0),
         2 * B * H * D * 2 + 2 * (2 * B * H * D + 2 * B * H * 4),
         f"qkv ({B}, 1, {3 * H * D}) bf16 -> int8 cache ({B}, {H}, {L}, "
         f"{D}) and fresh rows"),
        ("gelu_mul", lambda: df.gelu_mul(gate_lin),
         lambda: df.gelu_mul_plain(gate_lin), B * 3 * F * 2,
         f"gate | lin ({B}, 1, {2 * F}) bf16"),
        ("greedy_commit", lambda: df.greedy_commit(lk, None, *sk, 0, 2),
         lambda: df.greedy_commit_plain(lp, None, *sp, 0, 2),
         B * V * 2 + B * (1 + 4 + 4 + 4),
         f"logits ({B}, {V}) bf16, done, tokens ({B}, {L + 1})"),
    ]
    entries, parts = [], []
    for (name, kern, plain, nbytes, shape), wr, n_before in zip(
            runs, df.wrappers(), n0):
        ms, host_ms = device_ms(kern, iters)
        plain_ms, plain_host_ms = device_ms(plain, 20)
        launches = wr.launches - n_before
        want = 4 + 2 * iters  # the check, 3 warm-ups, two timed loops
        require(launches == want,
                f"{name}: {launches} launches for {want} calls")
        bound_ms, bound_by, _, _ = _bound(nbytes, 0.0)
        entries.append({
            "name": name, "route": "cuda",
            "source": "music2midi_tpu_torch/csrc/decode_fused.cu",
            "replaces": None, "launches": launches,
            "max_rel_err": 0.0 if name != "add_rms_norm" else None,
            "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "plain_host_ms": plain_host_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "shape": shape})
        parts.append(f"{name} ({shape}): kernel ms={ms:.5f} host-inclusive="
                     f"{host_ms:.5f}; plain ms={plain_ms:.5f} host-inclusive"
                     f"={plain_host_ms:.5f}; bound_ms={bound_ms:.6f} "
                     f"({bound_by}: {nbytes} B); launches={launches}")
    info = ("kernels 7-10 against their twins: add_rms_norm x bit-equal, "
            f"norm {share:.6f} bit-equal, {int(ulps.max())} ulp at most; "
            f"embed_rms_norm x bit-equal, norm {e_share:.6f} bit-equal, "
            f"{int(e_ulps.max())} ulp at most; "
            "quantize_write_kv, gelu_mul, greedy_commit bit for bit; "
            + "; ".join(parts) + f" [{smi}]")
    return info, entries


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
    from music2midi_tpu_torch.infer.decode import (
        DecodeProgram,
        decode_programs,
        generate_tokens,
    )
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
        """Counts to 0, run fn, read every count just after; kernel 6
        (the hybrid decoder's) must not run on these T5 paths."""
        for w in wrappers:
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {w.__name__: w.launches for w in wrappers}
        require(counts["ssm_state_update"] == 0,
                f"a T5 path launched kernel 6: {counts}")
        return out, counts

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

    with Phase("kernel_vs_plain_adafactor") as ph:
        ph.info, adafactor_entry = adafactor_phase(smi)

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
        require(agree_n / agree_d >= C1_BAR,
                f"kernel route vs _attention_int8 {agree_n / agree_d} < "
                f"the C1 bar {C1_BAR}")
        # the serving loop (kernel route, captured) against the same loop
        # with the step's glue as ATen chains, captured afresh: the loop
        # before kernels 7-10, on the same encoder output
        serve_dcfg = engine._dcfg()._replace(pallas_attention=True)
        with parent_glue():
            parent = DecodeProgram(engine.model, engine.t5_config,
                                   serve_dcfg, enc.shape[0], enc.shape[1],
                                   enc.device)
            parent.run(engine.model, enc)  # its capture
            t_par, l_par = (t.cpu().numpy()
                            for t in parent.run(engine.model, enc))
            del parent
        par_n = par_d = par_rows = 0
        for r in range(stats[0]["real_rows"]):
            m = int(max(l_par[r], l_on[r]))
            same = int((t_par[r, :m] == t_on[r, :m]).sum())
            par_n, par_d, par_rows = par_n + same, par_d + m, \
                par_rows + (same == m)
        require(par_n == par_d,
                f"the fused loop vs the loop of ATen glue: {par_n} of "
                f"{par_d} tokens equal")
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
                   f"{agree_n / agree_d:.6f} ({agree_n}/{agree_d}) "
                   f"greedy_token_agreement_with_the_aten_glue_loop="
                   f"{par_n / par_d:.6f} ({par_n}/{par_d}; rows equal "
                   f"{par_rows}/{stats[0]['real_rows']}) [{smi}]")

    with Phase("decode_graph") as ph:
        ph.info = decode_graph_phase(smi, launches_of, engine, batch, cond)

    with Phase("batch_serving") as ph:
        songs = [song] + [synthetic_song(180.0, 16000, seed=s)
                          for s in (8, 9, 10)]
        conds = [[0, 0], [1, 1], [2, 2], [3, 0]]
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        beng = Music2MIDI.from_npz(RECORD, dtype=torch.bfloat16)
        t0 = time.perf_counter()
        beng.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        kept = torch.cuda.memory_allocated() - held
        peak = torch.cuda.max_memory_allocated() - held
        captures = {key[0]: [round(c, 4) for c in prog.capture_seconds]
                    for key, prog in decode_programs(beng.model).items()}
        require(sorted(captures) == [8, 16, 32, 64, 128],
                f"warmup captured the buckets {sorted(captures)}")
        runs = []
        _, batch_launches = launches_of(
            lambda: beng.generate_batch(songs, cond_indices=conds))
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            midis = beng.generate_batch(songs, cond_indices=conds)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        notes = [len(m.instruments[0].notes) for m in midis]
        require(all(k > 0 for k in notes), f"a song gave no notes: {notes}")
        bstats = [{k: s[k] for k in ("batch_width", "real_rows", "steps",
                                     "tokens_real")}
                  for s in beng.last_decode_stats]
        med = float(np.median(runs))
        single = {(n.start, n.end, n.pitch)
                  for n in midi.instruments[0].notes}
        batched = {(n.start, n.end, n.pitch)
                   for n in midis[0].instruments[0].notes}
        del beng
        ph.info = (f"warmup_s={warm_s:.3f} (every bucket; capture seconds "
                   f"by bucket {captures}; the engine keeps {kept} B with "
                   f"every bucket captured, peak {peak} B) runs_s={runs} "
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
            run = steps_run(steps, eng._dcfg())
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

    prep_dir = tempfile.TemporaryDirectory()
    corpus = Path(prep_dir.name) / "corpus"
    with Phase("data_prep") as ph:
        ph.info = data_prep_phase(smi, launches_of, corpus)

    with Phase("training") as ph, tempfile.TemporaryDirectory() as td:
        path = str(Path(td) / "a4_22050.wav")
        write_wav(path, fixture, fixture_sr)
        ph.info = training_phase(smi, launches_of, check_midi, path, corpus,
                                 adafactor_entry)

    with Phase("entry_points") as ph:
        ph.info = entry_points_phase(smi, launches_of, engine, corpus)

    with Phase("parallel") as ph, tempfile.TemporaryDirectory() as td:
        path = str(Path(td) / "a4_22050.wav")
        write_wav(path, fixture, fixture_sr)
        ph.info = parallel_phase(smi, engine, song, corpus, path, Path(td))
    prep_dir.cleanup()

    with Phase("configs") as ph, tempfile.TemporaryDirectory() as td:
        ph.info = configs_phase(smi, launches_of, Path(td))

    with Phase("orbax") as ph, tempfile.TemporaryDirectory() as td:
        path = str(Path(td) / "a4_22050.wav")
        write_wav(path, fixture, fixture_sr)
        ph.info = orbax_phase(smi, launches_of, path)

    with Phase("kernels") as ph:
        ph.info, ssm_entry = ssm_state_update_phase(smi)
        fused_info, fused_entries = decode_fused_phase(smi)
        ph.info += "; " + fused_info
        print(json.dumps({"kernels": [
            mel_entries["log_mel_fft"], mel_entries["log_mel_dft"],
            int8_entry, cross_t_entry, adafactor_entry, ssm_entry,
            *fused_entries]}), flush=True)

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:
        parallel_worker(sys.argv[2], Path(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--loader-worker"]:
        loader_worker(sys.argv[2], Path(sys.argv[3]), Path(sys.argv[4]))
        sys.exit(0)
    sys.exit(main())
