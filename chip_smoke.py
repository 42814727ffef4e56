"""Drive the PyTorch/CUDA port (music2midi_tpu_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing one line with its own seconds; any failure raises
and exits non-zero, and nothing is caught and passed over:

  1. environment: card name, ``nvidia-smi`` name and power limit, torch
     and nvcc versions (no card: exit 1 before anything else);
  2. build: the one nvcc build of ``music2midi_tpu_torch/csrc/*.cu``;
  3. kernel vs plain: the fused log-mel kernel against its plain PyTorch
     version on the card, at the serving shape of a 3-minute song (64
     chunks of 48000 samples: noise, a 440 Hz tone and silence, plus the
     bucket's zero rows) and at a ragged length (41234 samples), with the
     TPU kernel's bars: noise within 1e-3 in the log domain, silence on
     log(1e-6) within 1e-4, the tone's argmax mel bin equal; then the
     kernel, the plain version and a torch.stft chain timed with CUDA
     events;
  4. serving path: ``Music2MIDI.from_npz(model of record, bf16)`` on the
     card, ``generate(audio_path=...)`` on the calibration fixture, the
     pinned ``check_midi`` gate, and the mel kernel's launch count of
     this run;
  5. fp32 parity: the same fixture's greedy tokens through fp32 engines
     on the card and on the CPU, agreement >= 0.99;
  6. song timing: a synthetic 3-minute song through serving ``generate``,
     one warm-up and three timed runs, and a per-stage breakdown;
  7. the ``kernels`` JSON line.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Only ``nvcc`` and ``nvidia-smi`` are started as subprocesses; no threads.
"""

from __future__ import annotations

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


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over `iters` calls, CUDA events."""
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


def mel_bound(B: int, S: int, cfg) -> tuple:
    """Least time on the card for the log-mel of (B, S): bytes (wave read
    once, mels written once) over HBM rate vs fp32 operations over the
    fp32 rate.  A frame needs an n_fft-point real FFT, 2.5 N log2 N flops
    (half a complex FFT of the same length), plus the window, the power
    of N/2 + 1 bins and the multiply-adds of the nonzero mel weights."""
    from music2midi_tpu_torch.ops.mel import num_frames
    from music2midi_tpu_torch.ops.mel_cuda import mel_nnz

    F = num_frames(S, cfg)
    n = cfg.n_fft
    nbytes = 4 * B * S + 4 * B * F * cfg.n_mels
    per_frame = 2.5 * n * math.log2(n) + n + 3 * (n // 2 + 1) + 2 * mel_nnz(cfg)
    ops = B * F * per_frame
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from music2midi_tpu_torch.audio import resample, write_wav
    from music2midi_tpu_torch.calibration import check_midi, render_fixture
    from music2midi_tpu_torch.infer import Music2MIDI
    from music2midi_tpu_torch.ops import _build
    from music2midi_tpu_torch.ops.detokenize import detokenize
    from music2midi_tpu_torch.ops.mel import LogMelConfig, log_mel_spectrogram
    from music2midi_tpu_torch.ops.mel_cuda import log_mel_spectrogram_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with Phase("environment") as ph:
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
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
    with Phase("kernel_vs_plain") as ph:
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
        max_err = 0.0
        for w, rows in ((wave, noise_rows), (ragged, [0, 1, 2, 3])):
            x = torch.from_numpy(w).cuda()
            got = log_mel_spectrogram_cuda(x, cfg)
            torch.cuda.synchronize()
            ref = log_mel_spectrogram(x, cfg)
            require(got.shape == ref.shape, f"shapes {got.shape} vs {ref.shape}")
            require(bool(torch.isfinite(got).all()), "non-finite kernel output")
            err = float((got[rows] - ref[rows]).abs().max())
            require(err <= 1e-3, f"kernel vs plain max |diff| {err} > 1e-3")
            max_err = max(max_err, err)
        x = torch.from_numpy(wave).cuda()
        got = log_mel_spectrogram_cuda(x, cfg)
        ref = log_mel_spectrogram(x, cfg)
        silence = float((got[2:n_real:3] - math.log(1e-6)).abs().max())
        require(silence <= 1e-4, f"silence off the log floor by {silence}")
        tone_k = int(got[1].mean(0).argmax())
        tone_p = int(ref[1].mean(0).argmax())
        require(tone_k == tone_p, f"tone argmax bin {tone_k} vs {tone_p}")
        # tone rows: near-silent mel bins sit at fp32 round-off, so they are
        # held by argmax only (as the JAX package's tests hold them)
        tone_kernel_plain = float((got[1:n_real:3] - ref[1:n_real:3]).abs().max())
        lib = stft_log_mel(x, cfg)
        lib_err = float((lib - ref).abs().max())
        ms = cuda_ms(lambda: log_mel_spectrogram_cuda(x, cfg), 50)
        plain_ms = cuda_ms(lambda: log_mel_spectrogram(x, cfg), 20)
        library_ms = cuda_ms(lambda: stft_log_mel(x, cfg), 20)
        bound_ms, bound_by, nbytes, ops = mel_bound(B, S, cfg)
        ph.info = (f"shape=({B},{S}) max_abs_err(noise)={max_err:.3e} "
                   f"silence_err={silence:.2e} tone_bin={tone_k} "
                   f"tone: kernel-plain={tone_kernel_plain:.3e} "
                   f"stft_vs_plain={lib_err:.2e} ms={ms:.4f} "
                   f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
                   f"bound_ms={bound_ms:.4f} ({bound_by}; {nbytes} B, "
                   f"{ops:.4g} flop) [{smi}]")
    mel_entry = {
        "name": "log_mel_fft", "route": "cuda",
        "source": "music2midi_tpu_torch/csrc/mel_fft.cu",
        "replaces": "music2midi_tpu/ops/mel_pallas.py:145",
        "launches": 0, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }

    fixture, fixture_sr = render_fixture()
    with Phase("serving_path") as ph:
        engine = Music2MIDI.from_npz(RECORD, dtype=torch.bfloat16)
        require(engine.device.type == "cuda", "engine not on the card")
        with tempfile.TemporaryDirectory() as td:
            path = str(Path(td) / "a4_22050.wav")
            write_wav(path, fixture, fixture_sr)
            log_mel_spectrogram_cuda.launches = 0
            midi = engine.generate(audio_path=path)
            torch.cuda.synchronize()
            launches = log_mel_spectrogram_cuda.launches
        ok, detail = check_midi(midi)
        require(ok, f"calibration gate failed on the card: {detail}")
        require(launches > 0, "the serving path did not launch the mel kernel")
        mel_entry["launches"] = launches
        n_notes = len(midi.instruments[0].notes)
        ph.info = (f"check_midi=pass ({detail}) notes={n_notes} "
                   f"mel_kernel_launches={launches} "
                   f"decode={engine.last_decode_stats[0]['steps']} steps")

    with Phase("fp32_parity") as ph:
        chunks16 = resample(fixture, fixture_sr, 16000)
        toks = {}
        for dev in ("cuda", "cpu"):
            eng = Music2MIDI.from_npz(RECORD, device=dev)
            toks[dev] = eng.sample_tokens_batched(eng._chunk_waveform(chunks16))
        same = total = 0
        for a, b in zip(toks["cuda"], toks["cpu"]):
            n = max(len(a), len(b))
            pa = np.zeros(n, np.int64)
            pb = np.zeros(n, np.int64)
            pa[:len(a)], pb[:len(b)] = a, b
            same += int((pa == pb).sum())
            total += n
        agree = same / total
        require(agree >= 0.99, f"fp32 cuda-vs-cpu token agreement {agree}")
        ph.info = f"token_agreement={agree:.6f} ({same}/{total} tokens)"

    with Phase("song_timing") as ph:
        song = synthetic_song(180.0, 16000, seed=7)
        times = []
        n_notes = 0
        for i in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            midi = engine.generate(audio_y=song)
            torch.cuda.synchronize()
            if i > 0:
                times.append(time.perf_counter() - t0)
            n_notes = len(midi.instruments[0].notes)
        require(n_notes > 0, "the 3-minute song gave no notes")
        p50 = float(np.median(times))
        stats = engine.last_decode_stats
        # per-stage time of the song's one batch through the engine's own
        # stage methods, CUDA events
        batch, cond = engine._pad_batch(engine._chunk_waveform(song))
        wave = engine._device_wave(batch)
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
        ph.info = (f"p50_song_latency_s={p50:.4f} "
                   f"songs_per_min={60.0 / p50:.3f} runs_s={times} "
                   f"notes={n_notes} chunks={stats[0]['real_rows']} "
                   f"bucket={len(batch)} "
                   f"decode_steps={[s['steps'] for s in stats]} "
                   f"rows_at_cap={at_cap} row_steps={row_steps} "
                   f"stage_ms(transport={st_wave:.3f}, mel={st_mel:.3f}, "
                   f"encoder={st_enc:.3f}, "
                   f"decode={st_dec:.3f}, detokenize={st_det:.3f}) "
                   f"[{smi}]")

    with Phase("kernels"):
        print(json.dumps({"kernels": [mel_entry]}), flush=True)

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
