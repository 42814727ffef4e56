"""The fused log-mel kernel for Hopper: wrapper, tables and launch count.

Replaces ``music2midi_tpu/ops/mel_pallas.py::log_mel_spectrogram_pallas_fft``
(the TPU's serving mel).  The kernel is CUDA C++ in ``csrc/mel_fft.cu``,
built by ``ops/_build.py`` at first use; its plain PyTorch version is
``ops/mel.py::log_mel_spectrogram``, and ``chip_smoke.py`` holds the two
against each other on the card.

Bound on the H100 at the serving shape (64 x 48000 wave -> 64 x 188 x 384):
bytes are 64*48000*4 read + 64*188*384*4 written = 30.8 MB, ~9 us at
3.35 TB/s; operations are the real FFT's 2.5 N log2 N = 56 k fp32 flops
per frame plus the window, the power and the mel triangles, 65.5 k a
frame and 0.79 GFLOP in all, ~12 us at the 67 TFLOP/s fp32 rate
(``chip_smoke.py::mel_bound``).  So the kernel is bound by operations,
though only just, and its design keeps every
intermediate (frames, spectrum, power) in shared memory so that the bytes
stay at the minimum.  The measured time is in PERF.md.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .mel import LogMelConfig, filterbank_for, hann_window, num_frames

_MAX_N_FFT = 4096  # shared memory: 20 * n_fft / 2 bytes, under 48 KB


def check_shape(n_samples: int, cfg: LogMelConfig) -> None:
    """The TPU kernel's guard (256 | n_fft, 128 | hop) plus this kernel's
    own: a power-of-two n_fft up to 4096, and a wave longer than the
    reflect pad."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    if n_fft % 256 != 0 or hop % 128 != 0:
        raise ValueError("mel kernel requires 256 | n_fft and 128 | hop")
    if n_fft & (n_fft - 1) or n_fft > _MAX_N_FFT:
        raise ValueError(
            f"mel kernel requires a power-of-two n_fft <= {_MAX_N_FFT}"
        )
    if n_samples <= n_fft // 2:
        raise ValueError(
            f"reflect pad of {n_fft // 2} needs more than {n_samples} samples"
        )


@functools.lru_cache(maxsize=8)
def _tables(cfg: LogMelConfig, device: torch.device) -> tuple:
    """Device tables: Hann window, (cos, sin) twiddles, and each mel bin's
    nonzero span [lo, hi) with its weights, from the float32 filterbank
    the plain version multiplies by."""
    n_fft = cfg.n_fft
    k = np.arange(n_fft // 2, dtype=np.float64)
    ang = 2.0 * np.pi * k / n_fft
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    fb = filterbank_for(cfg)  # (n_freqs, n_mels)
    lo = np.zeros(cfg.n_mels, np.int32)
    hi = np.zeros(cfg.n_mels, np.int32)
    off = np.zeros(cfg.n_mels, np.int32)
    weights = []
    pos = 0
    for m in range(cfg.n_mels):
        nz = np.nonzero(fb[:, m])[0]
        if len(nz):
            lo[m], hi[m] = nz[0], nz[-1] + 1
        off[m] = pos
        weights.append(fb[lo[m]:hi[m], m])
        pos += hi[m] - lo[m]
    wts = np.concatenate(weights + [np.zeros(1, np.float32)])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (dev(hann_window(n_fft)), dev(tw), dev(lo), dev(hi), dev(off),
            dev(wts))


def mel_nnz(cfg: LogMelConfig) -> int:
    """Nonzero filterbank weights: the multiply-adds of the mel step."""
    return int(np.count_nonzero(filterbank_for(cfg)))


def log_mel_spectrogram_cuda(
    wave: torch.Tensor, cfg: LogMelConfig = LogMelConfig()
) -> torch.Tensor:
    """(B, S) float32 CUDA wave -> (B, F, n_mels) float32 log-mel, one
    launch of the fused kernel on the current stream."""
    if wave.device.type != "cuda":
        raise ValueError(f"mel kernel needs a CUDA tensor, got {wave.device}")
    if wave.dtype != torch.float32:
        raise ValueError(f"mel kernel needs float32, got {wave.dtype}")
    if wave.dim() != 2:
        raise ValueError(f"mel kernel needs (B, S), got {tuple(wave.shape)}")
    if not wave.is_contiguous():
        raise ValueError("mel kernel needs a contiguous wave")
    B, S = wave.shape
    check_shape(S, cfg)
    F = num_frames(S, cfg)
    out = torch.empty((B, F, cfg.n_mels), dtype=torch.float32,
                      device=wave.device)
    if B == 0:
        return out
    hann, tw, lo, hi, off, wts = _tables(cfg, wave.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(wave.device).cuda_stream
    status = lib.m2m_log_mel_fft(
        wave.data_ptr(), out.data_ptr(), hann.data_ptr(), tw.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), off.data_ptr(), wts.data_ptr(),
        B, S, F, cfg.n_fft, cfg.hop_length, cfg.n_mels,
        float(cfg.log_floor), stream,
    )
    _build.check(status, "m2m_log_mel_fft")
    log_mel_spectrogram_cuda.launches += 1
    return out


log_mel_spectrogram_cuda.launches = 0
