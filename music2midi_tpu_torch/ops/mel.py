"""Log-mel spectrogram front end in PyTorch.

Port of ``music2midi_tpu/ops/mel.py``: torchaudio's MelSpectrogram
conventions (sr 16000, n_fft 2048, hop 256, f_min 20, 384 mels), i.e.

  * center=True with reflect padding of n_fft // 2 on both sides
  * periodic Hann window, win_length = n_fft
  * power-2 spectrum, no normalisation
  * HTK mel scale, norm=None, f_max = sr / 2
  * clamp at 1e-6, then log

``log_mel_spectrogram`` is the plain version (``torch.fft.rfft``, fp32):
the fp32 parity path on any device, and the version the CUDA kernel of
``mel_cuda.py`` is held against.  ``log_mel_spectrogram_fast`` is the
serving-mode dispatch: the kernel for a CUDA tensor, the plain version for
a CPU tensor.  The host tables are numpy, built in float64 and rounded to
float32 exactly as the JAX package builds them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


class LogMelConfig(NamedTuple):
    sample_rate: int = 16000
    n_fft: int = 2048
    hop_length: int = 256
    f_min: float = 20.0
    n_mels: int = 384
    log_floor: float = 1e-6
    # per-bin clamp at the expected mel power of an RMS-sigma white noise
    # floor before the log; 0.0 = off (the serving default)
    noise_floor_sigma: float = 0.0


def _hz_to_mel_htk(f) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    n_freqs: int, f_min: float, f_max: float, n_mels: int, sample_rate: int
) -> np.ndarray:
    """(n_freqs, n_mels) triangular HTK-mel filterbank, norm=None
    (torchaudio.functional.melscale_fbanks(mel_scale="htk"))."""
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(
        _hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2
    )
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=4)
def hann_window(n_fft: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window default), float32."""
    n = np.arange(n_fft, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)).astype(np.float32)


def filterbank_for(cfg: LogMelConfig) -> np.ndarray:
    return mel_filterbank(
        cfg.n_fft // 2 + 1, cfg.f_min, cfg.sample_rate / 2.0, cfg.n_mels,
        cfg.sample_rate,
    )


@functools.lru_cache(maxsize=8)
def noise_mel_floor(cfg: LogMelConfig) -> np.ndarray:
    """(n_mels,) float32: expected mel power of an RMS-sigma white gaussian
    input, sigma^2 * sum(hann^2) * colsum(fb), never below log_floor."""
    w = hann_window(cfg.n_fft).astype(np.float64)
    fb = filterbank_for(cfg)
    floor = cfg.noise_floor_sigma ** 2 * float(np.sum(w * w)) * fb.sum(0)
    return np.maximum(floor, cfg.log_floor).astype(np.float32)


def num_frames(n_samples: int, cfg: LogMelConfig) -> int:
    """Frame count with center=True padding: 1 + n_samples // hop."""
    return 1 + n_samples // cfg.hop_length


def log_mel_spectrogram(
    wave: torch.Tensor, cfg: LogMelConfig = LogMelConfig()
) -> torch.Tensor:
    """Plain version: waveform (B, S) -> log-mel (B, F, n_mels) float32,
    F = 1 + S // hop, on the wave's device."""
    wave = wave.to(torch.float32)
    pad = cfg.n_fft // 2
    x = torch.nn.functional.pad(wave[:, None, :], (pad, pad), mode="reflect")
    frames = x[:, 0].unfold(-1, cfg.n_fft, cfg.hop_length)  # (B, F, n_fft)
    window = torch.from_numpy(hann_window(cfg.n_fft)).to(wave.device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = spec.real.square() + spec.imag.square()
    fb = torch.from_numpy(filterbank_for(cfg)).to(wave.device)
    mel = torch.matmul(power, fb)
    if cfg.noise_floor_sigma > 0.0:
        floor = torch.from_numpy(noise_mel_floor(cfg)).to(wave.device)
        mel = torch.maximum(mel, floor)
    return torch.log(torch.clamp(mel, min=cfg.log_floor))


def log_mel_spectrogram_fast(
    wave: torch.Tensor, cfg: LogMelConfig = LogMelConfig()
) -> torch.Tensor:
    """Serving-mode front end: the hand-written CUDA kernel for a CUDA
    tensor (it raises on what it does not take: there is no fallback),
    the plain version for a CPU tensor."""
    if wave.device.type != "cuda":
        return log_mel_spectrogram(wave, cfg)
    from .mel_cuda import log_mel_spectrogram_cuda

    out = log_mel_spectrogram_cuda(wave.to(torch.float32).contiguous(), cfg)
    return apply_noise_floor(out, cfg)


def apply_noise_floor(log_mel: torch.Tensor, cfg: LogMelConfig) -> torch.Tensor:
    """The per-bin noise floor on a kernel's output, which clamps at
    log_floor only: a log-domain max, equal to the power-domain max of the
    plain version (log is monotonic).  A no-op when the floor is off."""
    if cfg.noise_floor_sigma <= 0.0:
        return log_mel
    floor = torch.from_numpy(np.log(noise_mel_floor(cfg))).to(log_mel.device)
    return torch.maximum(log_mel, floor)


def log_mel_config_from(config) -> LogMelConfig:
    """Build from the shared config tree."""
    return LogMelConfig(
        sample_rate=int(config.model.sample_rate),
        n_fft=int(config.spectrogram.n_fft),
        hop_length=int(config.spectrogram.hop_length),
        f_min=float(config.spectrogram.f_min),
        n_mels=int(config.model.t5.d_model),
    )
