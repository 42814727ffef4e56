"""Host-side DSP: STFT, phase-vocoder time stretch, pitch shift.

First-party replacement for librosa.effects.pitch_shift, the most expensive
host op in the reference's training data pipeline (reference
music2midi/dataset.py:132-133,157-160; SURVEY.md §3.2 hot loop).  Same
recipe as librosa: time-stretch by 2^(-n/12) with a phase vocoder
(n_fft=2048, hop=512, Hann), then resample back to the original rate, fixed
to the input length.

The port's own copy of ``music2midi_tpu/dsp.py``.  A C++ implementation
with the same signature (``csrc/m2m_dsp.cpp``, loaded through
``native.py``) is taken when it builds; this numpy version is the
reference and the fallback.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from .audio import resample as _resample_rational


def stft(
    y: np.ndarray, n_fft: int = 2048, hop_length: int = 512
) -> np.ndarray:
    """Center-padded (reflect) STFT -> (1 + n_fft//2, frames) complex."""
    pad = n_fft // 2
    x = np.pad(y, pad, mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop_length
    idx = (
        np.arange(n_frames)[:, None] * hop_length + np.arange(n_fft)[None, :]
    )
    window = np.hanning(n_fft + 1)[:-1]  # periodic hann
    return np.fft.rfft(x[idx] * window, axis=1).T


def istft(
    D: np.ndarray, n_fft: int = 2048, hop_length: int = 512,
    length: int | None = None,
) -> np.ndarray:
    """Overlap-add inverse STFT with squared-window normalization."""
    window = np.hanning(n_fft + 1)[:-1]
    frames = np.fft.irfft(D.T, n=n_fft, axis=1) * window
    n_frames = frames.shape[0]
    out_len = n_fft + (n_frames - 1) * hop_length
    out = np.zeros(out_len)
    norm = np.zeros(out_len)
    win_sq = window * window
    for i in range(n_frames):
        s = i * hop_length
        out[s:s + n_fft] += frames[i]
        norm[s:s + n_fft] += win_sq
    out = out / np.maximum(norm, 1e-8)
    pad = n_fft // 2
    out = out[pad:]
    if length is not None:
        if len(out) < length:
            out = np.pad(out, (0, length - len(out)))
        out = out[:length]
    return out


def phase_vocoder(
    D: np.ndarray, rate: float, hop_length: int = 512
) -> np.ndarray:
    """Stretch an STFT in time by `rate` (>1 = faster/shorter)."""
    n_bins = D.shape[0]
    n_fft = 2 * (n_bins - 1)
    time_steps = np.arange(0, D.shape[1], rate)
    # expected phase advance per hop for each bin
    phi_advance = np.linspace(0, np.pi * hop_length, n_bins)
    D_pad = np.concatenate([D, np.zeros((n_bins, 2), dtype=D.dtype)], axis=1)
    out = np.zeros((n_bins, len(time_steps)), dtype=complex)
    phase_acc = np.angle(D_pad[:, 0])
    for t, step in enumerate(time_steps):
        i = int(step)
        frac = step - i
        mag = (1 - frac) * np.abs(D_pad[:, i]) + frac * np.abs(D_pad[:, i + 1])
        out[:, t] = mag * np.exp(1j * phase_acc)
        dphase = (
            np.angle(D_pad[:, i + 1]) - np.angle(D_pad[:, i]) - phi_advance
        )
        dphase = dphase - 2 * np.pi * np.round(dphase / (2 * np.pi))
        phase_acc = phase_acc + phi_advance + dphase
    return out


def time_stretch(y: np.ndarray, rate: float, n_fft: int = 2048,
                 hop_length: int = 512) -> np.ndarray:
    D = stft(y, n_fft, hop_length)
    D2 = phase_vocoder(D, rate, hop_length)
    return istft(D2, n_fft, hop_length,
                 length=int(round(len(y) / rate)))


def pitch_shift(
    y: np.ndarray, sr: int, n_steps: float, prefer_native: bool = True
) -> np.ndarray:
    """Shift pitch by n_steps semitones, preserving duration and length.

    Dispatches to the C++ implementation (``native.py``) when it is built
    (same algorithm, held against this path within 1e-5), else runs this
    numpy path."""
    if n_steps == 0:
        return np.asarray(y, dtype=np.float32)
    if prefer_native:
        from . import native

        if native.available():
            return native.pitch_shift(y, sr, n_steps)
    rate = 2.0 ** (-float(n_steps) / 12.0)
    stretched = time_stretch(np.asarray(y, dtype=np.float64), rate)
    # resample by `rate` back to the original duration
    frac = Fraction(rate).limit_denominator(1000)
    shifted = _resample_rational(
        stretched, frac.denominator, frac.numerator
    )
    if len(shifted) < len(y):
        shifted = np.pad(shifted, (0, len(y) - len(shifted)))
    return shifted[: len(y)].astype(np.float32)
