"""Port mel front end: the plain PyTorch version against the JAX package.

The plain version (``ops/mel.py::log_mel_spectrogram``) is what the CUDA
kernel is held against on the card, so it is held here against the JAX
fp32 FFT path, the Pallas FFT kernel in interpret mode (the TPU kernel
the CUDA one replaces) and the torch.stft golden vector, at the bars the
JAX package's own tests use: atol 1e-3 in the log domain against the
kernel (``test_mel_pallas.py``), 5e-4 max / 1e-5 mean against the golden
vector (``test_mel.py``).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from music2midi_tpu.ops.mel import LogMelConfig as JaxLogMelConfig
from music2midi_tpu.ops.mel import log_mel_spectrogram as jax_log_mel
from music2midi_tpu.ops.mel import mel_filterbank as jax_filterbank
from music2midi_tpu.ops.mel_pallas import log_mel_spectrogram_pallas_fft
from music2midi_tpu_torch.ops import mel_cuda
from music2midi_tpu_torch.ops.mel import (
    LogMelConfig,
    log_mel_spectrogram,
    log_mel_spectrogram_fast,
    mel_filterbank,
)

DATA = Path(__file__).resolve().parent / "data"


def _noise(n_samples, rows=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, n_samples)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("n_samples", [48000, 41234])
def test_plain_mel_matches_jax_and_pallas_fft(n_samples):
    w = _noise(n_samples)
    mine = log_mel_spectrogram(torch.from_numpy(w), LogMelConfig()).numpy()
    ref = np.asarray(jax_log_mel(w, JaxLogMelConfig()))
    kern = np.asarray(log_mel_spectrogram_pallas_fft(
        w, JaxLogMelConfig(), interpret=True))
    assert mine.shape == ref.shape == kern.shape
    np.testing.assert_allclose(mine, ref, atol=1e-3)
    np.testing.assert_allclose(mine, kern, atol=1e-3)


def test_plain_mel_matches_torch_stft_golden():
    d = np.load(DATA / "golden_mel_torch.npz")
    mine = log_mel_spectrogram(
        torch.from_numpy(d["waveform"][None]), LogMelConfig())[0].numpy()
    gold = d["log_mel"].astype(np.float32)
    assert mine.shape == gold.shape == (63, 384)
    diff = np.abs(mine - gold)
    assert diff.max() < 5e-4, diff.max()
    assert diff.mean() < 1e-5, diff.mean()


def test_tone_argmax_and_silence_floor():
    cfg = LogMelConfig()
    t = np.arange(48000) / cfg.sample_rate
    wave = np.stack([np.sin(2 * np.pi * 440 * t).astype(np.float32),
                     np.zeros(48000, np.float32)])
    out = log_mel_spectrogram(torch.from_numpy(wave), cfg).numpy()
    ref = np.asarray(jax_log_mel(wave, JaxLogMelConfig()))
    assert np.argmax(out[0].mean(0)) == np.argmax(ref[0].mean(0))
    np.testing.assert_allclose(out[1], np.log(1e-6), atol=1e-4)


def test_filterbank_and_noise_floor_match_jax():
    np.testing.assert_array_equal(
        mel_filterbank(1025, 20.0, 8000.0, 384, 16000),
        jax_filterbank(1025, 20.0, 8000.0, 384, 16000))
    w = np.zeros((1, 16000), np.float32)
    w[0, 8000:] = _noise(8000, rows=1)[0]
    mine = log_mel_spectrogram(
        torch.from_numpy(w), LogMelConfig(noise_floor_sigma=0.003)).numpy()
    ref = np.asarray(jax_log_mel(w, JaxLogMelConfig(noise_floor_sigma=0.003)))
    np.testing.assert_allclose(mine, ref, atol=1e-3)


def test_kernel_shape_guards_raise():
    # the TPU kernel's guard: 128 | hop and 256 | n_fft
    with pytest.raises(ValueError):
        mel_cuda.check_shape(3000, LogMelConfig(hop_length=300))
    with pytest.raises(ValueError):
        mel_cuda.check_shape(3000, LogMelConfig(n_fft=384, hop_length=128))
    # this kernel's own: power-of-two n_fft, wave longer than the pad
    with pytest.raises(ValueError):
        mel_cuda.check_shape(48000, LogMelConfig(n_fft=1536, hop_length=256))
    with pytest.raises(ValueError):
        mel_cuda.check_shape(1024, LogMelConfig())
    mel_cuda.check_shape(48000, LogMelConfig())
    # the wrapper refuses a CPU tensor: it launches the kernel or raises
    with pytest.raises(ValueError):
        mel_cuda.log_mel_spectrogram_cuda(torch.zeros(1, 48000))


def test_serving_dispatch_takes_plain_path_on_cpu():
    w = torch.from_numpy(_noise(48000))
    before = mel_cuda.log_mel_spectrogram_cuda.launches
    fast = log_mel_spectrogram_fast(w, LogMelConfig())
    assert mel_cuda.log_mel_spectrogram_cuda.launches == before
    torch.testing.assert_close(fast, log_mel_spectrogram(w, LogMelConfig()),
                               rtol=0, atol=0)


def test_kernel_tables_cover_each_triangle():
    """The [lo, hi) spans and weights the kernel sums over reproduce the
    dense filterbank exactly (checked on the host)."""
    cfg = LogMelConfig()
    hann, tw, lo, hi, off, wts = mel_cuda._tables(cfg, torch.device("cpu"))
    fb = mel_filterbank(1025, 20.0, 8000.0, 384, 16000)
    dense = np.zeros_like(fb)
    lo, hi, off, wts = lo.numpy(), hi.numpy(), off.numpy(), wts.numpy()
    for m in range(cfg.n_mels):
        dense[lo[m]:hi[m], m] = wts[off[m]:off[m] + hi[m] - lo[m]]
    np.testing.assert_array_equal(dense, fb)
    assert tw.shape == (1024, 2) and hann.shape == (2048,)
    assert mel_cuda.mel_nnz(cfg) == int((fb != 0).sum())
