"""Port direct-DFT log-mel wrapper against the JAX package (CPU).

``ops/mel_cuda.py::log_mel_spectrogram_dft_cuda`` launches the kernel of
``csrc/mel_dft.cu`` on a CUDA tensor (held against the plain version on
the card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``) and runs
the plain version on a CPU tensor.  Here its CPU route is held against the
TPU kernel it replaces, ``log_mel_spectrogram_pallas`` in interpret mode,
at the bars of the JAX package's own tests (``test_mel_pallas.py``): atol
2e-2 on noise, silence on log(1e-6) within 1e-4, the tone's argmax equal;
and its shape guard raises as the TPU kernel's does, before any CUDA
call.
"""

import numpy as np
import pytest
import torch

from music2midi_tpu.ops.mel import LogMelConfig as JaxLogMelConfig
from music2midi_tpu.ops.mel_pallas import log_mel_spectrogram_pallas
from music2midi_tpu_torch.ops import mel_cuda
from music2midi_tpu_torch.ops.mel import LogMelConfig


@pytest.mark.parametrize("n_samples", [48000, 41234])
def test_dft_mel_matches_jax_pallas_dft(n_samples):
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(1, n_samples)) * 0.3).astype(np.float32)
    want = np.asarray(log_mel_spectrogram_pallas(w, JaxLogMelConfig(),
                                                 interpret=True))
    before = mel_cuda.log_mel_spectrogram_dft_cuda.launches
    got = mel_cuda.log_mel_spectrogram_dft_cuda(torch.from_numpy(w),
                                                LogMelConfig()).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-2)
    assert mel_cuda.log_mel_spectrogram_dft_cuda.launches == before


def test_dft_mel_tone_and_silence():
    cfg = LogMelConfig()
    t = np.arange(48000) / cfg.sample_rate
    wave = np.stack([np.sin(2 * np.pi * 440 * t).astype(np.float32),
                     np.zeros(48000, np.float32)])
    want = np.asarray(log_mel_spectrogram_pallas(wave, JaxLogMelConfig(),
                                                 interpret=True))
    got = mel_cuda.log_mel_spectrogram_dft_cuda(torch.from_numpy(wave),
                                                cfg).numpy()
    assert np.argmax(got[0].mean(0)) == np.argmax(want[0].mean(0))
    np.testing.assert_allclose(got[1], np.log(1e-6), atol=1e-4)


@pytest.mark.parametrize("cfg, n_samples, match", [
    (LogMelConfig(n_fft=2048, hop_length=300), 3000, "hop"),
    (LogMelConfig(n_fft=4096, hop_length=256), 9000, "power-of-two"),
    (LogMelConfig(), 1000, "reflect pad"),
])
def test_dft_mel_guard_raises_before_any_cuda_call(cfg, n_samples, match):
    with pytest.raises(ValueError, match=match):
        mel_cuda.log_mel_spectrogram_dft_cuda(
            torch.zeros(1, n_samples), cfg)
