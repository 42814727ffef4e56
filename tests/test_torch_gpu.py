"""Port tests that need an NVIDIA card: the CUDA kernel against its plain
version, and the serving path through it.  They skip without a card;
on a machine with one (whose Python may lack jax, which
``tests/conftest.py`` imports):
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``."""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from music2midi_tpu_torch.ops import mel_cuda
from music2midi_tpu_torch.ops.mel import LogMelConfig, log_mel_spectrogram

pytestmark = pytest.mark.gpu

RECORD = Path(__file__).resolve().parent.parent / "checkpoints" \
    / "model_of_record.npz"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n_samples", [48000, 41234])
def test_mel_kernel_matches_plain_on_card(card, n_samples):
    """The TPU kernel's bars: noise within 1e-3 in the log domain, silence
    on the log floor within 1e-4, the tone's argmax mel bin equal (a
    tone's near-silent bins sit at fp32 round-off in both versions)."""
    cfg = LogMelConfig()
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(6, n_samples)) * 0.3).astype(np.float32)
    t = np.arange(n_samples) / cfg.sample_rate
    w[1] = np.sin(2 * np.pi * 440 * t)
    w[2] = 0.0
    x = torch.from_numpy(w).to(card)
    got = mel_cuda.log_mel_spectrogram_cuda(x, cfg)
    torch.cuda.synchronize()
    ref = log_mel_spectrogram(x, cfg)
    assert got.shape == ref.shape
    noise = [0, 3, 4, 5]
    assert float((got[noise] - ref[noise]).abs().max()) <= 1e-3
    assert float((got[2] - math.log(1e-6)).abs().max()) <= 1e-4
    assert int(got[1].mean(0).argmax()) == int(ref[1].mean(0).argmax())


def test_serving_path_launches_the_kernel(card):
    from music2midi_tpu_torch.audio import resample
    from music2midi_tpu_torch.calibration import check_midi, render_fixture
    from music2midi_tpu_torch.infer import Music2MIDI

    wav, sr = render_fixture()
    engine = Music2MIDI.from_npz(RECORD, dtype=torch.bfloat16)
    before = mel_cuda.log_mel_spectrogram_cuda.launches
    midi = engine.generate(audio_y=resample(wav, sr, 16000))
    assert mel_cuda.log_mel_spectrogram_cuda.launches > before
    ok, detail = check_midi(midi)
    assert ok, detail
