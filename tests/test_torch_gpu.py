"""Port tests that need an NVIDIA card: each CUDA kernel against its plain
version at the serving shapes and at ``chip_smoke.py``'s bars, and the
serving path through the kernels.  They skip without a card; on a machine
with one (whose Python may lack jax, which ``tests/conftest.py``
imports): ``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from music2midi_tpu_torch.models.t5 import _quantize_kv, _split_heads
from music2midi_tpu_torch.ops import decode_attention as da
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


@pytest.mark.parametrize("kernel", ["fft", "dft"])
@pytest.mark.parametrize("n_samples", [48000, 41234])
def test_mel_kernel_matches_plain_on_card(card, n_samples, kernel):
    """The TPU kernel's bars: noise within 1e-3 in the log domain, silence
    on the log floor within 1e-4, the tone's argmax mel bin equal (a
    tone's near-silent bins sit at fp32 round-off in both versions)."""
    fn = {"fft": mel_cuda.log_mel_spectrogram_cuda,
          "dft": mel_cuda.log_mel_spectrogram_dft_cuda}[kernel]
    cfg = LogMelConfig()
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(6, n_samples)) * 0.3).astype(np.float32)
    t = np.arange(n_samples) / cfg.sample_rate
    w[1] = np.sin(2 * np.pi * 440 * t)
    w[2] = 0.0
    x = torch.from_numpy(w).to(card)
    before = fn.launches
    got = fn(x, cfg)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = log_mel_spectrogram(x, cfg)
    assert got.shape == ref.shape
    noise = [0, 3, 4, 5]
    assert float((got[noise] - ref[noise]).abs().max()) <= 1e-3
    assert float((got[2] - math.log(1e-6)).abs().max()) <= 1e-4
    assert int(got[1].mean(0).argmax()) == int(ref[1].mean(0).argmax())


def _int8_inputs(card, L, seed):
    """Seeded (64, 8, L, 64) int8 K/V through the port's _quantize_kv, a
    bf16 query, fresh rows and a bias row, on the card."""
    g = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=g).to(card)

    B, H, D = 64, 8, 64
    return (normal(B, H, 1, D).to(torch.bfloat16),
            _quantize_kv(normal(B, H, L, D)), _quantize_kv(normal(B, H, L, D)),
            _quantize_kv(normal(B, H, 1, D)), _quantize_kv(normal(B, H, 1, D)),
            normal(1, H, 1, L))


def _close(got, ref, bar=2e-2):
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    err = float((got.float() - ref.float()).abs().max())
    assert err <= bar, err


@pytest.mark.parametrize("round_pv", [False, True])
@pytest.mark.parametrize("step", [0, 63, 127, 1022])
def test_int8_causal_kernel_matches_plain_on_card(card, step, round_pv):
    """Over the whole 1024-long cache, and over the views the decode loop
    passes (the visible prefix and the bias row's window): 2e-2 on the
    bf16 outputs, with ``p * vs`` in f32 (the TPU kernel's arithmetic) and
    rounded to bf16 (the serving route's)."""
    q, k, v, kn, vn, bias = _int8_inputs(card, 1024, step)
    before = da.decode_attention_int8.launches
    got = da.decode_attention_int8(q, k, v, bias, step, kn, vn, causal=True,
                                   round_pv=round_pv)
    assert da.decode_attention_int8.launches == before + 1
    _close(got, da.decode_attention_int8_plain(q, k, v, bias, step, kn, vn,
                                               causal=True,
                                               round_pv=round_pv))
    n = step + 1
    k_pre = (k[0][:, :, :n], k[1][..., :n])
    v_pre = (v[0][:, :, :n], v[1][..., :n])
    _close(da.decode_attention_int8(q, k_pre, v_pre, bias[0, :, 0, :n],
                                    step, kn, vn, causal=True,
                                    round_pv=round_pv), got, 0.0)


def _cross_inputs(card, L, seed):
    """A bf16 query and int8 cross K/V laid out as ``precompute_cross_kv``
    lays them out: ``_quantize_kv`` of a ``_split_heads`` view of a
    (B, L, H*D) projection, so keys sit H*D bytes apart."""
    g = torch.Generator().manual_seed(seed)
    B, H, D = 64, 8, 64

    def proj():
        x = torch.randn(B, L, H * D, generator=g).to(card, torch.bfloat16)
        return _quantize_kv(_split_heads(x, H, D))

    q = torch.randn(B, H, 1, D, generator=g).to(card, torch.bfloat16)
    return q, proj(), proj()


@pytest.mark.parametrize("round_pv", [False, True])
@pytest.mark.parametrize("enc_len", [190, 150])
def test_int8_cross_and_cross_t_kernels_match_plain_on_card(card, enc_len,
                                                            round_pv):
    """The int8 kernel's cross route with both ``round_pv`` settings, and
    the transposed-cross kernel on the padded layout of
    ``transpose_cross_entry`` (rows of 190 keys 192 bytes apart)."""
    q, k, v = _cross_inputs(card, 190, enc_len)
    assert k[0].stride(2) == 8 * 64
    got = da.decode_attention_int8(q, k, v, None, None, None, None,
                                   causal=False, enc_len=enc_len,
                                   round_pv=round_pv)
    _close(got, da.decode_attention_int8_plain(
        q, k, v, None, None, None, None, causal=False, enc_len=enc_len,
        round_pv=round_pv))
    kt, vt = da.transpose_cross_entry(k), da.transpose_cross_entry(v)
    assert kt[0].shape == (64, 8, 64, 190) and kt[0].stride(2) == 192
    before = da.decode_attention_cross_t.launches
    got_t = da.decode_attention_cross_t(q, kt, vt, enc_len=enc_len)
    assert da.decode_attention_cross_t.launches == before + 1
    _close(got_t, da.decode_attention_cross_t_plain(q, kt, vt,
                                                    enc_len=enc_len))
    # keys >= enc_len are masked whatever the pad bytes hold
    for t in (kt[0], vt[0]):
        torch.as_strided(t, (64, 8, 64, 192), t.stride())[..., 190:] = 127
    _close(da.decode_attention_cross_t(q, kt, vt, enc_len=enc_len), got_t,
           0.0)


@pytest.mark.parametrize("pallas_cross", [False, True])
def test_serving_path_launches_the_kernel(card, pallas_cross):
    from music2midi_tpu_torch.audio import resample
    from music2midi_tpu_torch.calibration import check_midi, render_fixture
    from music2midi_tpu_torch.infer import Music2MIDI

    wav, sr = render_fixture()
    engine = Music2MIDI.from_npz(RECORD, dtype=torch.bfloat16)
    engine.pallas_cross = pallas_cross
    counters = (mel_cuda.log_mel_spectrogram_cuda,
                da.decode_attention_int8, da.decode_attention_cross_t)
    before = [f.launches for f in counters]
    midi = engine.generate(audio_y=resample(wav, sr, 16000))
    mel, int8, cross_t = (f.launches - b for f, b in zip(counters, before))
    steps = engine.last_decode_stats[0]["steps"]
    assert mel == 1
    # 6 self blocks per step, and 6 cross blocks in one kernel or the other
    assert int8 == (6 if pallas_cross else 12) * steps
    assert cross_t == (6 * steps if pallas_cross else 0)
    ok, detail = check_midi(midi)
    assert ok, detail
