"""Port pipeline (Music2MIDI) against the JAX engine, song -> notes, CPU.

Bars: in the fp32 parity mode, the notes of ``sample_notes`` are exactly
the JAX engine's on the same weights and waveform (model of record, and
random weights over several chunk batches); the host-tokenizer route
(``device_detokenize=False``) gives the same notes as the device route;
entry points refuse to default to a card that is not there.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music2midi_tpu.config import default_config as jax_default_config
from music2midi_tpu.infer import Music2MIDI as JaxMusic2MIDI
from music2midi_tpu_torch.audio import resample
from music2midi_tpu_torch.calibration import check_midi, render_fixture
from music2midi_tpu_torch.config import default_config
from music2midi_tpu_torch.infer import Music2MIDI
from music2midi_tpu_torch.utils import numpy_to_midi

RECORD = Path(__file__).resolve().parent.parent / "checkpoints" \
    / "model_of_record.npz"


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The suite runs files in parallel workers: two intra-op threads per
    worker cost nothing alone and avoid oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def fixture_16k():
    wav, sr = render_fixture()
    return resample(wav, sr, 16000)


def test_record_notes_equal_jax_fp32(fixture_16k):
    # the fixture's rows end by step 43: a 128-token cap changes no token
    # and spares the JAX side three of its five cache phases to compile
    mine = Music2MIDI.from_npz(RECORD, device="cpu", decode_max_length=128)
    ref = JaxMusic2MIDI.from_npz(RECORD, use_compilation_cache=False,
                                 decode_max_length=128)
    got = mine.sample_notes(fixture_16k)
    want = ref.sample_notes(fixture_16k)
    assert len(got) > 0
    np.testing.assert_array_equal(got, want)
    assert check_midi(numpy_to_midi(got))[0]
    host = Music2MIDI.from_npz(RECORD, device="cpu", decode_max_length=128,
                               device_detokenize=False)
    np.testing.assert_array_equal(host.sample_notes(fixture_16k), got)
    stats = mine.last_decode_stats
    assert stats and stats[0]["batch_width"] == 8 and stats[0]["real_rows"] == 4
    assert stats[0]["steps"] < 127


def test_random_weights_multi_batch_equal_jax_fp32():
    """Ten 3-s chunks at batch size 8: two device batches (8, and 2
    padded to the bucket 8), stitched in token time."""
    small = {"num_layers": 2, "num_decoder_layers": 2, "d_model": 64,
             "d_ff": 96}
    cfg = default_config()
    for k, v in small.items():
        cfg.model.t5[k] = v
    cfg.inference.batch_size = 8
    jcfg = jax_default_config()
    for k, v in small.items():
        jcfg.model.t5[k] = v
    jcfg.inference.batch_size = 8
    rng = np.random.default_rng(5)
    wave = (rng.normal(size=10 * 48000 - 1234) * 0.1).astype(np.float32)
    mine = Music2MIDI.from_random(cfg, seed=2, device="cpu",
                                  decode_max_length=24)
    ref = JaxMusic2MIDI.from_random(jcfg, seed=2, decode_max_length=24,
                                    use_compilation_cache=False)
    np.testing.assert_array_equal(mine.sample_tokens_batched(
        mine._chunk_waveform(wave)), ref.sample_tokens_batched(
        ref._chunk_waveform(wave)))
    np.testing.assert_array_equal(mine.sample_notes(wave),
                                  ref.sample_notes(wave))
    assert [s["real_rows"] for s in mine.last_decode_stats] == [8, 2]


def test_entry_points_need_an_explicit_cpu_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Music2MIDI.from_random(seed=0)
    assert Music2MIDI.from_random(seed=0, device="cpu").device.type == "cpu"


def test_serving_mode_int16_transport_matches_jax():
    eng = Music2MIDI.from_random(seed=0, device="cpu", dtype=torch.bfloat16)
    ref = JaxMusic2MIDI.from_random(seed=0, use_compilation_cache=False,
                                    dtype=jnp.bfloat16)
    rng = np.random.default_rng(9)
    batch = (rng.uniform(-1.2, 1.2, size=(3, 4800))).astype(np.float32)
    np.testing.assert_array_equal(eng._encode_wave(batch.copy()),
                                  ref._encode_wave(batch.copy()))
    assert eng._dcfg().quantize_kv
