"""Port engine attributes against the JAX engine (CPU).

Bars: ``_dcfg`` equal field for field to the JAX engine's over a grid of
settings (the quantized-KV flag against both of JAX's, and
``pallas_attention`` on exactly when the KV is quantized, the port's
route); ``encoder_len`` 190 as JAX's; ``cond_index_from_names`` equal;
``_dither_tile`` bit-equal; the sampling generator of a batch a function
of (``sample_seed``, batch start) alone; fp32 greedy tokens equal to the
JAX engine's with ``input_dither = 0.003`` and with ``mel_noise_floor``
set (small random weights); the Lightning and orbax constructors' errors.
"""

import itertools

import numpy as np
import pytest
import torch

from music2midi_tpu.config import default_config as jax_default_config
from music2midi_tpu.infer import Music2MIDI as JaxMusic2MIDI
from music2midi_tpu.infer import pipeline as jax_pipeline
from music2midi_tpu_torch.config import default_config
from music2midi_tpu_torch.infer import Music2MIDI
from music2midi_tpu_torch.infer import pipeline as port_pipeline

SMALL = {"num_layers": 2, "num_decoder_layers": 2, "d_model": 64,
         "d_ff": 96}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads per parallel test worker (see
    test_torch_pipeline.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _small(cfg):
    for k, v in SMALL.items():
        cfg.model.t5[k] = v
    cfg.inference.batch_size = 8
    return cfg


def _engines(dtype_name="float32", **kw):
    import jax.numpy as jnp

    port = Music2MIDI.from_random(_small(default_config()), seed=4,
                                  device="cpu",
                                  dtype=getattr(torch, dtype_name), **kw)
    ref = JaxMusic2MIDI.from_random(_small(jax_default_config()), seed=4,
                                    use_compilation_cache=False,
                                    dtype=getattr(jnp, dtype_name), **kw)
    return port, ref


GRID = {
    "int8_kv": (None, True, False),
    "kv_bits": (8, 4),
    "int8_weights": (False, True),
    "unroll": (1, 4),
    "temperature": (0.0, 0.7),
    "top_k": (0, 5),
    "suppress_tokens": ((), (2,)),
    "pallas_cross": (False, True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dcfg_equals_jax_field_for_field(dtype):
    port, ref = _engines(dtype, decode_max_length=96)
    n = 0
    for values in itertools.product(*GRID.values()):
        for name, value in zip(GRID, values):
            setattr(port, name, value)
            setattr(ref, name, value)
        got, want = port._dcfg(), ref._dcfg()
        for field in ("max_length", "temperature", "top_k",
                      "suppress_tokens", "quantize_weights", "pallas_cross",
                      "unroll", "kv_bits"):
            assert getattr(got, field) == getattr(want, field), (field, values)
        assert got.quantize_kv == want.quantize_cross_kv \
            == want.quantize_self_kv, values
        assert got.pallas_attention == got.quantize_kv
        n += 1
    assert n == 384


def test_encoder_len_and_cond_names_equal_jax():
    port = Music2MIDI.from_random(seed=0, device="cpu")
    ref = JaxMusic2MIDI.from_random(seed=0, use_compilation_cache=False)
    assert port.encoder_len == ref.encoder_len == 190
    for names in ({}, {"genre": "pop"}, {"difficulty": "advanced"},
                  {"genre": "classical", "difficulty": "intermediate"}):
        assert port.cond_index_from_names(**names) \
            == ref.cond_index_from_names(**names)
    assert port.cond_index_from_names(genre="pop",
                                      difficulty="beginner") == [1, 0]
    with pytest.raises(ValueError, match="unknown genre"):
        port.cond_index_from_names(genre="polka")


@pytest.mark.parametrize("split", [48000, 1000])
def test_dither_tile_bit_equal(split):
    got = port_pipeline._dither_tile(split)
    want = jax_pipeline._dither_tile(split)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_chunking_with_dither_bit_equal():
    port, ref = _engines()
    wave = np.random.default_rng(0).normal(size=70000).astype(np.float32)
    for engine in (port, ref):
        engine.input_dither = 0.003
    got, want = port._chunk_waveform(wave), ref._chunk_waveform(wave)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    port.input_dither = 0.0
    assert not np.array_equal(port._chunk_waveform(wave), got)


def test_sample_rng_per_seed_and_batch():
    port, _ = _engines()
    assert port._sample_rng(0) is None  # greedy
    port.temperature = 1.0

    def draw(seed, start):
        port.sample_seed = seed
        return torch.rand(4, generator=port._sample_rng(start))

    assert torch.equal(draw(3, 0), draw(3, 0))
    assert not torch.equal(draw(3, 0), draw(3, 128))
    assert not torch.equal(draw(3, 0), draw(4, 0))


def _tokens(engine, wave):
    return engine.sample_tokens_batched(engine._chunk_waveform(wave))


@pytest.mark.parametrize("knob", ["input_dither", "mel_noise_floor"])
def test_fp32_tokens_equal_jax_with_dither_and_noise_floor(knob):
    """The knob set to 0.003 on both engines, on a quiet waveform whose
    mel sits near the floor, so that the knob changes the input."""
    port, ref = _engines(decode_max_length=24)
    rng = np.random.default_rng(6)
    wave = np.zeros(16000 * 7, np.float32)
    wave[:16000 * 3] = rng.normal(size=16000 * 3) * 1e-4
    before = _tokens(port, wave)
    for engine in (port, ref):
        setattr(engine, knob, 0.003)
    assert getattr(port, knob) == 0.003
    got, want = _tokens(port, wave), _tokens(ref, wave)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(got, before))
    if knob == "mel_noise_floor":
        assert port.mel_config.noise_floor_sigma == 0.003


def test_orbax_directory_raises(tmp_path):
    # a directory with no checkpoint: JAX restore_params' error
    with pytest.raises(FileNotFoundError, match="no checkpoint under"):
        Music2MIDI.from_orbax(tmp_path, device="cpu")
