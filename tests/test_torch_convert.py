"""Port checkpoint conversion and ``Music2MIDI.from_torch_checkpoint``
against the JAX package (CPU).

A Lightning-schema ``.ckpt`` is built in the test from the weights of an
HF ``T5ForConditionalGeneration`` (2 + 2 layers, d_model 64, seeded) and
conditioning tables, under the key layout ``tests/test_lightning_ckpt.py``
gives it (``model.transformer.*``, ``model.conditioning.embeds.{i}``, the
mel front end's buffers).  Bars: the port's parameters equal the JAX
converter's bit for bit (through the converter and through the engine);
``params_to_hf_state_dict`` inverts the conversion exactly; fp32 greedy
tokens of the two engines loaded from the ``.ckpt`` equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from transformers import T5Config as HFT5Config  # noqa: E402
from transformers import T5ForConditionalGeneration  # noqa: E402

from music2midi_tpu.config import default_config as jax_default_config  # noqa: E402
from music2midi_tpu.infer import Music2MIDI as JaxMusic2MIDI  # noqa: E402
from music2midi_tpu.models import convert as jconvert  # noqa: E402
from music2midi_tpu.models import t5 as jt5  # noqa: E402
from music2midi_tpu_torch.config import default_config  # noqa: E402
from music2midi_tpu_torch.infer import Music2MIDI  # noqa: E402
from music2midi_tpu_torch.models import convert as pconvert  # noqa: E402
from music2midi_tpu_torch.models import t5 as pt5  # noqa: E402
from music2midi_tpu_torch.weights import params_from_jax  # noqa: E402

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


@pytest.fixture(scope="module")
def lightning_ckpt(tmp_path_factory):
    """HF T5 + conditioning tables, saved in the Lightning checkpoint
    schema of the reference's training run."""
    cfg = _small(default_config())
    torch.manual_seed(0)
    model = T5ForConditionalGeneration(HFT5Config(**cfg.model.t5.to_dict()))
    cond = [torch.nn.Embedding(len(v), int(cfg.model.t5.d_model))
            for v in cfg.conditioning.values()]
    state_dict = {f"model.transformer.{k}": v
                  for k, v in model.state_dict().items()}
    for i, emb in enumerate(cond):
        state_dict[f"model.conditioning.embeds.{i}.weight"] = emb.weight.data
    n_fft = int(cfg.spectrogram.n_fft)
    state_dict["model.spectrogram.melspectrogram.spectrogram.window"] = \
        torch.hann_window(n_fft, periodic=True)
    state_dict["model.spectrogram.melspectrogram.mel_scale.fb"] = \
        torch.zeros(n_fft // 2 + 1, int(cfg.model.t5.d_model))
    blob = {"epoch": 0, "global_step": 0,
            "pytorch-lightning_version": "2.2.4", "state_dict": state_dict,
            "loops": {}, "callbacks": {}, "optimizer_states": [],
            "lr_schedulers": [], "hparams_name": "kwargs",
            "hyper_parameters": {"config_path": "config.yaml"}}
    path = tmp_path_factory.mktemp("ckpt") / "epoch=0-step=0.ckpt"
    torch.save(blob, path)
    return path, model, state_dict


def _assert_same(port: dict, ref: dict):
    assert sorted(port) == sorted(ref)
    for k in port:
        a = np.asarray(port[k])
        b = np.asarray(ref[k])
        assert a.dtype == b.dtype == np.float32, k
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=k)


def test_converter_equals_jax_bit_for_bit(lightning_ckpt):
    _, _, sd = lightning_ckpt
    pcfg = pt5.t5_config_from(_small(default_config()))
    jcfg = jt5.t5_config_from(_small(jax_default_config()))
    port = pconvert.reference_checkpoint_to_params(sd, pcfg)
    ref = params_from_jax(jconvert.reference_checkpoint_to_params(sd, jcfg))
    _assert_same(port, {k: v.numpy() for k, v in ref.items()})
    assert "conditioning.1" in port and "conditioning.2" not in port
    # a bare HF state_dict (no wrapper prefix, no conditioning)
    bare = pconvert.hf_state_dict_to_params(
        {k[len("model.transformer."):]: v for k, v in sd.items()
         if k.startswith("model.transformer.")}, pcfg)
    _assert_same(bare, {k: v for k, v in port.items()
                        if not k.startswith("conditioning")})


def test_hf_round_trip(lightning_ckpt):
    _, model, sd = lightning_ckpt
    pcfg = pt5.t5_config_from(_small(default_config()))
    port = pconvert.reference_checkpoint_to_params(sd, pcfg)
    back = pconvert.params_to_hf_state_dict(port, pcfg)
    hf = {k: v.numpy() for k, v in model.state_dict().items()}
    assert set(back) <= set(hf)
    for k, v in back.items():
        np.testing.assert_array_equal(v, hf[k], err_msg=k)
    jcfg = jt5.t5_config_from(_small(jax_default_config()))
    jback = jconvert.params_to_hf_state_dict(
        jconvert.reference_checkpoint_to_params(sd, jcfg), jcfg)
    assert sorted(jback) == sorted(back)


def test_engines_from_ckpt_equal_params_and_fp32_tokens(lightning_ckpt):
    path, _, _ = lightning_ckpt
    port = Music2MIDI.from_torch_checkpoint(path, _small(default_config()),
                                            device="cpu",
                                            decode_max_length=48)
    ref = JaxMusic2MIDI.from_torch_checkpoint(
        path, _small(jax_default_config()), use_compilation_cache=False,
        decode_max_length=48)
    _assert_same({k: v.numpy() for k, v in port.model.state_dict().items()},
                 {k: v.numpy() for k, v in params_from_jax(ref.params).items()})
    sr = 16000
    t = np.arange(3 * sr) / sr
    chunks = np.stack([
        (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32),
        (0.3 * np.sin(2 * np.pi * 262 * t)
         + 0.3 * np.sin(2 * np.pi * 330 * t)).astype(np.float32),
    ])
    got = port.sample_tokens_batched(chunks, cond_index=[1, 2])
    want = ref.sample_tokens_batched(chunks, cond_index=[1, 2])
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert jnp.asarray(want[0]).shape[0] > 1
