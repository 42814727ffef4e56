"""Port weights: the npz loader and the JAX tree -> state_dict carrier."""

from pathlib import Path

import numpy as np
import torch

from music2midi_tpu.models.t5 import T5Config as JaxT5Config
from music2midi_tpu.models.t5 import init_params as jax_init_params
from music2midi_tpu.train.checkpoint import load_params_npz
from music2midi_tpu_torch.models.t5 import T5Config, T5Model, init_params
from music2midi_tpu_torch.weights import (
    load_npz,
    params_from_jax,
    tree_from_state_dict,
)

RECORD = Path(__file__).resolve().parent.parent / "checkpoints" \
    / "model_of_record.npz"


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jax_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_load_npz_is_bit_equal_to_jax_loader():
    """Every leaf of the model of record, bit for bit (bf16 as bf16)."""
    sd, cfg = load_npz(RECORD)
    tree, jcfg = load_params_npz(RECORD)
    assert cfg.to_dict() == jcfg.to_dict()
    ref = params_from_jax(tree)
    assert set(sd) == set(ref) and len(sd) == 146
    for k, t in sd.items():
        assert t.dtype == torch.bfloat16, k
        assert t.shape == ref[k].shape, k
        np.testing.assert_array_equal(_bits(t), _bits(ref[k]), err_msg=k)
    # and against the JAX leaves themselves, not through params_from_jax
    q = tree["decoder"]["layers"][3]["self_attn"]["q"]
    np.testing.assert_array_equal(
        _bits(sd["decoder.layers.3.self_attn.q"]), _jax_bits(q))
    np.testing.assert_array_equal(
        _bits(sd["conditioning.1"]), _jax_bits(tree["conditioning"][1]))


def test_params_from_jax_round_trips_and_loads_into_the_module():
    cfg = T5Config(d_model=32, d_kv=8, num_heads=4, d_ff=48, num_layers=2,
                   num_decoder_layers=2)
    jcfg = JaxT5Config(d_model=32, d_kv=8, num_heads=4, d_ff=48,
                       num_layers=2, num_decoder_layers=2)
    tree = jax_init_params(7, jcfg)
    sd = params_from_jax(tree)
    back = tree_from_state_dict(sd)
    again = params_from_jax(back)
    assert set(again) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(again[k].numpy(), sd[k].numpy())
    model = T5Model.from_state_dict(sd, cfg)
    assert dict(model.named_parameters()).keys() == sd.keys()
    # the port's own init draws the JAX init's numbers (same seed words)
    mine = init_params(7, cfg)
    assert mine.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(mine[k], sd[k].numpy(), err_msg=k)
