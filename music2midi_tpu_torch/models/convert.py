"""Weight conversion: HF / PyTorch-Lightning T5 checkpoints <-> the port's
state_dict.

A copy of ``music2midi_tpu/models/convert.py`` (numpy only) that emits the
port's flat ``state_dict`` names (``weights.py``: the JAX tree paths
joined with ``.``) instead of the JAX parameter tree.  It reads a bare
``T5ForConditionalGeneration.state_dict()`` and the reference's Lightning
checkpoint layout (keys prefixed ``model.transformer.``, conditioning
tables under ``model.conditioning.embeds.{i}.weight``).

HF ``nn.Linear`` stores (out, in); the port computes ``x @ W`` with W
(in, out), so every projection is transposed.  HF module paths:
  {stack}.block.{i}.layer.0.SelfAttention.{q,k,v,o}
  decoder.block.{i}.layer.1.EncDecAttention.{q,k,v,o}
  {stack}.block.{i}.layer.{last}.DenseReluDense.{wi_0,wi_1,wo}
  {stack}.block.0.layer.0.SelfAttention.relative_attention_bias
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from .t5 import T5Config

_ATTN = ("q", "k", "v", "o")
_MLP = ("wi_0", "wi_1", "wo")


def _np(t) -> np.ndarray:
    """torch.Tensor | np.ndarray -> float32 numpy."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _layer_paths(cfg: T5Config):
    """(port prefix, HF block, is_decoder) for every layer of both stacks."""
    for stack, n in (("encoder", cfg.num_layers),
                     ("decoder", cfg.num_decoder_layers)):
        for i in range(n):
            yield f"{stack}.layers.{i}", f"{stack}.block.{i}", \
                stack == "decoder"


def _hf_names(cfg: T5Config) -> Dict[str, tuple]:
    """port name -> (HF name, transposed) for every T5 parameter."""
    out = {"shared_embedding": ("shared.weight", False),
           "lm_head": ("lm_head.weight", True)}
    for port, hf, dec in _layer_paths(cfg):
        mlp_layer = 2 if dec else 1
        for w in _ATTN:
            out[f"{port}.self_attn.{w}"] = (
                f"{hf}.layer.0.SelfAttention.{w}.weight", True)
        out[f"{port}.ln1"] = (f"{hf}.layer.0.layer_norm.weight", False)
        if dec:
            for w in _ATTN:
                out[f"{port}.cross_attn.{w}"] = (
                    f"{hf}.layer.1.EncDecAttention.{w}.weight", True)
            out[f"{port}.ln2"] = (f"{hf}.layer.1.layer_norm.weight", False)
        for w in _MLP:
            out[f"{port}.mlp.{w}"] = (
                f"{hf}.layer.{mlp_layer}.DenseReluDense.{w}.weight", True)
        out[f"{port}.ln{mlp_layer + 1}"] = (
            f"{hf}.layer.{mlp_layer}.layer_norm.weight", False)
    for stack in ("encoder", "decoder"):
        out[f"{stack}.rel_bias"] = (
            f"{stack}.block.0.layer.0.SelfAttention"
            ".relative_attention_bias.weight", False)
        out[f"{stack}.final_ln"] = (f"{stack}.final_layer_norm.weight", False)
    return out


def hf_state_dict_to_params(state_dict: Mapping[str, Any],
                            cfg: T5Config) -> Dict[str, np.ndarray]:
    """HF T5ForConditionalGeneration state_dict (optionally under the
    Lightning / reference wrapper prefixes) -> the port's state_dict of
    float32 numpy arrays."""
    sd = dict(state_dict)
    for prefix in ("model.transformer.", "transformer.", "model."):
        if any(k.startswith(prefix + "shared") for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()
                  if k.startswith(prefix)}
            break
    out = {}
    for name, (hf, transposed) in _hf_names(cfg).items():
        w = _np(sd[hf])
        out[name] = np.ascontiguousarray(w.T) if transposed else w
    return out


def reference_checkpoint_to_params(state_dict: Mapping[str, Any],
                                   cfg: T5Config) -> Dict[str, np.ndarray]:
    """A full reference Lightning state_dict -> the port's state_dict with
    the conditioning tables (``conditioning.{i}``), ignoring the mel
    front end's buffers (a fixed torchaudio filterbank)."""
    params = hf_state_dict_to_params(state_dict, cfg)
    i = 0
    while True:
        key = next((k for k in state_dict
                    if k.endswith(f"conditioning.embeds.{i}.weight")), None)
        if key is None:
            break
        params[f"conditioning.{i}"] = _np(state_dict[key])
        i += 1
    return params


def params_to_hf_state_dict(params: Mapping[str, Any],
                            cfg: T5Config) -> Dict[str, np.ndarray]:
    """Inverse mapping: the port's state_dict -> HF names (float32 numpy,
    the embedding also under both stacks' ``embed_tokens``)."""
    out = {}
    for name, (hf, transposed) in _hf_names(cfg).items():
        w = _np(params[name])
        out[hf] = np.ascontiguousarray(w.T) if transposed else w
    out["encoder.embed_tokens.weight"] = out["shared.weight"]
    out["decoder.embed_tokens.weight"] = out["shared.weight"]
    return out
