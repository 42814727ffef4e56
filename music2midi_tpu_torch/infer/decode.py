"""Greedy autoregressive decode over a static KV cache.

Port of ``music2midi_tpu/infer/decode.py::generate_tokens`` for the
greedy path: decoder_start = 1, ``suppress_tokens`` masked to -inf before
the argmax, finished rows emit PAD, and the loop exits as soon as every
row has emitted EOS.  Temperature / top-k sampling is not ported yet.

The cache is allocated once at ``max_length`` instead of growing in phases
(64 -> 128 -> ...) as the JAX loop does; each step attends only over the
positions written so far, so the greedy tokens are the same.  The EOS
check reads one boolean back to the host every step.

``DecodeConfig.pallas_attention`` and ``pallas_cross`` keep the JAX field
names: they route the int8 attention blocks through the decode-attention
kernels (``ops/decode_attention.py``), which run as CUDA kernels on CUDA
tensors and as their plain versions on CPU tensors; the int8 kernel's
calls go through a launch plan built once per generation over the caches
(``models/t5.py::int8_attention_plan``).  The JAX package's
conditions of a TPU backend and a batch multiple of its block do not
apply.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..models.t5 import (
    T5Config,
    T5Model,
    decode_step,
    decoder_bias_rows,
    init_kv_cache,
    int8_attention_plan,
    precompute_cross_kv,
    prepare_decode_params,
    transpose_cross_kv,
)


class DecodeConfig(NamedTuple):
    max_length: int = 1024  # total length including the start token
    suppress_tokens: tuple = ()  # token ids masked to -inf before argmax
    quantize_kv: bool = False  # int8 self- and cross-KV (serving mode)
    # with quantize_kv: every int8 attention block through
    # decode_attention_int8 with round_pv (the CUDA kernel on a CUDA tensor)
    pallas_attention: bool = False
    # with quantize_kv: the cross-KV stored transposed (B, H, D, L) once
    # per generation, and the cross blocks through decode_attention_cross_t
    pallas_cross: bool = False


@torch.no_grad()
def generate_tokens(
    model: T5Model,
    encoder_hidden: torch.Tensor,  # (B, L, d_model)
    cfg: T5Config,
    dcfg: DecodeConfig = DecodeConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (tokens (B, max_length) int32 starting with decoder_start and
    PAD-filled after EOS, lengths (B,) int32 including start and EOS)."""
    B = encoder_hidden.shape[0]
    dev = encoder_hidden.device
    max_len = dcfg.max_length
    cross_kv = precompute_cross_kv(model, encoder_hidden, cfg,
                                   quantize=dcfg.quantize_kv)
    if dcfg.pallas_cross and dcfg.quantize_kv:
        cross_kv = transpose_cross_kv(cross_kv)
    dparams = prepare_decode_params(model, cfg)
    bias_rows = decoder_bias_rows(dparams["rel_bias"], max_len, cfg)
    cache = init_kv_cache(B, max_len, cfg, quantize=dcfg.quantize_kv,
                          device=dev)
    # the int8 kernel's launch plan: the caches checked and packed once
    plan = int8_attention_plan(cache, cross_kv, bias_rows) \
        if dcfg.pallas_attention and dcfg.quantize_kv else None
    suppress = list(dcfg.suppress_tokens)

    tokens = torch.full((B, max_len), cfg.pad_token_id, dtype=torch.int32,
                        device=dev)
    tokens[:, 0] = cfg.decoder_start_token_id
    token = tokens[:, 0].clone()
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for step in range(max_len - 1):
        logits = decode_step(dparams, token, step, cache, cross_kv, cfg,
                             bias_rows, plan)
        if suppress:
            logits[:, suppress] = -float("inf")
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(done, cfg.pad_token_id, nxt)
        done = done | (nxt == cfg.eos_token_id)
        tokens[:, step + 1] = nxt
        token = nxt
        if bool(done.all()):
            break
    eos = tokens == cfg.eos_token_id
    has_eos = eos.any(dim=1)
    first_eos = eos.to(torch.int8).argmax(dim=1).to(torch.int32)
    lengths = torch.where(has_eos, first_eos + 1, max_len).to(torch.int32)
    return tokens, lengths
