"""Autoregressive decode over a static KV cache.

Port of ``music2midi_tpu/infer/decode.py::generate_tokens``:
decoder_start = 1, ``suppress_tokens`` masked to -inf before the
selection, greedy argmax or temperature / top-k sampling, finished rows
emit PAD, and the loop exits once every row has emitted EOS.

The cache is allocated once at ``max_length`` instead of growing in phases
(64 -> 128 -> ...) as the JAX loop does; each step attends only over the
positions written so far, so the tokens are the same.  The EOS check reads
one boolean back to the host every ``unroll`` steps; rows that are done
keep emitting PAD in between, so greedy tokens do not depend on
``unroll``, and the loop never runs past ``max_length``.

Sampling draws from a ``torch.Generator`` on the decode device, by the
Gumbel-max rule ``jax.random.categorical`` uses.  JAX's random bits cannot
be reproduced, so sampled tokens are held to their distribution and to
one seed giving one sequence, not to JAX's tokens.

``DecodeConfig.pallas_attention`` and ``pallas_cross`` keep the JAX field
names: they route the int8 attention blocks through the decode-attention
kernels (``ops/decode_attention.py``), which run as CUDA kernels on CUDA
tensors and as their plain versions on CPU tensors; the int8 kernel's
calls go through a launch plan built once per generation over the caches
(``models/t5.py::int8_attention_plan``).  The JAX package's conditions of
a TPU backend and a batch multiple of its block do not apply; as there,
``pallas_cross`` is ignored unless the KV is quantized at 8 bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => no top-k filtering
    suppress_tokens: tuple = ()  # token ids masked to -inf before selection
    quantize_kv: bool = False  # quantized self- and cross-KV (serving mode)
    # int8 weight-only quantization of every decode projection
    # (models/t5.py::_quantize_w, per-column scales)
    quantize_weights: bool = False
    # with quantize_kv: every int8 attention block through
    # decode_attention_int8 with round_pv (the CUDA kernel on a CUDA tensor)
    pallas_attention: bool = False
    # with quantize_kv at 8 bits: the cross-KV stored transposed
    # (B, H, D, L) once per generation, and the cross blocks through
    # decode_attention_cross_t
    pallas_cross: bool = False
    unroll: int = 1  # decode steps between two EOS read-backs
    kv_bits: int = 8  # quantized-KV width: 8 (+-127) or 4 (+-7, in int8)


def _select_next(logits: torch.Tensor, dcfg: DecodeConfig,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B, vocab) logits -> (B,) int32 next tokens: suppressed ids to
    -inf, then the argmax (temperature 0), or a draw from
    softmax(logits / temperature) over the top_k largest (all when 0):
    the argmax of the scaled logits plus Gumbel noise from ``generator``.
    Writes into ``logits``."""
    if dcfg.suppress_tokens:
        logits[:, list(dcfg.suppress_tokens)] = -float("inf")
    if dcfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / dcfg.temperature
    if dcfg.top_k > 0:
        kth = torch.topk(scaled, dcfg.top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, -float("inf"), scaled)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_(min=tiny)))
    return torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)


@torch.no_grad()
def generate_tokens(
    model: T5Model,
    encoder_hidden: torch.Tensor,  # (B, L, d_model)
    cfg: T5Config,
    dcfg: DecodeConfig = DecodeConfig(),
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (tokens (B, max_length) int32 starting with decoder_start and
    PAD-filled after EOS, lengths (B,) int32 including start and EOS).

    Greedy when ``dcfg.temperature == 0``, else temperature / top-k
    sampling from ``generator`` (on the decode device; a generator seeded
    0 when None, as the JAX loop takes ``PRNGKey(0)``)."""
    B = encoder_hidden.shape[0]
    dev = encoder_hidden.device
    max_len = dcfg.max_length
    unroll = max(1, int(dcfg.unroll))
    quant = dcfg.quantize_kv
    cross_kv = precompute_cross_kv(model, encoder_hidden, cfg,
                                   quantize=quant, bits=dcfg.kv_bits)
    if dcfg.pallas_cross and quant and dcfg.kv_bits == 8:
        cross_kv = transpose_cross_kv(cross_kv)
    dparams = prepare_decode_params(model, cfg,
                                    quantize_weights=dcfg.quantize_weights)
    bias_rows = decoder_bias_rows(dparams["rel_bias"], max_len, cfg)
    cache = init_kv_cache(B, max_len, cfg, quantize=quant, device=dev,
                          bits=dcfg.kv_bits)
    # the int8 kernel's launch plan: the caches checked and packed once
    plan = int8_attention_plan(cache, cross_kv, bias_rows, cfg.dtype) \
        if dcfg.pallas_attention and quant else None
    if dcfg.temperature != 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    tokens = torch.full((B, max_len), cfg.pad_token_id, dtype=torch.int32,
                        device=dev)
    tokens[:, 0] = cfg.decoder_start_token_id
    token = tokens[:, 0].clone()
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for step in range(max_len - 1):
        logits = decode_step(dparams, token, step, cache, cross_kv, cfg,
                             bias_rows, plan)
        nxt = _select_next(logits, dcfg, generator)
        nxt = torch.where(done, cfg.pad_token_id, nxt)
        done = done | (nxt == cfg.eos_token_id)
        tokens[:, step + 1] = nxt
        token = nxt
        if (step + 1) % unroll == 0 and bool(done.all()):
            break
    eos = tokens == cfg.eos_token_id
    has_eos = eos.any(dim=1)
    first_eos = eos.to(torch.int8).argmax(dim=1).to(torch.int32)
    lengths = torch.where(has_eos, first_eos + 1, max_len).to(torch.int32)
    return tokens, lengths
