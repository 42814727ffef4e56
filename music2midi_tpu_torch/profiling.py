"""Analytic model-FLOPs accounting (MFU) and the card's bf16 peak.

A copy of the FLOPs half of ``music2midi_tpu/profiling.py``: the matmul
FLOPs the MODEL requires (2 M N K per dot; causal attention at its true
triangular cost), not the FLOPs the implementation executes.  Padding,
lockstep decode past a row's EOS and recomputation are overheads that
MFU charges against utilization.  Embedding gathers, norms and
elementwise ops are left out (well under 1 % here).

``device_peak_flops`` replaces the JAX package's TPU table with NVIDIA's
dense bf16 tensor-core peaks, looked up by ``torch.cuda.get_device_name``.
The trace helpers of the JAX module (``jax.profiler``) are not copied.
"""

from __future__ import annotations

from typing import Optional

import torch

#: dense bf16 tensor-core FLOP/s by card-name substring, from NVIDIA's
#: H100 data sheets; more specific substrings first (the lookup scans in
#: order).  An H100 SXM5 names itself "NVIDIA H100 80GB HBM3".
PEAK_FLOPS_BF16 = {
    "h100 nvl": 835e12,
    "h100 pcie": 756e12,
    "h100 sxm": 989.4e12,
    "h100 80gb hbm3": 989.4e12,
}


def peak_flops_for_name(name: str) -> Optional[float]:
    """bf16 peak FLOP/s of the card called ``name``, or None when the
    table does not know it."""
    name = name.lower()
    for sub, peak in PEAK_FLOPS_BF16.items():
        if sub in name:
            return peak
    return None


def device_peak_flops(device=None) -> Optional[float]:
    """bf16 peak FLOP/s of ``device`` (default: the current CUDA device),
    or None for a CPU or a card the table does not know."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return peak_flops_for_name(torch.cuda.get_device_name(dev))


def _attn_proj_flops(cfg, tokens: int) -> float:
    """Q+K+V+O projections for `tokens` positions in one attention block."""
    inner = cfg.num_heads * cfg.d_kv
    return 4 * 2.0 * tokens * cfg.d_model * inner


def _ffn_flops(cfg, tokens: int) -> float:
    """Gated-GELU FFN: wi_0, wi_1, wo — three d_model x d_ff matmuls."""
    return 3 * 2.0 * tokens * cfg.d_model * cfg.d_ff


def encoder_fwd_flops(cfg, batch: int, enc_len: int) -> float:
    """Forward matmul FLOPs of the T5 encoder stack (no lm_head)."""
    inner = cfg.num_heads * cfg.d_kv
    per_layer = (
        _attn_proj_flops(cfg, enc_len)
        # scores (L x L) + attn-weighted values: 2 dots of L*L*inner
        + 2 * 2.0 * enc_len * enc_len * inner
        + _ffn_flops(cfg, enc_len)
    )
    return batch * cfg.num_layers * per_layer


def decoder_fwd_flops(cfg, batch: int, enc_len: int, dec_len: int) -> float:
    """Teacher-forced decoder forward (training shape), incl. cross-attn
    K/V projections over the encoder sequence and the untied lm_head.
    Causal self-attention counted at its true triangular cost."""
    inner = cfg.num_heads * cfg.d_kv
    causal_pairs = dec_len * (dec_len + 1) / 2.0
    per_layer = (
        _attn_proj_flops(cfg, dec_len)
        + 2 * 2.0 * causal_pairs * inner  # causal self-attn scores+values
        # cross-attn: Q,O on dec tokens; K,V on enc tokens
        + 2 * 2.0 * dec_len * cfg.d_model * inner
        + 2 * 2.0 * enc_len * cfg.d_model * inner
        + 2 * 2.0 * dec_len * enc_len * inner  # cross scores+values
        + _ffn_flops(cfg, dec_len)
    )
    lm_head = 2.0 * dec_len * cfg.d_model * cfg.vocab_size
    return batch * (cfg.num_decoder_layers * per_layer + lm_head)


def train_step_flops(cfg, batch: int, enc_len: int, dec_len: int) -> float:
    """One fwd+bwd step: the standard 3x-forward matmul approximation
    (each forward dot spawns two same-shape backward dots)."""
    return 3.0 * (
        encoder_fwd_flops(cfg, batch, enc_len)
        + decoder_fwd_flops(cfg, batch, enc_len, dec_len)
    )


def decode_flops(cfg, batch: int, enc_len: int, steps: int) -> float:
    """Model FLOPs for KV-cached greedy decode of `steps` tokens per row:
    encoder forward + one-time cross-K/V projections + per-token decoder
    work (self-attn over the causal prefix, cross-attn over enc_len,
    FFN, lm_head)."""
    inner = cfg.num_heads * cfg.d_kv
    nl = cfg.num_decoder_layers
    cross_kv_init = nl * 2 * 2.0 * enc_len * cfg.d_model * inner
    causal_pairs = steps * (steps + 1) / 2.0
    per_layer = (
        _attn_proj_flops(cfg, steps)
        + 2 * 2.0 * causal_pairs * inner
        + 2 * 2.0 * steps * cfg.d_model * inner  # cross Q,O
        + 2 * 2.0 * steps * enc_len * inner  # cross scores+values
        + _ffn_flops(cfg, steps)
    )
    lm_head = 2.0 * steps * cfg.d_model * cfg.vocab_size
    return (
        encoder_fwd_flops(cfg, batch, enc_len)
        + batch * (cross_kv_init + nl * per_layer + lm_head)
    )
