"""Model-required operations and bytes, from shapes alone.

A frozen copy of the arithmetic the port keeps for its own reports
(``music2midi_tpu_torch/profiling.py``: ``encoder_fwd_flops``,
``decoder_fwd_flops``, ``train_step_flops``, ``decode_flops``;
``chip_smoke.py``: ``attention_bound``), so that the yardstick cannot move
with the program.  FLOPs are the matmul FLOPs the MODEL requires (2 M N K
per dot, causal attention at its triangular cost); padding, lockstep
decode past a row's EOS and recomputation count against utilisation.
Norms, gathers and elementwise work are left out (well under 1 %).

``cfg`` is any object with the T5 sizes as attributes (``d_model``,
``d_kv``, ``num_heads``, ``d_ff``, ``num_layers``, ``num_decoder_layers``,
``vocab_size``); ``sizes`` builds one from a configuration file's
``model`` block.
"""

from __future__ import annotations

from types import SimpleNamespace

#: NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def sizes(model: dict) -> SimpleNamespace:
    """The T5 sizes of a configuration file's ``model`` block."""
    return SimpleNamespace(
        d_model=int(model["d_model"]), d_kv=int(model["d_kv"]),
        num_heads=int(model["num_heads"]), d_ff=int(model["d_ff"]),
        num_layers=int(model["num_layers"]),
        num_decoder_layers=int(model["num_decoder_layers"]),
        vocab_size=int(model["vocab_size"]))


def _attn_proj_flops(cfg, tokens: float) -> float:
    """Q+K+V+O projections for ``tokens`` positions in one block."""
    return 4 * 2.0 * tokens * cfg.d_model * cfg.num_heads * cfg.d_kv


def _ffn_flops(cfg, tokens: float) -> float:
    """Gated-GELU FFN: wi_0, wi_1, wo."""
    return 3 * 2.0 * tokens * cfg.d_model * cfg.d_ff


def encoder_fwd_flops(cfg, batch: int, enc_len: int) -> float:
    """Forward matmul FLOPs of the encoder stack."""
    inner = cfg.num_heads * cfg.d_kv
    per_layer = (_attn_proj_flops(cfg, enc_len)
                 + 2 * 2.0 * enc_len * enc_len * inner
                 + _ffn_flops(cfg, enc_len))
    return batch * cfg.num_layers * per_layer


def decoder_fwd_flops(cfg, batch: int, enc_len: int, dec_len: int) -> float:
    """Teacher-forced decoder forward, with the cross K/V projections over
    the encoder sequence and the untied lm_head; causal self-attention at
    its triangular cost."""
    inner = cfg.num_heads * cfg.d_kv
    causal_pairs = dec_len * (dec_len + 1) / 2.0
    per_layer = (_attn_proj_flops(cfg, dec_len)
                 + 2 * 2.0 * causal_pairs * inner
                 + 2 * 2.0 * dec_len * cfg.d_model * inner
                 + 2 * 2.0 * enc_len * cfg.d_model * inner
                 + 2 * 2.0 * dec_len * enc_len * inner
                 + _ffn_flops(cfg, dec_len))
    lm_head = 2.0 * dec_len * cfg.d_model * cfg.vocab_size
    return batch * (cfg.num_decoder_layers * per_layer + lm_head)


def train_step_flops(cfg, batch: int, enc_len: int, dec_len: int) -> float:
    """One forward and backward step: three times the forward (each
    forward dot spawns two backward dots of its shape)."""
    return 3.0 * (encoder_fwd_flops(cfg, batch, enc_len)
                  + decoder_fwd_flops(cfg, batch, enc_len, dec_len))


def decode_flops(cfg, batch: int, enc_len: int, steps: int) -> float:
    """KV-cached greedy decode of ``steps`` tokens a row: the encoder, the
    cross K/V projections once, and per token the decoder's self-attention
    over the causal prefix, cross-attention over ``enc_len``, FFN and
    lm_head."""
    inner = cfg.num_heads * cfg.d_kv
    nl = cfg.num_decoder_layers
    cross_kv_init = nl * 2 * 2.0 * enc_len * cfg.d_model * inner
    causal_pairs = steps * (steps + 1) / 2.0
    per_layer = (_attn_proj_flops(cfg, steps)
                 + 2 * 2.0 * causal_pairs * inner
                 + 2 * 2.0 * steps * cfg.d_model * inner
                 + 2 * 2.0 * steps * enc_len * inner
                 + _ffn_flops(cfg, steps))
    lm_head = 2.0 * steps * cfg.d_model * cfg.vocab_size
    return (encoder_fwd_flops(cfg, batch, enc_len)
            + batch * (cross_kv_init + nl * per_layer + lm_head))


def attention_bound_s(B: int, H: int, D: int, n: int, causal: bool,
                      q_bytes: int = 2) -> float:
    """Least seconds on the card for one int8 decode-attention call over
    ``n`` visible keys: each input byte read once (n int8 K and V rows
    with their f32 scales, the bias row in the causal case, q of
    ``q_bytes`` an element) and the output (q's type) written once, over
    the HBM rate, against 4 B H n D fp32 operations (q.k and p.v) over the
    fp32 rate; the larger of the two."""
    nbytes = 2 * B * H * n * (D + 4) + 2 * B * H * D * q_bytes
    if causal:
        nbytes += H * n * 4
    return max(nbytes / HBM_BYTES_PER_S,
               4.0 * B * H * n * D / FP32_FLOPS_PER_S)


def decode_attention_bound_s(cfg, width: int, steps: int, enc_len: int,
                             q_bytes: int = 2) -> float:
    """The summed bound of every int8 decode-attention call of one batch
    decoded ``steps`` steps at ``width`` rows: per step and decoder layer
    one self call over the causal prefix (n = step + 1) and one cross call
    over the ``enc_len`` encoder positions."""
    H, D = cfg.num_heads, cfg.d_kv
    cross = attention_bound_s(width, H, D, enc_len, False, q_bytes)
    total = 0.0
    for s in range(steps):
        total += attention_bound_s(width, H, D, s + 1, True, q_bytes) + cross
    return cfg.num_decoder_layers * total
