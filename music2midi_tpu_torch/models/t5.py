"""T5 encoder-decoder in PyTorch, HF-``transformers`` semantics.

Port of ``music2midi_tpu/models/t5.py``: RMSNorm with fp32 variance (cast
before the weight multiply), UNSCALED q.k attention with -1e9 masking,
relative position buckets (bidirectional encoder, causal decoder, one bias
table per stack), gated-GELU ("gelu_new") FFN, untied lm_head.

Parameters live in ``T5Model``, an ``nn.Module`` whose parameter names are
the JAX tree paths joined with ``.`` (see ``weights.py``), kept in the
layout of the JAX package: projections are (in, out) and apply as
``x @ w``.  The forward passes are plain functions over that module and a
``T5Config`` that names the compute dtype, as in the JAX package.

Training (``t5_forward``, ``shift_right``, ``cross_entropy_loss``) runs
the same ``encode`` and ``decoder_forward`` with dropout at the JAX
package's sites: the input embeddings, the attention probabilities, each
residual branch, the MLP hidden layer and each stack's final norm output.
The masks are drawn from an explicit ``torch.Generator`` on the model's
device, so they are held to their distribution and to one seed giving one
mask, not to JAX's random bits.  The forward passes record autograd
graphs when the parameters require grad; the serving callers wrap them in
``torch.no_grad`` (``infer/pipeline.py``, ``infer/decode.py``).

Matmuls follow the JAX package's precision: projections multiply in the
compute dtype (fp32 accumulation, output rounded to the compute dtype);
attention scores and the probability-weighted sums are accumulated and
kept in fp32 (JAX's ``preferred_element_type=float32``), which here means
upcasting the (exact) compute-dtype operands to fp32.

Decoding (``precompute_cross_kv``, ``init_kv_cache``, ``decode_step``)
updates the self-attention KV cache IN PLACE, where the JAX package
returns a new one, at a step held on the device (a 0-d int32 tensor), so
that a step's launches do not depend on its position and a CUDA graph
captures them (``infer/decode.py``).  The plain routes read a prefix of
the cache of static length with the JAX package's causal mask (-1e9 on
keys after ``step``, which underflow to exactly zero probability); the
int8 kernel reads the step and only the keys up to it.  The cross-KV is
not padded to a multiple of 128: that pad is a TPU lane-layout choice,
and the unpadded keys give the same outputs.

Serving options, as in the JAX package: ``prepare_decode_params(
quantize_weights=True)`` stores every decode projection as int8 values
with per-column scales (``_quantize_w``), applied to the f32 product; the
quantized KV caches hold +-127 levels (``bits=8``) or +-7 (``bits=4``).
torch has no 4-bit integer type, so the +-7 levels are stored unpacked in
int8: the same numbers as the JAX package's int4 arrays, and no saving of
bytes.  The width travels with the self cache (``KVCache.bits``), where the
JAX package reads it off the cache's dtype, so that each step's fresh row
is quantized at the cache's own width.

Given an ``Int8AttentionPlan`` over its caches (``int8_attention_plan``;
the JAX package's ``use_pallas`` route), ``decode_step`` sends the int8
attention blocks through the int8 decode-attention kernel of
``ops/decode_attention.py``, with the caches' checks and argument packing
done once a generation instead of on every call; a transposed cross-KV
(``CrossKV.transposed``) always takes the transposed-cross kernel.  Both
run as CUDA kernels on CUDA tensors and as their plain versions on CPU
tensors.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..ops import decode_fused as _df
from ..ops.decode_attention import (
    Int8AttentionPlan,
    decode_attention_cross_t,
    transpose_cross_entry,
)
from ..ops.decode_fused import gelu_new, rms_norm
from ..parallel.mesh import copy_to_tp_region, reduce_from_tp_region


class T5Config(NamedTuple):
    vocab_size: int = 400
    d_model: int = 384
    d_kv: int = 64
    num_heads: int = 8
    d_ff: int = 1152
    num_layers: int = 6
    num_decoder_layers: int = 6
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-6
    pad_token_id: int = 0
    eos_token_id: int = 2
    decoder_start_token_id: int = 1
    dtype: torch.dtype = torch.float32  # compute dtype for matmuls


def t5_config_from(config, dtype=torch.float32) -> T5Config:
    """Build from the shared config tree; keys it does not set keep the HF
    T5Config defaults above."""
    t5 = config.model.t5
    return T5Config(
        vocab_size=int(t5.vocab_size),
        d_model=int(t5.d_model),
        d_ff=int(t5.d_ff),
        num_layers=int(t5.num_layers),
        num_decoder_layers=int(t5.num_decoder_layers),
        relative_attention_num_buckets=int(t5.relative_attention_num_buckets),
        pad_token_id=int(t5.pad_token_id),
        eos_token_id=int(t5.eos_token_id),
        decoder_start_token_id=int(t5.decoder_start_token_id),
        dtype=dtype,
    )


# --------------------------------------------------------------------- #
# parameters                                                             #
# --------------------------------------------------------------------- #


def _p(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


class Attention(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.q, self.k, self.v = _p(d, inner), _p(d, inner), _p(d, inner)
        self.o = _p(inner, d)


class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int):
        super().__init__()
        self.wi_0, self.wi_1, self.wo = _p(d, d_ff), _p(d, d_ff), _p(d_ff, d)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        d = cfg.d_model
        self.self_attn = Attention(d, cfg.num_heads * cfg.d_kv)
        self.ln1 = _p(d)
        self.mlp = MLP(d, cfg.d_ff)
        self.ln2 = _p(d)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        d, inner = cfg.d_model, cfg.num_heads * cfg.d_kv
        self.self_attn = Attention(d, inner)
        self.ln1 = _p(d)
        self.cross_attn = Attention(d, inner)
        self.ln2 = _p(d)
        self.mlp = MLP(d, cfg.d_ff)
        self.ln3 = _p(d)


class Stack(nn.Module):
    def __init__(self, cfg: T5Config, layer_cls, n_layers: int,
                 bias_heads: int):
        super().__init__()
        self.layers = nn.ModuleList(layer_cls(cfg) for _ in range(n_layers))
        self.rel_bias = _p(cfg.relative_attention_num_buckets, bias_heads)
        self.final_ln = _p(cfg.d_model)


class T5Model(nn.Module):
    """The parameter container; names match ``weights.load_npz`` keys.

    Under tensor parallelism (``tp_group``, a process group of tp ranks)
    it holds one rank's shard (``parallel/mesh.py::shard_params``) at the
    rank's local ``cfg`` (``parallel/mesh.py::local_config``: H / tp heads,
    d_ff / tp): the relative-bias tables stay whole, and the forward
    passes read the rank's head columns of them (``bias_table``)."""

    def __init__(self, cfg: T5Config, num_conditioning: Tuple[int, ...] = (6, 3),
                 tp_group=None):
        super().__init__()
        tp = 1 if tp_group is None else dist.get_world_size(tp_group)
        heads = cfg.num_heads * tp
        self.shared_embedding = _p(cfg.vocab_size, cfg.d_model)
        self.encoder = Stack(cfg, EncoderLayer, cfg.num_layers, heads)
        self.decoder = Stack(cfg, DecoderLayer, cfg.num_decoder_layers, heads)
        self.lm_head = _p(cfg.d_model, cfg.vocab_size)
        self.conditioning = nn.ParameterList(
            _p(n, cfg.d_model) for n in num_conditioning
        )
        self.tp_group = tp_group
        self.heads = None if tp_group is None else slice(
            dist.get_rank(tp_group) * cfg.num_heads,
            (dist.get_rank(tp_group) + 1) * cfg.num_heads)

    @classmethod
    def from_state_dict(cls, sd: Dict[str, torch.Tensor], cfg: T5Config,
                        tp_group=None) -> "T5Model":
        """Build around the given tensors (their dtypes are kept: a bf16
        checkpoint stays bf16, as the JAX engine keeps it).  The parameters
        do not require grad (``train/loop.py::trainable_model`` builds
        the trainer's float32 masters that do).  With ``tp_group``, ``sd``
        is a tp rank's shard and ``cfg`` its local config."""
        n_cond = []
        while f"conditioning.{len(n_cond)}" in sd:
            n_cond.append(sd[f"conditioning.{len(n_cond)}"].shape[0])
        with torch.device("meta"):
            model = cls(cfg, tuple(n_cond), tp_group)
        model.load_state_dict(
            {k: nn.Parameter(v, requires_grad=False) for k, v in sd.items()},
            strict=True, assign=True,
        )
        return model


def bias_table(model: T5Model, stack: Stack) -> torch.Tensor:
    """A stack's relative-bias table at the model's heads: (buckets, H),
    or a tp rank's columns of it."""
    if model.heads is None:
        return stack.rel_bias
    return stack.rel_bias[:, model.heads]


def init_params(seed: int, cfg: T5Config,
                num_conditioning: Tuple[int, ...] = (6, 3)) -> Dict[str, np.ndarray]:
    """HF T5 init scheme on host numpy -> flat float32 state_dict arrays.

    For a seed in [0, 2**32) this draws the same numbers as the JAX
    package's ``init_params(seed, ...)`` (same entropy words, same order),
    so both engines can start from identical random weights."""
    if not 0 <= int(seed) < 2 ** 32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    rng = np.random.default_rng([0, int(seed)])
    d, dk, h, dff = cfg.d_model, cfg.d_kv, cfg.num_heads, cfg.d_ff
    inner = h * dk
    out: Dict[str, np.ndarray] = {}

    def normal(key, shape, std):
        out[key] = (rng.normal(size=shape) * std).astype(np.float32)

    def ones(key):
        out[key] = np.ones((d,), np.float32)

    def attn(prefix):
        normal(prefix + ".q", (d, inner), (d * dk) ** -0.5)
        normal(prefix + ".k", (d, inner), d ** -0.5)
        normal(prefix + ".v", (d, inner), d ** -0.5)
        normal(prefix + ".o", (inner, d), inner ** -0.5)

    def mlp(prefix):
        normal(prefix + ".wi_0", (d, dff), d ** -0.5)
        normal(prefix + ".wi_1", (d, dff), d ** -0.5)
        normal(prefix + ".wo", (dff, d), dff ** -0.5)

    normal("shared_embedding", (cfg.vocab_size, d), 1.0)
    for i in range(cfg.num_layers):
        p = f"encoder.layers.{i}"
        attn(p + ".self_attn")
        ones(p + ".ln1")
        mlp(p + ".mlp")
        ones(p + ".ln2")
    normal("encoder.rel_bias", (cfg.relative_attention_num_buckets, h),
           (d * dk) ** -0.5)
    ones("encoder.final_ln")
    for i in range(cfg.num_decoder_layers):
        p = f"decoder.layers.{i}"
        attn(p + ".self_attn")
        ones(p + ".ln1")
        attn(p + ".cross_attn")
        ones(p + ".ln2")
        mlp(p + ".mlp")
        ones(p + ".ln3")
    normal("decoder.rel_bias", (cfg.relative_attention_num_buckets, h),
           (d * dk) ** -0.5)
    ones("decoder.final_ln")
    normal("lm_head", (d, cfg.vocab_size), d ** -0.5)
    for i, n in enumerate(num_conditioning):
        normal(f"conditioning.{i}", (n, d), 1.0)
    return out


# --------------------------------------------------------------------- #
# primitives (T5's ``rms_norm`` and ``gelu_new``: ops/decode_fused.py)    #
# --------------------------------------------------------------------- #


def relative_position_bucket(
    relative_position: torch.Tensor, bidirectional: bool, num_buckets: int,
    max_distance: int,
) -> torch.Tensor:
    """HF T5Attention._relative_position_bucket; relative = key - query."""
    rel = relative_position
    buckets = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        buckets = buckets + (rel > 0).to(rel.dtype) * num_buckets
        rel = rel.abs()
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    rel_f = torch.clamp(rel.float(), min=1.0)  # guard log(0)
    large = max_exact + (
        torch.log(rel_f / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(rel.dtype)
    large = torch.clamp(large, max=num_buckets - 1)
    return buckets + torch.where(is_small, rel, large)


def position_bias(
    rel_bias_table: torch.Tensor,  # (num_buckets, heads)
    query_positions: torch.Tensor,  # (Q,)
    key_positions: torch.Tensor,  # (K,)
    bidirectional: bool, num_buckets: int, max_distance: int,
) -> torch.Tensor:
    """-> (heads, Q, K) additive attention bias."""
    rel = key_positions[None, :] - query_positions[:, None]
    buckets = relative_position_bucket(rel, bidirectional, num_buckets,
                                       max_distance)
    return rel_bias_table[buckets].permute(2, 0, 1)


def _split_heads(x: torch.Tensor, num_heads: int, d_kv: int) -> torch.Tensor:
    """(B, L, H*D) -> (B, H, L, D)"""
    b, l, _ = x.shape
    return x.reshape(b, l, num_heads, d_kv).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, D) -> (B, L, H*D)"""
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def _quantize_w(w: torch.Tensor,
                group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-column int8 weight quantization of (in, out)
    -> (int8 values (in, out), f32 scales (out,)): column amax / 127,
    round half to even, as the JAX package's ``_quantize_w``.  ``group``:
    the tp group of a row-split matrix, whose columns' amax spans every
    rank's rows."""
    w = w.float()
    amax = w.abs().amax(dim=0)
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w / scale), -127.0, 127.0)
    return q.to(torch.int8), scale


def _proj(x: torch.Tensor, w, dtype) -> torch.Tensor:
    """Bias-free linear x (..., in) @ w (in, out) in the compute dtype.

    ``w`` may be an int8 (values, scales) pair from ``_quantize_w``: the
    product is taken in f32 and scaled there, then rounded once to the
    compute dtype, as the JAX package scales its f32 accumulator.  A bf16
    ``torch.matmul`` would round its output before the scale (a second
    rounding); the product of a bf16 (or f32) and an int8 value is exact
    in f32, so an f32 product of the upcast operands is that accumulator up
    to the order of its sums."""
    if isinstance(w, tuple):
        vals, scale = w
        y = torch.matmul(x.to(dtype).float(), vals.float())
        return (y * scale).to(dtype)
    return torch.matmul(x.to(dtype), w.to(dtype))


def _proj_row(x: torch.Tensor, w, dtype, group) -> torch.Tensor:
    """A row-split projection (o, wo) -> its output, replicated over tp:
    ``_proj`` without tp (``group`` None); else the rank's partial
    product in f32 (of the compute-dtype operands, scaled there for an
    int8 pair), summed over tp (``reduce_from_tp_region``) and then
    rounded once to the compute dtype, as one device rounds its f32
    accumulator."""
    if group is None:
        return _proj(x, w, dtype)
    if isinstance(w, tuple):
        vals, scale = w
        y = torch.matmul(x.to(dtype).float(), vals.float()) * scale
    else:
        y = torch.matmul(x.to(dtype).float(), w.to(dtype).float())
    return reduce_from_tp_region(y, group).to(dtype)


class MaskShard(NamedTuple):
    """The dropout source of a sharded training step: each mask is drawn
    from ``generator`` at its full shape (the global batch of ``batch``
    rows, and all heads / the full d_ff at a ``split_dim`` site) and the
    rank keeps its part (rows ``rows``, tp slice ``tp_rank`` of ``tp``),
    so that the step draws one device's masks."""
    generator: torch.Generator
    rows: slice
    batch: int
    tp_rank: int = 0
    tp: int = 1

    def keep(self, shape, split_dim: Optional[int], rate: float,
             device) -> torch.Tensor:
        full = list(shape)
        full[0] = self.batch
        if split_dim is not None:
            full[split_dim] *= self.tp
        u = torch.rand(full, generator=self.generator, device=device)[self.rows]
        if split_dim is not None:
            n = shape[split_dim]
            u = u.narrow(split_dim, self.tp_rank * n, n)
        return u < (1.0 - rate)


def dropout(x: torch.Tensor, rate: float, generator,
            split_dim: Optional[int] = None) -> torch.Tensor:
    """Inverted dropout: each entry kept with probability ``1 - rate``
    (a uniform draw from ``generator`` below it) and scaled by
    ``1 / (1 - rate)`` in x's dtype; the identity when ``generator`` is
    None (deterministic) or ``rate`` is 0.  ``generator`` may be a
    ``MaskShard`` (a sharded step), for which ``split_dim`` names the dim
    that tp splits here (heads, d_ff)."""
    if generator is None or rate == 0.0:
        return x
    if isinstance(generator, MaskShard):
        keep = generator.keep(x.shape, split_dim, rate, x.device)
    else:
        keep = torch.rand(x.shape, generator=generator, device=x.device) \
            < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor],  # broadcastable to (B, H, Q, K)
    mask: Optional[torch.Tensor],  # broadcastable, True = keep
    dtype,
    generator: Optional[torch.Generator] = None,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """T5 attention: scores = q @ k^T (NO 1/sqrt(d)) + bias, fp32 softmax;
    in training, dropout on the probabilities (HF T5's site)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        scores = scores + bias.float()
    if mask is not None:
        scores = torch.where(mask, scores, -1e9)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    probs = dropout(probs, dropout_rate, generator, split_dim=1)
    return torch.matmul(probs.float(), v.float()).to(dtype)


def self_attention_block(p: Attention, x, bias, mask, cfg: T5Config,
                         generator=None, group=None):
    """``group``: the tp group (the rank's heads; None: all heads)."""
    x = copy_to_tp_region(x, group)
    q = _split_heads(_proj(x, p.q, cfg.dtype), cfg.num_heads, cfg.d_kv)
    k = _split_heads(_proj(x, p.k, cfg.dtype), cfg.num_heads, cfg.d_kv)
    v = _split_heads(_proj(x, p.v, cfg.dtype), cfg.num_heads, cfg.d_kv)
    out = attention(q, k, v, bias, mask, cfg.dtype, generator,
                    cfg.dropout_rate)
    return _proj_row(_merge_heads(out), p.o, cfg.dtype, group)


def mlp_block(p: MLP, x, cfg: T5Config, generator=None, group=None):
    """Gated-GELU FFN: wo(dropout(gelu_new(wi_0 x) * (wi_1 x))); with a
    tp ``group``, over the rank's d_ff / tp hidden units."""
    x = copy_to_tp_region(x, group)
    gate = gelu_new(_proj(x, p.wi_0, cfg.dtype))
    lin = _proj(x, p.wi_1, cfg.dtype)
    return _proj_row(dropout(gate * lin, cfg.dropout_rate, generator,
                             split_dim=-1), p.wo, cfg.dtype, group)


# --------------------------------------------------------------------- #
# stacks                                                                 #
# --------------------------------------------------------------------- #


def _train_generator(deterministic: bool, generator, cfg: T5Config):
    """The generator the dropout sites draw from: None when deterministic
    or at rate 0; a training pass with dropout needs one."""
    if deterministic or cfg.dropout_rate == 0.0:
        return None
    if generator is None:
        raise ValueError("dropout needs a torch.Generator "
                         "(or deterministic=True)")
    return generator


def encode(model: T5Model, inputs_embeds: torch.Tensor, cfg: T5Config,
           deterministic: bool = True,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Encoder stack over inputs_embeds (B, L, d_model); with
    ``deterministic=False`` dropout draws from ``generator``."""
    gen = _train_generator(deterministic, generator, cfg)
    rate = cfg.dropout_rate
    enc, tp = model.encoder, model.tp_group
    L = inputs_embeds.shape[1]
    pos = torch.arange(L, device=inputs_embeds.device)
    bias = position_bias(
        bias_table(model, enc), pos, pos, True,
        cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance,
    )[None]
    x = dropout(inputs_embeds.to(cfg.dtype), rate, gen)
    for layer in enc.layers:
        h = rms_norm(x, layer.ln1, cfg.layer_norm_epsilon)
        h = self_attention_block(layer.self_attn, h, bias, None, cfg, gen,
                                 tp)
        x = x + dropout(h, rate, gen)
        h = rms_norm(x, layer.ln2, cfg.layer_norm_epsilon)
        x = x + dropout(mlp_block(layer.mlp, h, cfg, gen, tp), rate, gen)
    return dropout(rms_norm(x, enc.final_ln, cfg.layer_norm_epsilon), rate,
                   gen)


def decoder_forward(
    model: T5Model, decoder_input_ids: torch.Tensor,
    encoder_hidden: torch.Tensor, cfg: T5Config,
    decoder_attention_mask: Optional[torch.Tensor] = None,  # (B, T) 1=keep
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Full-sequence decoder -> logits (B, T, vocab); with
    ``deterministic=False`` dropout draws from ``generator``."""
    gen = _train_generator(deterministic, generator, cfg)
    rate = cfg.dropout_rate
    dec, tp = model.decoder, model.tp_group
    T = decoder_input_ids.shape[1]
    dev = encoder_hidden.device
    x = dropout(model.shared_embedding[decoder_input_ids].to(cfg.dtype),
                rate, gen)
    pos = torch.arange(T, device=dev)
    bias = position_bias(
        bias_table(model, dec), pos, pos, False,
        cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance,
    )[None]
    enc_tp = copy_to_tp_region(encoder_hidden, tp)
    causal = torch.ones((T, T), dtype=torch.bool, device=dev).tril()[None, None]
    if decoder_attention_mask is not None:
        causal = causal & decoder_attention_mask[:, None, None, :].bool()
    for layer in dec.layers:
        h = rms_norm(x, layer.ln1, cfg.layer_norm_epsilon)
        h = self_attention_block(layer.self_attn, h, bias, causal, cfg, gen,
                                 tp)
        x = x + dropout(h, rate, gen)
        h = copy_to_tp_region(rms_norm(x, layer.ln2, cfg.layer_norm_epsilon),
                              tp)
        ca = layer.cross_attn
        q = _split_heads(_proj(h, ca.q, cfg.dtype), cfg.num_heads, cfg.d_kv)
        k = _split_heads(_proj(enc_tp, ca.k, cfg.dtype),
                         cfg.num_heads, cfg.d_kv)
        v = _split_heads(_proj(enc_tp, ca.v, cfg.dtype),
                         cfg.num_heads, cfg.d_kv)
        a = attention(q, k, v, None, None, cfg.dtype, gen, rate)
        x = x + dropout(_proj_row(_merge_heads(a), ca.o, cfg.dtype, tp),
                        rate, gen)
        h = rms_norm(x, layer.ln3, cfg.layer_norm_epsilon)
        x = x + dropout(mlp_block(layer.mlp, h, cfg, gen, tp), rate, gen)
    x = dropout(rms_norm(x, dec.final_ln, cfg.layer_norm_epsilon), rate, gen)
    return _proj(x, model.lm_head, cfg.dtype)


def shift_right(labels: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    """HF T5 _shift_right: prepend decoder_start, drop the last label,
    -100 -> pad."""
    start = torch.full((labels.shape[0], 1), cfg.decoder_start_token_id,
                       dtype=labels.dtype, device=labels.device)
    shifted = torch.cat([start, labels[:, :-1]], dim=1)
    return torch.where(shifted == -100, cfg.pad_token_id, shifted)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       token_count: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Token-mean cross entropy in fp32 with -100 ignored (HF
    CrossEntropyLoss's default).  ``token_count``: the valid tokens the
    sum is divided by (default: these labels'; a dp rank passes the
    global batch's, so that the dp ranks' losses sum to its mean)."""
    valid = labels != -100
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    if token_count is None:
        token_count = valid.sum()
    return (nll * valid).sum() / token_count.clamp(min=1)


def t5_forward(model: T5Model, inputs_embeds: torch.Tensor,
               labels: torch.Tensor, cfg: T5Config,
               deterministic: bool = True,
               generator=None,
               token_count: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward -> (loss, logits), labels padded with -100: the
    encoder, then the decoder on the right-shifted labels (one generator
    draws the encoder's masks, then the decoder's).  ``token_count``:
    ``cross_entropy_loss``'s."""
    enc = encode(model, inputs_embeds, cfg, deterministic, generator)
    logits = decoder_forward(model, shift_right(labels, cfg), enc, cfg,
                             deterministic=deterministic, generator=generator)
    return cross_entropy_loss(logits, labels, token_count), logits


def conditioning_prepend(model: T5Model, features: torch.Tensor,
                         cond_index: torch.Tensor) -> torch.Tensor:
    """(B, L, d) + (B, n_cond) -> (B, n_cond + L, d): one embedding per
    conditioning type in front of the mel frames."""
    embeds = [table[cond_index[:, i]]
              for i, table in enumerate(model.conditioning)]
    stacked = torch.stack(embeds, dim=1).to(features.dtype)
    return torch.cat([stacked, features], dim=1)


# --------------------------------------------------------------------- #
# incremental decoding                                                   #
# --------------------------------------------------------------------- #


_KV_LEVELS = {8: 127.0, 4: 7.0}  # quantized-KV width -> levels


def _quantize_kv(x: torch.Tensor,
                 bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, L, D) -> (int8 values, fp32 scales laid out (B, H, 1, L)):
    symmetric per-position amax / levels, round half to even; +-127 levels
    at ``bits=8``, +-7 at ``bits=4`` (the JAX package's int4 values, kept
    unpacked in int8)."""
    if bits not in _KV_LEVELS:
        raise ValueError(f"_quantize_kv: bits must be 8 or 4, got {bits}")
    return _df.quantize_rows(x, _KV_LEVELS[bits])


def _attention_int8(
    q: torch.Tensor,  # (B, H, 1, D)
    k_entry: Tuple[torch.Tensor, torch.Tensor],  # int8 (B,H,L,D), (B,H,1,L)
    v_entry: Tuple[torch.Tensor, torch.Tensor],
    bias: Optional[torch.Tensor],  # broadcastable to (B, H, 1, L), fp32
    mask: Optional[torch.Tensor],  # broadcastable, True = keep
    dtype,
) -> torch.Tensor:
    """Decode-time attention over int8 K/V with the per-position scales
    folded into the score and probability rows:
    q . (k8_j ks_j) = ks_j (q . k8_j) and sum_j p_j v8_j vs_j =
    sum_j (p_j vs_j) v8_j, so no dequantized K/V tensor is formed.  int8
    values are exact in fp32, so the products match the JAX package's
    compute-dtype operands with fp32 accumulation."""
    k8, k_scale = k_entry
    v8, v_scale = v_entry
    scores = torch.matmul(q.float(), k8.float().transpose(-1, -2))
    scores = scores * k_scale
    if bias is not None:
        scores = scores + bias.float()
    if mask is not None:
        scores = torch.where(mask, scores, -1e9)
    probs = torch.softmax(scores, dim=-1)
    probs = (probs * v_scale).to(dtype)
    return torch.matmul(probs.float(), v8.float()).to(dtype)


class CrossKV(NamedTuple):
    """Per-layer cross-attention (K, V), each a tensor or an int8 pair;
    ``transposed``: int8 values stored (B, H, D, L) for the
    transposed-cross kernel (``transpose_cross_kv``)."""
    layers: list
    enc_len: int
    transposed: bool = False


def transpose_cross_kv(cross_kv: CrossKV) -> CrossKV:
    """An int8 CrossKV with its values stored (B, H, D, L): one copy per
    generation, as the JAX package's ``pallas_cross`` route makes."""
    if not all(isinstance(k, tuple) for k, _ in cross_kv.layers):
        raise ValueError("the transposed cross layout needs an int8 cross-KV")
    return cross_kv._replace(layers=[
        (transpose_cross_entry(k), transpose_cross_entry(v))
        for k, v in cross_kv.layers
    ], transposed=True)


@torch.no_grad()
def precompute_cross_kv(model: T5Model, encoder_hidden: torch.Tensor,
                        cfg: T5Config, quantize: bool = False,
                        bits: int = 8) -> CrossKV:
    """Cross-attention K/V of every decoder layer, computed once per
    generation; ``quantize`` stores int8 values (``bits`` wide: +-127 or
    +-7 levels) with (B, H, 1, L) scales."""
    out = []
    for layer in model.decoder.layers:
        ca = layer.cross_attn
        k = _split_heads(_proj(encoder_hidden, ca.k, cfg.dtype),
                         cfg.num_heads, cfg.d_kv)
        v = _split_heads(_proj(encoder_hidden, ca.v, cfg.dtype),
                         cfg.num_heads, cfg.d_kv)
        if quantize:
            out.append((_quantize_kv(k, bits), _quantize_kv(v, bits)))
        else:
            out.append((k, v))
    return CrossKV(layers=out, enc_len=encoder_hidden.shape[1])


class KVCache(list):
    """The self-attention cache: per layer a (K, V) pair, and ``bits``, the
    width at which its quantized entries hold their values (8: +-127
    levels, 4: +-7, both stored in int8).  ``decode_step`` quantizes each
    step's fresh row at this width; the JAX package reads the width off
    the entries' dtype (int8 or int4), which int8 storage cannot tell."""

    def __init__(self, layers, bits: int = 8):
        super().__init__(layers)
        if bits not in _KV_LEVELS:
            raise ValueError(f"KVCache: bits must be 8 or 4, got {bits}")
        self.bits = bits


def init_kv_cache(batch: int, max_len: int, cfg: T5Config,
                  quantize: bool = False, device=None,
                  bits: int = 8) -> KVCache:
    """Per layer a (K, V) pair of (B, H, max_len, d_kv) buffers, or of int8
    (values, (B, H, 1, max_len) fp32 scales) pairs when ``quantize``, the
    values ``bits`` wide."""
    shape = (batch, cfg.num_heads, max_len, cfg.d_kv)
    sshape = (batch, cfg.num_heads, 1, max_len)

    def one():
        if quantize:
            return (torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.ones(sshape, dtype=torch.float32, device=device))
        return torch.zeros(shape, dtype=cfg.dtype, device=device)

    return KVCache([(one(), one()) for _ in range(cfg.num_decoder_layers)],
                   bits)


def prepare_decode_params(model: T5Model, cfg: T5Config,
                          quantize_weights: bool = False) -> dict:
    """Decode-time weights, built once per generation: projections cast to
    the compute dtype, self-attention q/k/v fused into one (d, 3*H*D)
    matrix and wi_0/wi_1 into one (d, 2*d_ff).  Layer-norm weights keep
    their stored dtype (rms_norm multiplies before its final cast).

    ``quantize_weights`` stores every projection, lm_head included, as an
    int8 (values, per-column scales) pair (``_quantize_w``), quantized from
    the weights as stored (the fused matrices from their concatenation);
    the embedding stays in the compute dtype, as in the JAX package.

    Under tensor parallelism the rank's shards are fused and cast, the
    relative bias is the rank's head columns, and the scales of a
    row-split matrix (o, wo) are those of the whole matrix."""
    dt = cfg.dtype

    def cast(w, group=None):
        return _quantize_w(w, group) if quantize_weights else w.to(dt)

    tp = model.tp_group
    layers = []
    for layer in model.decoder.layers:
        sa, ca, mlp = layer.self_attn, layer.cross_attn, layer.mlp
        layers.append({
            "ln1": layer.ln1, "ln2": layer.ln2, "ln3": layer.ln3,
            "sa_qkv": cast(torch.cat([sa.q, sa.k, sa.v], dim=1)),
            "sa_o": cast(sa.o, tp),
            "ca_q": cast(ca.q),
            "ca_o": cast(ca.o, tp),
            "mlp_wi": cast(torch.cat([mlp.wi_0, mlp.wi_1], dim=1)),
            "mlp_wo": cast(mlp.wo, tp),
        })
    return {
        "embedding": model.shared_embedding.to(dt),
        "rel_bias": bias_table(model, model.decoder),
        "final_ln": model.decoder.final_ln,
        "lm_head": cast(model.lm_head),
        "layers": layers,
    }


def decoder_bias_rows(rel_bias: torch.Tensor, max_len: int,
                      cfg: T5Config) -> torch.Tensor:
    """(H, max_len) causal position-bias row read backwards: the bias of
    query ``step`` over keys ``0..step`` is ``rows[:, max_len-1-step:]``
    (the decoder bias depends only on key - query)."""
    rel = torch.arange(-(max_len - 1), 1, device=rel_bias.device)
    buckets = relative_position_bucket(
        rel, False, cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance,
    )
    return rel_bias[buckets].transpose(0, 1)


def int8_attention_plan(kv_cache: list, cross_kv: CrossKV,
                        bias_rows: torch.Tensor,
                        dtype=torch.bfloat16) -> Int8AttentionPlan:
    """The launch plan of the int8 kernel over one generation's int8 self
    cache and, unless it is transposed (``decode_attention_cross_t``), its
    int8 cross-KV, with ``round_pv`` as the engine serves, for queries of
    the compute ``dtype`` (bf16, or f32: the kernel's f32 instance)."""
    cross = None if cross_kv.transposed else cross_kv.layers
    return Int8AttentionPlan(kv_cache, bias_rows, cross, cross_kv.enc_len,
                             round_pv=True, dtype=dtype)


def _prefix(entry, n: int):
    """The first n cached positions of an entry (a view)."""
    if isinstance(entry, tuple):
        vals, scales = entry
        return vals[:, :, :n], scales[:, :, :, :n]
    return entry[:, :, :n]


def _cache_length(kv_cache: list) -> int:
    entry = kv_cache[0][0]
    return (entry[0] if isinstance(entry, tuple) else entry).shape[2]


@torch.no_grad()
def decode_step(
    dparams: dict,  # prepare_decode_params output
    token: torch.Tensor,  # (B,) current input token
    step,  # position of `token`: a 0-d int32 tensor on the device, or an int
    kv_cache: KVCache,  # init_kv_cache(...)
    cross_kv: CrossKV,
    cfg: T5Config,
    bias_rows: torch.Tensor,  # decoder_bias_rows(...)
    plan: Optional[Int8AttentionPlan] = None,  # int8_attention_plan(...)
    cache_len: Optional[int] = None,
    tp_group=None,  # the model's tp group: caches and dparams a tp shard's
) -> torch.Tensor:
    """One incremental decoder step -> logits (B, vocab).  Writes this
    step's K/V into ``kv_cache`` at ``step`` (quantized at the cache's
    ``bits``) and attends over [0, step].

    ``step`` lives on the device (a host int is written to a device
    scalar first), and nothing in the step reads it back: the cache
    write goes to the position the step holds, the plain attention routes
    read a prefix of static length ``cache_len`` (default: the whole
    cache; it must exceed ``step``) with the keys after the step masked
    to -1e9, which underflows to a probability of exactly 0, and the
    position bias gathered by the step, as the JAX ``decode_step`` reads
    its phase's cache; the int8 kernel reads the step itself.  So the
    step's work is the same launches at every step, and a CUDA graph
    captures it (``infer/decode.py``).

    Routes, as the JAX ``decode_step``: with a ``plan`` (built over these
    caches by ``int8_attention_plan``; JAX's ``use_pallas``) an int8 self
    cache goes through ``plan.causal`` and an int8 cross-KV through
    ``plan.cross``, the int8 kernel; a transposed cross-KV always goes
    through ``decode_attention_cross_t``; otherwise ``_attention_int8``
    (int8) or ``attention``.  The int8 kernel runs with ``round_pv``, so
    it computes ``_attention_int8``'s arithmetic (``p * vs`` rounded to
    the compute dtype: bf16, or f32 where that is a no-op), the JAX
    engine's serving route, in the self blocks of the ``pallas_cross``
    route too, as there; it takes the +-7-level entries of a 4-bit cache
    as it takes the +-127 ones.  The kernels read the cache buffers in
    place, never copies.

    Under tensor parallelism (``tp_group``) ``cfg`` is the rank's local
    config, the caches and ``dparams`` hold its heads and hidden units,
    and the o and wo projections' partial products are summed over tp
    (``_proj_row``): three all-reduces a layer."""
    dt = cfg.dtype
    H, D = cfg.num_heads, cfg.d_kv
    eps = cfg.layer_norm_epsilon
    dev = token.device
    if not isinstance(step, torch.Tensor):
        step = torch.full((), int(step), dtype=torch.int32, device=dev)
    int8_self = isinstance(kv_cache[0][0], tuple)
    if plan is None or not int8_self:
        # the plain routes: keys 0..c-1, those after the step masked, the
        # bias of key j at step s from column L - 1 - s + j of the rows
        c = _cache_length(kv_cache) if cache_len is None else int(cache_len)
        L = bias_rows.shape[1]
        keys = torch.arange(c, device=dev)
        cols = (keys + (L - 1) - step).clamp_(max=L - 1)
        bias_row = bias_rows.index_select(1, cols)[None, :, None, :]
        mask = (keys <= step)[None, None, None, :]
    layers = dparams["layers"]
    # x: the residual stream (B, 1, d_model), updated in place
    x, h = _df.embed_rms_norm(dparams["embedding"], token, layers[0]["ln1"],
                              eps)
    for i, layer in enumerate(layers):
        if i:
            h = _df.add_rms_norm(x, delta, layer["ln1"], eps)
        qkv = _proj(h, layer["sa_qkv"], dt)
        q = _split_heads(qkv[..., :H * D], H, D)
        k_entry, v_entry = kv_cache[i]
        if int8_self:
            k_newq, v_newq = _df.quantize_write_kv(
                qkv, k_entry, v_entry, step, _KV_LEVELS[kv_cache.bits])
        else:
            pos = step.view(1).long()
            for entry, new in zip(kv_cache[i], qkv.chunk(3, dim=-1)[1:]):
                entry.index_copy_(2, pos, _split_heads(new, H, D))
        if int8_self and plan is not None:
            h = plan.causal(i, q, k_newq, v_newq, step)
        elif int8_self:
            h = _attention_int8(q, _prefix(k_entry, c), _prefix(v_entry, c),
                                bias_row, mask, dt)
        else:
            h = attention(q, _prefix(k_entry, c), _prefix(v_entry, c),
                          bias_row, mask, dt)
        h = _df.add_rms_norm(
            x, _proj_row(_merge_heads(h), layer["sa_o"], dt, tp_group),
            layer["ln2"], eps)
        q = _split_heads(_proj(h, layer["ca_q"], dt), H, D)
        ck, cv = cross_kv.layers[i]
        if cross_kv.transposed:
            a = decode_attention_cross_t(q, ck, cv, enc_len=cross_kv.enc_len)
        elif isinstance(ck, tuple) and plan is not None:
            a = plan.cross(i, q)
        elif isinstance(ck, tuple):
            a = _attention_int8(q, ck, cv, None, None, dt)
        else:
            a = attention(q, ck, cv, None, None, dt)
        h = _df.add_rms_norm(
            x, _proj_row(_merge_heads(a), layer["ca_o"], dt, tp_group),
            layer["ln3"], eps)
        delta = _proj_row(_df.gelu_mul(_proj(h, layer["mlp_wi"], dt)),
                          layer["mlp_wo"], dt, tp_group)
    x = _df.add_rms_norm(x, delta, dparams["final_ln"], eps)
    return _proj(x, dparams["lm_head"], dt)[:, 0, :]
