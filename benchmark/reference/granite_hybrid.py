"""The plain reference of granite-4.0-h's hybrid decoder behind an audio
prefix: the benchmark's own copy, float32 with TF32 off, importing
nothing of the program.

The forward pass of HF ``transformers``' ``GraniteMoeHybridForCausalLM``
(``model_type`` ``granitemoehybrid``) from its published layer equations:

    h = h + residual_multiplier * mixer(rms(h))      # mamba or attention
    h = h + residual_multiplier * (moe(rms(h)) + shared_mlp(rms(h)))

inputs_embeds (the projected audio prefix, then the token embeddings)
times ``embedding_multiplier``; a final RMSNorm, the tied head, logits
over ``logits_scaling``.  Mamba-2 by its sequential recurrence, one
position at a time from a zero state; causal NoPE GQA attention with an
explicit softmax, scores times ``attention_multiplier``; the MoE as a
loop over experts, each over the tokens routed to it (softmax over the
top-k router logits), beside the shared SiLU-gated MLP.  Departures from
HF: the prefix and its projector (not part of the published model),
float32 throughout, ``dt`` unclamped (HF's default limit is (0, inf)),
no mask beyond causality.

Weights: random from the run's seed, as the configuration states: one
generator per tensor on the device, seeded from the seed and the
tensor's name (``tensor_seed``), drawn in float32 (``draw``), and every
matrix and norm rounded to the served weight dtype (the model's weights
are those bfloat16 numbers); ``A_log``, ``D``, ``dt_bias`` and the conv
stay float32.  ``teacher_forced`` runs the decoder one layer at a time,
drawing each layer's weights when it is reached, so that a float32 pass
over a few rows at the published widths fits on the card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Params = Dict[str, torch.Tensor]
FLOAT32_PARAMS = ("A_log", "D", "dt_bias", "conv_weight", "conv_bias")
INIT_STD = 0.02  # every random matrix's standard deviation ...
EMBEDDING_INIT_STD = 0.002  # ... but the tied embedding's
HEAD_ROWS = 1024  # positions a block of the head's logits


def strict_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------------ #
# weights                                                             #
# ------------------------------------------------------------------ #


def _kinds(cfg: dict) -> List[str]:
    return list(cfg["layer_types"][:int(cfg["num_hidden_layers"])])


def _sizes(cfg: dict):
    H, P = int(cfg["mamba_n_heads"]), int(cfg["mamba_d_head"])
    G, N = int(cfg["mamba_n_groups"]), int(cfg["mamba_d_state"])
    inner = H * P
    return H, P, G, N, inner, inner + 2 * G * N


def layer_shapes(cfg: dict, i: int) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of layer i's parameters (linear weights (out,
    in))."""
    d, E = int(cfg["hidden_size"]), int(cfg["num_local_experts"])
    I, S = int(cfg["intermediate_size"]), int(cfg["shared_intermediate_size"])
    K = int(cfg["mamba_d_conv"])
    H, P, G, N, inner, conv_dim = _sizes(cfg)
    p = f"layers.{i}."
    out = [(p + "input_norm", (d,), "ones"), (p + "post_norm", (d,), "ones")]
    if _kinds(cfg)[i] == "mamba":
        conv = f"uniform {1.0 / math.sqrt(K)!r}"
        out += [(p + "in_proj", (inner + conv_dim + H, d), "normal"),
                (p + "conv_weight", (conv_dim, K), conv),
                (p + "conv_bias", (conv_dim,), conv),
                (p + "dt_bias", (H,), "dt_bias"),
                (p + "A_log", (H,), "A_log"),
                (p + "D", (H,), "ones"),
                (p + "norm", (inner,), "ones"),
                (p + "out_proj", (d, inner), "normal")]
    else:
        kv = int(cfg["num_key_value_heads"]) * (
            d // int(cfg["num_attention_heads"]))
        out += [(p + "q_proj", (d, d), "normal"),
                (p + "k_proj", (kv, d), "normal"),
                (p + "v_proj", (kv, d), "normal"),
                (p + "o_proj", (d, d), "normal")]
    return out + [(p + "router", (E, d), "normal"),
                  (p + "experts_in", (E, 2 * I, d), "normal"),
                  (p + "experts_out", (E, d, I), "normal"),
                  (p + "shared_in", (2 * S, d), "normal"),
                  (p + "shared_out", (d, S), "normal")]


def outer_shapes(cfg: dict) -> List[Tuple[str, tuple, str]]:
    d = int(cfg["hidden_size"])
    return [("embedding", (int(cfg["vocab_size"]), d), "embedding"),
            ("projector.weight", (d, int(cfg["prefix_dim"])), "normal"),
            ("projector.bias", (d,), "zeros"),
            ("final_norm", (d,), "ones")]


def tensor_seed(seed: int, name: str) -> int:
    """The run's seed mixed with the name's 64-bit FNV-1a hash."""
    h = 0xCBF29CE484222325
    for byte in name.encode():
        h = ((h ^ byte) * 0x100000001B3) % (1 << 64)
    return (int(seed) * 0x9E3779B97F4A7C15 + h) % (1 << 63)


def draw(name: str, shape: tuple, init: str, seed: int, device
         ) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(tensor_seed(seed, name))
    if init in ("normal", "embedding"):
        std = EMBEDDING_INIT_STD if init == "embedding" else INIT_STD
        return torch.randn(shape, generator=g, device=device) * std
    if init == "ones":
        return torch.ones(shape, device=device)
    if init == "zeros":
        return torch.zeros(shape, device=device)
    u = torch.rand(shape, generator=g, device=device)
    if init.startswith("uniform "):
        return (2.0 * u - 1.0) * float(init.split()[1])
    if init == "A_log":
        return torch.log(1.0 + 15.0 * u)
    if init == "dt_bias":
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(lo + u * (hi - lo)).clamp(min=1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown init {init!r}")


def weights(shapes, cfg: dict, seed: int, device,
            weight_dtype: torch.dtype) -> Params:
    """float32 tensors holding the served weights."""
    out = {}
    for name, shape, init in shapes:
        t = draw(name, shape, init, seed, device)
        if name.rsplit(".", 1)[-1] not in FLOAT32_PARAMS:
            t = t.to(weight_dtype).float()
        out[name.split(".", 2)[-1] if name.startswith("layers.")
            else name] = t
    return out


# ------------------------------------------------------------------ #
# the forward pass                                                    #
# ------------------------------------------------------------------ #


def _linear(x, w, b=None):
    y = x @ w.t()
    return y if b is None else y + b


def _rms(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _silu(x):
    return x * torch.sigmoid(x)


def _scan_inputs(lp: Params, cfg: dict, x: torch.Tensor) -> tuple:
    """The mixer's input (B, T, d) -> z (B, T, inner), the recurrence's x
    (B, T, H, P), B and C per head (B, T, H, N), dt after softplus (B, T,
    H) and A (H,)."""
    Bsz, T, _ = x.shape
    H, P, G, N, inner, conv_dim = _sizes(cfg)
    K = int(cfg["mamba_d_conv"])
    zxbcdt = _linear(x, lp["in_proj"])
    z = zxbcdt[..., :inner]
    xbc = zxbcdt[..., inner:inner + conv_dim]
    dt = zxbcdt[..., inner + conv_dim:]
    padded = torch.cat([xbc.new_zeros(Bsz, K - 1, conv_dim), xbc], 1)
    conv = lp["conv_bias"] + sum(padded[:, k:k + T] * lp["conv_weight"][:, k]
                                 for k in range(K))
    conv = _silu(conv)
    xs = conv[..., :inner].reshape(Bsz, T, H, P)
    heads_of = torch.arange(H, device=x.device) // (H // G)
    Bh = conv[..., inner:inner + G * N].reshape(Bsz, T, G, N)[:, :, heads_of]
    Ch = conv[..., inner + G * N:].reshape(Bsz, T, G, N)[:, :, heads_of]
    dt = torch.nn.functional.softplus(dt + lp["dt_bias"])
    return z, xs, Bh, Ch, dt, -torch.exp(lp["A_log"])


def mamba(lp: Params, cfg: dict, x: torch.Tensor,
          states: Optional[list] = None) -> torch.Tensor:
    Bsz, T, _ = x.shape
    H, P, G, N, inner, _ = _sizes(cfg)
    z, xs, Bh, Ch, dt, A = _scan_inputs(lp, cfg, x)
    h = x.new_zeros(Bsz, H, P, N)
    ys = []
    for t in range(T):
        h = torch.exp(dt[:, t] * A)[:, :, None, None] * h \
            + dt[:, t, :, None, None] * xs[:, t, :, :, None] \
            * Bh[:, t, :, None, :]
        ys.append((h * Ch[:, t, :, None, :]).sum(-1)
                  + lp["D"][:, None] * xs[:, t])
    if states is not None:
        states.append(h)
    y = torch.stack(ys, 1).reshape(Bsz, T, inner) * _silu(z)
    yg = y.reshape(Bsz, T, G, inner // G)
    yg = yg * torch.rsqrt(yg.pow(2).mean(-1, keepdim=True)
                          + float(cfg["rms_norm_eps"]))
    return _linear(lp["norm"] * yg.reshape(Bsz, T, inner), lp["out_proj"])


def attention(lp: Params, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    Bsz, T, d = x.shape
    Hq, Hk = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    D = d // Hq
    q = _linear(x, lp["q_proj"]).view(Bsz, T, Hq, D).transpose(1, 2)
    k = _linear(x, lp["k_proj"]).view(Bsz, T, Hk, D).transpose(1, 2)
    v = _linear(x, lp["v_proj"]).view(Bsz, T, Hk, D).transpose(1, 2)
    k = k.repeat_interleave(Hq // Hk, dim=1)
    v = v.repeat_interleave(Hq // Hk, dim=1)
    s = (q @ k.transpose(-1, -2)) * float(cfg["attention_multiplier"])
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, -math.inf)
    a = torch.exp(s - s.max(-1, keepdim=True).values)
    a = a / a.sum(-1, keepdim=True)
    return _linear((a @ v).transpose(1, 2).reshape(Bsz, T, d), lp["o_proj"])


def moe(lp: Params, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    top_v, top_i = torch.topk(_linear(x, lp["router"]),
                              int(cfg["num_experts_per_tok"]), dim=-1)
    gates = torch.softmax(top_v, dim=-1)
    out = torch.zeros_like(x)
    for e in range(lp["experts_in"].shape[0]):
        rows, slot = torch.nonzero(top_i == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        gate, up = _linear(x[rows], lp["experts_in"][e]).chunk(2, dim=-1)
        y = _linear(_silu(gate) * up, lp["experts_out"][e])
        out.index_add_(0, rows, y * gates[rows, slot, None])
    gate, up = _linear(x, lp["shared_in"]).chunk(2, dim=-1)
    return (out + _linear(_silu(gate) * up, lp["shared_out"])).reshape(shape)


def layer(lp: Params, kind: str, cfg: dict, x: torch.Tensor,
          states: Optional[list] = None) -> torch.Tensor:
    eps, r = float(cfg["rms_norm_eps"]), float(cfg["residual_multiplier"])
    h = _rms(x, lp["input_norm"], eps)
    h = mamba(lp, cfg, h, states) if kind == "mamba" else \
        attention(lp, cfg, h)
    x = x + r * h
    return x + r * moe(lp, cfg, _rms(x, lp["post_norm"], eps))


def _inputs(outer: Params, cfg: dict, prefix: torch.Tensor,
            ids: torch.Tensor) -> torch.Tensor:
    """The decoder's input embeddings: the projected prefix, then the
    fed ids' embeddings, times ``embedding_multiplier``."""
    x = torch.cat([_linear(prefix.float(), outer["projector.weight"],
                           outer["projector.bias"]),
                   outer["embedding"][ids]], 1)
    return x * float(cfg["embedding_multiplier"])


@torch.no_grad()
def teacher_forced(cfg: dict, seed: int, weight_dtype: torch.dtype,
                   prefix: torch.Tensor, ids: torch.Tensor,
                   served: Sequence[torch.Tensor]
                   ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Prefix (R, Lp, prefix_dim) float32 + the fed ids (R, T) -> (per row
    the gap of the reference's best logit above each served token's, at
    the positions the row served: ``served[r]`` holds its next tokens,
    len <= T; every Mamba layer's final SSM state (R, H, P, N))."""
    strict_fp32()
    dev = prefix.device
    outer = weights(outer_shapes(cfg), cfg, seed, dev, weight_dtype)
    x = _inputs(outer, cfg, prefix, ids)
    states: List[torch.Tensor] = []
    for i, kind in enumerate(_kinds(cfg)):
        lp = weights(layer_shapes(cfg, i), cfg, seed, dev, weight_dtype)
        x = layer(lp, kind, cfg, x, states)
        del lp
    Lp = prefix.shape[1]
    x = _rms(x[:, Lp:], outer["final_norm"], float(cfg["rms_norm_eps"]))
    gaps = []
    for r, want in enumerate(served):
        n = len(want)
        row = []
        for lo in range(0, n, HEAD_ROWS):
            logits = (x[r, lo:min(n, lo + HEAD_ROWS)]
                      @ outer["embedding"].t()) \
                / float(cfg["logits_scaling"])
            got = logits.gather(1, want[lo:lo + HEAD_ROWS, None].to(dev))
            row.append(logits.max(1).values - got[:, 0])
        gaps.append(torch.cat(row))
    return gaps, states


MIXER_INPUTS = ("input_norm", "in_proj", "conv_weight", "conv_bias",
                "dt_bias", "A_log")


@torch.no_grad()
def first_mamba_state(cfg: dict, seed: int, weight_dtype: torch.dtype,
                      prefix: torch.Tensor, ids: torch.Tensor,
                      heads: torch.Tensor, rows_at_once: int = 32
                      ) -> torch.Tensor:
    """Prefix (R, Lp, prefix_dim) float32 + the fed ids (R, T) -> the
    first Mamba layer's final SSM state over ``heads``, (R, len(heads), P,
    N): ``teacher_forced``'s states[0] on those heads, at the cost of that
    layer's mixer input alone (the layers before it run whole), so that
    every row of a batch can be held to it."""
    strict_fp32()
    dev = prefix.device
    first = _kinds(cfg).index("mamba")
    outer = weights([s for s in outer_shapes(cfg) if s[0] != "final_norm"],
                    cfg, seed, dev, weight_dtype)
    before = [weights(layer_shapes(cfg, i), cfg, seed, dev, weight_dtype)
              for i in range(first)]
    lp = weights([s for s in layer_shapes(cfg, first)
                  if s[0].rsplit(".", 1)[-1] in MIXER_INPUTS],
                 cfg, seed, dev, weight_dtype)
    kinds = _kinds(cfg)
    eps = float(cfg["rms_norm_eps"])
    H, P, G, N, inner, _ = _sizes(cfg)
    out = []
    for lo in range(0, prefix.shape[0], rows_at_once):
        x = _inputs(outer, cfg, prefix[lo:lo + rows_at_once],
                    ids[lo:lo + rows_at_once])
        for i, p in enumerate(before):
            x = layer(p, kinds[i], cfg, x)
        _, xs, Bh, Ch, dt, A = _scan_inputs(lp, cfg,
                                            _rms(x, lp["input_norm"], eps))
        xs, Bh, dt, A = xs[:, :, heads], Bh[:, :, heads], dt[:, :, heads], \
            A[heads]
        h = x.new_zeros(x.shape[0], len(heads), P, N)
        for t in range(x.shape[1]):
            h = torch.exp(dt[:, t] * A)[:, :, None, None] * h \
                + dt[:, t, :, None, None] * xs[:, t, :, :, None] \
                * Bh[:, t, :, None, :]
        out.append(h)
    return torch.cat(out)
