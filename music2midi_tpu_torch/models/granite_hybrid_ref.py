"""Plain float32 reference of granite-4.0-h's hybrid decoder behind an
audio prefix.

The forward pass of HF ``transformers``' ``GraniteMoeHybridForCausalLM``
(``model_type`` ``granitemoehybrid``) written from its published layer
equations, with nothing of the program: no kernel, no cache, no batching
trick, every matmul in float32 with TF32 off (``strict_fp32``).  It
imports torch and math alone, so that it holds the program to the model
and not to itself.

Inputs: a prefix (B, Lp, prefix_dim) of audio features and token ids (B,
T).  The prefix goes through a linear projector (with bias) to the hidden
size; the ids through the tied embedding; both are inputs_embeds, which
HF's forward multiplies by ``embedding_multiplier``.  Each layer::

    h = h + residual_multiplier * mixer(rms(h))      # mamba or attention
    h = h + residual_multiplier * (moe(rms(h)) + shared_mlp(rms(h)))

then a final RMSNorm, the tied head, and logits / ``logits_scaling``.

* Mamba-2 mixer: ``in_proj`` -> z (d_inner), xBC (d_inner + 2 G N), dt
  (heads); xBC through a causal depthwise conv of width ``mamba_d_conv``
  plus bias, then SiLU, split into x, B, C; ``dt = softplus(dt +
  dt_bias)``, ``A = -exp(A_log)``; the recurrence ``h_t = exp(dt_t A)
  h_{t-1} + dt_t x_t (x) B_t``, ``y_t = h_t C_t + D x_t``, one position at
  a time from a zero state; ``y = rms_group(y * silu(z)) * w`` (the
  gated RMSNorm, per group of d_inner / G channels); ``out_proj``.
* Attention: GQA without positions (NoPE), no bias, scores scaled by
  ``attention_multiplier``, causal over the prefix and the tokens,
  explicit softmax.
* MoE: router logits, the top ``num_experts_per_tok``, softmax over those
  logits; per expert, a SiLU-gated MLP (``input_linear`` holds the gate
  then the up half) over the tokens routed to it, weighted by their gate
  and summed; beside it one SiLU-gated shared MLP on every token.

Departures from HF, each deliberate:
* The prefix and its projector (an audio-prefix decoder: the model of
  record's tower in front of the language model) are not part of the
  published model.
* Everything is float32, where HF computes in the checkpoint's dtype;
  the router's logits are float32 in both.
* ``dt`` is not clamped: HF's default ``time_step_limit`` is (0, inf),
  which softplus already satisfies.
* No attention or padding mask beyond causality: every prefix position is
  real.

Parameters are a flat dict of float32 tensors under the program's names
(``models/granite_hybrid.py``), linear weights (out, in) as in HF.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


def strict_fp32() -> None:
    """float32 matmuls and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _linear(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w.t()
    return y if b is None else y + b


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def embed(p: Params, cfg: dict, prefix: torch.Tensor,
          ids: torch.Tensor) -> torch.Tensor:
    """(B, Lp, prefix_dim) prefix + (B, T) ids -> (B, Lp + T, hidden)
    inputs_embeds, times ``embedding_multiplier``."""
    x = torch.cat([_linear(prefix.float(), p["projector.weight"],
                           p["projector.bias"]),
                   p["embedding"][ids]], dim=1)
    return x * float(cfg["embedding_multiplier"])


def mamba(lp: Params, cfg: dict, x: torch.Tensor,
          state: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """The Mamba-2 mixer over (B, T, hidden), position by position;
    ``state`` (a list) receives the final SSM state (B, H, P, N)."""
    Bsz, T, _ = x.shape
    H, P = int(cfg["mamba_n_heads"]), int(cfg["mamba_d_head"])
    N, G = int(cfg["mamba_d_state"]), int(cfg["mamba_n_groups"])
    K = int(cfg["mamba_d_conv"])
    inner = H * P
    zxbcdt = _linear(x, lp["in_proj"])
    z = zxbcdt[..., :inner]
    xbc = zxbcdt[..., inner:2 * inner + 2 * G * N]
    dt = zxbcdt[..., 2 * inner + 2 * G * N:]
    # causal depthwise conv: output t reads inputs t - K + 1 .. t
    w, bias = lp["conv_weight"], lp["conv_bias"]  # (C, K), (C,)
    padded = torch.cat([xbc.new_zeros(Bsz, K - 1, xbc.shape[-1]), xbc], 1)
    conv = bias + sum(padded[:, k:k + T] * w[:, k] for k in range(K))
    conv = _silu(conv)
    xs = conv[..., :inner].reshape(Bsz, T, H, P)
    Bm = conv[..., inner:inner + G * N].reshape(Bsz, T, G, N)
    Cm = conv[..., inner + G * N:].reshape(Bsz, T, G, N)
    heads_of = torch.arange(H, device=x.device) // (H // G)
    Bh, Ch = Bm[:, :, heads_of], Cm[:, :, heads_of]  # (B, T, H, N)
    dt = torch.nn.functional.softplus(dt + lp["dt_bias"])  # (B, T, H)
    A = -torch.exp(lp["A_log"])
    h = x.new_zeros(Bsz, H, P, N)
    ys = []
    for t in range(T):
        decay = torch.exp(dt[:, t] * A)[:, :, None, None]
        h = decay * h + (dt[:, t, :, None, None] * xs[:, t, :, :, None]
                         * Bh[:, t, :, None, :])
        ys.append((h * Ch[:, t, :, None, :]).sum(-1)
                  + lp["D"][:, None] * xs[:, t])
    if state is not None:
        state.append(h)
    y = torch.stack(ys, 1).reshape(Bsz, T, inner) * _silu(z)
    yg = y.reshape(Bsz, T, G, inner // G)
    yg = yg * torch.rsqrt(yg.pow(2).mean(-1, keepdim=True)
                          + float(cfg["rms_norm_eps"]))
    y = lp["norm"] * yg.reshape(Bsz, T, inner)
    return _linear(y, lp["out_proj"])


def attention(lp: Params, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """Causal NoPE GQA over (B, T, hidden), explicit softmax."""
    Bsz, T, d = x.shape
    Hq, Hk = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    D = d // Hq
    q = _linear(x, lp["q_proj"]).view(Bsz, T, Hq, D).transpose(1, 2)
    k = _linear(x, lp["k_proj"]).view(Bsz, T, Hk, D).transpose(1, 2)
    v = _linear(x, lp["v_proj"]).view(Bsz, T, Hk, D).transpose(1, 2)
    k = k.repeat_interleave(Hq // Hk, dim=1)  # HF repeat_kv: head j <- j // n
    v = v.repeat_interleave(Hq // Hk, dim=1)
    s = (q @ k.transpose(-1, -2)) * float(cfg["attention_multiplier"])
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, -math.inf)
    a = torch.exp(s - s.max(-1, keepdim=True).values)
    a = a / a.sum(-1, keepdim=True)
    o = (a @ v).transpose(1, 2).reshape(Bsz, T, d)
    return _linear(o, lp["o_proj"])


def moe(lp: Params, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """Routed experts (a loop over experts, each over the tokens routed to
    it) plus the shared MLP, over (B, T, hidden)."""
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    k = int(cfg["num_experts_per_tok"])
    logits = _linear(x, lp["router"])
    top_v, top_i = torch.topk(logits, k, dim=-1)
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
    out = out + _linear(_silu(gate) * up, lp["shared_out"])
    return out.reshape(shape)


def layer(lp: Params, kind: str, cfg: dict, x: torch.Tensor,
          state: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """One decoder layer (``kind`` "mamba" or "attention")."""
    eps, r = float(cfg["rms_norm_eps"]), float(cfg["residual_multiplier"])
    h = _rms(x, lp["input_norm"], eps)
    h = mamba(lp, cfg, h, state) if kind == "mamba" else \
        attention(lp, cfg, h)
    x = x + r * h
    return x + r * moe(lp, cfg, _rms(x, lp["post_norm"], eps))


def layer_params(p: Params, i: int) -> Params:
    """Layer i's parameters, under their names within the layer."""
    pre = f"layers.{i}."
    return {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}


def head(p: Params, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm, tied head, / ``logits_scaling``."""
    x = _rms(x, p["final_norm"], float(cfg["rms_norm_eps"]))
    return (x @ p["embedding"].t()) / float(cfg["logits_scaling"])


@torch.no_grad()
def forward(p: Params, cfg: dict, prefix: torch.Tensor, ids: torch.Tensor,
            states: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Logits (B, T, vocab) at the token positions of prefix + ids: the
    logits at position Lp + t predict token t + 1.  ``states`` (a list)
    receives each mamba layer's final SSM state, in layer order."""
    x = embed(p, cfg, prefix, ids)
    kinds = cfg["layer_types"][:int(cfg["num_hidden_layers"])]
    for i, kind in enumerate(kinds):
        x = layer(layer_params(p, i), kind, cfg, x, states)
    return head(p, cfg, x[:, prefix.shape[1]:])


def state_update(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                 A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One position of the recurrence for a batch of rows: h (B, H, P, N),
    x (B, H, P), dt (B, H) after softplus, A (H,) negative, Bm and Cm (B,
    G, N), D (H,) -> (new h, y (B, H, P))."""
    H, G = h.shape[1], Bm.shape[1]
    heads_of = torch.arange(H, device=h.device) // (H // G)
    Bh, Ch = Bm[:, heads_of], Cm[:, heads_of]
    h = torch.exp(dt * A)[..., None, None] * h \
        + dt[..., None, None] * x[..., None] * Bh[:, :, None, :]
    return h, (h * Ch[:, :, None, :]).sum(-1) + D[:, None] * x
