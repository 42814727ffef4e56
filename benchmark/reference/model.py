"""The plain reference: music2midi's T5 v1.1 and log-mel front end in
float32 PyTorch, written from the published semantics and not from the
program.

* Weights: the npz export read here with numpy (bfloat16 leaves stored as
  their uint16 bit patterns; ``__dtypes__`` names each leaf's type), as
  float32.  Projections are (in, out) matrices applied as ``x @ w``.
* Front end: torchaudio's MelSpectrogram conventions (centre, reflect pad
  n_fft / 2, periodic Hann window, power 2, HTK mel scale with norm None,
  f_max = sr / 2), clamp at 1e-6, natural log.
* Encoder input: one learned vector per conditioning type (genre,
  difficulty) in front of the mel frames.
* T5 v1.1 (HF ``transformers``): RMSNorm without mean, unscaled q.k
  attention with a relative-position bias (one table per stack,
  bidirectional in the encoder, causal in the decoder, HF's bucket
  formula in float32), gated-GELU ("gelu_new") FFN, untied lm_head.
* Dropout (training only): inverted dropout at HF T5's sites in forward
  order, each mask ``torch.rand(shape, generator) < 1 - rate`` drawn from
  the one generator of the step.

Everything runs in float32 with TF32 off (``strict_fp32``).
"""

from __future__ import annotations

import json
import math
from typing import Dict, Optional

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


def strict_fp32() -> None:
    """float32 matmuls without TF32, as the reference's precision is."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def load_params(path, device) -> Params:
    """npz export -> {key: float32 tensor on ``device``}."""
    with np.load(path) as z:
        dtypes = json.loads(bytes(z["__dtypes__"]).decode())
        out = {}
        for key, kind in dtypes.items():
            a = np.asarray(z[key])
            if kind == "bfloat16":
                a = (a.view(np.uint16).astype(np.uint32) << 16).view(
                    np.float32)
            out[key] = torch.from_numpy(np.array(a, np.float32)).to(device)
    return out


# ------------------------------------------------------------------ #
# front end                                                           #
# ------------------------------------------------------------------ #


def _mel_filterbank(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                    sr: int) -> np.ndarray:
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(f_min), hz_to_mel(f_max),
                                  n_mels + 2))
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def log_mel(wave: torch.Tensor, sr: int, n_fft: int, hop: int, f_min: float,
            n_mels: int) -> torch.Tensor:
    """(B, S) float32 -> (B, 1 + S // hop, n_mels) log-mel."""
    pad = n_fft // 2
    x = torch.nn.functional.pad(wave[:, None, :].float(), (pad, pad),
                                mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)
    n = torch.arange(n_fft, dtype=torch.float64, device=wave.device)
    window = (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / n_fft)).float()
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = spec.real.square() + spec.imag.square()
    fb = torch.from_numpy(_mel_filterbank(n_fft // 2 + 1, f_min, sr / 2.0,
                                          n_mels, sr)).to(wave.device)
    return torch.log(torch.clamp(power @ fb, min=1e-6))


# ------------------------------------------------------------------ #
# T5                                                                  #
# ------------------------------------------------------------------ #


class Dropout:
    """HF T5's dropout sites fed from one generator; inactive when
    ``generator`` is None."""

    def __init__(self, rate: float, generator: Optional[torch.Generator]):
        self.rate = rate
        self.generator = generator

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.generator is None or self.rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < (1.0 - self.rate)
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


def _bucket(rel: torch.Tensor, bidirectional: bool, num_buckets: int,
            max_distance: int) -> torch.Tensor:
    """HF ``T5Attention._relative_position_bucket`` (rel = key - query)."""
    out = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        out = out + (rel > 0).long() * num_buckets
        rel = rel.abs()
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = num_buckets // 2
    large = max_exact + (
        torch.log(rel.float().clamp(min=1.0) / max_exact)
        / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).long()
    large = torch.clamp(large, max=num_buckets - 1)
    return out + torch.where(rel < max_exact, rel, large)


def _bias(table: torch.Tensor, q_len: int, k_len: int, bidirectional: bool,
          m: dict) -> torch.Tensor:
    q = torch.arange(q_len, device=table.device)
    k = torch.arange(k_len, device=table.device)
    b = _bucket(k[None, :] - q[:, None], bidirectional,
                m["relative_attention_num_buckets"],
                m["relative_attention_max_distance"])
    return table[b].permute(2, 0, 1)[None]  # (1, H, Q, K)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps))


def _gelu_new(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * torch.pow(x, 3.0))))


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, n, _ = x.shape
    return x.reshape(b, n, h, -1).transpose(1, 2)


def _attend(p: Params, pre: str, x: torch.Tensor, kv: torch.Tensor,
            bias: Optional[torch.Tensor], mask: Optional[torch.Tensor],
            h: int, drop: Dropout) -> torch.Tensor:
    q = _heads(x @ p[pre + "/q"], h)
    k = _heads(kv @ p[pre + "/k"], h)
    v = _heads(kv @ p[pre + "/v"], h)
    scores = q @ k.transpose(-1, -2)
    if bias is not None:
        scores = scores + bias
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = drop(torch.softmax(scores, dim=-1))
    out = (probs @ v).transpose(1, 2).reshape(x.shape[0], x.shape[1], -1)
    return out @ p[pre + "/o"]


def _mlp(p: Params, pre: str, x: torch.Tensor, drop: Dropout) -> torch.Tensor:
    hidden = _gelu_new(x @ p[pre + "/wi_0"]) * (x @ p[pre + "/wi_1"])
    return drop(hidden) @ p[pre + "/wo"]


def encoder_inputs(p: Params, mel: torch.Tensor, cond: torch.Tensor
                   ) -> torch.Tensor:
    """(B, F, d) mel + (B, n_cond) indices -> (B, n_cond + F, d)."""
    vecs = [p[f"conditioning/#{i}"][cond[:, i]] for i in range(cond.shape[1])]
    return torch.cat([torch.stack(vecs, dim=1), mel], dim=1)


def encode(p: Params, m: dict, x: torch.Tensor, drop: Dropout
           ) -> torch.Tensor:
    h, eps = m["num_heads"], m["layer_norm_epsilon"]
    bias = _bias(p["encoder/rel_bias"], x.shape[1], x.shape[1], True, m)
    x = drop(x)
    for i in range(m["num_layers"]):
        pre = f"encoder/layers/#{i}"
        y = _rms(x, p[pre + "/ln1"], eps)
        x = x + drop(_attend(p, pre + "/self_attn", y, y, bias, None, h,
                             drop))
        x = x + drop(_mlp(p, pre + "/mlp", _rms(x, p[pre + "/ln2"], eps),
                          drop))
    return drop(_rms(x, p["encoder/final_ln"], eps))


def decode_logits(p: Params, m: dict, ids: torch.Tensor, enc: torch.Tensor,
                  drop: Dropout) -> torch.Tensor:
    """Teacher-forced decoder over input ids (B, T) -> logits (B, T, V)."""
    h, eps = m["num_heads"], m["layer_norm_epsilon"]
    T = ids.shape[1]
    bias = _bias(p["decoder/rel_bias"], T, T, False, m)
    causal = torch.ones(T, T, dtype=torch.bool, device=ids.device).tril()
    x = drop(p["shared_embedding"][ids])
    for i in range(m["num_decoder_layers"]):
        pre = f"decoder/layers/#{i}"
        y = _rms(x, p[pre + "/ln1"], eps)
        x = x + drop(_attend(p, pre + "/self_attn", y, y, bias, causal, h,
                             drop))
        y = _rms(x, p[pre + "/ln2"], eps)
        x = x + drop(_attend(p, pre + "/cross_attn", y, enc, None, None, h,
                             drop))
        x = x + drop(_mlp(p, pre + "/mlp", _rms(x, p[pre + "/ln3"], eps),
                          drop))
    return drop(_rms(x, p["decoder/final_ln"], eps)) @ p["lm_head"]


def train_loss(p: Params, m: dict, mel_cfg: dict, wave: torch.Tensor,
               cond: torch.Tensor, labels: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """The training loss of a batch: token-mean cross entropy over labels
    != -100, the decoder fed the labels shifted right behind the start
    token (-100 -> pad)."""
    drop = Dropout(m["dropout_rate"], generator)
    with torch.no_grad():
        mel = log_mel(wave, **mel_cfg)
    enc = encode(p, m, encoder_inputs(p, mel, cond), drop)
    start = torch.full_like(labels[:, :1], m["decoder_start_token_id"])
    ids = torch.cat([start, labels[:, :-1]], dim=1)
    ids = torch.where(ids == -100, m["pad_token_id"], ids)
    logits = decode_logits(p, m, ids, enc, drop)
    valid = labels != -100
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, labels, 0)[..., None])
    return (nll[..., 0] * valid).sum() / valid.sum()
