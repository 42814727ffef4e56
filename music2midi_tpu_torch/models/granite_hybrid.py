"""granite-4.0-h's hybrid decoder (HF ``GraniteMoeHybrid``) as an
audio-prefix decoder behind the model of record's tower.

The tower (mel, T5 encoder, conditioning prepend) gives a (B, Lp, 384)
prefix; a linear projector (with bias) maps it to the hidden size, and the
decoder emits MIDI event ids greedily after it.  The layer equations are
those of the plain reference (``models/granite_hybrid_ref.py``, which says
where they come from): Mamba-2 mixers and NoPE GQA attention layers in the
configuration's ``layer_types`` order, each followed by a top-k MoE beside
a shared SiLU-gated MLP, with Granite's multipliers (inputs_embeds times
``embedding_multiplier``, both residual branches times
``residual_multiplier``, logits over ``logits_scaling``, attention scores
times ``attention_multiplier``) and a tied embedding and head.

Every layer is written twice:

* ``prefill`` over the prefix, once a generation: the Mamba layers by the
  chunked SSD form (chunks of ``mamba_chunk_size`` positions: within a
  chunk the quadratic form, between chunks the carried state), the
  attention layers causally; it leaves each Mamba layer's SSM state and
  conv tail, and each attention layer's K and V, in the decode state.
* ``decode_step``, one token a row at a device-held position: the conv
  tail, the SSM state (kernel 6, ``ops/ssm_state_update.py``) and the KV
  cache updated in place, so that the step's launches do not depend on
  its position and the decode loop captures it (``infer/decode.py``).

The MoE routes each token to its top ``num_experts_per_tok`` of
``num_local_experts`` experts (softmax over the chosen router logits, in
float32) and computes only the routed (token, expert) pairs: the pairs
are sorted by expert, each expert's rows go through its gate/up and down
matrices as one grouped product over device-side offsets
(``torch._grouped_mm`` on a card, a loop over the experts on the CPU),
and each token's outputs are put back in its own order and summed by its
gates.  Shapes are static (rows x top-k pairs), nothing is dropped and
nothing is read back, so the routing runs inside a CUDA graph.  With
``counters``, ``decode_step`` adds each MoE layer's routed tokens per
expert and its busiest expert's count to two device tensors.

Precision (the configuration's): weights and matmuls in ``dtype``
(bfloat16 serving, float32 for the CPU tests), the SSM state and conv
tail in ``state_dtype`` (float32; bfloat16 is the benchmark's control),
the scan, softplus, conv and gated norm in float32, router logits in
float32, attention scores in ``dtype`` with a float32 softmax.

Weights are random from a seed (``init_params``): one generator per
tensor, seeded from the seed and the tensor's name, so a tensor is drawn
alone and the same anywhere; the Mamba-2 convention (state-spaces/mamba
``Mamba2``): ``A ~ U[1, 16]`` as ``A_log``, dt log-uniform in [0.001,
0.1] floored at 1e-4 into ``dt_bias`` by inverse softplus, ``D = 1``, the
conv as PyTorch's Conv1d default (U(-1/sqrt(K), 1/sqrt(K)), K the conv
width), norms 1, the projector's bias 0, every matrix N(0, 0.02) but
the tied embedding, N(0, 0.002): at 0.02 the input token's own
embedding, times ``embedding_multiplier``, outweighs the rest of the tied
head's logit by ~11 of their standard deviations, and every step repeats
its input (one token over 128 rows x 1,023 steps on the card); at 0.002
the input's pull is ~1 deviation, and the rows' tokens and routes spread
(all 72 experts hit a layer step).  Matrices and norms are rounded to the
weight dtype as drawn.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.ssm_state_update import ssm_state_update

#: parameters kept in float32 whatever the weight dtype
FLOAT32_PARAMS = ("A_log", "D", "dt_bias", "conv_weight", "conv_bias")
INIT_STD = 0.02  # the random matrices' standard deviation
EMBEDDING_INIT_STD = 0.002  # the tied embedding's (see the module doc)
_PREFILL_ROWS = 16  # rows a block of the prefill's SSD scan
_PREFILL_TOKENS = 8192  # tokens a block of the prefill's MoE


class HybridConfig(NamedTuple):
    hidden_size: int = 4096
    num_hidden_layers: int = 10
    layer_types: tuple = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4
    vocab_size: int = 100352
    prefix_dim: int = 384  # the tower's width, the projector's input
    mamba_n_heads: int = 128
    mamba_d_head: int = 64
    mamba_d_state: int = 128
    mamba_n_groups: int = 1
    mamba_d_conv: int = 4
    mamba_chunk_size: int = 256
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    attention_multiplier: float = 0.0078125
    num_local_experts: int = 72
    num_experts_per_tok: int = 10
    intermediate_size: int = 768
    shared_intermediate_size: int = 1536
    embedding_multiplier: float = 12.0
    residual_multiplier: float = 0.22
    logits_scaling: float = 16.0
    rms_norm_eps: float = 1e-5
    pad_token_id: int = 0
    eos_token_id: int = 2
    decoder_start_token_id: int = 1
    dtype: torch.dtype = torch.float32  # weights and matmuls
    state_dtype: torch.dtype = torch.float32  # SSM state and conv tail

    @property
    def inner(self) -> int:
        return self.mamba_n_heads * self.mamba_d_head

    @property
    def conv_dim(self) -> int:
        return self.inner + 2 * self.mamba_n_groups * self.mamba_d_state

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kinds(self) -> tuple:
        return tuple(self.layer_types[:self.num_hidden_layers])


#: the YAML decoder block's keys that are read as integers or floats
_INT_KEYS = ("hidden_size", "num_hidden_layers", "vocab_size", "prefix_dim",
             "mamba_n_heads", "mamba_d_head", "mamba_d_state",
             "mamba_n_groups", "mamba_d_conv", "mamba_chunk_size",
             "num_attention_heads", "num_key_value_heads",
             "num_local_experts", "num_experts_per_tok", "intermediate_size",
             "shared_intermediate_size")
_FLOAT_KEYS = ("attention_multiplier", "embedding_multiplier",
               "residual_multiplier", "logits_scaling", "rms_norm_eps")
MODEL_TYPE = "granitemoehybrid"


def hybrid_config_from(config, dtype=torch.float32) -> HybridConfig:
    """The ``model.decoder`` block of the config tree (``type:
    granitemoehybrid`` and HF's key names) -> HybridConfig; the token ids
    are the tokenizer's, from ``model.t5``; ``prefix_dim`` defaults to the
    tower's ``d_model``; ``state_dtype`` names a torch dtype (default
    float32)."""
    dec, t5 = config.model.decoder, config.model.t5
    if dec.get("type") != MODEL_TYPE:
        raise ValueError(f"model.decoder.type must be {MODEL_TYPE!r}, got "
                         f"{dec.get('type')!r}")
    kw = {k: int(dec[k]) for k in _INT_KEYS if k in dec}
    kw.update({k: float(dec[k]) for k in _FLOAT_KEYS if k in dec})
    kw.setdefault("prefix_dim", int(t5.d_model))
    cfg = HybridConfig(
        **kw, layer_types=tuple(str(t) for t in dec.layer_types),
        pad_token_id=int(t5.pad_token_id), eos_token_id=int(t5.eos_token_id),
        decoder_start_token_id=int(t5.decoder_start_token_id), dtype=dtype,
        state_dtype=getattr(torch, str(dec.get("state_dtype", "float32"))))
    if len(cfg.layer_types) < cfg.num_hidden_layers or \
            set(cfg.kinds) - {"mamba", "attention"}:
        raise ValueError(f"layer_types {cfg.layer_types!r} must name mamba "
                         f"or attention for {cfg.num_hidden_layers} layers")
    return cfg


# --------------------------------------------------------------------- #
# parameters                                                             #
# --------------------------------------------------------------------- #


def param_shapes(cfg: HybridConfig) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter, linear weights (out, in)."""
    d, E = cfg.hidden_size, cfg.num_local_experts
    H, K = cfg.mamba_n_heads, cfg.mamba_d_conv
    conv = f"uniform {1.0 / math.sqrt(K)!r}"  # Conv1d's default, fan in K
    out = [("embedding", (cfg.vocab_size, d), "embedding"),
           ("projector.weight", (d, cfg.prefix_dim), "normal"),
           ("projector.bias", (d,), "zeros"),
           ("final_norm", (d,), "ones")]
    for i, kind in enumerate(cfg.kinds):
        p = f"layers.{i}."
        out += [(p + "input_norm", (d,), "ones"),
                (p + "post_norm", (d,), "ones")]
        if kind == "mamba":
            out += [(p + "in_proj", (cfg.inner + cfg.conv_dim + H, d),
                     "normal"),
                    (p + "conv_weight", (cfg.conv_dim, K), conv),
                    (p + "conv_bias", (cfg.conv_dim,), conv),
                    (p + "dt_bias", (H,), "dt_bias"),
                    (p + "A_log", (H,), "A_log"),
                    (p + "D", (H,), "ones"),
                    (p + "norm", (cfg.inner,), "ones"),
                    (p + "out_proj", (d, cfg.inner), "normal")]
        else:
            kv = cfg.num_key_value_heads * cfg.head_dim
            out += [(p + "q_proj", (d, d), "normal"),
                    (p + "k_proj", (kv, d), "normal"),
                    (p + "v_proj", (kv, d), "normal"),
                    (p + "o_proj", (d, d), "normal")]
        out += [(p + "router", (E, d), "normal"),
                (p + "experts_in", (E, 2 * cfg.intermediate_size, d),
                 "normal"),
                (p + "experts_out", (E, d, cfg.intermediate_size), "normal"),
                (p + "shared_in", (2 * cfg.shared_intermediate_size, d),
                 "normal"),
                (p + "shared_out", (d, cfg.shared_intermediate_size),
                 "normal")]
    return out


def tensor_seed(seed: int, name: str) -> int:
    """The seed of one parameter's generator: the run's seed mixed with
    the name's 64-bit FNV-1a hash."""
    h = 0xCBF29CE484222325
    for byte in name.encode():
        h = ((h ^ byte) * 0x100000001B3) % (1 << 64)
    return (int(seed) * 0x9E3779B97F4A7C15 + h) % (1 << 63)


def draw(name: str, shape: tuple, init: str, seed: int, device
         ) -> torch.Tensor:
    """One parameter, float32, drawn from its own generator."""
    g = torch.Generator(device=device).manual_seed(tensor_seed(seed, name))
    if init in ("normal", "embedding"):
        std = EMBEDDING_INIT_STD if init == "embedding" else INIT_STD
        return torch.randn(shape, generator=g, device=device) * std
    if init == "ones":
        return torch.ones(shape, device=device)
    if init == "zeros":
        return torch.zeros(shape, device=device)
    u = torch.rand(shape, generator=g, device=device)
    if init.startswith("uniform "):  # U(-bound, bound)
        return (2.0 * u - 1.0) * float(init.split()[1])
    if init == "A_log":
        return torch.log(1.0 + 15.0 * u)
    if init == "dt_bias":
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(lo + u * (hi - lo)).clamp(min=1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown init {init!r}")


def init_params(cfg: HybridConfig, seed: int, device="cpu",
                weight_dtype: Optional[torch.dtype] = None
                ) -> Dict[str, torch.Tensor]:
    """Every parameter from ``seed`` on ``device``; all but
    ``FLOAT32_PARAMS`` in ``weight_dtype`` (default: the config's)."""
    wd = cfg.dtype if weight_dtype is None else weight_dtype
    out = {}
    for name, shape, init in param_shapes(cfg):
        t = draw(name, shape, init, seed, device)
        out[name] = t if name.rsplit(".", 1)[-1] in FLOAT32_PARAMS \
            else t.to(wd)
    return out


class GraniteHybrid:
    """The decoder's parameters on one device, per layer, ready for
    ``prefill`` and ``decode_step``.  ``tp_group`` is None: the hybrid
    serves whole on one device."""

    tp_group = None

    def __init__(self, params: Dict[str, torch.Tensor], cfg: HybridConfig,
                 device="cpu"):
        self.cfg = cfg
        dev = torch.device(device)

        def get(name):
            t = params[name].to(dev)
            keep = name.rsplit(".", 1)[-1] in FLOAT32_PARAMS
            return t.float() if keep else t.to(cfg.dtype)

        self.embedding = get("embedding")
        self.projector_w = get("projector.weight")
        self.projector_b = get("projector.bias")
        self.final_norm = get("final_norm")
        self.layers: List[dict] = []
        for i, kind in enumerate(cfg.kinds):
            pre = f"layers.{i}."
            lp = {k[len(pre):]: get(k) for k in params if k.startswith(pre)}
            lp["kind"] = kind
            if kind == "mamba":
                lp["A"] = -torch.exp(lp.pop("A_log"))
                lp["conv_weight_t"] = lp.pop("conv_weight").t().contiguous()
            self.layers.append(lp)

    @classmethod
    def from_seed(cls, cfg: HybridConfig, seed: int, device="cpu"
                  ) -> "GraniteHybrid":
        return cls(init_params(cfg, seed, device), cfg, device)

    @property
    def mamba_layers(self) -> int:
        return sum(lp["kind"] == "mamba" for lp in self.layers)

    @property
    def attention_layers(self) -> int:
        return len(self.layers) - self.mamba_layers


# --------------------------------------------------------------------- #
# the decode state                                                       #
# --------------------------------------------------------------------- #


class HybridState(NamedTuple):
    """What a generation keeps on the device: per Mamba layer its SSM
    state (B, H, P, N) and conv tail (B, K - 1, conv_dim), in
    ``state_dtype``; per attention layer K and V (B, Hk, max_len, D) in
    ``dtype``."""
    ssm: list
    conv: list
    k: list
    v: list

    def nbytes_fixed(self) -> int:
        """Bytes of the fixed-size state (SSM states and conv tails)."""
        return sum(t.numel() * t.element_size() for t in self.ssm + self.conv)


def init_state(model: GraniteHybrid, batch: int, max_len: int, device
               ) -> HybridState:
    cfg = model.cfg
    H, P, N = cfg.mamba_n_heads, cfg.mamba_d_head, cfg.mamba_d_state
    n_m, n_a = model.mamba_layers, model.attention_layers

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    kv = (batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
    return HybridState(
        ssm=[zeros((batch, H, P, N), cfg.state_dtype) for _ in range(n_m)],
        conv=[zeros((batch, cfg.mamba_d_conv - 1, cfg.conv_dim),
                    cfg.state_dtype) for _ in range(n_m)],
        k=[zeros(kv, cfg.dtype) for _ in range(n_a)],
        v=[zeros(kv, cfg.dtype) for _ in range(n_a)])


# --------------------------------------------------------------------- #
# pieces                                                                 #
# --------------------------------------------------------------------- #


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Granite's RMSNorm: variance in float32, cast back before the
    weight."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return w * y.to(x.dtype)


def gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
               groups: int, eps: float, dtype) -> torch.Tensor:
    """rms over each group of ``y * silu(z)`` (float32) times ``w``, in
    ``dtype``."""
    g = y.float() * F.silu(z.float())
    shape = g.shape
    g = g.reshape(*shape[:-1], groups, shape[-1] // groups)
    g = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + eps)
    return (w.float() * g.reshape(shape)).to(dtype)


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor
               ) -> torch.Tensor:
    """Rows of ``x`` (M, K) sorted by group, group e the rows [offs[e-1],
    offs[e]) -> each row times its group's ``w[e]`` (out, K) transposed:
    (M, out).  One grouped product on a card, a loop on the CPU."""
    if x.device.type == "cuda":
        return torch._grouped_mm(x, w.transpose(-2, -1), offs=offs)
    out = x.new_empty(x.shape[0], w.shape[1])
    lo = 0
    for e, hi in enumerate(offs.tolist()):
        if hi > lo:
            out[lo:hi] = x[lo:hi] @ w[e].t()
        lo = hi
    return out


def moe(lp: dict, h: torch.Tensor, cfg: HybridConfig,
        counts_into: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        ) -> torch.Tensor:
    """The routed experts plus the shared MLP over tokens (T, d).  With
    ``counts_into`` (tokens per expert, busiest expert's count), this
    layer's routed tokens are added to them."""
    T, d = h.shape
    k, E = cfg.num_experts_per_tok, cfg.num_local_experts
    logits = F.linear(h, lp["router"]).float()
    top_v, top_i = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(top_v, dim=-1)
    flat = top_i.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(E, dtype=torch.int64, device=h.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    offs = torch.cumsum(counts, 0).to(torch.int32)
    xs = h.index_select(0, order // k)
    gate, up = grouped_mm(xs, lp["experts_in"], offs).chunk(2, dim=-1)
    ys = grouped_mm(F.silu(gate) * up, lp["experts_out"], offs)
    y = torch.empty_like(ys).index_copy_(0, order, ys)  # each pair's slot
    routed = torch.bmm(gates.to(h.dtype)[:, None, :], y.view(T, k, d))[:, 0]
    gate, up = F.linear(h, lp["shared_in"]).chunk(2, dim=-1)
    out = routed + F.linear(F.silu(gate) * up, lp["shared_out"])
    if counts_into is not None:
        counts_into[0].add_(counts)
        counts_into[1].add_(counts.max())
    return out


def _moe_blocks(lp: dict, h: torch.Tensor, cfg: HybridConfig) -> torch.Tensor:
    """``moe`` over (B, L, d) in blocks of tokens (the prefill's)."""
    flat = h.reshape(-1, h.shape[-1])
    out = torch.cat([moe(lp, flat[lo:lo + _PREFILL_TOKENS], cfg)
                     for lo in range(0, flat.shape[0], _PREFILL_TOKENS)])
    return out.view(h.shape)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 scan in its chunked (SSD) form from a zero state, all
    float32: x (B, L, H, P), dt (B, L, H) after softplus, A (H,), Bm and
    Cm (B, L, G, N) -> (y without the D term (B, L, H, P), the final state
    (B, H, P, N)).  Within a chunk y_i = sum_{j <= i} (C_i . B_j)
    exp(cumA_i - cumA_j) dt_j x_j plus the carried state read by C_i; the
    state carries from chunk to chunk."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2:]
    Hg = H // G
    S = x.new_zeros(Bsz, G, Hg * P, N)
    ys = []
    for lo in range(0, L, chunk):
        xs = x[:, lo:lo + chunk].permute(0, 2, 1, 3)  # (B, H, l, P)
        l = xs.shape[2]
        dts = dt[:, lo:lo + chunk].transpose(1, 2)  # (B, H, l)
        acs = torch.cumsum(dts * A[:, None], dim=-1)  # (B, H, l)
        Bg = Bm[:, lo:lo + chunk].permute(0, 2, 1, 3)  # (B, G, l, N)
        Cg = Cm[:, lo:lo + chunk].permute(0, 2, 1, 3)
        tril = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp((acs[..., :, None] - acs[..., None, :])
                          .masked_fill(~tril, -math.inf))  # (B, H, l, l)
        cb = (Cg @ Bg.transpose(-1, -2))[:, :, None]  # (B, G, 1, l, l)
        m = cb * (decay * dts[..., None, :]).view(Bsz, G, Hg, l, l)
        y = m @ xs.reshape(Bsz, G, Hg, l, P)  # (B, G, Hg, l, P)
        # the carried state, read by C_i and decayed to position i
        carry = (Cg @ S.transpose(-1, -2)).view(Bsz, G, l, Hg, P)
        y = y + carry.permute(0, 1, 3, 2, 4) * \
            torch.exp(acs).view(Bsz, G, Hg, l, 1)
        ys.append(y.reshape(Bsz, H, l, P).permute(0, 2, 1, 3))
        w = (torch.exp(acs[..., -1:] - acs) * dts).view(Bsz, G, Hg, l, 1)
        xw = (xs.reshape(Bsz, G, Hg, l, P) * w).transpose(-1, -2)
        S = (S.view(Bsz, G, Hg, P, N)
             * torch.exp(acs[..., -1]).view(Bsz, G, Hg, 1, 1)
             ).view(Bsz, G, Hg * P, N) + xw.reshape(Bsz, G, Hg * P, l) @ Bg
    return torch.cat(ys, 1), S.view(Bsz, H, P, N)


def _conv_split(cfg: HybridConfig, conv: torch.Tensor):
    inner, GN = cfg.inner, cfg.mamba_n_groups * cfg.mamba_d_state
    return conv[..., :inner], conv[..., inner:inner + GN], \
        conv[..., inner + GN:]


def mamba_prefill(lp: dict, h: torch.Tensor, cfg: HybridConfig,
                  ssm: torch.Tensor, conv_tail: torch.Tensor) -> torch.Tensor:
    """The mixer over the prefix (B, L, d); writes the final SSM state and
    the conv tail (the last K - 1 inputs of the conv) into ``ssm`` and
    ``conv_tail``."""
    Bsz, L, _ = h.shape
    H, P = cfg.mamba_n_heads, cfg.mamba_d_head
    G, N, K = cfg.mamba_n_groups, cfg.mamba_d_state, cfg.mamba_d_conv
    zxbcdt = F.linear(h, lp["in_proj"])
    z = zxbcdt[..., :cfg.inner]
    xbc = zxbcdt[..., cfg.inner:cfg.inner + cfg.conv_dim].float()
    dt = zxbcdt[..., cfg.inner + cfg.conv_dim:]
    padded = torch.cat([xbc.new_zeros(Bsz, K - 1, cfg.conv_dim), xbc], 1)
    conv_tail.copy_(padded[:, L:])
    wt = lp["conv_weight_t"]  # (K, C)
    conv = lp["conv_bias"] + sum(padded[:, j:j + L] * wt[j] for j in range(K))
    x, Bm, Cm = _conv_split(cfg, F.silu(conv))
    dt = F.softplus(dt.float() + lp["dt_bias"])
    y = torch.empty(Bsz, L, H, P, dtype=torch.float32, device=h.device)
    for lo in range(0, Bsz, _PREFILL_ROWS):
        rows = slice(lo, lo + _PREFILL_ROWS)
        y[rows], final = ssd_chunked(
            x[rows].reshape(-1, L, H, P), dt[rows], lp["A"],
            Bm[rows].reshape(-1, L, G, N), Cm[rows].reshape(-1, L, G, N),
            cfg.mamba_chunk_size)
        ssm[rows].copy_(final)
    y = y + lp["D"][:, None] * x.reshape(Bsz, L, H, P)
    y = gated_norm(y.reshape(Bsz, L, cfg.inner), z, lp["norm"], G,
                   cfg.rms_norm_eps, cfg.dtype)
    return F.linear(y, lp["out_proj"])


def mamba_step(lp: dict, h: torch.Tensor, cfg: HybridConfig,
               ssm: torch.Tensor, conv_tail: torch.Tensor) -> torch.Tensor:
    """The mixer for one token a row (B, d), updating ``conv_tail`` and
    ``ssm`` in place (the SSM state through kernel 6)."""
    Bsz = h.shape[0]
    H, P = cfg.mamba_n_heads, cfg.mamba_d_head
    G, N = cfg.mamba_n_groups, cfg.mamba_d_state
    zxbcdt = F.linear(h, lp["in_proj"])
    z = zxbcdt[:, :cfg.inner]
    xbc = zxbcdt[:, cfg.inner:cfg.inner + cfg.conv_dim]
    dt = zxbcdt[:, cfg.inner + cfg.conv_dim:]
    window = torch.cat([conv_tail.float(), xbc.float()[:, None]], 1)
    conv_tail.copy_(window[:, 1:])
    conv = (window * lp["conv_weight_t"]).sum(1) + lp["conv_bias"]
    x, Bm, Cm = _conv_split(cfg, F.silu(conv))
    dt = F.softplus(dt.float() + lp["dt_bias"])
    y = ssm_state_update(ssm, x.reshape(Bsz, H, P).contiguous(),
                         dt.contiguous(), lp["A"],
                         Bm.reshape(Bsz, G, N).contiguous(),
                         Cm.reshape(Bsz, G, N).contiguous(), lp["D"])
    y = gated_norm(y.reshape(Bsz, cfg.inner), z, lp["norm"], G,
                   cfg.rms_norm_eps, cfg.dtype)
    return F.linear(y, lp["out_proj"])


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor, cfg: HybridConfig) -> torch.Tensor:
    """q (B, Hk, Q, D) (a KV head's query heads along Q) over k, v (B, Hk,
    Lk, D): scores in the compute dtype times the multiplier, a float32
    softmax with ``mask`` (Q, Lk) or (Lk,) (True = keep)."""
    s = (q @ k.transpose(-1, -2)).float() * cfg.attention_multiplier
    p = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    return p.to(q.dtype) @ v


def attention_prefill(lp: dict, h: torch.Tensor, cfg: HybridConfig,
                      k_cache: torch.Tensor, v_cache: torch.Tensor
                      ) -> torch.Tensor:
    """Causal attention over the prefix (B, L, d); its K and V go to
    positions [0, L) of the cache."""
    Bsz, L, d = h.shape
    Hk, D = cfg.num_key_value_heads, cfg.head_dim
    r = cfg.num_attention_heads // Hk
    # query head j reads KV head j // r (HF repeat_kv)
    q = F.linear(h, lp["q_proj"]).view(Bsz, L, Hk, r, D) \
        .permute(0, 2, 3, 1, 4).reshape(Bsz, Hk, r * L, D)
    k = F.linear(h, lp["k_proj"]).view(Bsz, L, Hk, D).transpose(1, 2)
    v = F.linear(h, lp["v_proj"]).view(Bsz, L, Hk, D).transpose(1, 2)
    k_cache[:, :, :L].copy_(k)
    v_cache[:, :, :L].copy_(v)
    causal = torch.ones(L, L, dtype=torch.bool, device=h.device).tril()
    o = _attend(q, k, v, causal.repeat(r, 1), cfg).view(Bsz, Hk, r, L, D)
    return F.linear(o.permute(0, 3, 1, 2, 4).reshape(Bsz, L, d), lp["o_proj"])


def attention_step(lp: dict, h: torch.Tensor, cfg: HybridConfig,
                   k_cache: torch.Tensor, v_cache: torch.Tensor,
                   pos: torch.Tensor, keys: int) -> torch.Tensor:
    """One token a row (B, d) at position ``pos`` (a (1,) int64 on the
    device): its K and V written into the cache there, then attention
    over the first ``keys`` positions with those after ``pos`` masked."""
    Bsz, d = h.shape
    Hk, D = cfg.num_key_value_heads, cfg.head_dim
    r = cfg.num_attention_heads // Hk
    q = F.linear(h, lp["q_proj"]).view(Bsz, Hk, r, D)
    k_cache.index_copy_(2, pos, F.linear(h, lp["k_proj"]).view(Bsz, Hk, 1, D))
    v_cache.index_copy_(2, pos, F.linear(h, lp["v_proj"]).view(Bsz, Hk, 1, D))
    mask = torch.arange(keys, device=h.device) <= pos
    o = _attend(q, k_cache[:, :, :keys], v_cache[:, :, :keys], mask, cfg)
    return F.linear(o.reshape(Bsz, d), lp["o_proj"])


# --------------------------------------------------------------------- #
# the two passes                                                         #
# --------------------------------------------------------------------- #


@torch.no_grad()
def prefill(model: GraniteHybrid, prefix: torch.Tensor,
            state: HybridState) -> None:
    """Every layer over the prefix (B, Lp, prefix_dim), writing the decode
    state's first Lp positions; no logits (the start token is the decode
    loop's first step)."""
    cfg = model.cfg
    r, eps = cfg.residual_multiplier, cfg.rms_norm_eps
    x = F.linear(prefix.to(cfg.dtype), model.projector_w, model.projector_b) \
        * cfg.embedding_multiplier
    m = a = 0
    for lp in model.layers:
        h = rms_norm(x, lp["input_norm"], eps)
        if lp["kind"] == "mamba":
            h = mamba_prefill(lp, h, cfg, state.ssm[m], state.conv[m])
            m += 1
        else:
            h = attention_prefill(lp, h, cfg, state.k[a], state.v[a])
            a += 1
        x = x + h * r
        x = x + _moe_blocks(lp, rms_norm(x, lp["post_norm"], eps), cfg) * r


@torch.no_grad()
def decode_step(model: GraniteHybrid, token: torch.Tensor,
                pos: torch.Tensor, state: HybridState, keys: int,
                counters: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
    """One step -> float32 logits (B, vocab) / ``logits_scaling``.
    ``token`` (B,) at position ``pos`` (a 0-d int32 on the device);
    attention reads the first ``keys`` cache positions (they must cover
    ``pos``).  ``counters``: (tokens per expert (layers, E), busiest
    expert's count (layers,)) int64, added to."""
    cfg = model.cfg
    r, eps = cfg.residual_multiplier, cfg.rms_norm_eps
    at = pos.view(1).long()
    x = model.embedding[token] * cfg.embedding_multiplier
    m = a = 0
    for i, lp in enumerate(model.layers):
        h = rms_norm(x, lp["input_norm"], eps)
        if lp["kind"] == "mamba":
            h = mamba_step(lp, h, cfg, state.ssm[m], state.conv[m])
            m += 1
        else:
            h = attention_step(lp, h, cfg, state.k[a], state.v[a], at, keys)
            a += 1
        x = x + h * r
        into = None if counters is None else (counters[0][i], counters[1][i])
        x = x + moe(lp, rms_norm(x, lp["post_norm"], eps), cfg, into) * r
    x = rms_norm(x, model.final_norm, eps)
    return F.linear(x, model.embedding).float() / cfg.logits_scaling
