"""The T5 decode step's glue, fused (kernels 7-10): wrappers, plain twins
and launch counts.

Replaces no TPU kernel: the JAX package leaves this glue to XLA, which
fuses it inside its compiled decode loop.  ``models/t5.py::decode_step``
and ``infer/decode.py::DecodeProgram`` call, once a layer or a step:

- ``add_rms_norm(x, delta, w, eps)``: ``x += delta`` in place, then T5's
  RMSNorm of x (``embed_rms_norm(table, token, w, eps)``: x gathered from
  the embedding by the token ids instead, -> (x, norm));
- ``quantize_write_kv(qkv, k_entry, v_entry, step, levels)``: this step's
  K and V rows, read from the fused q|k|v projection, quantized per (row,
  head) at +-``levels`` and written into the int8 cache entries at the
  step the device holds -> the fresh rows as ``Int8AttentionPlan.causal``
  takes them, ((k8, k scale), (v8, v scale));
- ``gelu_mul(gate_lin)``: ``gelu_new(gate) * lin`` from the fused
  wi_0|wi_1 projection, rounded to its dtype;
- ``greedy_commit(logits, suppress, done, tokens, token, step, pad_id,
  eos_id)``: the greedy selection and the loop's bookkeeping (suppressed
  ids to -inf, the argmax, PAD for rows already done, ``done``, the token
  at ``tokens[:, step + 1]`` and in ``token``; then the step advanced,
  by an ATen add after the kernel).

A CUDA tensor goes to ``csrc/decode_fused.cu`` (built by ``ops/_build.py``
at first use) and a failed launch or a tensor the kernel does not take
raises; a CPU tensor goes to the ``*_plain`` twin, the ATen chain the step
ran before, op by op.  The kernels compute that chain's arithmetic on the
card: kernels 8-10 equal it bit for bit, kernel 7 sums its squares in the
order of ATen's reduce (``_reduce_width``), so that its norm differs at
most by the order of that sum.  T5's ``rms_norm`` and ``gelu_new`` are
defined here once: ``models/t5.py`` imports them for training, the
encoder and the cross-KV, and the twins call them; ``quantize_rows`` is
the int8 quantization both caches share.

Nothing here allocates but the outputs or reads anything back, so the
decode loop's CUDA graph captures the kernels as they are, and each
wrapper's ``.launches`` counts its kernel's launches (``embed_rms_norm``
counts on ``add_rms_norm``).  Bound: bytes, 0.1-0.6 MB a launch at the
decode shapes; a launch's floor binds.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_D = 1024  # kernel 7: ATen's reduce at most 256 threads a row
_MAX_DK = 256  # kernel 8: 8 values a lane


# --------------------------------------------------------------------- #
# T5's norm and gelu, and the plain twins                                #
# --------------------------------------------------------------------- #


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """T5LayerNorm: no mean subtraction, variance in fp32, cast to the
    input dtype before the weight multiply."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (weight * y.to(x.dtype)).to(x.dtype)


_GELU_C = float(np.sqrt(2.0 / np.pi).astype(np.float32))


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """HF "gelu_new" (tanh approximation).  As in the JAX package, the
    polynomial runs in the input dtype and the tanh and the final product
    in fp32 (the float32 constant promotes there)."""
    x3 = x * x * x
    inner = (x + 0.044715 * x3).float() * _GELU_C
    return (0.5 * x).float() * (1.0 + torch.tanh(inner))


def add_rms_norm_plain(x: torch.Tensor, delta: torch.Tensor, w: torch.Tensor,
                       eps: float) -> torch.Tensor:
    x.add_(delta)
    return rms_norm(x, w, eps)


def embed_rms_norm_plain(table: torch.Tensor, token: torch.Tensor,
                         w: torch.Tensor, eps: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = table[token][:, None]
    return x, rms_norm(x, w, eps)


def quantize_rows(x: torch.Tensor,
                  levels: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, L, D) -> (int8 values, fp32 scales laid out (B, H, 1, L)):
    symmetric per-position amax / levels, round half to even."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / levels
    q = torch.clamp(torch.round(xf / scale), -levels, levels)
    return q.to(torch.int8), scale.transpose(-1, -2)


def quantize_write_kv_plain(qkv: torch.Tensor, k_entry, v_entry,
                            step: torch.Tensor, levels: float) -> tuple:
    B, H, _, D = k_entry[0].shape
    pos = step.view(1).long()
    fresh = []
    for i, (vals, scales) in enumerate((k_entry, v_entry), start=1):
        new = qkv[..., i * H * D:(i + 1) * H * D].reshape(B, 1, H, D)
        q8, s = quantize_rows(new.transpose(1, 2), levels)
        vals.index_copy_(2, pos, q8)
        scales.index_copy_(3, pos, s)
        fresh.append((q8, s))
    return tuple(fresh)


def gelu_mul_plain(gate_lin: torch.Tensor) -> torch.Tensor:
    gate, lin = gate_lin.chunk(2, dim=-1)
    return (gelu_new(gate) * lin).to(gate_lin.dtype)


def greedy_commit_plain(logits: torch.Tensor, suppress: Optional[torch.Tensor],
                        done: torch.Tensor, tokens: torch.Tensor,
                        token: torch.Tensor, step: torch.Tensor, pad_id: int,
                        eos_id: int) -> None:
    if suppress is not None:
        logits.index_fill_(1, suppress, -float("inf"))
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    nxt = torch.where(done, pad_id, nxt)
    done |= nxt == eos_id
    tokens.index_copy_(1, (step + 1).view(1).long(), nxt[:, None])
    token.copy_(nxt)
    step += 1


# --------------------------------------------------------------------- #
# wrappers                                                               #
# --------------------------------------------------------------------- #


def _check(name: str, t: torch.Tensor, shape: tuple, dtypes: tuple,
           device: torch.device, align: int = 1) -> None:
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, needs one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, needs "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, needs {device}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name}: needs a contiguous, {align}-byte aligned "
                         "tensor")


def _check_step(step: torch.Tensor, device: torch.device) -> None:
    _check("step", step, (), (torch.int32,), device)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _last_pow2(n: int) -> int:
    return 1 << (int(n).bit_length() - 1)


def _reduce_width(rows: int, d: int) -> int:
    """ATen's threads a row for the mean over the last dim of a (rows, d)
    contiguous float32 tensor (``Reduce.cuh`` ``setReduceConfig``: loads
    of 4-value vectors when d > 128, at most 512 threads a block), which
    kernel 7 takes to sum its squares in ATen's order."""
    dim0, cap = (d // 4 if d > 128 else d), 512
    dim0_pow2 = _last_pow2(dim0) if dim0 < cap else cap
    dim1_pow2 = _last_pow2(rows) if rows < cap else cap
    height = min(dim1_pow2, cap // min(dim0_pow2, 32))
    return min(dim0_pow2, cap // height)


def _norm_launch(x, delta, table, token, w, out, eps) -> None:
    rows, d = out.numel() // out.shape[-1], out.shape[-1]
    dev = out.device
    if out.dtype not in _DTYPES or not 0 < d <= _MAX_D or \
            (d > 128 and d % 4):
        raise ValueError(f"add_rms_norm: needs float32 or bfloat16 rows of "
                         f"d <= {_MAX_D}, a multiple of 4 above 128, got "
                         f"{out.dtype} {tuple(out.shape)}")
    for name, t in (("x", x), ("delta", delta)):
        if t is not None:
            _check(name, t, out.shape, (out.dtype,), dev, 16)
    _check("w", w, (d,), _DTYPES, dev, 16)
    if table is not None:
        _check("table", table, (table.shape[0], d), (out.dtype,), dev, 16)
        _check("token", token, (rows,), (torch.int32,), dev)
    if rows:
        _build.check(_build.load().m2m_add_rms_norm(
            x.data_ptr(), None if delta is None else delta.data_ptr(),
            None if table is None else table.data_ptr(),
            None if token is None else token.data_ptr(), w.data_ptr(),
            out.data_ptr(), rows, d, 0 if table is None else table.shape[0],
            _reduce_width(rows, d), int(out.dtype == torch.bfloat16),
            int(w.dtype == torch.bfloat16), float(eps), _stream(dev)),
            "m2m_add_rms_norm")
        add_rms_norm.launches += 1


@torch.no_grad()
def add_rms_norm(x: torch.Tensor, delta: torch.Tensor, w: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """``x += delta`` in place (both (..., d) of the compute dtype), then
    -> T5's RMSNorm of x with weight ``w`` (d,), in x's dtype.  Kernel 7
    for CUDA tensors, ``add_rms_norm_plain`` for CPU tensors."""
    if x.device.type != "cuda":
        return add_rms_norm_plain(x, delta, w, eps)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    _norm_launch(x, delta, None, None, w, out, eps)
    return out


@torch.no_grad()
def embed_rms_norm(table: torch.Tensor, token: torch.Tensor, w: torch.Tensor,
                   eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (x = ``table[token]`` (B, 1, d), T5's RMSNorm of x), for a (V, d)
    table and (B,) int32 ids (an id off the table gives a NaN
    row on the card).  Kernel 7, counted on ``add_rms_norm``, for CUDA
    tensors; ``embed_rms_norm_plain`` for CPU tensors."""
    if table.device.type != "cuda":
        return embed_rms_norm_plain(table, token, w, eps)
    x = torch.empty((token.shape[0], 1, table.shape[-1]), dtype=table.dtype,
                    device=table.device)
    out = torch.empty_like(x)
    _norm_launch(x, None, table, token, w, out, eps)
    return x, out


add_rms_norm.launches = 0


@torch.no_grad()
def quantize_write_kv(qkv: torch.Tensor, k_entry, v_entry,
                      step: torch.Tensor, levels: float) -> tuple:
    """This step's K and V rows of ``qkv`` (B, 1, 3 H D: q | k | v),
    quantized per (row, head) at +-``levels`` (127.0 or 7.0) and written
    into the int8 cache entries ((B, H, L, D) int8 values, (B, H, 1, L)
    float32 scales) at position ``step`` (a 0-d int32 on the device) ->
    ((k8, k scale), (v8, v scale)), (B, H, 1, D) int8 and (B, H, 1, 1)
    float32.  Kernel 8 for CUDA tensors (a step off the cache writes
    nothing), ``quantize_write_kv_plain`` for CPU tensors."""
    if qkv.device.type != "cuda":
        return quantize_write_kv_plain(qkv, k_entry, v_entry, step, levels)
    (kv, ks), (vv, vs) = k_entry, v_entry
    B, H, L, D = kv.shape
    dev = qkv.device
    if D > _MAX_DK:
        raise ValueError(f"quantize_write_kv: d_kv {D} > {_MAX_DK}")
    _check("qkv", qkv, (B, 1, 3 * H * D), _DTYPES, dev)
    for name, t, shape, dtype in (("k values", kv, (B, H, L, D), torch.int8),
                                  ("v values", vv, (B, H, L, D), torch.int8),
                                  ("k scales", ks, (B, H, 1, L), torch.float32),
                                  ("v scales", vs, (B, H, 1, L),
                                   torch.float32)):
        _check(name, t, shape, (dtype,), dev)
    _check_step(step, dev)
    rows = [torch.empty((B, H, 1, D), dtype=torch.int8, device=dev)
            for _ in range(2)]
    scales = [torch.empty((B, H, 1, 1), dtype=torch.float32, device=dev)
              for _ in range(2)]
    if B * H:
        _build.check(_build.load().m2m_quantize_write_kv(
            qkv.data_ptr(), kv.data_ptr(), ks.data_ptr(), vv.data_ptr(),
            vs.data_ptr(), rows[0].data_ptr(), scales[0].data_ptr(),
            rows[1].data_ptr(), scales[1].data_ptr(), step.data_ptr(), B, H,
            D, L, int(qkv.dtype == torch.bfloat16), float(levels),
            _stream(dev)), "m2m_quantize_write_kv")
        quantize_write_kv.launches += 1
    return (rows[0], scales[0]), (rows[1], scales[1])


quantize_write_kv.launches = 0


@torch.no_grad()
def gelu_mul(gate_lin: torch.Tensor) -> torch.Tensor:
    """(..., 2 F) of the compute dtype, gate | lin -> ``gelu_new(gate) *
    lin`` (..., F) rounded to that dtype.  Kernel 9 for CUDA tensors,
    ``gelu_mul_plain`` for CPU tensors."""
    if gate_lin.device.type != "cuda":
        return gelu_mul_plain(gate_lin)
    f2 = gate_lin.shape[-1]
    if f2 % 2:
        raise ValueError(f"gelu_mul: odd last dim {f2}")
    _check("gate_lin", gate_lin, gate_lin.shape, _DTYPES, gate_lin.device)
    out = torch.empty((*gate_lin.shape[:-1], f2 // 2), dtype=gate_lin.dtype,
                      device=gate_lin.device)
    rows = gate_lin.numel() // f2 if f2 else 0
    if out.numel():
        _build.check(_build.load().m2m_gelu_mul(
            gate_lin.data_ptr(), out.data_ptr(), rows, f2 // 2,
            int(gate_lin.dtype == torch.bfloat16), _stream(gate_lin.device)),
            "m2m_gelu_mul")
        gelu_mul.launches += 1
    return out


gelu_mul.launches = 0


@torch.no_grad()
def greedy_commit(logits: torch.Tensor, suppress: Optional[torch.Tensor],
                  done: torch.Tensor, tokens: torch.Tensor,
                  token: torch.Tensor, step: torch.Tensor, pad_id: int,
                  eos_id: int) -> None:
    """One greedy step of the decode loop, in place: ``suppress``'s ids
    (int64, or None) of ``logits`` (B, V) to -inf, the argmax of each row
    (the first of equal maxima), PAD for the rows ``done`` (B,) already
    holds, ``done`` |= EOS, the token into ``tokens[:, step + 1]`` (B, N)
    int32 and ``token`` (B,) int32, then ``step`` (a 0-d int32) + 1.
    Kernel 10, one warp a row, for CUDA tensors (a step + 1 off
    ``tokens`` writes no token there; every block reads the step, so an
    ATen add advances it after the launch); ``greedy_commit_plain`` for
    CPU tensors."""
    if logits.device.type != "cuda":
        return greedy_commit_plain(logits, suppress, done, tokens, token,
                                   step, pad_id, eos_id)
    B, V = logits.shape
    dev = logits.device
    _check("logits", logits, (B, V), _DTYPES, dev)
    if suppress is not None:
        _check("suppress", suppress, (suppress.numel(),), (torch.int64,), dev)
    _check("done", done, (B,), (torch.bool,), dev)
    _check("tokens", tokens, (B, tokens.shape[-1]), (torch.int32,), dev)
    _check("token", token, (B,), (torch.int32,), dev)
    _check_step(step, dev)
    if B:
        _build.check(_build.load().m2m_greedy_commit(
            logits.data_ptr(),
            None if suppress is None else suppress.data_ptr(),
            0 if suppress is None else suppress.numel(), done.data_ptr(),
            tokens.data_ptr(), token.data_ptr(), step.data_ptr(), B, V,
            tokens.shape[-1], int(pad_id), int(eos_id),
            int(logits.dtype == torch.bfloat16), _stream(dev)),
            "m2m_greedy_commit")
        greedy_commit.launches += 1
    step += 1


greedy_commit.launches = 0


def wrappers() -> tuple:
    """The four kernels' counted wrappers."""
    return add_rms_norm, quantize_write_kv, gelu_mul, greedy_commit
