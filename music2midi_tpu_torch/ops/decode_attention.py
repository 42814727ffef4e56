"""Decode-step attention over int8 K/V for Hopper: wrappers, plain versions
and launch counts.

Port of ``music2midi_tpu/ops/decode_attention.py``.  Two functions, each
with the TPU kernel's arguments and arithmetic:

  * ``decode_attention_int8`` (TPU kernel ``decode_attention_int8``): one
    decode step of attention over an int8 (B, H, L, D) cache with
    per-position f32 scales (B, H, 1, L) folded into the score and
    probability rows, f32 softmax, -1e9 masking.  ``causal=True`` (self
    attention) adds the relative-position bias row, keeps keys <= ``step``
    and takes position ``step`` from this step's fresh quantized row;
    ``causal=False`` (cross attention) keeps keys < ``enc_len``.  Products
    and ``p * vs`` are f32; only the output is rounded to bf16.
    ``round_pv=True`` rounds each ``p * vs`` to bf16 before the PV
    products instead: the arithmetic of the JAX package's serving route,
    ``models/t5.py::_attention_int8``, which the port's engine serves
    with (its JAX twin never enables the TPU kernel).
  * ``decode_attention_cross_t`` (TPU kernel ``decode_attention_cross_t``):
    cross attention over a TRANSPOSED (B, H, D, L) int8 cache
    (``transpose_cross_entry``: a view of a copy whose rows are padded to
    16 bytes), as the TPU kernel's source reads: each
    int8 x bf16 product of the score and PV passes rounded to bf16 (the
    f32 product is exact, so this is one rounding), the sums in f32, and
    ``p * vs`` rounded to bf16 before the PV products.  XLA on the CPU
    keeps such bf16 intermediates in f32 unless
    ``--xla_allow_excess_precision=false``; with that flag the JAX kernel
    in interpret mode equals the plain version below bit for bit on the
    tests' inputs.

A CUDA tensor goes to the hand-written kernel in
``csrc/decode_attention.cu`` (built by ``ops/_build.py`` at first use) and
a failed launch raises; a CPU tensor goes to the plain PyTorch version
beside it (``*_plain``).  The tensor's device decides.

The port writes this step's row into the self cache before the call, so
the fresh-row patch of the causal kernel recomputes a value that is
already in the cache.  The kernel keeps the TPU kernel's signature all the
same: for key ``step`` it reads the fresh row and never the cache row.

Bound on the H100 (3.35 TB/s): both kernels are bound by the bytes of the
int8 cache.  At B = 64, H = 8, D = 64 and n visible keys the causal kernel
moves 65,536 n bytes of K/V, 4,096 n of scales, 32 n of bias and 131 KB of
q and output (71.4 MB, 21 us, at n = 1023); its 4 B H n D flops take 2 us
at the 67 TFLOP/s fp32 rate.  Cross attention at L = 190 moves 13.4 MB,
4 us (``chip_smoke.py`` computes both bounds).  The decode loop calls 12
of these per step; one launch replaces the ~10 launches of the plain
chain, which is what the loop, bound by the host's launches, gains.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

MAX_KEYS = 4096  # visible keys per call: the score row lives in shared
# memory (4 bytes a key, 16 KB at this maximum)
MAX_CROSS_T_KEYS = 1024  # the transposed-cross kernel stages all of K
# and V in shared memory, 2 x 64 x (keys + 16) bytes, beside 11 floats a
# key: 178 KB at this maximum
HEAD_DIM = 64  # the kernels are written for d_kv = 64

Entry = Tuple[torch.Tensor, torch.Tensor]  # (int8 values, f32 scales)

_NEG = -1e9


# --------------------------------------------------------------------- #
# plain versions                                                         #
# --------------------------------------------------------------------- #


def _bias_2d(bias: torch.Tensor) -> torch.Tensor:
    """(1, H, 1, L) or (H, L) -> an (H, L) view."""
    if bias.dim() == 4:
        return bias[0, :, 0, :]
    if bias.dim() != 2:
        raise ValueError(f"bias must be (1, H, 1, L) or (H, L), got "
                         f"{tuple(bias.shape)}")
    return bias


def decode_attention_int8_plain(
    q: torch.Tensor,  # (B, H, 1, D)
    k_entry: Entry,  # int8 (B, H, L, D), f32 (B, H, 1, L)
    v_entry: Entry,
    bias: Optional[torch.Tensor],  # (1, H, 1, L) or (H, L) f32 (causal)
    step: Optional[int],  # position of this step's query (causal)
    new_k: Optional[Entry],  # int8 (B, H, 1, D), f32 (B, H, 1, 1) (causal)
    new_v: Optional[Entry],
    causal: bool,
    enc_len: int = 0,
    round_pv: bool = False,
) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch -> (B, H, 1, D) in q.dtype.

    Key ``step`` (causal) is read from the fresh rows, through the same
    products as every other key.  ``round_pv=False`` is the TPU kernel's
    arithmetic (``p * vs`` in f32); ``round_pv=True`` rounds each
    ``p * vs`` to bf16 before the PV products, the fresh row's too, as
    the JAX package's serving route ``models/t5.py::_attention_int8``
    does over the post-write cache."""
    k8, ks = k_entry
    v8, vs = v_entry
    B, H, L, D = k8.shape
    if not causal and enc_len <= 0:
        enc_len = L  # no pad mask (0 would mask every key)
    qf = q.to(torch.bfloat16).float()  # (B, H, 1, D)
    kf, vf = k8.float(), v8.float()
    ks, vs = ks[:, :, 0, :], vs[:, :, 0, :]  # (B, H, L)
    l_pos = torch.arange(L, device=q.device)
    if causal:
        fresh = l_pos == step
        kf = torch.where(fresh[:, None], new_k[0].float(), kf)
        vf = torch.where(fresh[:, None], new_v[0].float(), vf)
        ks = torch.where(fresh, new_k[1][:, :, 0, :], ks)
        vs = torch.where(fresh, new_v[1][:, :, 0, :], vs)
    scores = torch.matmul(qf, kf.transpose(-1, -2))[:, :, 0, :] * ks
    if causal:
        scores = scores + _bias_2d(bias).float()[None, :, :L]
        scores = torch.where(l_pos <= step, scores,
                             torch.tensor(_NEG, device=q.device))
    elif enc_len < L:
        scores = torch.where(l_pos < enc_len, scores,
                             torch.tensor(_NEG, device=q.device))
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    p = e / e.sum(dim=-1, keepdim=True)  # (B, H, L) f32
    pv = p * vs
    if round_pv:
        pv = pv.to(torch.bfloat16).float()
    out = torch.matmul(pv[:, :, None, :], vf)  # (B, H, 1, D)
    return out.to(torch.bfloat16).to(q.dtype)


def transpose_cross_entry(entry: Entry) -> Entry:
    """(int8 (B, H, L, D), scales (B, H, 1, L)) -> values transposed for
    ``decode_attention_cross_t``: a (B, H, D, L) view, the JAX package's
    shape, of a zeroed (B, H, D, Lp) copy with Lp = L rounded up to 16, so
    that every row of L keys starts 16 bytes aligned and the kernel can
    read whole 16-byte pieces (the pad keys are masked).  The scales stay
    in their score-row layout.  Once per generation: cross K/V are
    written once."""
    vals, scales = entry
    B, H, L, D = vals.shape
    padded = torch.zeros((B, H, D, _round16(L)), dtype=vals.dtype,
                         device=vals.device)
    padded[..., :L] = vals.transpose(2, 3)
    return padded[..., :L], scales


def decode_attention_cross_t_plain(
    q: torch.Tensor,  # (B, H, 1, D)
    kt_entry: Entry,  # int8 (B, H, D, L), f32 (B, H, 1, L)
    vt_entry: Entry,
    enc_len: int = 0,
) -> torch.Tensor:
    """The TPU kernel's arithmetic in PyTorch -> (B, H, 1, D) in q.dtype:
    products rounded to bf16, sums in f32, ``p * vs`` rounded to bf16."""
    kt8, ks = kt_entry
    vt8, vs = vt_entry
    B, H, D, L = kt8.shape
    if enc_len <= 0:
        enc_len = L
    qt = q.to(torch.bfloat16).float().transpose(2, 3)  # (B, H, D, 1)
    s = (kt8.float() * qt).to(torch.bfloat16).float().sum(2)  # (B, H, L)
    s = s * ks[:, :, 0, :]
    if enc_len < L:
        l_pos = torch.arange(L, device=q.device)
        s = torch.where(l_pos < enc_len, s,
                        torch.tensor(_NEG, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)
    p = (p * vs[:, :, 0, :]).to(torch.bfloat16).float()
    o = (vt8.float() * p[:, :, None, :]).to(torch.bfloat16).float().sum(3)
    return o.to(torch.bfloat16)[:, :, None, :].to(q.dtype)


# --------------------------------------------------------------------- #
# kernel launch arguments (the C structs of csrc/decode_attention.cu)    #
# --------------------------------------------------------------------- #


def _struct(name: str, pointers: str, strides: str, ints: str):
    fields = ([(f, ctypes.c_void_p) for f in pointers.split()]
              + [(f, ctypes.c_int64) for f in strides.split()]
              + [(f, ctypes.c_int) for f in ints.split()])
    return type(name, (ctypes.Structure,), {"_fields_": fields})


# field order and types match Int8AttnArgs / CrossTArgs field for field
_Int8Args = _struct(
    "Int8AttnArgs",
    "q k v ks vs bias kn vn kns vns out",
    "q_sb q_sh k_sb k_sh k_sl v_sb v_sh v_sl ks_sb ks_sh ks_sl "
    "vs_sb vs_sh vs_sl bias_sh bias_sl kn_sb kn_sh vn_sb vn_sh "
    "kns_sb kns_sh vns_sb vns_sh",
    "H n_keys step causal round_pv",
)
_CrossTArgs = _struct(
    "CrossTArgs",
    "q kt vt ks vs out",
    "q_sb q_sh kt_sb kt_sh kt_sd vt_sb vt_sh vt_sd ks_sb ks_sh ks_sl "
    "vs_sb vs_sh vs_sl",
    "H n_keys",
)


def _check_int8(name: str, t: torch.Tensor, dims: int) -> None:
    """An int8 operand read 16 bytes at a time: int8, on the card, unit
    stride on its last dim, every other stride and the address 16-byte
    aligned."""
    if t.dtype != torch.int8 or t.dim() != dims:
        raise ValueError(f"{name}: needs int8 with {dims} dims, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
            s % 16 for s in t.stride()[:-1]):
        raise ValueError(f"{name}: needs unit last stride and 16-byte "
                         f"aligned rows, got strides {t.stride()}")


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _check_padded_rows(name: str, t: torch.Tensor, n_keys: int) -> None:
    """A transposed (B, H, D, L) int8 operand whose rows the kernel reads
    in whole 16-byte pieces: aligned rows (``_check_int8``), and storage
    behind every row for ``n_keys`` rounded up to 16 bytes, as
    ``transpose_cross_entry`` pads it."""
    _check_int8(name, t, 4)
    last = t.storage_offset() + sum(
        (n - 1) * st for n, st in zip(t.shape[:-1], t.stride()[:-1]))
    if t.stride(-2) < _round16(n_keys) or \
            last + _round16(n_keys) > t.untyped_storage().nbytes():
        raise ValueError(f"{name}: rows must be padded to {_round16(n_keys)} "
                         f"bytes (transpose_cross_entry), got strides "
                         f"{t.stride()}")


def _check_f32(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{name}: needs float32 {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")


def _query(q: torch.Tensor, B: int, H: int, D: int) -> torch.Tensor:
    """q as bf16 (B, H, 1, D) with a unit last stride (a view if it is)."""
    if tuple(q.shape) != (B, H, 1, D):
        raise ValueError(f"q: needs {(B, H, 1, D)}, got {tuple(q.shape)}")
    q = q.to(torch.bfloat16)
    return q if q.stride(-1) == 1 else q.contiguous()


def _on_card(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("decode attention: operands on different devices")


# --------------------------------------------------------------------- #
# wrappers                                                               #
# --------------------------------------------------------------------- #


@torch.no_grad()
def decode_attention_int8(
    q: torch.Tensor,
    k_entry: Entry,
    v_entry: Entry,
    bias: Optional[torch.Tensor],
    step: Optional[int],
    new_k: Optional[Entry],
    new_v: Optional[Entry],
    causal: bool,
    enc_len: int = 0,
    round_pv: bool = False,
) -> torch.Tensor:
    """-> attention output (B, H, 1, D) in q.dtype.

    The kernel for CUDA tensors, ``decode_attention_int8_plain`` for CPU
    tensors.  ``round_pv`` rounds each ``p * vs`` to bf16 before the PV
    products (the serving arithmetic of ``_attention_int8``); off, it is
    the TPU kernel's arithmetic.  The kernel reads only the visible keys, through the
    operands' strides: keys 0..step (causal; key ``step`` from the fresh
    row) or 0..enc_len-1 (cross), so a caller may pass a whole
    ``max_length`` cache buffer.  ``bias`` is indexed by key position
    (``bias[h, j]`` for key j) and may be a strided view."""
    if q.device.type != "cuda":
        return decode_attention_int8_plain(q, k_entry, v_entry, bias, step,
                                           new_k, new_v, causal, enc_len,
                                           round_pv)
    k8, ks = k_entry
    v8, vs = v_entry
    B, H, L, D = k8.shape
    if D != HEAD_DIM:
        raise ValueError(f"decode attention kernel needs d_kv {HEAD_DIM}, "
                         f"got {D}")
    if causal:
        step = int(step)
        if not 0 <= step < L:
            raise ValueError(f"step {step} outside the cache length {L}")
        n_keys = step + 1
    else:
        n_keys = L if enc_len <= 0 else int(enc_len)
        if n_keys > L:
            raise ValueError(f"enc_len {n_keys} > cache length {L}")
    if n_keys > MAX_KEYS:
        raise ValueError(f"decode attention kernel takes at most {MAX_KEYS} "
                         f"visible keys, got {n_keys}")
    _check_int8("k", k8, 4)
    _check_int8("v", v8, 4)
    if tuple(v8.shape) != (B, H, L, D):
        raise ValueError(f"v: needs {(B, H, L, D)}, got {tuple(v8.shape)}")
    _check_f32("k scales", ks, (B, H, 1, L))
    _check_f32("v scales", vs, (B, H, 1, L))
    qb = _query(q, B, H, D)
    out = torch.empty((B, H, 1, D), dtype=torch.bfloat16, device=q.device)
    a = _Int8Args(
        q=qb.data_ptr(), k=k8.data_ptr(), v=v8.data_ptr(),
        ks=ks.data_ptr(), vs=vs.data_ptr(), out=out.data_ptr(),
        q_sb=qb.stride(0), q_sh=qb.stride(1),
        k_sb=k8.stride(0), k_sh=k8.stride(1), k_sl=k8.stride(2),
        v_sb=v8.stride(0), v_sh=v8.stride(1), v_sl=v8.stride(2),
        ks_sb=ks.stride(0), ks_sh=ks.stride(1), ks_sl=ks.stride(3),
        vs_sb=vs.stride(0), vs_sh=vs.stride(1), vs_sl=vs.stride(3),
        H=H, n_keys=n_keys, step=step if causal else -1, causal=int(causal),
        round_pv=int(round_pv),
    )
    if causal:
        b2 = _bias_2d(bias)
        if b2.dtype != torch.float32:
            b2 = b2.float()
        if b2.shape[0] != H or b2.shape[1] < n_keys:
            raise ValueError(f"bias: needs (H, >= {n_keys}), got "
                             f"{tuple(b2.shape)}")
        kn8, kns = new_k
        vn8, vns = new_v
        for name, t in (("new k", kn8), ("new v", vn8)):
            _check_int8(name, t, 4)
            if tuple(t.shape) != (B, H, 1, D):
                raise ValueError(f"{name}: needs {(B, H, 1, D)}, got "
                                 f"{tuple(t.shape)}")
        _check_f32("new k scale", kns, (B, H, 1, 1))
        _check_f32("new v scale", vns, (B, H, 1, 1))
        _on_card(q, k8, v8, ks, vs, b2, kn8, vn8, kns, vns)
        a.bias, a.bias_sh, a.bias_sl = b2.data_ptr(), b2.stride(0), \
            b2.stride(1)
        a.kn, a.kn_sb, a.kn_sh = kn8.data_ptr(), kn8.stride(0), kn8.stride(1)
        a.vn, a.vn_sb, a.vn_sh = vn8.data_ptr(), vn8.stride(0), vn8.stride(1)
        a.kns, a.kns_sb, a.kns_sh = kns.data_ptr(), kns.stride(0), \
            kns.stride(1)
        a.vns, a.vns_sb, a.vns_sh = vns.data_ptr(), vns.stride(0), \
            vns.stride(1)
    else:
        _on_card(q, k8, v8, ks, vs)
    if B * H:
        lib = _build.load()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.check(lib.m2m_decode_attention_int8(
            ctypes.addressof(a), B * H, stream), "m2m_decode_attention_int8")
        decode_attention_int8.launches += 1
    return out.to(q.dtype)


decode_attention_int8.launches = 0


@torch.no_grad()
def decode_attention_cross_t(
    q: torch.Tensor,
    kt_entry: Entry,
    vt_entry: Entry,
    enc_len: int = 0,
) -> torch.Tensor:
    """-> attention output (B, H, 1, D) in q.dtype, over a transposed int8
    cross cache.  The kernel for CUDA tensors, which stages the K and V
    rows in 16-byte pieces and so needs them padded as
    ``transpose_cross_entry`` pads them (it raises otherwise; keys >=
    enc_len are masked, whatever the pad holds);
    ``decode_attention_cross_t_plain`` for CPU tensors."""
    if q.device.type != "cuda":
        return decode_attention_cross_t_plain(q, kt_entry, vt_entry, enc_len)
    kt8, ks = kt_entry
    vt8, vs = vt_entry
    B, H, D, L = kt8.shape
    if D != HEAD_DIM:
        raise ValueError(f"decode attention kernel needs d_kv {HEAD_DIM}, "
                         f"got {D}")
    n_keys = L if enc_len <= 0 else int(enc_len)
    if n_keys > L:
        raise ValueError(f"enc_len {n_keys} > cache length {L}")
    if n_keys > MAX_CROSS_T_KEYS:
        raise ValueError(f"transposed-cross kernel takes at most "
                         f"{MAX_CROSS_T_KEYS} keys, got {n_keys}")
    for name, t in (("kt", kt8), ("vt", vt8)):
        if tuple(t.shape) != (B, H, D, L):
            raise ValueError(f"{name}: needs {(B, H, D, L)}, got "
                             f"{tuple(t.shape)}")
        _check_padded_rows(name, t, n_keys)
    _check_f32("k scales", ks, (B, H, 1, L))
    _check_f32("v scales", vs, (B, H, 1, L))
    _on_card(q, kt8, vt8, ks, vs)
    qb = _query(q, B, H, D)
    out = torch.empty((B, H, 1, D), dtype=torch.bfloat16, device=q.device)
    a = _CrossTArgs(
        q=qb.data_ptr(), kt=kt8.data_ptr(), vt=vt8.data_ptr(),
        ks=ks.data_ptr(), vs=vs.data_ptr(), out=out.data_ptr(),
        q_sb=qb.stride(0), q_sh=qb.stride(1),
        kt_sb=kt8.stride(0), kt_sh=kt8.stride(1), kt_sd=kt8.stride(2),
        vt_sb=vt8.stride(0), vt_sh=vt8.stride(1), vt_sd=vt8.stride(2),
        ks_sb=ks.stride(0), ks_sh=ks.stride(1), ks_sl=ks.stride(3),
        vs_sb=vs.stride(0), vs_sh=vs.stride(1), vs_sl=vs.stride(3),
        H=H, n_keys=n_keys,
    )
    if B * H:
        lib = _build.load()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.check(lib.m2m_decode_attention_cross_t(
            ctypes.addressof(a), B * H, stream),
            "m2m_decode_attention_cross_t")
        decode_attention_cross_t.launches += 1
    return out.to(q.dtype)


decode_attention_cross_t.launches = 0
