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
    with (its JAX twin never enables the TPU kernel).  A float32 query
    takes the kernel's f32 instance: q, ``p * vs`` and the output stay
    f32 (``round_pv`` rounds to the compute dtype, f32, which is a no-op),
    the arithmetic of ``_attention_int8`` in an fp32 engine with int8 KV.
    The TPU kernel rounds an f32 query to bf16 at its call; the port's
    engine needs ``_attention_int8``'s f32 arithmetic there, as the JAX
    engine serves it.  The +-7-level caches of ``kv_bits=4`` are int8
    arrays too, so the kernel takes them as they are.
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
beside it (``*_plain``).  The tensor's device decides.  The decode loop
calls the int8 kernel through ``Int8AttentionPlan``, which checks and
packs a program's caches once, so that a call costs the host a few
microseconds where ``decode_attention_int8`` checks and packs every
operand on every call.  The causal kernel reads the step from an int32 in
device memory (the plan takes the decode loop's device step; the public
function writes its host step to one), so a CUDA graph that captured the
plan's launches replays them at every step.  Neither kernel allocates or
reads back anything, so both are captured as they are.

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
chain, in a step that the captured loop replays as one graph.

The causal and cross kernels sum the scores and the softmax in the order
of the plain route that the engine's tokens are held against on the card
(``models/t5.py::_attention_int8`` through cuBLAS and ``torch.softmax``;
``csrc/decode_attention.cu`` says which), so that both round ``p * vs``
alike.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

MAX_KEYS = 4096  # visible keys per call: the score, scale and bias rows
# live in shared memory (16 bytes a key, 64 KB at this maximum)
MAX_CROSS_T_KEYS = 1024  # the transposed-cross kernel stages all of K
# and V in shared memory, 2 x 64 x (keys + 16) bytes, beside 11 floats a
# key: 178 KB at this maximum
HEAD_DIM = 64  # the kernels are written for d_kv = 64

Entry = Tuple[torch.Tensor, torch.Tensor]  # (int8 values, f32 scales)

_NEG = -1e9
_BIAS_DTYPES = (torch.float32, torch.bfloat16)  # a launch plan's bias rows


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
    does over the post-write cache.  A float32 q is the f32 instance's:
    q, ``p * vs`` and the output unrounded (``_attention_int8`` at f32);
    any other q is rounded to bf16."""
    k8, ks = k_entry
    v8, vs = v_entry
    B, H, L, D = k8.shape
    if not causal and enc_len <= 0:
        enc_len = L  # no pad mask (0 would mask every key)
    f32 = q.dtype == torch.float32
    qf = q.float() if f32 else q.to(torch.bfloat16).float()  # (B, H, 1, D)
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
    if round_pv and not f32:
        pv = pv.to(torch.bfloat16).float()
    out = torch.matmul(pv[:, :, None, :], vf)  # (B, H, 1, D)
    return out if f32 else out.to(torch.bfloat16).to(q.dtype)


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
    "q k v ks vs bias kn vn kns vns step out",
    "q_sb q_sh k_sb k_sh k_sl v_sb v_sh v_sl ks_sb ks_sh ks_sl "
    "vs_sb vs_sh vs_sl bias_sh bias_sl kn_sb kn_sh vn_sb vn_sh "
    "kns_sb kns_sh vns_sb vns_sh",
    "H n_keys causal round_pv q_f32",
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


def _q_aligned(q: torch.Tensor, q_strides) -> bool:
    """Each (b, h) row of q starts 16 bytes aligned, with a unit last
    stride: the kernels read it 16 bytes at a time."""
    per16 = 16 // q.element_size()
    return (q_strides[3] == 1 and q.data_ptr() % 16 == 0
            and q_strides[0] % per16 == 0 and q_strides[1] % per16 == 0)


def _query(q: torch.Tensor, B: int, H: int, D: int,
           dtype=torch.bfloat16) -> torch.Tensor:
    """q as ``dtype`` (B, H, 1, D) with 16-byte aligned rows (a view if it
    has them)."""
    if tuple(q.shape) != (B, H, 1, D):
        raise ValueError(f"q: needs {(B, H, 1, D)}, got {tuple(q.shape)}")
    q = q.to(dtype)
    return q if _q_aligned(q, q.stride()) else q.contiguous()


def _on_card(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("decode attention: operands on different devices")


# --------------------------------------------------------------------- #
# wrappers                                                               #
# --------------------------------------------------------------------- #


def _check_head_dim(D: int) -> None:
    if D != HEAD_DIM:
        raise ValueError(f"decode attention kernel needs d_kv {HEAD_DIM}, "
                         f"got {D}")


def _visible_keys(causal: bool, step, enc_len: int, L: int) -> int:
    """Keys the kernel reads: 0..step (causal) or 0..enc_len-1 (cross)."""
    if causal:
        if not 0 <= int(step) < L:
            raise ValueError(f"step {step} outside the cache length {L}")
        n_keys = int(step) + 1
    else:
        n_keys = L if enc_len <= 0 else int(enc_len)
        if n_keys > L:
            raise ValueError(f"enc_len {n_keys} > cache length {L}")
    if n_keys > MAX_KEYS:
        raise ValueError(f"decode attention kernel takes at most {MAX_KEYS} "
                         f"visible keys, got {n_keys}")
    return n_keys


def _pack_int8(k_entry: Entry, v_entry: Entry, n_keys: int, causal: bool,
               round_pv: bool, out: torch.Tensor):
    """Check int8 K/V buffers and their scales as the kernel reads them
    (16-byte rows through their strides, f32 scales at any stride) and pack
    the argument fields they fix; q, the fresh rows and the step's address
    are set per launch.  ``n_keys``: the visible keys (cross), or the keys
    a causal launch may see, which bounds its step and sizes its shared
    memory; the causal bias row holds key j of step s at column
    ``n_keys - s - 1 + j``.  ``out``'s dtype, bf16 or f32, picks the
    kernel's instance, and q must have the same."""
    k8, ks = k_entry
    v8, vs = v_entry
    _check_int8("k", k8, 4)
    _check_int8("v", v8, 4)
    B, H, L, D = k8.shape
    if tuple(v8.shape) != (B, H, L, D):
        raise ValueError(f"v: needs {(B, H, L, D)}, got {tuple(v8.shape)}")
    _check_f32("k scales", ks, (B, H, 1, L))
    _check_f32("v scales", vs, (B, H, 1, L))
    _on_card(k8, v8, ks, vs, out)
    return _Int8Args(
        k=k8.data_ptr(), v=v8.data_ptr(), ks=ks.data_ptr(), vs=vs.data_ptr(),
        out=out.data_ptr(),
        k_sb=k8.stride(0), k_sh=k8.stride(1), k_sl=k8.stride(2),
        v_sb=v8.stride(0), v_sh=v8.stride(1), v_sl=v8.stride(2),
        ks_sb=ks.stride(0), ks_sh=ks.stride(1), ks_sl=ks.stride(3),
        vs_sb=vs.stride(0), vs_sh=vs.stride(1), vs_sl=vs.stride(3),
        H=H, n_keys=n_keys, causal=int(causal),
        round_pv=int(round_pv), q_f32=int(out.dtype == torch.float32),
    )


def _launch_int8(args: int, pairs: int, q: torch.Tensor, q_strides,
                 fresh: tuple, step: int, stream: int) -> None:
    """One launch on a packed argument block (its address): the pointers
    of q, the fresh rows (k, v, k scale, v scale) and the step (an int32
    on the card, read by the kernel; 0 for cross attention)."""
    _build.check(_build.load().m2m_decode_attention_int8(
        args, pairs, q.data_ptr(), q_strides[0], q_strides[1], *fresh, step,
        stream), "m2m_decode_attention_int8")
    decode_attention_int8.launches += 1


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
    the TPU kernel's arithmetic.  A float32 q launches the f32 instance
    (q, ``p * vs`` and the output in f32); any other is taken as bf16.
    The kernel reads only the visible keys, through the operands'
    strides: keys 0..step (causal; key ``step`` from the fresh row) or
    0..enc_len-1 (cross), so a caller may pass a whole ``max_length``
    cache buffer.  ``bias`` is indexed by key position
    (``bias[h, j]`` for key j) and may be a strided view.  The host
    ``step`` is written to an int32 on the card, which the kernel reads
    (the decode loop's launch plan passes its own device step).  Every
    call checks and packs all of its operands; the decode loop calls the
    kernel through an ``Int8AttentionPlan``, which does that once a
    program."""
    if q.device.type != "cuda":
        return decode_attention_int8_plain(q, k_entry, v_entry, bias, step,
                                           new_k, new_v, causal, enc_len,
                                           round_pv)
    B, H, L, D = k_entry[0].shape
    _check_head_dim(D)
    n_keys = _visible_keys(causal, step, enc_len, L)
    dt = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
    out = torch.empty((B, H, 1, D), dtype=dt, device=q.device)
    a = _pack_int8(k_entry, v_entry, n_keys, causal, round_pv, out)
    qb = _query(q, B, H, D, dt)
    _on_card(qb, out)
    fresh, step_dev = (0, 0, 0, 0), None
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
        _on_card(q, b2, kn8, vn8, kns, vns)
        a.bias_sh, a.bias_sl = b2.stride()
        a.kn_sb, a.kn_sh = kn8.stride()[:2]
        a.vn_sb, a.vn_sh = vn8.stride()[:2]
        a.kns_sb, a.kns_sh = kns.stride()[:2]
        a.vns_sb, a.vns_sh = vns.stride()[:2]
        fresh = (kn8.data_ptr(), vn8.data_ptr(), kns.data_ptr(),
                 vns.data_ptr())
        a.bias = b2.data_ptr()  # n_keys = step + 1: key j at column j
        step_dev = torch.full((), n_keys - 1, dtype=torch.int32,
                              device=q.device)
    if B * H:
        _launch_int8(ctypes.addressof(a), B * H, qb, qb.stride(), fresh,
                     0 if step_dev is None else step_dev.data_ptr(),
                     torch.cuda.current_stream(q.device).cuda_stream)
    return out.to(q.dtype)


decode_attention_int8.launches = 0


class Int8AttentionPlan:
    """``decode_attention_int8`` over one generation's int8 caches, with
    what is fixed for the generation checked and packed once: each
    layer's self cache and cross-KV buffers (base pointers, strides, scale
    rows), the bias table, B, H, ``round_pv`` and ``dtype``, the query's
    and the output's (bfloat16, or float32 for the kernel's f32
    instance).

    ``decode_step`` calls ``causal(i, q, new_k, new_v, step)`` for layer
    i's self block (keys 0..step, key ``step`` from the fresh rows, the
    bias window ``bias_rows[:, L - step - 1:]``) and ``cross(i, q)`` for
    its cross block (keys < ``enc_len``).  ``step`` is a 0-d int32 tensor
    on the plan's device, whose address the launch takes: the kernel reads
    the step there, computes its visible keys and bias window from it, and
    writes NaN for a step outside the cache, so that a CUDA graph that
    captured the calls follows the step as the decode loop advances it.
    A host int is also taken (checked against the cache's length and
    written to a device scalar of the plan's).  The kernel's shared memory
    is sized once, for the cache's length.  On the card a call checks
    only what moves (q: (B, H, 1, D) of ``dtype`` with 16-byte aligned
    rows; the fresh rows: contiguous, as ``_quantize_kv`` makes them; the
    step's type and device), and makes one C call that sets q, the fresh
    rows and the step's address on the packed argument block and launches
    on the current stream.  The output goes to a buffer of the plan's,
    one per (layer, block), valid until that block is called again: the
    decode loop consumes it at once.  Nothing is read back and nothing
    allocated per call, so a CUDA graph captures the calls.  On CPU
    tensors a call runs the plain version over the views that
    ``decode_attention_int8`` would be given (the cache's first step + 1
    keys, the bias window), so the two agree bit for bit.  Launches count
    in ``decode_attention_int8.launches``.

    ``bias_rows`` is kept as it is given when it is float32 and
    contiguous (else as a float32 contiguous copy): a caller that owns
    such rows may refill them in place between generations."""

    def __init__(self, self_cache: list, bias_rows: torch.Tensor,
                 cross_layers: Optional[list] = None, enc_len: int = 0,
                 round_pv: bool = True, dtype=torch.bfloat16):
        if dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"launch plan: dtype must be bfloat16 or "
                             f"float32, got {dtype}")
        k8 = self_cache[0][0][0]
        B, H, L, D = k8.shape
        if L > MAX_KEYS:
            raise ValueError(f"decode attention kernel takes at most "
                             f"{MAX_KEYS} visible keys, the cache holds {L}")
        if bias_rows.dtype not in _BIAS_DTYPES or \
                tuple(bias_rows.shape) != (H, L):
            raise ValueError(f"bias rows: needs float32 or bfloat16 {(H, L)}, "
                             f"got {bias_rows.dtype} {tuple(bias_rows.shape)}")
        # float32 (exact from bf16), and contiguous, so that the kernel's
        # copies of a window's values are coalesced (the engine's rows are
        # a transposed view, keys 8 floats apart); no copy when they are
        bias_rows = bias_rows.float().contiguous()
        self.device, self.length, self.round_pv = k8.device, L, round_pv
        self.dtype = dtype
        self._self, self._cross = list(self_cache), list(cross_layers or [])
        self._bias_rows = bias_rows
        self._q_shape = (B, H, 1, D)
        row, scale = (self._q_shape, torch.int8), ((B, H, 1, 1), torch.float32)
        self._fresh = (row, row, scale, scale)  # k, v, k scale, v scale
        self.enc_len, Lc = 0, 0
        if self._cross:
            Lc = self._cross[0][0][0].shape[2]
            self.enc_len = _visible_keys(False, None, enc_len, Lc)

        def pack(layers, causal, n_keys, shape):
            outs = [torch.empty(self._q_shape, dtype=dtype,
                                device=self.device) for _ in layers]
            args = [_pack_int8(k, v, n_keys, causal, round_pv, o)
                    for (k, v), o in zip(layers, outs)]
            for a, (k, v) in zip(args, layers):
                if tuple(k[0].shape) != shape:
                    raise ValueError(f"every layer's cache needs {shape}, "
                                     f"got {tuple(k[0].shape)}")
                if causal:  # the fresh rows' layout, checked per call
                    a.kn_sb, a.kn_sh, a.kns_sb, a.kns_sh = H * D, D, H, 1
                    a.vn_sb, a.vn_sh, a.vns_sb, a.vns_sh = H * D, D, H, 1
                    a.bias = bias_rows.data_ptr()
                    a.bias_sh, a.bias_sl = bias_rows.stride()
            return outs, args

        self._self_out, self._self_args = pack(self._self, True, L,
                                               (B, H, L, D))
        self._cross_out, self._cross_args = pack(self._cross, False,
                                                 self.enc_len, (B, H, Lc, D))
        _on_card(k8, bias_rows)
        self._pairs = B * H
        if self.device.type == "cuda":
            _check_head_dim(D)
            self._index = self.device.index if self.device.index is not None \
                else torch.cuda.current_device()
            self._addr = {"self": [ctypes.addressof(a)
                                   for a in self._self_args],
                          "cross": [ctypes.addressof(a)
                                    for a in self._cross_args]}
            # where a host step is written for the kernel to read
            self._host_step = torch.zeros((), dtype=torch.int32,
                                          device=self.device)
            # the current stream's handle, read on every call (a capture
            # or a caller's stream context changes it); cheaper than
            # torch.cuda.current_stream, which builds a Stream object
            self._stream = torch._C._cuda_getCurrentRawStream
            _build.load()

    def _q_strides(self, q: torch.Tensor):
        sq = q.stride()
        if q.shape != self._q_shape or q.dtype != self.dtype or \
                not _q_aligned(q, sq) or q.get_device() != self._index:
            raise ValueError(f"q: needs {self.dtype} {self._q_shape} with "
                             f"16-byte aligned rows on {self.device}, got "
                             f"{q.dtype} {tuple(q.shape)} {sq} on {q.device}")
        return sq

    def _check_host_step(self, step: int) -> None:
        if not 0 <= step < self.length:
            raise ValueError(f"step {step} outside the cache length "
                             f"{self.length}")

    def causal(self, i: int, q: torch.Tensor, new_k: Entry, new_v: Entry,
               step) -> torch.Tensor:
        """Layer i's self block at ``step`` (a 0-d int32 tensor on the
        plan's device, or a host int) -> (B, H, 1, D) of ``dtype``."""
        if self.device.type != "cuda":
            n = int(step) + 1
            self._check_host_step(n - 1)
            (k8, ks), (v8, vs) = self._self[i]
            return decode_attention_int8_plain(
                q, (k8[:, :, :n], ks[..., :n]), (v8[:, :, :n], vs[..., :n]),
                self._bias_rows[:, self.length - n:], n - 1, new_k, new_v,
                True, 0, self.round_pv)
        if isinstance(step, torch.Tensor):
            if step.dtype != torch.int32 or step.numel() != 1 or \
                    step.get_device() != self._index:
                raise ValueError(f"step: needs a 0-d int32 tensor on "
                                 f"{self.device}, got {step.dtype} "
                                 f"{tuple(step.shape)} on {step.device}")
        else:
            self._check_host_step(int(step))
            self._host_step.fill_(int(step))
            step = self._host_step
        sq = self._q_strides(q)
        fresh = (new_k[0], new_v[0], new_k[1], new_v[1])
        ptrs = tuple(t.data_ptr() for t in fresh)
        for t, want, ptr in zip(fresh, self._fresh, ptrs):
            if (t.shape, t.dtype) != want or not t.is_contiguous() or \
                    ptr % 16 or t.get_device() != self._index:
                raise ValueError(f"fresh row: needs a contiguous, 16-byte "
                                 f"aligned {want} on {self.device}, got "
                                 f"{t.dtype} {tuple(t.shape)} {t.stride()}")
        _launch_int8(self._addr["self"][i], self._pairs, q, sq, ptrs,
                     step.data_ptr(), self._stream(self._index))
        return self._self_out[i]

    def cross(self, i: int, q: torch.Tensor) -> torch.Tensor:
        """Layer i's cross block -> (B, H, 1, D) of ``dtype``."""
        if self.device.type != "cuda":
            k, v = self._cross[i]
            return decode_attention_int8_plain(q, k, v, None, None, None,
                                               None, False, self.enc_len,
                                               self.round_pv)
        _launch_int8(self._addr["cross"][i], self._pairs, q,
                     self._q_strides(q), (0, 0, 0, 0), 0,
                     self._stream(self._index))
        return self._cross_out[i]


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
    _check_head_dim(D)
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
