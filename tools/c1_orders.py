"""The f32 summation orders of the plain decode-attention route on a CUDA
card, and kernel 3 held against that route bit for bit.

The plain route, ``models/t5.py::_attention_int8``, sums q . k (K = 64)
and p vs . v (K = the keys read) in cuBLAS's f32 matmul and the softmax
in ``torch.softmax``.  Their products are exact in f32 (bf16 times int8),
so each order is a sequence of f32 additions, which this script emulates
and holds against the library at the decode's shapes, printing the
share of outputs each order gives bit for bit.  The orders: one sum in
key order; S strided parts (keys i, i + S, ...) or S contiguous slices
of ceil(ceil(K / S) / m) * m keys, each summed in order, met by a
butterfly (the lane-0 result of an xor tree) or in turn.  Then kernel 3
(``Int8AttentionPlan`` over a 1024-key cache, bf16 with ``round_pv``, the
engine's route) against the plain route as ``decode_step`` runs it (the
phase's prefix of the cache, keys after the step masked): the share of
equal outputs and the largest difference, at causal steps and at cross
attention over 190 keys.  Needs a CUDA card; from the repo root:

    python3 tools/c1_orders.py

Prints the card's name and power limit, one line a shape, and writes
``chiprun_out/c1/orders.json``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEV = "cuda"
BH, D = 256, 64  # (b, h) rows of a sample, head dim
SHAPES = (1, 2, 5, 17, 32, 33, 63, 64, 65, 100, 127, 128, 129, 190, 200,
          255, 256, 300, 511, 512, 700, 1023, 1024)


def in_order(t: torch.Tensor) -> torch.Tensor:
    """((t0 + t1) + t2) + ... over the last dim, in f32."""
    acc = torch.zeros(t.shape[:-1], device=t.device)
    for k in range(t.shape[-1]):
        acc = acc + t[..., k]
    return acc


def butterfly(parts: torch.Tensor) -> torch.Tensor:
    """Lane 0's result of an xor tree over the last dim (a power of 2)."""
    off = parts.shape[-1] // 2
    while off >= 1:
        parts = parts + parts[..., torch.arange(parts.shape[-1],
                                                device=parts.device) ^ off]
        off //= 2
    return parts[..., 0]


def strided(t: torch.Tensor, s: int) -> torch.Tensor:
    """S parts: keys i, i + S, ... of each, in order."""
    return torch.stack([in_order(t[..., i::s]) for i in range(s)], -1)


def sliced(t: torch.Tensor, s: int, m: int) -> torch.Tensor:
    """S contiguous slices of ceil(ceil(K / S) / m) * m keys, in order."""
    K = t.shape[-1]
    size = -(-(-(-K // s)) // m) * m
    zero = torch.zeros(t.shape[:-1], device=t.device)
    return torch.stack([in_order(t[..., i * size:(i + 1) * size])
                        if i * size < K else zero for i in range(s)], -1)


def candidates(t: torch.Tensor, max_parts: int) -> dict:
    """Every emulated order of the sum over t's last dim."""
    out = {"in order": in_order(t)}
    s = 2
    while s <= max_parts:
        parts = {f"strided {s}": strided(t, s)}
        for m in (1, 8, 32):
            parts[f"slices {s} of m{m}"] = sliced(t, s, m)
        for name, p in parts.items():
            out[f"{name} + tree"] = butterfly(p)
            out[f"{name} + in turn"] = in_order(p)
        s *= 2
    return out


def shares(cands: dict, ref: torch.Tensor) -> dict:
    return {k: round(float((v == ref).float().mean()), 4)
            for k, v in cands.items()}


def orders(gen: torch.Generator) -> dict:
    """The library against each emulated order, share of equal outputs."""
    res = {"scores": {}, "pv": {}, "softmax": {}}
    for n in SHAPES:
        q = torch.randn(BH, 1, D, generator=gen, device=DEV).to(
            torch.bfloat16).float()
        k8 = torch.randint(-127, 128, (BH, n, D), generator=gen,
                           device=DEV).float()
        ref = torch.matmul(q, k8.transpose(-1, -2))[:, 0, :]
        res["scores"][n] = shares(candidates(q[:, 0, None, :] * k8, 64), ref)
        # torch.softmax: lane i of a warp of W = min(32, 2^ceil(log2 n))
        # adds keys i, i + W, ..., the lanes meet by a butterfly
        x = ref * 0.01 + torch.randn(BH, n, generator=gen, device=DEV)
        e = torch.exp(x - x.amax(-1, keepdim=True))
        w = min(1 << max(0, (n - 1).bit_length()), 32)
        total = butterfly(strided(e, w)) if w > 1 else e[:, 0]
        res["softmax"][n] = float(
            (e / total[:, None] == torch.softmax(x, -1)).float().mean())
        p = torch.softmax(torch.randn(BH, n, generator=gen, device=DEV) * 3,
                          -1)
        pv = (p * torch.rand(BH, n, generator=gen, device=DEV)
              * 0.05).to(torch.bfloat16).float()
        v8 = torch.randint(-127, 128, (BH, n, D), generator=gen,
                           device=DEV).float()
        ref = torch.matmul(pv[:, None, :], v8)[:, 0, :]
        res["pv"][n] = shares(candidates(
            (pv[:, :, None] * v8).transpose(1, 2), 64), ref)
        best = {part: max(res[part][n].items(), key=lambda kv: kv[1])
                for part in ("scores", "pv")}
        print(f"K/N {n}: scores {best['scores']} pv {best['pv']} softmax "
              f"{res['softmax'][n]}", flush=True)
    return res


def kernel_vs_plain(gen: torch.Generator) -> dict:
    """Kernel 3 through its launch plan against the plain route of
    ``decode_step``, on seeded inputs at the serving shapes."""
    from music2midi_tpu_torch.infer.decode import _phase_lengths
    from music2midi_tpu_torch.models.t5 import _attention_int8, _quantize_kv
    from music2midi_tpu_torch.ops import decode_attention as da

    B, H, L = 64, 8, 1024

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=DEV)

    k, v = _quantize_kv(normal(B, H, L, D)), _quantize_kv(normal(B, H, L, D))
    rows = normal(H, L)
    q = normal(B, H, 1, D).to(torch.bfloat16)
    plan = da.Int8AttentionPlan([(k, v)], rows, [(k, v)], enc_len=190,
                                round_pv=True)
    phases = _phase_lengths(L, True)
    out = {}

    def compare(what, got, ref):
        torch.cuda.synchronize()
        out[what] = [round(float((got == ref).float().mean()), 6),
                     float((got.float() - ref.float()).abs().max())]

    for step in (0, 10, 31, 62, 63, 100, 126, 127, 200, 300, 510, 511, 700,
                 1022, 1023):
        c = next(p for p in phases if step < p - 1 or p == phases[-1])
        keys = torch.arange(c, device=DEV)
        cols = (keys + (L - 1) - step).clamp(max=L - 1)
        ref = _attention_int8(q, (k[0][:, :, :c], k[1][..., :c]),
                              (v[0][:, :, :c], v[1][..., :c]),
                              rows[:, cols][None, :, None, :],
                              (keys <= step)[None, None, None, :],
                              torch.bfloat16)
        fresh = [(e[0][:, :, step:step + 1].contiguous(),
                  e[1][..., step:step + 1].contiguous()) for e in (k, v)]
        got = plan.causal(0, q, *fresh, torch.full(
            (), step, dtype=torch.int32, device=DEV))
        compare(f"causal step {step} (prefix {c})", got, ref)
    compare("cross 190", plan.cross(0, q), _attention_int8(
        q, (k[0][:, :, :190], k[1][..., :190]),
        (v[0][:, :, :190], v[1][..., :190]), None, None, torch.bfloat16))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("c1_orders: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    res = orders(torch.Generator(device=DEV).manual_seed(0))
    res["kernel_vs_plain"] = kernel_vs_plain(
        torch.Generator(device=DEV).manual_seed(1))
    for what, (share, err) in res["kernel_vs_plain"].items():
        print(f"kernel 3 vs plain {what}: equal {share} max |diff| {err}",
              flush=True)
    out = ROOT / "chiprun_out" / "c1"
    out.mkdir(parents=True, exist_ok=True)
    (out / "orders.json").write_text(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
