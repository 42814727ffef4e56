"""Greedy-token agreement of the port's engine on a (dp, tp) mesh with the
engine on one device, on ``chip_smoke.py``'s 180-s song.

bf16 rounding depends on a product's shape: splitting the batch over dp
gives each matmul other widths, and tp splits every projection, so bf16
tokens move where fp32 tokens do not.  This tool separates the causes.
For each mesh in (2, 1), (1, 2) and (2, 2) (ranks on the one card over
gloo, each a ``python3 -m torch.distributed.run`` process running this
file with ``--worker``) it reads, in bf16 and in fp32, the mesh engine's
agreement with one device on the whole batch, and with one device on the
same row groups (each dp rank's rows run as a batch of their own,
``group_tokens``): with tp = 1 the latter is the same
arithmetic, so it must be 1.0.  Needs a CUDA card; from the repo root:

    python3 tools/torch_mesh_agreement.py

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

MESHES = ((2, 1), (1, 2), (2, 2))
DTYPES = ("bfloat16", "float32")


def _proj_row_f64(x, w, dtype, group):
    """``models/t5.py::_proj_row`` with the partial products in float64
    (exact sums of bf16 products), rounded once after the tp sum."""
    from music2midi_tpu_torch.models import t5
    from music2midi_tpu_torch.parallel.mesh import reduce_from_tp_region

    if group is None:
        return t5._proj(x, w, dtype)
    y = torch_matmul64(x.to(dtype), w.to(dtype))
    return reduce_from_tp_region(y, group).to(dtype)


def torch_matmul64(a, b):
    import torch

    return torch.matmul(a.double(), b.double())


def worker(dp: int, tp: int, out: Path, variant: str = "") -> None:
    import torch

    from music2midi_tpu_torch.models import t5

    if variant == "f64":
        t5._proj_row = _proj_row_f64

    import chip_smoke as cs
    from music2midi_tpu_torch.infer import Music2MIDI
    from music2midi_tpu_torch.parallel import (
        make_mesh,
        maybe_initialize_distributed,
    )
    from music2midi_tpu_torch.parallel.distributed import shutdown

    torch.backends.cuda.matmul.allow_tf32 = False
    info = maybe_initialize_distributed(device="cuda")
    mesh = make_mesh(dp, tp, "cuda")
    song = cs.synthetic_song(180.0, 16000, seed=7)
    res = {}
    for name in DTYPES:
        eng = Music2MIDI.from_npz(cs.RECORD, dtype=getattr(torch, name),
                                  mesh=mesh)
        res[name] = [t.tolist() for t in
                     eng.sample_tokens_batched(eng._chunk_waveform(song))]
    if info.rank == 0:
        (out / f"{dp}x{tp}{variant}.json").write_text(json.dumps(res))
    shutdown()


def group_tokens(engine, chunks, dp: int) -> list:
    """One device's greedy tokens of ``chunks`` with the rows of each of
    ``dp`` ranks run as a batch of their own, as a (dp, tp) mesh groups
    them (bf16 rounding depends on a product's shape, so a batch split
    moves tokens with no parallelism at all): a list of EOS-trimmed
    rows, as ``sample_tokens_batched`` gives them."""
    batch, cond = engine._pad_batch(chunks)
    k = -(-len(batch) // dp)
    out = []
    for g in range(dp):
        rows = slice(g * k, (g + 1) * k)
        toks, lens = engine._encode_and_generate(batch[rows], cond[rows])
        out += [toks[i, :int(lens[i])].tolist() for i in range(len(toks))]
    return out[:len(chunks)]


def _agree(cs, a, b) -> float:
    same, total = cs.token_agreement(a, b)
    return same / total


def main() -> int:
    import torch

    import chip_smoke as cs
    from music2midi_tpu_torch.bench import card_name_and_power_limit
    from music2midi_tpu_torch.infer import Music2MIDI

    if not torch.cuda.is_available():
        print("torch_mesh_agreement: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_name_and_power_limit(), flush=True)
    song = cs.synthetic_song(180.0, 16000, seed=7)
    one = {}
    for name in DTYPES:
        eng = Music2MIDI.from_npz(cs.RECORD, dtype=getattr(torch, name))
        chunks = eng._chunk_waveform(song)
        one[name] = {dp: group_tokens(eng, chunks, dp) for dp in (1, 2)}
    # cuBLAS's bf16 products with reduced-precision split-K sums refused
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    eng = Music2MIDI.from_npz(cs.RECORD, dtype=torch.bfloat16)
    strict = group_tokens(eng, eng._chunk_waveform(song), 1)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    rows = {"one device bf16 vs fp32": _agree(cs, one["bfloat16"][1],
                                             one["float32"][1]),
            "one device bf16, reduced-precision split-K off vs on":
                _agree(cs, strict, one["bfloat16"][1])}
    with tempfile.TemporaryDirectory() as td:
        out = Path(td)
        for dp, tp, variant in [(*m, "") for m in MESHES] + [(1, 2, "f64")]:
            cs.torchrun(dp * tp, [__file__, "--worker", str(dp), str(tp),
                                  str(out), variant], ROOT, backend="gloo")
            mesh = json.loads((out / f"{dp}x{tp}{variant}.json").read_text())
            for name in DTYPES:
                whole = cs.token_agreement(mesh[name], one[name][1])
                groups = cs.token_agreement(mesh[name], one[name][dp])
                rows[f"{dp}x{tp}{variant} {name}"] = {
                    "vs_one_device_whole_batch": whole[0] / whole[1],
                    "vs_one_device_same_row_groups": groups[0] / groups[1],
                    "vs_one_device_fp32": _agree(
                        cs, mesh[name], one["float32"][1]),
                    "tokens": whole[1]}
    for name in DTYPES:
        a = cs.token_agreement(one[name][2], one[name][1])
        rows[f"one device, 2 row groups {name}"] = {
            "vs_one_device_whole_batch": a[0] / a[1], "tokens": a[1]}
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]),
               *sys.argv[5:6])
        sys.exit(0)
    sys.exit(main())
