"""One rank of ``tests/test_torch_parallel.py``'s gloo process groups, and
the cases both sides run.

Run as ``python3 _torch_parallel_child.py SPEC_JSON`` with ``RANK`` and
``WORLD_SIZE`` in the environment: the rank joins the group through
``parallel.maybe_initialize_distributed`` (``file://`` store, CPU, gloo),
then, on each mesh ``SPEC["meshes"]`` names, runs the cases and writes
``OUT/<dp>x<tp>/rank<r>.json`` (+ ``.npz``: parameters gathered after the
steps on rank 0; the replicated parameters' gradients of step 1 on every
rank).  The test process
imports this module too and runs the same functions without a mesh, so
both sides are built by one piece of code.  Nothing here imports JAX.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from music2midi_tpu_torch.config import default_config
from music2midi_tpu_torch.infer import Music2MIDI
from music2midi_tpu_torch.models.t5 import init_params, t5_config_from
from music2midi_tpu_torch.ops.mel import LogMelConfig
from music2midi_tpu_torch.parallel import maybe_initialize_distributed
from music2midi_tpu_torch.parallel.distributed import shutdown
from music2midi_tpu_torch.parallel.mesh import (
    gather_params,
    make_mesh,
    param_pspecs,
    shard_params,
)
from music2midi_tpu_torch.train.checkpoint import save_train_state
from music2midi_tpu_torch.train.loop import (
    Batch,
    TrainState,
    make_optimizer,
    make_train_step,
    pad_labels,
    trainable_model,
)

MEL = LogMelConfig(n_fft=256, hop_length=128, n_mels=384)
LR = 0.05
ENGINE_MAX_LEN = 32


def tiny_config(dropout: float = 0.0):
    """2 + 2 layers, d_ff 128 (tests/_distributed_trainstep.py's sizes)."""
    return t5_config_from(default_config())._replace(
        num_layers=2, num_decoder_layers=2, d_ff=128, dropout_rate=dropout)


def train_batch() -> Batch:
    """tests/_distributed_trainstep.py's batch: 8 rows, the first four with
    7 labels and the last four with 4, so dp shards hold unequal token
    counts."""
    rng = np.random.default_rng(0)
    wave = (rng.normal(size=(8, 4096)) * 0.1).astype(np.float32)
    labels = pad_labels([np.array([140, 3, 60, 150, 4, 60, 2])] * 4
                        + [np.array([135, 3, 70, 2])] * 4)
    return Batch(wave, labels, np.zeros((8, 2), np.int32))


def engine_songs() -> list:
    """tests/test_decode_pipeline.py:199-201's song (3 chunks)."""
    rng = np.random.default_rng(11)
    return [(rng.normal(size=9 * 16000) * 0.2).astype(np.float32)]


def train(mesh=None, dropout: float = 0.0, steps: int = 2,
          ckpt_dir=None) -> dict:
    """``steps`` train steps from ``init_params(0)`` at a fixed lr ->
    {"losses", "params" (gathered), "grads" (step 1's, of the replicated
    parameters)}; with ``ckpt_dir``, the state after step 1 saved there."""
    cfg = tiny_config(dropout)
    full = {k: torch.from_numpy(v) for k, v in init_params(0, cfg).items()}
    model = trainable_model(full, cfg, "cpu", mesh)
    state = TrainState(model, make_optimizer(model, lr=LR))
    step_fn = make_train_step(cfg, MEL, mesh)
    specs = param_pspecs(full)
    losses, grads = [], {}
    for i in range(steps):
        state, loss = step_fn(state, train_batch(), seed=0)
        losses.append(float(loss))
        if i == 0:
            grads = {k: p.grad.numpy().copy()
                     for k, p in model.named_parameters() if specs[k] is None}
            if ckpt_dir is not None:
                save_train_state(ckpt_dir, state, mesh=mesh)
    params = gather_params(model.state_dict(), mesh)
    return {"losses": losses, "grads": grads,
            "params": {k: v.numpy() for k, v in params.items()}}


def engine(mesh=None) -> dict:
    """fp32 engine, random weights (seed 0), 32-token cap: generate_batch's
    notes and sample_tokens_batched's tokens on ``engine_songs``."""
    eng = Music2MIDI.from_random(seed=0, decode_max_length=ENGINE_MAX_LEN,
                                 device="cpu", mesh=mesh)
    songs = engine_songs()
    midis = eng.generate_batch(songs)
    notes = [[(n.start, n.end, n.pitch) for i in m.instruments
              for n in i.notes] for m in midis]
    tokens = eng.sample_tokens_batched(eng._chunk_waveform(songs[0]))
    return {"notes": notes, "tokens": [t.tolist() for t in tokens],
            "stats": eng.last_decode_stats}


def _write(out: Path, rank: int, result: dict, arrays: dict) -> None:
    out.mkdir(parents=True, exist_ok=True)
    (out / f"rank{rank}.json").write_text(json.dumps(result))
    np.savez(out / f"rank{rank}.npz", **arrays)


def main(spec: dict) -> None:
    torch.set_num_threads(1)
    info = maybe_initialize_distributed(
        device="cpu", init_method=f"file://{spec['store']}")
    assert info and info.backend == "gloo", info
    rank = info.rank
    for dp, tp in spec["meshes"]:
        mesh = make_mesh(dp, tp, "cpu")
        out = Path(spec["out"]) / f"{dp}x{tp}"
        full = {k: torch.from_numpy(v)
                for k, v in init_params(0, tiny_config()).items()}
        back = gather_params(shard_params(full, mesh), mesh)
        result = {"backend": info.backend, "device": str(info.device),
                  "roundtrip": all(torch.equal(back[k], full[k])
                                   for k in full)}
        arrays = {}
        ckpt = out / "ckpt" if [dp, tp] == spec.get("ckpt_mesh") else None
        runs = {"dropout0": train(mesh, ckpt_dir=ckpt)}
        if [dp, tp] == spec.get("dropout_mesh"):
            runs["dropout0.1"] = train(mesh, dropout=0.1)
        for name, run in runs.items():
            result[f"{name}/losses"] = run["losses"]
            if rank == 0:
                arrays.update({f"{name}/params/{k}": v
                               for k, v in run["params"].items()})
            arrays.update({f"{name}/grads/{k}": v
                           for k, v in run["grads"].items()})
        result["engine"] = engine(mesh)
        _write(out, rank, result, arrays)
    print(f"rank {rank}: ok", flush=True)


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
    shutdown()
