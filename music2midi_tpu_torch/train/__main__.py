"""Training CLI of the port:
``python3 -m music2midi_tpu_torch.train DATA_DIR [--name --config --ckpt]``.

Port of the repository's root ``train.py`` (the reference's Lightning
trainer, reference train.py:17-41), on one device or on a ``(dp, tp)``
mesh of ranks: HF-default Adafactor
with relative-step warmup (``--lr`` fixes it), gradient accumulation
(``trainer.accumulate_grad_batches``), checkpoints with the config
embedded (``OUT_DIR/NAME/ckpt``, the last 3 kept, and ``ckpt_best`` by
validation loss, its bar in ``ckpt_best/best_val.json``), validation and
a checkpoint at epoch ends (at most once per ``max(steps per epoch,
log_every_n_steps)`` steps), ``log.jsonl`` + stdout logging (wandb
attaches when it is installed), and ``--eval_in_train``'s chroma score
of the training batch at each log step (reference model.py:40-42).

It runs on ``cuda`` unless ``--device cpu`` is given, and never falls
back to the CPU.  ``--config`` takes a YAML config, such as the training
recipes ``configs/synth16k_aug_r5.yaml`` and its siblings, or JSON, such
as an npz's ``__config__`` (``config.load_config``); default the
repository's ``config.yaml``.  ``--init_from`` warm-starts the parameters
from any checkpoint ``weights.py::restore_params`` reads (the model
of record's npz and a JAX run's orbax directories among them), floating
leaves cast to float32 masters; ``--ckpt`` resumes the whole training
state, of the port's trainer or of the JAX trainer (a step dir or a
training root of either; ``train/checkpoint.py``).

Several ranks: ``python3 -m torch.distributed.run --nproc_per_node N -m
music2midi_tpu_torch.train DATA_DIR --tp T`` (``M2M_DIST_BACKEND=gloo``
for ranks that share a card; ``parallel/distributed.py``).  The mesh is
``(dp, tp)`` with dp = N / T, and the batch must divide by dp.  Every
rank builds the same loader from the same seed and keeps its dp rows of
each batch (``train/loop.py``), so the run follows the one-device
trajectory; rank 0 alone writes ``log.jsonl``, the stdout log and the
checkpoints, which are the one-device format (``--ckpt`` resumes under
any mesh).  ``--tp 1`` in one process is the one-device run.
"""

from __future__ import annotations

import argparse
import json
import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from ..config import resolve_config
from ..data import DataLoader, Music2MIDIDataset
from ..evaluation import evaluate_batch as chroma
from ..infer.decode import DecodeConfig, generate_tokens
from ..infer.pipeline import resolve_device
from ..models.t5 import (
    conditioning_prepend,
    encode,
    init_params,
    t5_config_from,
)
from ..ops.mel import log_mel_config_from, log_mel_spectrogram
from ..parallel import distributed
from ..parallel.mesh import local_config, make_mesh
from ..tokenizer import MidiTokenizer
from ..utils import numpy_to_midi
from .adafactor import MultiSteps
from .checkpoint import restore_params, restore_train_state, save_train_state
from .loop import (
    TrainState,
    make_eval_step,
    make_optimizer,
    make_train_step,
    to_device,
    trainable_model,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python3 -m music2midi_tpu_torch.train",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("data_dir", type=str)
    parser.add_argument(
        "--name", type=str,
        default=datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
        help="name of the run",
    )
    parser.add_argument("--config", type=str, default=None,
                        help="config file, YAML or JSON (default: the "
                             "repository's config.yaml)")
    parser.add_argument(
        "--ckpt", type=str, default=None,
        help="checkpoint dir to resume training (a step dir or a "
             "training root of the port's or the JAX trainer)",
    )
    parser.add_argument(
        "--init_from", type=str, default=None,
        help="warm-start fine-tuning: initialize PARAMS from any "
             "checkpoint (npz export / save_params dir / training "
             "ckpt) with a fresh optimizer and step 0 — unlike --ckpt, "
             "which resumes the full training state",
    )
    parser.add_argument(
        "--run_id", type=str, default=None,
        help="wandb run id to resume (when wandb is installed)",
    )
    parser.add_argument("--out_dir", type=str, default="runs")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--tp", type=int, default=1,
        help="tensor-parallel degree: ranks that split each model "
             "(dp = ranks / tp)",
    )
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument(
        "--lr", type=float, default=None,
        help="fixed Adafactor lr (default: HF relative-step warmup "
             "schedule, the reference configuration)",
    )
    parser.add_argument("--eval_in_train", action="store_true",
                        help="chroma score on train batches every "
                             "log_every_n_steps (reference behavior)")
    parser.add_argument(
        "--steps_per_dispatch", type=int, default=1,
        help="steps per log line: the loss logs once a group of K "
             "steps (JAX scans such a group in one dispatch; the port "
             "steps eagerly, on the same trajectory)",
    )
    parser.add_argument(
        "--dtype", type=str, default="float32",
        choices=["float32", "bfloat16"],
        help="model compute dtype.  bfloat16 = mixed precision: matmuls "
             "and activations in bf16, parameters / gradients / Adafactor "
             "state and layer-norm + loss math stay fp32.  float32 is the "
             "reference-parity configuration",
    )
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu for smoke "
                             "runs)")
    return parser.parse_args(argv)


@torch.no_grad()
def evaluate_training_batch(model, batch, t5_cfg, mel_cfg, tokenizer,
                            notes_batch) -> float:
    """Greedy-decode the training batch and chroma-score it (reference
    model.py:55-65: max_length = 4 * max notes)."""
    max_notes = max(len(n) for n in notes_batch)
    max_len = min(1024, max(8, max_notes * 4))
    dev = to_device(batch, model.shared_embedding.device)
    mel = log_mel_spectrogram(dev.waveform, mel_cfg)
    enc = encode(model, conditioning_prepend(model, mel, dev.cond_index),
                 t5_cfg)
    tokens, _ = generate_tokens(model, enc, t5_cfg,
                                DecodeConfig(max_length=max_len))
    decoded = tokenizer.decode(list(tokens.cpu().numpy()), mode="batched")
    label_midi = [numpy_to_midi(n) for n in notes_batch]
    out_midi = [numpy_to_midi(n) for n in decoded]
    return chroma(label_midi, out_midi)


def _notes_from_labels(labels, tokenizer):
    out = []
    for row in np.asarray(labels):
        toks = row[row != -100]
        out.append(tokenizer.decode([toks])[0])
    return out


def _mesh(args, batch_size: int):
    """-> (mesh or None, device, rank): the process group and its (dp, tp)
    mesh when launched as ranks, else one device."""
    info = distributed.maybe_initialize(device=args.device)
    if not info:
        if args.tp != 1:
            raise SystemExit(f"--tp {args.tp} needs {args.tp} ranks: launch "
                             "with python3 -m torch.distributed.run")
        return None, resolve_device(args.device), 0
    print(f"rank {info.rank}/{info.world_size}: backend {info.backend} "
          f"device {info.device}", flush=True)
    if args.tp < 1 or info.world_size % args.tp:
        raise SystemExit(f"--tp {args.tp} does not divide "
                         f"{info.world_size} ranks")
    dp = info.world_size // args.tp
    if batch_size % dp:
        raise SystemExit(f"batch {batch_size} does not divide over "
                         f"dp = {dp}")
    return make_mesh(dp, args.tp, info.device.type), info.device, info.rank


def main(argv=None) -> None:
    args = parse_args(argv)
    try:
        _main(args)
    finally:
        distributed.shutdown()


def _main(args) -> None:
    config = resolve_config(args.config)
    mesh, device, rank = _mesh(args, int(config.dataloader.batch_size))
    data_dir = Path(args.data_dir)
    split = np.load(data_dir / "dataset_split.npz", allow_pickle=True)
    train_set = Music2MIDIDataset(data_dir, split["train_id"], config)
    val_set = Music2MIDIDataset(data_dir, split["val_id"], config)
    dl_cfg = config.dataloader
    train_loader = DataLoader(
        train_set, batch_size=int(dl_cfg.batch_size),
        num_workers=int(dl_cfg.num_workers), shuffle=True, seed=args.seed,
    )
    val_loader = DataLoader(
        val_set, batch_size=int(dl_cfg.batch_size),
        num_workers=int(dl_cfg.num_workers), shuffle=False, seed=args.seed,
        # validation must see every sample: drop_last would yield no batch
        # when the val split is smaller than one (Lightning never drops)
        drop_last=False,
    )

    t5_cfg = t5_config_from(
        config, dtype={"float32": torch.float32,
                       "bfloat16": torch.bfloat16}[args.dtype])
    mel_cfg = log_mel_config_from(config)
    tokenizer = MidiTokenizer(config)
    num_cond = tuple(len(v) for v in config.conditioning.values())
    if args.init_from:
        # warm start: PARAMS ONLY; optimizer state and step start fresh —
        # fine-tuning, not a resume (--ckpt is the resume path)
        params, ck_cfg = restore_params(args.init_from)
        if ck_cfg is not None:
            # dtype is a run-time choice, not an architecture field
            theirs = t5_config_from(ck_cfg, dtype=t5_cfg.dtype)
            if theirs != t5_cfg:
                raise SystemExit(
                    f"--init_from architecture mismatch: checkpoint has "
                    f"{theirs}, --config builds {t5_cfg}"
                )
        if rank == 0:
            print(f"warm start: params from {args.init_from}")
    else:
        params = {k: torch.from_numpy(v) for k, v in
                  init_params(args.seed, t5_cfg, num_cond).items()}
    model = trainable_model(params, t5_cfg, device, mesh)

    optimizer = make_optimizer(model, lr=args.lr)
    accum = int(config.trainer.accumulate_grad_batches)
    if accum > 1:
        optimizer = MultiSteps(optimizer, accum)
    state = TrainState(model, optimizer)
    if args.ckpt:
        state, _ = restore_train_state(args.ckpt, state, mesh)
        if rank == 0:
            print(f"resumed from {args.ckpt} at step {state.step}")

    out_dir = Path(args.out_dir) / args.name.replace(" ", "_").replace(
        ":", "-")
    if rank != 0:  # rank 0 alone writes
        _train(args, config, state, train_loader, val_loader, t5_cfg,
               mel_cfg, tokenizer, out_dir, lambda record: None, mesh)
        return
    out_dir.mkdir(parents=True, exist_ok=True)

    wandb_run = None
    try:  # optional wandb (reference train.py:36-39)
        import wandb

        wandb_run = wandb.init(
            project="music2midi", name=args.name, id=args.run_id,
            config=config.to_dict(), resume="allow",
        )
    except Exception:
        pass

    with open(out_dir / "log.jsonl", "a") as log_file:

        def log(record: dict):
            record["time"] = time.time()
            log_file.write(json.dumps(record) + "\n")
            log_file.flush()
            if wandb_run is not None:
                wandb_run.log(record, step=record.get("step"))
            print({k: v for k, v in record.items() if k != "time"},
                  flush=True)

        _train(args, config, state, train_loader, val_loader, t5_cfg,
               mel_cfg, tokenizer, out_dir, log, mesh)


def _train(args, config, state, train_loader, val_loader, t5_cfg, mel_cfg,
           tokenizer, out_dir: Path, log, mesh=None) -> None:
    """The loop of ``main``: steps, logs, validation and checkpoints.  On a
    ``mesh`` every rank runs it (the steps, validation and saves hold
    collectives); ``log`` writes on rank 0 only, as do the saves."""
    step_fn = make_train_step(t5_cfg, mel_cfg, mesh)
    eval_fn = make_eval_step(t5_cfg, mel_cfg, mesh)
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    log_every = int(config.trainer.log_every_n_steps)
    max_epochs = int(config.trainer.max_epochs)
    steps_per_epoch = max(1, len(train_loader))
    min_steps_between_saves = max(steps_per_epoch, log_every)
    step = state.step
    run_start_step = step
    last_saved = step
    t_start = time.time()

    # best-val checkpoint selection: out_dir/ckpt is always the LATEST
    # state (the resume target); out_dir/ckpt_best tracks the lowest val
    # loss across the run and its --ckpt resumes (the bar persists in
    # best_val.json, so a resumed run's first validation does not win
    # unconditionally)
    best_val = float("inf")
    best_val_file = out_dir / "ckpt_best" / "best_val.json"
    if args.ckpt and best_val_file.exists():  # every rank reads the bar
        try:
            best_val = float(json.loads(
                best_val_file.read_text())["val_loss"])
            if rank0:
                print(f"resumed best-val bar: {best_val:.6f}")
        except (ValueError, KeyError, TypeError) as e:
            if rank0:
                print(f"ignoring unreadable {best_val_file}: {e!r}")

    def run_val(epoch=None):
        nonlocal best_val
        vals = [float(eval_fn(state.model, b)) for b in val_loader]
        if vals:
            mean = float(np.mean(vals))
            rec = {"step": step, "val/loss": mean}
            if epoch is not None:
                rec["epoch"] = epoch
            if mean < best_val:
                best_val = mean
                save_train_state(out_dir / "ckpt_best", state, config,
                                 mesh=mesh)
                if rank0:
                    best_val_file.write_text(json.dumps(
                        {"val_loss": mean, "step": step}))
                rec["val/is_best"] = True
            log(rec)

    def save_ckpt():
        save_train_state(out_dir / "ckpt", state, config, mesh=mesh)

    def score(batch) -> float:
        # every rank decodes the whole batch; its tp group in step
        return evaluate_training_batch(
            state.model, batch, local_config(t5_cfg, mesh), mel_cfg,
            tokenizer, _notes_from_labels(batch.labels, tokenizer))

    # --steps_per_dispatch K: JAX scans K steps in one dispatch and logs
    # once a group; eager PyTorch launches step by step, so the port takes
    # the same per-step trajectory and only groups the log lines (the
    # group's last loss, ``dispatch_steps`` its size)
    K = max(1, args.steps_per_dispatch)
    in_group = 0
    epoch = loss = batch = None

    def log_train():
        rec = {
            "step": step, "epoch": epoch, "train/loss": float(loss),
            # steps THIS RUN over elapsed (a --ckpt resume starts above 0)
            "steps_per_sec": (step - run_start_step) / max(
                1e-9, time.time() - t_start),
        }
        if K > 1:
            rec["dispatch_steps"] = in_group
        if args.eval_in_train:
            rec["train/score"] = score(batch)
        log(rec)

    stop = False
    for epoch in range(max_epochs):
        for batch in train_loader:
            _, loss = step_fn(state, batch, args.seed)
            step += 1
            in_group += 1
            if step == run_start_step + 1 and rank0:
                print(f"first step done in {time.time() - t_start:.1f}s",
                      flush=True)
            stop = bool(args.max_steps and step >= args.max_steps)
            due = (in_group == K or stop) if K > 1 else (
                step % log_every == 0)
            if due:
                log_train()
                in_group = 0
            if stop:
                break
        if stop:
            break
        # validation + checkpoint at epoch ends (reference cadence),
        # throttled so tiny datasets do not spend the run saving
        if step - last_saved >= min_steps_between_saves:
            run_val(epoch)
            save_ckpt()
            last_saved = step
    if K > 1 and in_group:
        log_train()  # the epochs ran out inside a group
    # final save: the closing val pass scores the final params (and seeds
    # ckpt_best on short runs that never crossed an epoch boundary)
    if step > last_saved:
        run_val()
        save_ckpt()
    log({"step": step, "done": True})


if __name__ == "__main__":
    main()
