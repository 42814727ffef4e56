"""Kind ``train_windows``: the port's ``make_train_step`` over host
batches of seeded song windows, as the loader hands them; the end-to-end
metric is ``train_windows_per_s``.

Set-up builds one training state (``trainable_model`` from the
configuration's weights, ``make_optimizer``) and drives it through the
first steps with the window's own call, one step on each batch so that
every label width is warm; the first three are the ones the reference
follows.  From them it keeps each step's loss, the gradient norms the
optimizer's state holds after step 1 (Adafactor at step 1 keeps the row
and column means of g^2 + 1e-30, beta2 being 0 there) and the parameters
after step 3.  The same state then steps on in the window, cycling over
the batches.  After the window the program is freed and the reference
repeats the three steps (``reference/judge.py``).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import generate
from benchmark.drive.common import TracedSlice, checkpoint_path, sync
from benchmark.reference import judge
from benchmark.reference import model as ref

CHECK_STEPS = 3


def ref_key(name: str) -> str:
    """The program's parameter name -> the npz key the reference reads."""
    return "/".join(f"#{p}" if p.isdigit() else p for p in name.split("."))


def _grad_norms(optimizer, model) -> Dict[str, float]:
    """Each leaf's gradient norm at step 1, from the optimizer's state
    (infinite for a leaf the optimizer holds no state for)."""
    out = {}
    for name, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        if "row" in st:
            sq = float(st["row"].double().sum()) * p.shape[-1]
        elif "v" in st:
            sq = float(st["v"].double().sum())
        else:
            out[name] = float("inf")
            continue
        out[name] = max(sq - 1e-30 * p.numel(), 0.0) ** 0.5
    return out


def _dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's dropout generator as the configuration states it."""
    word = np.random.SeedSequence((int(seed), int(step))).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word))


def run(root: Path, cell, seed: int, seconds: float, traced: bool,
        device, training_override: Optional[dict] = None) -> dict:
    from music2midi_tpu_torch.config import resolve_config
    from music2midi_tpu_torch.models.t5 import t5_config_from
    from music2midi_tpu_torch.ops.mel import log_mel_config_from
    from music2midi_tpu_torch.train.loop import (
        Batch, TrainState, make_optimizer, make_train_step, trainable_model)
    from music2midi_tpu_torch.weights import load_npz

    config, traffic = cell.config, cell.traffic
    training = {**config["training"], **(training_override or {})}
    # the configuration's intra-op pool (the train CLI leaves PyTorch's
    # default, a thread a core; see the configuration's ``why``)
    torch.set_num_threads(int(training["intra_op_threads"]))
    port_cfg = resolve_config(config["port_config"])
    sr = int(port_cfg.model.sample_rate)
    t_setup = time.perf_counter()
    cats = [len(v) for v in config["port_config"]["conditioning"].values()]
    job = generate.song_pool(traffic, seed, sr, cats, cell.pkg)
    torch.backends.cuda.matmul.allow_tf32 = bool(training["allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(training["allow_tf32"])
    sd, _ = load_npz(checkpoint_path(root, config))
    t5_cfg = t5_config_from(port_cfg, dtype=getattr(torch, training["dtype"]))
    model = trainable_model(sd, t5_cfg, device)
    state = TrainState(model, make_optimizer(model))
    step = make_train_step(t5_cfg, log_mel_config_from(port_cfg))
    batches = generate.train_batches(traffic, job.result(), seed, sr)
    host = [Batch(b.wave, b.labels, b.cond) for b in batches]

    losses, grad_norm = [], {}
    for k in range(max(CHECK_STEPS, len(host))):
        _, loss = step(state, host[k % len(host)], seed)
        if k < CHECK_STEPS:
            losses.append(float(loss))
        if k == 0:
            grad_norm = _grad_norms(state.optimizer, model)
        if k == CHECK_STEPS - 1:
            after = {n: p.detach().to("cpu", copy=True)
                     for n, p in model.named_parameters()}
    sync(device)
    setup_s = time.perf_counter() - t_setup

    done = max(CHECK_STEPS, len(host))
    real_lens = [[int(n) for n in (b.labels != -100).sum(1)] for b in batches]
    t0 = time.perf_counter()
    window_steps, window_losses = [], []
    while time.perf_counter() - t0 < seconds:
        k = done % len(host)
        _, loss = step(state, host[k], seed)
        window_steps.append(k)
        window_losses.append(loss)
        done += 1
    sync(device)
    window_s = time.perf_counter() - t0
    bad = int((~torch.isfinite(torch.stack(window_losses))).sum())

    out = {"setup_s": setup_s, "window_s": window_s,
           "e2e": {"train_windows_per_s":
                   len(window_steps) * int(traffic["batch"]) / window_s},
           "attempted": len(window_steps), "failed": bad}
    trace_info = None
    if traced:
        sliced = TracedSlice()
        n = int(cell.spec["trace"]["steps"])
        traced_steps = []
        with sliced.run(device):
            for _ in range(n):
                k = done % len(host)
                step(state, host[k], seed)
                traced_steps.append(k)
                done += 1
        trace_info = {"slice": sliced, "steps": traced_steps}
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    out["ctx"] = {"window_s": window_s, "steps": window_steps,
                  "label_lens": real_lens,
                  "enc_len": 1 + int(batches[0].wave.shape[1])
                  // int(config["mel"]["hop"]) + len(cats),
                  "model": config["model"],
                  "peak_flops": float(config["peak_flops"]),
                  "on_card": device.type == "cuda",
                  "trace": trace_info, "calls": []}
    del state, model, step
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = judge_train(root, cell, device,
                                [batches[k % len(batches)]
                                 for k in range(CHECK_STEPS)],
                                seed, losses, grad_norm, after)
    return out


def judge_train(root: Path, cell, device, batches, seed: int,
                losses: List[float], grad_norm: Dict[str, float],
                after: Dict[str, torch.Tensor]) -> Dict[str, dict]:
    """The program's three steps against the reference's."""
    limits = cell.spec["check"]["limits"]
    ref.strict_fp32()
    p = ref.load_params(checkpoint_path(root, cell.config), device)
    start = {k: v.clone() for k, v in p.items()}
    ref_batches = [{"wave": torch.from_numpy(b.wave).to(device),
                    "cond": torch.from_numpy(b.cond).long().to(device),
                    "labels": torch.from_numpy(b.labels).long().to(device)}
                   for b in batches]
    gens = [_dropout_generator(seed, k, device) for k in range(CHECK_STEPS)]
    want = judge.train_reference(p, cell.config["model"], cell.config["mel"],
                                 ref_batches, gens)
    got_grad = {ref_key(n): g for n, g in grad_norm.items()}
    got_change = {ref_key(n): float((v.to(device) - start[ref_key(n)]).norm())
                  for n, v in after.items()}
    leaves = sorted(want["grad_norm"])
    moving = judge.moving_leaves(want["grad_norm"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, want["loss"]))
    return {
        "loss_gap": {"value": loss_gap, "limit": limits["loss_gap"]},
        "grad_gap": {"value": judge.worst_leaf_gap(got_grad,
                                                   want["grad_norm"], leaves),
                     "limit": limits["grad_gap"]},
        "change_gap": {"value": judge.worst_leaf_gap(
            got_change, want["change_norm"], moving),
            "limit": limits["change_gap"]},
    }
