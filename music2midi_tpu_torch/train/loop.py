"""The training step.

Port of ``music2midi_tpu/train/loop.py`` (the reference's Lightning
``training_step`` / ``validation_step``, music2midi/model.py:32-53):
waveform batch -> fp32 log-mel (no grad: the front end has no learned
parameters) -> conditioning prepend -> ``t5_forward`` with -100-masked
labels -> cross entropy -> backward -> Adafactor.

The JAX step is one jitted program over an immutable ``TrainState``; here
``TrainState`` holds the model (float32 master parameters that require
grad; ``T5Config.dtype`` bfloat16 is mixed precision, each projection
casting its weight), the optimizer and the step, and a step updates them
in place.  The mel is the plain FFT mel of ``ops/mel.py``, as the JAX
trainer calls ``ops/mel.py::log_mel_spectrogram`` and never the serving
kernel.

Dropout draws from a ``torch.Generator`` on the model's device seeded from
``(seed, step)`` (``dropout_generator``), as the JAX step folds the step
into its key: a run resumed at step k draws the masks of an unbroken run.
Gradient accumulation is ``adafactor.MultiSteps`` around the optimizer
(``optax.MultiSteps``); ``step`` counts micro-batches, as in JAX.

On a ``(dp, tp)`` mesh (``parallel/mesh.py``) every rank is given the
global batch and keeps its dp rows; the model is the rank's tp shard
(``trainable_model(..., mesh)``).  The JAX mesh's step is one program
whose loss is the token mean over the global batch; here each rank
divides its token sum by the global batch's valid-token count (an
all-reduce over dp), so the dp ranks' losses sum to that mean and their
gradients SUM to its gradient.  DDP's wrapper cannot do this (the
forward is ``t5_forward`` on the module's parameters, never
``module.forward``, so its reducer never arms); ``reduce_gradients`` sums
every gradient over dp in one all-reduce of a flat float32 buffer, as
the JAX step emits one psum, after the relative-bias tables' gradients
are summed over tp (a tp rank reads only its heads' columns).  Each rank
draws every dropout mask at its full shape from the step's generator and
keeps its part (``models/t5.py::MaskShard``), so a sharded step is the
one-device step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..models.t5 import (
    MaskShard,
    T5Config,
    T5Model,
    conditioning_prepend,
    t5_forward,
)
from ..ops.mel import LogMelConfig, log_mel_spectrogram
from ..parallel.mesh import (
    axis_group,
    axis_rank,
    axis_size,
    batch_sharding,
    batch_slice,
    local_config,
    param_pspecs,
    shard_params,
    split_dim,
)
from .adafactor import Adafactor


class Batch(NamedTuple):
    """One batch, numpy on the host or tensors on the device.  Labels are
    tokenized on the host (reference transformer.py:29-31), padded with
    -100 (loss-ignored)."""

    waveform: Union[np.ndarray, torch.Tensor]  # (B, S) f32 at the model rate
    labels: Union[np.ndarray, torch.Tensor]  # (B, L) int, -100 = ignore
    cond_index: Union[np.ndarray, torch.Tensor]  # (B, n_cond) int


@dataclass
class TrainState:
    model: T5Model  # float32 master parameters, requires_grad
    optimizer: object  # adafactor.Adafactor or adafactor.MultiSteps
    step: int = 0


def trainable_model(state_dict: Dict[str, torch.Tensor], cfg: T5Config,
                    device, mesh=None) -> T5Model:
    """A T5Model for training on ``device``: floating leaves cast to
    float32 masters that require grad, integer leaves kept as they are.
    On a ``mesh``, this rank's tp shard of the full ``state_dict`` at the
    local config of the full ``cfg``."""
    sd = {k: v.float() if v.is_floating_point() else v
          for k, v in shard_params(state_dict, mesh).items()}
    model = T5Model.from_state_dict(sd, local_config(cfg, mesh),
                                    axis_group(mesh, "tp")).to(device)
    for p in model.parameters():
        p.requires_grad_(p.is_floating_point())
    return model


def make_optimizer(model: T5Model, lr: Optional[float] = None,
                   warmup_init: bool = True) -> Adafactor:
    """HF-default Adafactor over the model's trainable parameters; for a
    tp shard with the tp group and each parameter's split dim, so that
    its statistics span the whole matrices."""
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    specs = param_pspecs(names)
    params = dict(model.named_parameters())
    return Adafactor([params[n] for n in names], lr=lr,
                     warmup_init=warmup_init, tp_group=model.tp_group,
                     split_dims=[split_dim(specs[n]) for n in names])


def to_device(batch: Batch, device) -> Batch:
    """Host (or device) batch -> float32 wave and int64 labels and
    conditioning on ``device``."""
    return Batch(
        torch.as_tensor(batch.waveform, dtype=torch.float32).to(device),
        torch.as_tensor(batch.labels).long().to(device),
        torch.as_tensor(batch.cond_index).long().to(device),
    )


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of step ``step`` of a run seeded ``seed``:
    seeded with the first 64-bit word of ``SeedSequence((seed, step))``."""
    word = np.random.SeedSequence((int(seed), int(step))).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word))


def _loss(model: T5Model, batch: Batch, generator, t5_cfg: T5Config,
          mel_cfg: LogMelConfig, deterministic: bool,
          dp_group=None) -> torch.Tensor:
    """The batch's loss; with a ``dp_group``, this rank's token sum over
    the global batch's valid-token count."""
    count = None
    if dp_group is not None:
        count = (batch.labels != -100).sum()
        dist.all_reduce(count, group=dp_group)
    with torch.no_grad():
        mel = log_mel_spectrogram(batch.waveform, mel_cfg)
    embeds = conditioning_prepend(model, mel, batch.cond_index)
    loss, _ = t5_forward(model, embeds, batch.labels, t5_cfg,
                         deterministic=deterministic, generator=generator,
                         token_count=count)
    return loss


def _device(state: TrainState) -> torch.device:
    return state.model.shared_embedding.device


def reduce_gradients(model: T5Model, mesh=None) -> None:
    """The sharded step's gradient collectives, in place: the relative-bias
    tables' gradients summed over tp, then every gradient summed over dp
    in one all-reduce of a flat float32 buffer.  Nothing without a
    mesh."""
    tp = model.tp_group
    if tp is not None:
        _sum_grads([model.encoder.rel_bias, model.decoder.rel_bias], tp)
    dp = axis_group(mesh, "dp")
    if dp is not None:
        _sum_grads([p for p in model.parameters() if p.grad is not None], dp)


def _sum_grads(params, group) -> None:
    flat = torch.cat([p.grad.float().reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


def _local_batch(batch: Batch, mesh, t5_cfg: T5Config, seed: int, step: int,
                 dev) -> Tuple[Batch, object]:
    """(this rank's rows of the global batch on ``dev``, the step's dropout
    source: None, its generator, or on a mesh a ``MaskShard`` of it)."""
    gen = (dropout_generator(seed, step, dev)
           if t5_cfg.dropout_rate > 0.0 else None)
    if mesh is None:
        return to_device(batch, dev), gen
    n = len(batch.waveform)
    if gen is not None:
        gen = MaskShard(gen, batch_slice(mesh, n), n, axis_rank(mesh, "tp"),
                        axis_size(mesh, "tp"))
    rows = batch_sharding(mesh)
    return to_device(Batch(*(rows.local(leaf) for leaf in batch)), dev), gen


def make_train_step(t5_cfg: T5Config, mel_cfg: LogMelConfig, mesh=None):
    """-> (state, batch, seed) -> (state, loss): one step, in place.  On a
    ``mesh`` (``t5_cfg`` the full config, the state's model a rank's
    shard), ``batch`` is the global batch and the loss is its mean, the
    same on every rank."""
    cfg = local_config(t5_cfg, mesh)
    dp = axis_group(mesh, "dp")

    def train_step(state: TrainState, batch: Batch,
                   seed: int = 0) -> Tuple[TrainState, torch.Tensor]:
        dev = _device(state)
        batch, gen = _local_batch(batch, mesh, cfg, seed, state.step, dev)
        state.optimizer.zero_grad(set_to_none=True)
        loss = _loss(state.model, batch, gen, cfg, mel_cfg, False, dp)
        loss.backward()
        reduce_gradients(state.model, mesh)
        state.optimizer.step()
        state.step += 1
        loss = loss.detach()
        if dp is not None:
            dist.all_reduce(loss, group=dp)
        return state, loss

    return train_step


def make_multi_step(t5_cfg: T5Config, mel_cfg: LogMelConfig, mesh=None):
    """-> (state, stacked_batches, seed) -> (state, losses (K,)): K steps
    over a Batch whose leaves carry a leading step axis, with
    ``train_step``'s exact trajectory (the JAX package's ``lax.scan``,
    here a loop)."""
    train_step = make_train_step(t5_cfg, mel_cfg, mesh)

    def multi_step(state: TrainState, batches: Batch,
                   seed: int = 0) -> Tuple[TrainState, torch.Tensor]:
        losses = []
        for k in range(len(batches.waveform)):
            state, loss = train_step(
                state, Batch(*(leaf[k] for leaf in batches)), seed)
            losses.append(loss)
        return state, torch.stack(losses)

    return multi_step


def make_eval_step(t5_cfg: T5Config, mel_cfg: LogMelConfig, mesh=None):
    """-> (model, batch) -> loss, deterministic and without grad; on a
    ``mesh`` as ``make_train_step``'s (the global batch's loss, on every
    rank), and a batch whose rows do not split over dp (a validation
    split's last batch) is run whole on every rank."""
    cfg = local_config(t5_cfg, mesh)
    dp, n_dp = axis_group(mesh, "dp"), axis_size(mesh, "dp")

    @torch.no_grad()
    def eval_step(model: T5Model, batch: Batch) -> torch.Tensor:
        group = dp if len(batch.waveform) % n_dp == 0 else None
        if group is not None:
            batch = Batch(*(batch_sharding(mesh).local(leaf)
                            for leaf in batch))
        batch = to_device(batch, model.shared_embedding.device)
        loss = _loss(model, batch, None, cfg, mel_cfg, True, group)
        if group is not None:
            dist.all_reduce(loss, group=group)
        return loss

    return eval_step


def pad_labels(labels_batch, ignore_index: int = -100) -> np.ndarray:
    """Host-side: list of 1-D int arrays -> (B, L) int32 padded with
    ignore_index (mirrors PAD->-100 at reference transformer.py:30)."""
    max_len = max(len(x) for x in labels_batch)
    out = np.full((len(labels_batch), max_len), ignore_index, dtype=np.int32)
    for i, x in enumerate(labels_batch):
        out[i, : len(x)] = x
    return out
