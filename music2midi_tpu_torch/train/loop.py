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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple, Union

import numpy as np
import torch

from ..models.t5 import T5Config, T5Model, conditioning_prepend, t5_forward
from ..ops.mel import LogMelConfig, log_mel_spectrogram


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
                    device) -> T5Model:
    """A T5Model for training on ``device``: floating leaves cast to
    float32 masters that require grad, integer leaves kept as they are."""
    sd = {k: v.float() if v.is_floating_point() else v
          for k, v in state_dict.items()}
    model = T5Model.from_state_dict(sd, cfg).to(device)
    for p in model.parameters():
        p.requires_grad_(p.is_floating_point())
    return model


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
          mel_cfg: LogMelConfig, deterministic: bool) -> torch.Tensor:
    with torch.no_grad():
        mel = log_mel_spectrogram(batch.waveform, mel_cfg)
    embeds = conditioning_prepend(model, mel, batch.cond_index)
    loss, _ = t5_forward(model, embeds, batch.labels, t5_cfg,
                         deterministic=deterministic, generator=generator)
    return loss


def _device(state: TrainState) -> torch.device:
    return state.model.shared_embedding.device


def make_train_step(t5_cfg: T5Config, mel_cfg: LogMelConfig):
    """-> (state, batch, seed) -> (state, loss): one step, in place."""

    def train_step(state: TrainState, batch: Batch,
                   seed: int = 0) -> Tuple[TrainState, torch.Tensor]:
        dev = _device(state)
        batch = to_device(batch, dev)
        gen = (dropout_generator(seed, state.step, dev)
               if t5_cfg.dropout_rate > 0.0 else None)
        state.optimizer.zero_grad(set_to_none=True)
        loss = _loss(state.model, batch, gen, t5_cfg, mel_cfg, False)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return train_step


def make_multi_step(t5_cfg: T5Config, mel_cfg: LogMelConfig):
    """-> (state, stacked_batches, seed) -> (state, losses (K,)): K steps
    over a Batch whose leaves carry a leading step axis, with
    ``train_step``'s exact trajectory (the JAX package's ``lax.scan``,
    here a loop)."""
    train_step = make_train_step(t5_cfg, mel_cfg)

    def multi_step(state: TrainState, batches: Batch,
                   seed: int = 0) -> Tuple[TrainState, torch.Tensor]:
        losses = []
        for k in range(len(batches.waveform)):
            state, loss = train_step(
                state, Batch(*(leaf[k] for leaf in batches)), seed)
            losses.append(loss)
        return state, torch.stack(losses)

    return multi_step


def make_eval_step(t5_cfg: T5Config, mel_cfg: LogMelConfig):
    """-> (model, batch) -> loss, deterministic and without grad."""

    @torch.no_grad()
    def eval_step(model: T5Model, batch: Batch) -> torch.Tensor:
        batch = to_device(batch, model.shared_embedding.device)
        return _loss(model, batch, None, t5_cfg, mel_cfg, True)

    return eval_step


def pad_labels(labels_batch, ignore_index: int = -100) -> np.ndarray:
    """Host-side: list of 1-D int arrays -> (B, L) int32 padded with
    ignore_index (mirrors PAD->-100 at reference transformer.py:30)."""
    max_len = max(len(x) for x in labels_batch)
    out = np.full((len(labels_batch), max_len), ignore_index, dtype=np.int32)
    for i, x in enumerate(labels_batch):
        out[i, : len(x)] = x
    return out
