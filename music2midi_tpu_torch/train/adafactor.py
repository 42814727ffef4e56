"""Adafactor with the HF-``transformers`` defaults, as a torch optimizer.

Port of ``music2midi_tpu/train/adafactor.py`` (``adafactor_hf``), written
from it and not from ``transformers``: the reference trains with
``Adafactor(self.parameters(), warmup_init=True)`` + ``AdafactorSchedule``
(reference music2midi/model.py:27-30), i.e. relative-step learning rate
min(1e-6 * step, 1/sqrt(step)), parameter-scale multiplication
max(1e-3, RMS(param)), second moments factored for every parameter with
ndim >= 2 (so the (32, 8) relative-bias tables too), beta2_t =
1 - step^-0.8, and the update clipped by RMS / clip_threshold.

The step's scalars (beta2_t, the relative step size) are rounded to
float32 on the host as the JAX transform computes them in float32; every
tensor op runs on the parameter's device with no read-back.  The moments
are float32 whatever the parameter dtype.

Under tensor parallelism a parameter may be a tp rank's slice
(``parallel/mesh.py``), and the statistics that span the whole matrix
(RMS(param), the row and column means of g^2, the mean of the row factor,
the update's RMS) are then sums all-reduced over the tp group, so that a
sharded step updates each slice as the unsharded optimizer updates the
matrix; a split moment keeps the slice's shape.

``MultiSteps`` is ``optax.MultiSteps(every_k_schedule=k)``: the running
mean of k micro-batch gradients, one inner step per k, so the inner
step count moves once per k calls.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_MOMENTS = ("row", "col", "v")


_EPS1, _EPS2 = 1e-30, 1e-3  # added to g^2; the floor of RMS(param)
_CLIP = 1.0  # the update's RMS bound
_DECAY = -0.8  # beta2_t = 1 - step^_DECAY


class Adafactor(torch.optim.Optimizer):
    """HF-default Adafactor: ``lr=None`` takes the relative step, with its
    warm-up (min(1e-6 * step, 1/sqrt(step))) when ``warmup_init``, else
    min(1e-2, 1/sqrt(step)); a fixed ``lr`` turns the relative step off,
    as HF's validation makes lr and relative_step exclusive.  No weight
    decay, as the reference trains.

    ``tp_group`` with ``split_dims`` (per parameter of ``params``, the dim
    split over tp, or None): the tensor-parallel statistics of the module
    docstring."""

    def __init__(self, params: Iterable[torch.Tensor],
                 lr: Optional[float] = None, warmup_init: bool = True,
                 tp_group=None,
                 split_dims: Optional[Sequence[Optional[int]]] = None):
        params = list(params)
        super().__init__(params, dict(lr=lr, warmup_init=warmup_init))
        self.tp_group = tp_group
        self.tp = 1 if tp_group is None else dist.get_world_size(tp_group)
        self._split = {} if tp_group is None else {
            p: d for p, d in zip(params, split_dims) if d is not None}

    def _mean(self, x: torch.Tensor, dim: Optional[int] = None,
              sharded: bool = False, keepdim: bool = False) -> torch.Tensor:
        """x's mean over ``dim`` (all of x when None); when ``sharded``
        (that dim is split over tp) the whole matrix's, from sums
        all-reduced over tp."""
        if not sharded:
            return x.mean() if dim is None else x.mean(dim, keepdim=keepdim)
        s = x.sum() if dim is None else x.sum(dim, keepdim=keepdim)
        dist.all_reduce(s, group=self.tp_group)
        return s / ((x.numel() if dim is None else x.shape[dim]) * self.tp)

    @staticmethod
    def _scalars(step: int, group: dict):
        """-> (beta2_t, 1 - beta2_t, step size), float32 values."""
        f32 = np.float32
        step_f = f32(step)
        beta2t = f32(1.0) - np.power(step_f, f32(_DECAY))
        if group["lr"] is None:
            min_step = (f32(1e-6) * step_f if group["warmup_init"]
                        else f32(1e-2))
            rel = min(min_step, f32(1.0) / np.sqrt(step_f))
        else:
            rel = f32(group["lr"])
        return float(beta2t), float(f32(1.0) - beta2t), float(f32(rel))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    if p.ndim >= 2:
                        st["row"] = torch.zeros(p.shape[:-1],
                                                dtype=torch.float32,
                                                device=p.device)
                        st["col"] = torch.zeros(p.shape[:-2] + p.shape[-1:],
                                                dtype=torch.float32,
                                                device=p.device)
                    else:
                        st["v"] = torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device)
                st["step"] += 1
                beta2t, one_minus, rel = self._scalars(st["step"], group)
                g = p.grad.float()
                split = self._split.get(p)  # 0 (rows) or 1 (columns)
                mean = self._mean
                # parameter scale: the step is relative to RMS(param)
                lr = mean(p.float().square(), sharded=split is not None
                          ).sqrt().clamp(min=_EPS2) * rel
                sq = g.square() + _EPS1
                if p.ndim >= 2:
                    row = st["row"].mul_(beta2t).add_(
                        mean(sq, -1, split == 1), alpha=one_minus)
                    col = st["col"].mul_(beta2t).add_(
                        mean(sq, -2, split == 0), alpha=one_minus)
                    # approx rsqrt(v): rows normalised by their mean
                    r = torch.rsqrt(row / mean(row, -1, split == 0,
                                               keepdim=True))[..., None]
                    c = torch.rsqrt(col)[..., None, :]
                    upd = r * c * g
                else:
                    v = st["v"].mul_(beta2t).add_(sq, alpha=one_minus)
                    upd = torch.rsqrt(v) * g
                upd_rms = mean(upd.square(), sharded=split is not None).sqrt()
                upd = upd / (upd_rms / _CLIP).clamp(min=1.0)
                p.add_((-(upd * lr)).to(p.dtype))
        return loss

    def load_state_dict(self, state_dict: dict) -> None:
        """torch's loader casts floating state to each parameter's dtype;
        the moments are put back at their saved (float32) dtype."""
        super().load_state_dict(state_dict)
        params = [p for g in self.param_groups for p in g["params"]]
        for idx, saved in state_dict["state"].items():
            p = params[int(idx)]
            for k in _MOMENTS:
                if k in saved:
                    self.state[p][k] = saved[k].to(p.device, copy=True)


class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=every_k)``: each ``step``
    folds the gradients into a running mean (Welford, ``acc + (g - acc) /
    (n + 1)``, float32); every ``every_k``-th call hands the mean to the
    inner optimizer as its gradients and takes one inner step."""

    def __init__(self, inner: torch.optim.Optimizer, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.inner = inner
        self.every_k = int(every_k)
        self.mini_step = 0
        self.acc: List[torch.Tensor] = [
            torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in self._params()]

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.inner.param_groups for p in g["params"]]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        n = self.mini_step
        for p, a in zip(self._params(), self.acc):
            if p.grad is not None:
                a.add_((p.grad.float() - a) / (n + 1))
        if n == self.every_k - 1:
            for p, a in zip(self._params(), self.acc):
                p.grad = a.to(p.dtype)
            self.inner.step()
            for a in self.acc:
                a.zero_()
        self.mini_step = (n + 1) % self.every_k

    def state_dict(self) -> dict:
        return {"mini_step": self.mini_step,
                "acc": [a.clone() for a in self.acc],
                "inner": self.inner.state_dict()}

    def load_state_dict(self, state_dict: dict) -> None:
        self.inner.load_state_dict(state_dict["inner"])
        self.mini_step = int(state_dict["mini_step"])
        for a, saved in zip(self.acc, state_dict["acc"]):
            a.copy_(saved)


def adafactor_lr_at(step: int, warmup_init: bool = True) -> float:
    """The relative-step lr (AdafactorSchedule.get_lr equivalent, for
    logging; the real scaling includes per-parameter RMS)."""
    if step <= 0:
        return 0.0
    min_step = 1e-6 * step if warmup_init else 1e-2
    return min(min_step, step ** -0.5)
