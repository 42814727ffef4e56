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
are float32 whatever the parameter dtype, views into one flat buffer a
device (``state[p]["row" | "col" | "v"]``); loading a state copies into
them.

A step updates all its leaves together in four phases (``csrc/
adafactor.cu`` says what each computes): 0 the sums of p^2 and of the
rows and columns of g^2 + eps1 (and a vector's moment), 1 the factored
moments and the row factor's sum, 2 the sum of the update's squares,
3 the parameter step.  The sums land in one float32 statistics buffer
(``_Layout``).  CUDA leaves go to the hand-written kernel, one launch a
phase for up to ``MAX_LEAVES`` leaves of the same step scalars; CPU
leaves to the plain PyTorch version of the same phases
(``step_plain``), which stays beside it for the CPU and as the kernel's
reference.  ``Adafactor.launches`` counts the kernel's launches and
``tensors`` the leaves of the last step; ``adafactor_kernel.launches``
counts them over all optimizers.

Under tensor parallelism a parameter may be a tp rank's slice
(``parallel/mesh.py``), and the statistics that span the whole matrix
(sum p^2, the row or column sums of g^2, the row factor's sum, the sum of
the update's squares) are then all-reduced over the tp group: they lead
the statistics buffer, one slice for each of the first three phases, so
that each phase ends in at most one ``all_reduce``, and a sharded step
updates each slice as the unsharded optimizer updates the matrix; a split
moment keeps the slice's shape.

``MultiSteps`` is ``optax.MultiSteps(every_k_schedule=k)``: the running
mean of k micro-batch gradients, one inner step per k, so the inner
step count moves once per k calls.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops import _build

_MOMENTS = ("row", "col", "v")


_EPS1, _EPS2 = 1e-30, 1e-3  # added to g^2; the floor of RMS(param)
_CLIP = 1.0  # the update's RMS bound
_DECAY = -0.8  # beta2_t = 1 - step^_DECAY

MAX_LEAVES = 256  # leaves a launch: their gradients' addresses ride in
# the kernel's arguments (csrc/adafactor.cu kMaxLeaves)
TILE_ROWS, TILE_COLS = 32, 128  # the kernel's tile (kTileRows, kTileCols)
PHASES = 4


def _moment_shapes(shape: torch.Size) -> Dict[str, tuple]:
    if len(shape) >= 2:
        return {"row": tuple(shape[:-1]),
                "col": tuple(shape[:-2] + shape[-1:])}
    return {"v": tuple(shape)}


class _Layout:
    """Where each leaf's statistics sit in one float32 buffer: sum p^2
    ("psq"); for a matrix the row sums ("rows") and column sums ("cols")
    of g^2 + eps1 and the sum of its row moments ("rfac"); sum upd^2
    ("usq").  Those that span a matrix split over tp (``splits``: the
    dim, or None) come first, one region for each of phases 0-2, so that
    a phase all-reduces one slice (``regions``); the rest follow.
    ``at[i][key]`` is (start, end); ``div[i]`` the whole matrix's
    (numel, rows, columns), the divisors of the means."""

    def __init__(self, shapes: Sequence[torch.Size],
                 splits: Sequence[Optional[int]], tp: int):
        entries = []  # (region, leaf, key, size); region 3 is local
        self.div = []
        for i, (shape, d) in enumerate(zip(shapes, splits)):
            n = math.prod(shape)
            sharded = d is not None
            entries.append((0 if sharded else 3, i, "psq", 1))
            rows = cols = 1
            if len(shape) >= 2:
                rows, cols = shape[-2], shape[-1]
                entries += [(0 if d == 1 else 3, i, "rows", n // cols),
                            (0 if d == 0 else 3, i, "cols", n // rows),
                            (1 if d == 0 else 3, i, "rfac", n // rows // cols)]
            entries.append((2 if sharded else 3, i, "usq", 1))
            self.div.append((n * (tp if sharded else 1),
                             rows * (tp if d == 0 else 1),
                             cols * (tp if d == 1 else 1)))
        self.at: List[Dict[str, tuple]] = [{} for _ in shapes]
        bounds, off = [], 0
        for region in range(4):
            start = off
            for r, i, key, size in entries:
                if r == region:
                    self.at[i][key] = (off, off + size)
                    off += size
            bounds.append((start, off))
        self.regions = bounds[:3]
        self.size = off


class _LeafRow(ctypes.Structure):
    """``AdafactorLeaf`` of csrc/adafactor.cu."""
    _fields_ = [("p", ctypes.c_void_p), ("row", ctypes.c_void_p),
                ("col", ctypes.c_void_p)] + [
        (k, ctypes.c_int64) for k in (
            "rows", "cols", "first_tile", "col_tiles", "n_tiles", "part",
            "row_part", "col_part", "psq", "row_sum", "col_sum", "rfac",
            "usq")] + [
        ("n_all", ctypes.c_float), ("rows_all", ctypes.c_float),
        ("cols_all", ctypes.c_float), ("pad", ctypes.c_int)]


class _Args(ctypes.Structure):
    """``AdafactorArgs`` of csrc/adafactor.cu: a launch's arguments."""
    _fields_ = [("g", ctypes.c_void_p * MAX_LEAVES),
                ("leaves", ctypes.c_void_p), ("tile_leaf", ctypes.c_void_p),
                ("stats", ctypes.c_void_p), ("scratch", ctypes.c_void_p),
                ("counters", ctypes.c_void_p), ("n_leaves", ctypes.c_int),
                ("n_tiles", ctypes.c_int), ("beta2", ctypes.c_float),
                ("one_minus", ctypes.c_float), ("rel", ctypes.c_float),
                ("pad", ctypes.c_int)]


def kernel_tables(params: Sequence[torch.Tensor], moments: Sequence[dict],
                  layout: _Layout, first: int = 0):
    """The kernel's table for leaves ``first ..`` of ``layout`` (``params``
    and their moment views): -> (the ``_LeafRow`` array, each tile's leaf
    (int32), the scratch floats it needs).  A leaf is R x C (a vector one
    row), cut into TILE_ROWS x TILE_COLS tiles; its scratch holds a
    partial sum a tile, its row partials (R a column of tiles) and its
    column partials (C a row of tiles)."""
    rows_out = (_LeafRow * len(params))()
    tile_leaf, tiles, scratch = [], 0, 0
    for li, (p, mom) in enumerate(zip(params, moments)):
        at, (n_all, rows_all, cols_all) = (layout.at[first + li],
                                           layout.div[first + li])
        factored = "col" in mom
        R, C = (p.shape[0], p.shape[1]) if factored else (1, p.numel())
        col_tiles, row_tiles = -(-C // TILE_COLS), -(-R // TILE_ROWS)
        n_tiles = row_tiles * col_tiles
        e = rows_out[li]
        e.p, e.rows, e.cols = p.data_ptr(), R, C
        e.row = mom["row" if factored else "v"].data_ptr()
        e.col = mom["col"].data_ptr() if factored else None
        e.first_tile, e.col_tiles, e.n_tiles = tiles, col_tiles, n_tiles
        e.part = scratch
        scratch += n_tiles
        if factored:
            e.row_part, e.col_part = scratch, scratch + R * col_tiles
            scratch += R * col_tiles + C * row_tiles
            e.row_sum, e.col_sum, e.rfac = (at["rows"][0], at["cols"][0],
                                            at["rfac"][0])
        e.psq, e.usq = at["psq"][0], at["usq"][0]
        e.n_all, e.rows_all, e.cols_all = n_all, rows_all, cols_all
        tile_leaf += [li] * n_tiles
        tiles += n_tiles
    return rows_out, np.asarray(tile_leaf, np.int32), scratch


class _Chunk:
    """Up to MAX_LEAVES leaves of one plan with the same step scalars, on
    a card: the kernel's table, tile map, scratch and counters there, and
    the argument block whose gradients and scalars a step sets."""

    def __init__(self, params, moments, layout, first, stats):
        dev = params[0].device
        table, tile_leaf, n_scratch = kernel_tables(params, moments, layout,
                                                    first)
        host = torch.frombuffer(bytearray(bytes(table)) + tile_leaf.tobytes(),
                                dtype=torch.uint8)
        # written once for the leaf set, without a wait on the card
        self.table = host.pin_memory().to(dev, non_blocking=True)
        self.scratch = torch.zeros(max(n_scratch, 1), dtype=torch.float32,
                                   device=dev)
        self.counters = torch.zeros(len(params), dtype=torch.int32,
                                    device=dev)
        self.params, self.first = list(params), first
        a = self.args = _Args()
        a.leaves = self.table.data_ptr()
        a.tile_leaf = self.table.data_ptr() + ctypes.sizeof(table)
        a.stats, a.scratch = stats.data_ptr(), self.scratch.data_ptr()
        a.counters = self.counters.data_ptr()
        a.n_leaves, a.n_tiles = len(params), len(tile_leaf)
        self.addr = ctypes.addressof(a)

    def set_step(self, scalars) -> None:
        ptrs = []
        for p in self.params:
            g = p.grad
            if not g.is_contiguous():
                raise ValueError(f"Adafactor kernel: needs contiguous "
                                 f"gradients, got strides {g.stride()}")
            ptrs.append(g.data_ptr())
        a = self.args
        a.g[:len(ptrs)] = ptrs
        a.beta2, a.one_minus, a.rel = scalars


class _Plan:
    """The leaves one step updates on one device, in order (``items``:
    (param, state, group index)), with their statistics buffer and layout;
    on a card the kernel's chunks (cut where the step scalars change and
    at MAX_LEAVES)."""

    def __init__(self, items, splits, tp, starts):
        params = [p for p, _, _ in items]
        self.device = params[0].device
        self.layout = _Layout([p.shape for p in params], splits, tp)
        self.stats = torch.zeros(self.layout.size, dtype=torch.float32,
                                 device=self.device)
        self.chunks: List[_Chunk] = []
        if self.device.type == "cuda":
            for p in params:
                if p.dtype != torch.float32 or p.ndim > 2 or \
                        not p.is_contiguous() or p.numel() == 0:
                    raise ValueError(
                        f"Adafactor kernel: takes contiguous float32 leaves "
                        f"of 1 or 2 dims, got {p.dtype} {tuple(p.shape)}")
            moments = [{k: st[k] for k in _MOMENTS if k in st}
                       for _, st, _ in items]
            ends = list(starts[1:]) + [len(items)]
            self.chunks = [_Chunk(params[s:e], moments[s:e], self.layout, s,
                                  self.stats)
                           for s, e in zip(starts, ends)]
            self.index = self.device.index if self.device.index is not None \
                else torch.cuda.current_device()


class Adafactor(torch.optim.Optimizer):
    """HF-default Adafactor: ``lr=None`` takes the relative step, with its
    warm-up (min(1e-6 * step, 1/sqrt(step))) when ``warmup_init``, else
    min(1e-2, 1/sqrt(step)); a fixed ``lr`` turns the relative step off,
    as HF's validation makes lr and relative_step exclusive.  No weight
    decay, as the reference trains.

    ``tp_group`` with ``split_dims`` (per parameter of ``params``, the dim
    split over tp, or None): the tensor-parallel statistics of the module
    docstring.  The kernel takes contiguous float32 leaves of one or two
    dims on a card (``trainable_model``'s masters) and raises on
    others."""

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
        # each parameter's moments in a flat float32 buffer a device
        self._moment_at, off = {}, 0
        for p in params:
            at = {}
            for k, shape in _moment_shapes(p.shape).items():
                at[k] = (off, shape)
                off += math.prod(shape)
            self._moment_at[p] = at
        self._moment_size = off
        self._moments: Dict[torch.device, torch.Tensor] = {}
        self._plans: Dict[torch.device, tuple] = {}  # the last, a device
        self.launches = 0  # kernel launches, all steps
        self.tensors = 0  # leaves updated by the last step

    def _views(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        buf = self._moments.get(p.device)
        if buf is None:
            buf = self._moments[p.device] = torch.zeros(
                self._moment_size, dtype=torch.float32, device=p.device)
        return {k: buf[o:o + math.prod(s)].view(s)
                for k, (o, s) in self._moment_at[p].items()}

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

    def _begin(self) -> Dict[torch.device, list]:
        """Count the step of every leaf with a gradient (its state made at
        its first); -> its (param, state, group index) items by device."""
        by_device: Dict[torch.device, list] = {}
        for gi, group in enumerate(self.param_groups):
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    for k, view in self._views(p).items():
                        st[k] = view.zero_()
                st["step"] += 1
                by_device.setdefault(p.device, []).append((p, st, gi))
        self.tensors = sum(len(v) for v in by_device.values())
        return by_device

    def _plan(self, items) -> _Plan:
        """The device's plan for these leaves: the last one if it holds
        the same leaves and chunks, else a new one."""
        keys = [(gi, st["step"]) for _, st, gi in items]
        starts = [0]
        for k in range(1, len(keys)):
            if keys[k] != keys[k - 1] or k - starts[-1] == MAX_LEAVES:
                starts.append(k)
        dev = items[0][0].device
        key = (tuple((id(p), p.data_ptr()) for p, _, _ in items),
               tuple(starts))
        last = self._plans.get(dev)
        if last is None or last[0] != key:
            plan = _Plan(items, [self._split.get(p) for p, _, _ in items],
                         self.tp, tuple(starts))
            last = self._plans[dev] = (key, plan)
        return last[1]

    def _all_reduce(self, plan: _Plan, phase: int) -> None:
        """Sum the statistics of phase ``phase`` that span split matrices
        over tp: one call, or none where no leaf is split."""
        lo, hi = plan.layout.regions[phase]
        if self.tp_group is not None and hi > lo:
            dist.all_reduce(plan.stats[lo:hi], group=self.tp_group)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for items in self._begin().values():
            plan = self._plan(items)
            if plan.device.type == "cuda":
                self._step_kernel(plan, items)
            elif plan.device.type == "cpu":
                self._step_plain(plan, items)
            else:
                raise ValueError(f"Adafactor: no version for "
                                 f"{plan.device.type} tensors")
        return loss

    def _step_kernel(self, plan: _Plan, items) -> None:
        lib = _build.load()
        for chunk in plan.chunks:
            _, st, gi = items[chunk.first]
            chunk.set_step(self._scalars(st["step"], self.param_groups[gi]))
        stream = torch._C._cuda_getCurrentRawStream(plan.index)
        for phase in range(PHASES):
            for chunk in plan.chunks:
                adafactor_kernel(lib, chunk, phase, stream)
                self.launches += 1
            if phase < PHASES - 1:
                self._all_reduce(plan, phase)

    def _step_plain(self, plan: _Plan, items) -> None:
        """The phases in plain PyTorch (any device; ``step`` takes them
        for CPU tensors)."""
        stats, layout = plan.stats, plan.layout
        scalars = {}
        for _, st, gi in items:
            if (gi, st["step"]) not in scalars:
                scalars[gi, st["step"]] = self._scalars(
                    st["step"], self.param_groups[gi])
        for phase in range(PHASES):
            for i, (p, st, gi) in enumerate(items):
                _plain_phase(phase, p, st, scalars[gi, st["step"]], stats,
                             layout.at[i], layout.div[i])
            if phase < PHASES - 1:
                self._all_reduce(plan, phase)

    def load_state_dict(self, state_dict: dict) -> None:
        """torch's loader casts floating state to each parameter's dtype;
        the moments are copied at their saved (float32) values into this
        optimizer's moment buffer, whose views the state keeps."""
        super().load_state_dict(state_dict)
        params = [p for g in self.param_groups for p in g["params"]]
        for idx, saved in state_dict["state"].items():
            p = params[int(idx)]
            st = self.state[p]
            views = self._views(p)
            for k in _MOMENTS:
                if k in saved and (k not in views or tuple(
                        saved[k].shape) != tuple(views[k].shape)):
                    raise ValueError(
                        f"optimizer state {idx}: moment {k!r} of shape "
                        f"{tuple(saved[k].shape)} does not fit the "
                        f"parameter's {tuple(p.shape)}")
            for k, view in views.items():
                st[k] = view.copy_(saved[k]) if k in saved else view.zero_()


def adafactor_kernel(lib, chunk: _Chunk, phase: int, stream: int) -> None:
    """One launch of csrc/adafactor.cu: phase ``phase`` over ``chunk``'s
    leaves on ``stream``.  ``adafactor_kernel.launches`` counts the
    launches of every optimizer, as the ops' wrappers count theirs."""
    _build.check(lib.m2m_adafactor_phase(chunk.addr, phase, stream),
                 "Adafactor")
    adafactor_kernel.launches += 1


adafactor_kernel.launches = 0


def _plain_update(p, st, stats, at, div) -> torch.Tensor:
    """The unclipped update: rsqrt(row / mean(row)) rsqrt(col) g, or
    rsqrt(v) g for a vector."""
    g = p.grad.float()
    if "row" not in st:
        return torch.rsqrt(st["v"]) * g
    row = st["row"]
    rmean = stats[slice(*at["rfac"])].view(row.shape[:-1] + (1,)) / div[1]
    r = torch.rsqrt(row / rmean)[..., None]
    c = torch.rsqrt(st["col"])[..., None, :]
    return r * c * g


def _plain_phase(phase, p, st, scalars, stats, at, div) -> None:
    beta2t, one_minus, rel = scalars
    if phase == 0:
        g = p.grad.float()
        stats[at["psq"][0]] = p.float().square().sum()
        sq = g.square() + _EPS1
        if "row" in st:
            stats[slice(*at["rows"])] = sq.sum(-1).reshape(-1)
            stats[slice(*at["cols"])] = sq.sum(-2).reshape(-1)
        else:
            st["v"].mul_(beta2t).add_(sq, alpha=one_minus)
    elif phase == 1 and "row" in st:
        row, col = st["row"], st["col"]
        row.mul_(beta2t).add_(
            stats[slice(*at["rows"])].view(row.shape) / div[2],
            alpha=one_minus)
        col.mul_(beta2t).add_(
            stats[slice(*at["cols"])].view(col.shape) / div[1],
            alpha=one_minus)
        stats[slice(*at["rfac"])] = row.sum(-1).reshape(-1)
    elif phase == 2:
        upd = _plain_update(p, st, stats, at, div)
        stats[at["usq"][0]] = upd.square().sum()
    elif phase == 3:
        n = div[0]
        lr = (stats[at["psq"][0]] / n).sqrt().clamp(min=_EPS2) * rel
        upd = _plain_update(p, st, stats, at, div)
        upd_rms = (stats[at["usq"][0]] / n).sqrt()
        upd = upd / (upd_rms / _CLIP).clamp(min=1.0)
        p.add_((-(upd * lr)).to(p.dtype))


@torch.no_grad()
def step_plain(optimizer: Adafactor) -> None:
    """One ``Adafactor.step`` through the plain version on any device (the
    kernel's reference on a card, for the tests and ``chip_smoke.py``)."""
    for items in optimizer._begin().values():
        optimizer._step_plain(optimizer._plan(items), items)


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
        self.tensors = 0  # leaves the last call updated (0: it folded)
        self.acc: List[torch.Tensor] = [
            torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in self._params()]

    @property
    def launches(self) -> int:
        return self.inner.launches

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
        self.tensors = 0
        if n == self.every_k - 1:
            for p, a in zip(self._params(), self.acc):
                p.grad = a.to(p.dtype)
            self.inner.step()
            self.tensors = self.inner.tensors
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
