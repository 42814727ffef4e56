"""Checkpoints: the training state, parameter exports and the npz format.

Port of ``music2midi_tpu/train/checkpoint.py``.  The layout of a training
checkpoint is the JAX package's (``ckpt_dir/step_{N:08d}/`` with the
config as ``config.json`` beside the state, the last ``keep`` steps
kept), but the state the port writes is one ``state.pt`` written by
``torch.save`` (the port writes no orbax): the parameters as a CPU
state_dict, the optimizer's ``state_dict`` and the step, all of it
loadable with ``torch.load(weights_only=True)``.  ``save_params`` writes
``ckpt_dir/params.pt`` (+ ``config.json``).

``restore_train_state`` also resumes a run of the JAX trainer: a step dir
holding its orbax ``state/`` (read by ``orbax.py``, with no orbax) is
turned into the dict a ``state.pt`` holds.  The ``AdafactorHFState``
gives every parameter's ``step`` and its ``row`` / ``col`` (a factored
matrix) or ``v`` moment; under ``optax.MultiSteps`` its ``mini_step`` and
``acc_grads`` give ``MultiSteps.mini_step`` / ``acc``.

``save_params_npz`` / ``load_params_npz`` are the JAX package's npz format
exactly ('/'-joined tree paths with '#i' for list indices, bfloat16 as its
uint16 bit pattern with the true dtypes in the ``__dtypes__`` JSON, the
config in ``__config__``), so an export from either package loads in the
other; bfloat16 bits are taken from torch, with no ``ml_dtypes``.
Parameters are flat state_dicts (``weights.py``); a key component that is
all digits is a list index.  The readers (``restore_params``,
``latest_checkpoint``, the npz loader) are ``weights.py``'s, so serving
loads an export without the training package.

On a ``(dp, tp)`` mesh a training checkpoint is still the one-device
format: every rank calls ``save_train_state`` (the gathers are
collectives), which gathers the parameters and the Adafactor moments
(and ``MultiSteps``' accumulators) of the tp shards, and rank 0 alone
writes; ``restore_train_state`` slices a saved state to the restoring
rank's shard, so a checkpoint resumes under any ``(dp, tp)``.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..config import ConfigNode
from ..parallel.mesh import (
    gather_params,
    gather_tensor,
    param_pspecs,
    shard_params,
    shard_tensor,
    split_dim,
)
from .adafactor import _MOMENTS, MultiSteps
from .. import orbax
from ..weights import (
    JAX_STATE_DIR,
    PARAMS_FILE,
    STATE_FILE,
    StateDict,
    is_jax_step,
    load_torch,
    params_from_jax,
    read_config,
    step_dir,
)
# the readers live in weights.py (serving needs them, not the trainer);
# they are named here as in the JAX module
from ..weights import latest_checkpoint, restore_params  # noqa: F401
from ..weights import load_npz as load_params_npz  # noqa: F401

_NPZ_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
               "float32": torch.float32}


def _write_config(path: Path, config: Optional[ConfigNode]) -> None:
    if config is not None:
        (path / "config.json").write_text(json.dumps(config.to_dict()))


def _moment_split(spec: Optional[str], key: str) -> Optional[int]:
    """The dim of an optimizer tensor split over tp, for a parameter of
    ``param_pspecs`` entry ``spec``: a ``MultiSteps`` accumulator ("acc")
    as its parameter; the column moment of a column-split matrix and the
    row moment of a row-split one along their only dim."""
    if key == "acc":
        return split_dim(spec)
    return 0 if (spec, key) in (("col", "col"), ("row", "row")) else None


def _map_optimizer_state(sd: dict, names: Sequence[str], fn) -> dict:
    """An optimizer state_dict (Adafactor's, or MultiSteps') with
    ``fn(param name, key, tensor)`` applied to every moment and
    accumulator; the optimizer's parameters are named ``names``."""
    if "inner" in sd:
        return {**sd, "acc": [fn(n, "acc", a) for n, a in zip(names, sd["acc"])],
                "inner": _map_optimizer_state(sd["inner"], names, fn)}
    state = {i: {k: fn(names[int(i)], k, v) if k in _MOMENTS else v
                 for k, v in st.items()}
             for i, st in sd["state"].items()}
    return {**sd, "state": state}


def _trainable_names(model) -> list:
    return [n for n, p in model.named_parameters() if p.requires_grad]


def save_train_state(ckpt_dir: Union[str, Path], state,
                     config: Optional[ConfigNode] = None,
                     keep: int = 3, mesh=None) -> Path:
    """Save {params, opt_state, step} (+ config JSON) under
    ckpt_dir/step_{N:08d}; keep the last ``keep`` steps.  -> the step dir.
    On a ``mesh``: every rank calls it; the tp shards are gathered and rank
    0 writes."""
    ckpt_dir = Path(ckpt_dir).resolve()
    path = ckpt_dir / f"step_{int(state.step):08d}"
    params = state.model.state_dict()
    opt_state = state.optimizer.state_dict()
    if mesh is not None:
        specs = param_pspecs(params)
        params = gather_params(params, mesh)
        opt_state = _map_optimizer_state(
            opt_state, _trainable_names(state.model),
            lambda n, k, t: gather_tensor(t, _moment_split(specs[n], k),
                                          mesh))
        if dist.get_rank() != 0:
            return path
    path.mkdir(parents=True, exist_ok=True)
    torch.save({"params": {k: v.detach().to("cpu", copy=True)
                           for k, v in params.items()},
                "opt_state": opt_state,
                "step": int(state.step)}, path / STATE_FILE)
    _write_config(path, config)
    _prune_old(ckpt_dir, keep)
    return path


def _prune_old(ckpt_dir: Path, keep: int) -> None:
    for old in sorted(ckpt_dir.glob("step_*"))[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


def _same_names(got, want, what: str) -> None:
    """Raise naming the first key that one of the two has and the other
    lacks."""
    extra, missing = sorted(set(got) - set(want)), sorted(set(want) - set(got))
    if extra:
        raise ValueError(f"{what}.{extra[0]}: not in the port's model")
    if missing:
        raise ValueError(f"{what}.{missing[0]}: missing")


def _flat(tree, what: str) -> Dict[str, torch.Tensor]:
    if not isinstance(tree, dict):
        raise ValueError(f"{what}: not a tree of arrays")
    return params_from_jax(tree)


def _from_jax(tree: dict, state, path: Path) -> dict:
    """The JAX trainer's TrainState (``read_tree`` of its ``state/``) ->
    the dict a port ``state.pt`` holds, for the optimizer of ``state``."""
    for key in ("params", "opt_state", "step"):
        if key not in tree:
            raise ValueError(f"{path}: {key} missing from the JAX state")
    params = _flat(tree["params"], "params")
    names = _trainable_names(state.model)
    opt = tree["opt_state"]
    multi = isinstance(state.optimizer, MultiSteps)
    if multi != ("inner_opt_state" in opt):
        raise ValueError(
            "opt_state.inner_opt_state: missing, but the port's optimizer "
            "accumulates gradients (MultiSteps)" if multi else
            "opt_state.inner_opt_state: an optax.MultiSteps state, but the "
            "port's optimizer does not accumulate gradients")
    inner = opt["inner_opt_state"] if multi else opt
    where = "opt_state.inner_opt_state" if multi else "opt_state"
    if set(inner) != {"step", "moments"}:
        raise ValueError(f"{where}: not an AdafactorHFState (keys "
                         f"{sorted(inner)})")
    step = int(inner["step"])
    moments = _flat(inner["moments"], f"{where}.moments")
    per_param, used = {}, set()
    for i, n in enumerate(names):
        if n not in params:
            raise ValueError(f"params.{n}: missing")
        shape = tuple(params[n].shape)  # whole, as saved; a mesh slices it
        if f"{n}.row" in moments:
            want = {"row": shape[:-1], "col": shape[:-2] + shape[-1:]}
        else:
            want = {"v": shape}
        st = {"step": step}
        for k, s in want.items():
            key = f"{n}.{k}" if k != "v" else n
            if key not in moments:
                raise ValueError(f"{where}.moments.{key}: missing")
            if tuple(moments[key].shape) != s:
                raise ValueError(f"{where}.moments.{key}: shape "
                                 f"{tuple(moments[key].shape)}, the port's "
                                 f"Adafactor keeps {s}")
            st[k] = moments[key].float()
            used.add(key)
        per_param[i] = st
    _same_names(moments, used, f"{where}.moments")
    base = state.optimizer.state_dict()
    opt_sd = {"state": per_param,
              "param_groups": (base["inner"] if multi else base)[
                  "param_groups"]}
    if multi:
        mini = int(opt["mini_step"])
        if not 0 <= mini < state.optimizer.every_k:
            raise ValueError(f"opt_state.mini_step: {mini}, the port "
                             f"accumulates {state.optimizer.every_k} steps")
        if int(opt["gradient_step"]) != step:
            raise ValueError(f"opt_state.gradient_step: "
                             f"{int(opt['gradient_step'])}, but the inner "
                             f"step is {step}")
        if opt.get("skip_state") not in ((), [], {}, None):
            raise ValueError("opt_state.skip_state: not empty")
        acc = _flat(opt["acc_grads"], "opt_state.acc_grads")
        _same_names(acc, names, "opt_state.acc_grads")
        opt_sd = {"mini_step": mini,
                  "acc": [acc[n].float() for n in names], "inner": opt_sd}
    return {"params": params, "opt_state": opt_sd, "step": int(tree["step"])}


def restore_train_state(path: Union[str, Path], state, mesh=None
                        ) -> Tuple[object, Optional[ConfigNode]]:
    """Restore into ``state`` (a TrainState built as the saved one was:
    the same parameter names and optimizer) from a step dir of either
    package's trainer, or from a training root taking its latest step.
    -> (state, config | None).  On a ``mesh`` the saved (whole) state is
    sliced to this rank's shard."""
    path = step_dir(Path(path).resolve())
    if is_jax_step(path):
        saved = _from_jax(orbax.read_tree(path / JAX_STATE_DIR), state, path)
    else:
        saved = load_torch(path / STATE_FILE)
    specs = param_pspecs(saved["params"])
    with torch.no_grad():
        own = state.model.state_dict()
        _same_names(saved["params"], own, f"{path}: params")
        for k, v in shard_params(saved["params"], mesh).items():
            own[k].copy_(v)
    opt_state = saved["opt_state"]
    if mesh is not None:
        opt_state = _map_optimizer_state(
            opt_state, _trainable_names(state.model),
            lambda n, k, t: shard_tensor(t, _moment_split(specs[n], k),
                                         mesh))
    state.optimizer.load_state_dict(opt_state)
    state.step = int(saved["step"])
    return state, read_config(path)


def save_params(ckpt_dir: Union[str, Path], params: StateDict,
                config: Optional[ConfigNode] = None) -> None:
    """Inference-only export: just the params (+ config)."""
    ckpt_dir = Path(ckpt_dir).resolve()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().to("cpu", copy=True) for k, v in params.items()},
               ckpt_dir / PARAMS_FILE)
    _write_config(ckpt_dir, config)


def average_params(sources: Sequence, weights: Optional[Sequence[float]] = None
                   ) -> Tuple[StateDict, Optional[ConfigNode]]:
    """Uniform (or ``weights``-weighted) average of the params of
    ``sources``, each anything ``restore_params`` accepts.  Accumulates in
    float64 and returns each leaf at its original dtype; the config comes
    from the first source that has one, and every source must have the
    same parameter names and shapes."""
    if not sources:
        raise ValueError("average_params: no sources")
    if weights is None:
        weights = [1.0] * len(sources)
    if len(weights) != len(sources):
        raise ValueError("average_params: len(weights) != len(sources)")
    total = float(sum(weights))
    if not np.isfinite(total) or total <= 0.0:
        raise ValueError(
            f"average_params: weights must sum to a finite positive "
            f"value, got {total} from {list(weights)}"
        )
    acc: Dict[str, torch.Tensor] = {}
    dtypes: Dict[str, torch.dtype] = {}
    cfg = None
    for src, w in zip(sources, weights):
        params, src_cfg = restore_params(src)
        cfg = cfg if cfg is not None else src_cfg
        if not acc:
            acc = {k: torch.zeros(v.shape, dtype=torch.float64)
                   for k, v in params.items()}
            dtypes = {k: v.dtype for k, v in params.items()}
        elif set(params) != set(acc) or any(
                params[k].shape != acc[k].shape for k in acc):
            raise ValueError(
                f"average_params: parameters of {src} differ from "
                f"{sources[0]}"
            )
        for k, v in params.items():
            acc[k] += (w / total) * v.to(torch.float64)
    return {k: a.to(dtypes[k]) for k, a in acc.items()}, cfg


def _npz_key(key: str) -> str:
    """state_dict key -> the JAX tree path: '/'-joined, list indices '#i'."""
    return "/".join(f"#{p}" if p.isdigit() else p for p in key.split("."))


def save_params_npz(path: Union[str, Path], params: StateDict,
                    config: Optional[ConfigNode] = None,
                    dtype: str = "bfloat16") -> None:
    """Single-FILE inference export in the JAX package's format: the float
    weights cast to ``dtype`` ("bfloat16"/"float16"/"float32"), integer
    leaves kept bit-exact, bfloat16 stored as its uint16 bit pattern with
    the true dtypes in ``__dtypes__``, the config in ``__config__``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    target = _NPZ_DTYPES[dtype]
    arrays, dtypes = {}, {}
    for key, t in params.items():
        t = t.detach().cpu()
        if t.is_floating_point():
            t = t.to(target)
        name = _npz_key(key)
        if t.dtype == torch.bfloat16:
            dtypes[name] = "bfloat16"
            arrays[name] = t.contiguous().view(torch.int16).numpy().view(
                np.uint16)
        else:
            a = t.numpy()
            dtypes[name] = a.dtype.name
            arrays[name] = a
    arrays["__dtypes__"] = np.frombuffer(json.dumps(dtypes).encode(),
                                         dtype=np.uint8)
    if config is not None:
        arrays["__config__"] = np.frombuffer(
            json.dumps(config.to_dict()).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)

