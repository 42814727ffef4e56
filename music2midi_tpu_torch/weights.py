"""Weights: the npz checkpoint format and the JAX parameter tree.

The repository's checkpoint of record is a single ``.npz`` written by
``music2midi_tpu/train/checkpoint.py::save_params_npz``:

  * one array per leaf, keyed by its tree path joined with ``/``, list
    indices written ``#i`` (``decoder/layers/#0/self_attn/q``);
  * bfloat16 leaves stored as their uint16 bit pattern, the true dtypes in
    the ``__dtypes__`` JSON entry;
  * the config in the ``__config__`` JSON entry.

The port keeps parameters as a flat ``state_dict`` whose keys are the same
paths joined with ``.`` and without the ``#`` (``decoder.layers.0.self_attn.q``),
which are exactly the parameter names of ``models.t5.T5Model``.  bfloat16
bits are reinterpreted in torch, with no ``ml_dtypes``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .config import ConfigNode

StateDict = Dict[str, torch.Tensor]


def _to_tensor(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    """numpy leaf -> tensor; bfloat16 arrives as uint16 bits (npz) or as an
    ml_dtypes array (a JAX tree), and both are reinterpreted bit for bit."""
    a = np.asarray(a)
    if dtype_name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _key(path) -> str:
    return ".".join(str(p) for p in path)


def load_npz(path: Union[str, Path]) -> Tuple[StateDict, Optional[ConfigNode]]:
    """Load a ``save_params_npz`` export -> (state_dict, config | None)."""
    with np.load(Path(path)) as z:
        dtypes = json.loads(bytes(z["__dtypes__"]).decode())
        cfg = None
        if "__config__" in z:
            cfg = ConfigNode(json.loads(bytes(z["__config__"]).decode()))
        sd = {}
        for key, want in dtypes.items():
            parts = [p[1:] if p.startswith("#") else p for p in key.split("/")]
            sd[_key(parts)] = _to_tensor(z[key], want)
    return sd, cfg


def params_from_jax(tree) -> StateDict:
    """A JAX parameter tree (nested dicts and lists of numpy or JAX arrays,
    as ``init_params`` or ``load_params_npz`` give it) -> state_dict.

    The values are carried across bit for bit; bfloat16 stays bfloat16."""
    out: StateDict = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [i])
        else:
            a = np.asarray(node)
            out[_key(path)] = _to_tensor(a, a.dtype.name)

    walk(tree, [])
    return out


def tree_from_state_dict(sd: StateDict) -> dict:
    """Inverse of ``params_from_jax``: state_dict -> nested dicts/lists of
    numpy arrays (bfloat16 leaves come back as exact float32)."""
    root: dict = {}
    for key, t in sd.items():
        parts = [int(p) if p.isdigit() else p for p in key.split(".")]
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        node[parts[-1]] = t.numpy()

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)
