"""Guarded multi-process initialization over ``torch.distributed``.

Port of ``music2midi_tpu/parallel/distributed.py``.  The reference's only
distributed contract is Lightning DDP over NCCL (reference
train.py:17-41, model.py:37); the JAX package calls
``jax.distributed.initialize()`` when a launcher's environment is present.
Here the launcher is torchrun (``python3 -m torch.distributed.run``),
which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``; ``M2M_DISTRIBUTED=1`` forces
initialization as in the JAX package.  Single-process runs are untouched,
so calling ``maybe_initialize`` is always safe.

The backend follows the device:

  * ``nccl`` for CUDA when every rank of the host has a card of its own
    (``LOCAL_WORLD_SIZE <= torch.cuda.device_count()``), rank r on card
    ``LOCAL_RANK``;
  * ``gloo`` for the CPU, and for ranks that share cards, when the caller
    asks for it (``backend="gloo"`` or ``M2M_DIST_BACKEND=gloo``): rank r
    on card ``LOCAL_RANK % device_count``.  gloo reduces CUDA tensors
    (``all_reduce``, ``broadcast``, ``barrier``) but has no
    ``all_gather`` for them; ``parallel/mesh.py`` gathers through
    ``all_reduce``.

NCCL with more ranks than cards raises, naming gloo; nothing switches
backend on its own.  The chosen backend and device are logged and
returned.
"""

from __future__ import annotations

import logging
import os
from typing import NamedTuple, Optional, Union

import torch
import torch.distributed as dist

_log = logging.getLogger(__name__)
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                 "LOCAL_RANK")


class DistInfo(NamedTuple):
    """What ``maybe_initialize`` set up: the process group's backend, this
    rank's device, its rank and the world size."""
    backend: str
    device: torch.device
    rank: int
    world_size: int


_info: Optional[DistInfo] = None


def should_initialize() -> bool:
    """True under ``M2M_DISTRIBUTED=1`` or a torchrun environment."""
    if os.environ.get("M2M_DISTRIBUTED") == "1":
        return True
    return any(os.environ.get(k) for k in _LAUNCHER_ENV)


def _rank_and_world() -> tuple:
    rank, world = os.environ.get("RANK"), os.environ.get("WORLD_SIZE")
    if (rank is None) != (world is None):
        given, missing = ("RANK", "WORLD_SIZE") if world is None else \
            ("WORLD_SIZE", "RANK")
        raise RuntimeError(
            f"torch.distributed launch: {missing} must be set when {given} "
            "is (both or neither of the pair)")
    if rank is None:  # M2M_DISTRIBUTED=1 alone: a world of one
        return 0, 1
    return int(rank), int(world)


def choose_backend(device: torch.device, backend: Optional[str] = None,
                   local_world: int = 1) -> str:
    """The backend for ``device``: ``backend``, else ``M2M_DIST_BACKEND``,
    else ``nccl`` on CUDA and ``gloo`` on the CPU.  NCCL needs a card for
    each of the host's ``local_world`` ranks."""
    backend = backend or os.environ.get("M2M_DIST_BACKEND") or (
        "nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    if device.type != "cuda" and backend == "nccl":
        raise ValueError("nccl needs CUDA tensors; the CPU takes gloo")
    if backend == "nccl" and local_world > torch.cuda.device_count():
        raise RuntimeError(
            f"nccl needs a card for each rank: {local_world} ranks on this "
            f"host, {torch.cuda.device_count()} card(s); ranks that share a "
            "card need backend='gloo' (M2M_DIST_BACKEND=gloo)")
    return backend


def maybe_initialize(backend: Optional[str] = None,
                     device: Optional[Union[str, torch.device]] = None,
                     init_method: Optional[str] = None
                     ) -> Union[bool, DistInfo]:
    """Initialize the default process group iff a launcher context exists.

    -> False in a single process; else a ``DistInfo`` (truthy), the same
    one on every later call.  ``device``: ``cuda`` (default) or ``cpu``;
    on CUDA the rank's card is made current.  ``init_method``: default
    ``env://`` (torchrun's store); a ``file://`` path serves launches
    without a port."""
    global _info
    if _info is not None:
        return _info
    if not should_initialize():
        return False
    rank, world = _rank_and_world()
    dev = torch.device("cuda" if device is None else device)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = choose_backend(dev, backend, local_world)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available: pass device='cpu' "
                               "to run on the CPU")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.cuda.init()  # DeviceMesh then keeps this card
    dist.init_process_group(backend, init_method=init_method or "env://",
                             rank=rank, world_size=world)
    _info = DistInfo(backend, dev, rank, world)
    _log.info("torch.distributed initialized: rank %d/%d, backend %s, "
              "device %s", rank, world, backend, dev)
    return _info


def shutdown() -> None:
    """Destroy the process group ``maybe_initialize`` made, if any, so that
    a later call initializes anew."""
    global _info
    if _info is not None:
        dist.destroy_process_group()
        _info = None
