"""Device mesh, sharding rules and the tensor-parallel operators.

Port of ``music2midi_tpu/parallel/mesh.py``.  The JAX package names a
``(dp, tp)`` mesh and leaves the collectives to XLA; here the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the process group
(``parallel/distributed.py``), and the collectives are written out:

  dp -- data parallel: each dp rank takes its rows of the batch
        (``batch_sharding``); the trainer sums the gradients over dp in
        one all-reduce a step (``train/loop.py``);
  tp -- tensor parallel, megatron-style: q/k/v and wi_0/wi_1 split by
        column (a rank holds H / tp heads and d_ff / tp hidden units), o
        and wo by row, everything else replicated (``param_pspecs``).  A
        tp rank runs the model at a local config (``local_config``) with
        ``copy_to_tp_region`` in front of each column-split projection and
        ``reduce_from_tp_region`` after each row-split one.

Placements are ``Sharding``s: a mesh and, per dimension of the global
array, the mesh axis it is split over (None: whole), as a JAX
``PartitionSpec``; ``Sharding.local`` takes this rank's part.  Gathers
(``gather_params``, ``gather_tensor``) are an ``all_reduce`` of a
zero-filled full-size buffer into which each rank writes its slice: gloo
has no ``all_gather`` for CUDA tensors, and adding zeros is exact.
Reductions of bfloat16 or float16 tensors run in float32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("dp", "tp")


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """Mesh over (dp, tp) of the initialized process group's ranks, tp
    innermost (rank = dp_rank * tp + tp_rank).  Defaults: every rank,
    tp = 1."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized "
                           "(parallel.maybe_initialize_distributed)")
    n = dist.get_world_size()
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} devices")
    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=AXES)


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh: Optional[DeviceMesh], axis: str):
    """The process group of this rank's ``axis``, or None when the axis
    has one rank (no collective to make)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (float32 for half types) -> t."""
    if t.dtype in (torch.bfloat16, torch.float16):
        wide = t.float()
        dist.all_reduce(wide, group=group)
        return t.copy_(wide)
    dist.all_reduce(t, group=group)
    return t


# ---------------------------------------------------------------------- #
# placements                                                              #
# ---------------------------------------------------------------------- #


def _axis_slice(mesh: Optional[DeviceMesh], axis: str, n: int) -> slice:
    """This rank's part of n entries split over ``axis`` (n must divide)."""
    size = axis_size(mesh, axis)
    if n % size:
        raise ValueError(f"{n} entries do not split over {axis} = {size}")
    r, k = axis_rank(mesh, axis), n // size
    return slice(r * k, (r + 1) * k)


def batch_slice(mesh: Optional[DeviceMesh], n: int) -> slice:
    """This dp rank's rows of an n-row batch (n must divide by dp)."""
    return _axis_slice(mesh, "dp", n)


class Sharding(NamedTuple):
    """A placement: per dimension of the global array the mesh axis that
    splits it, or None (a ``PartitionSpec``; trailing dims whole)."""
    mesh: Optional[DeviceMesh]
    spec: Tuple[Optional[str], ...] = ()

    def local(self, x):
        """This rank's part of the global array ``x`` (numpy or torch; a
        view where the index allows one)."""
        return x[tuple(slice(None) if axis is None else
                       _axis_slice(self.mesh, axis, x.shape[dim])
                       for dim, axis in enumerate(self.spec))]


def replicate(mesh: Optional[DeviceMesh]) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Optional[DeviceMesh]) -> Sharding:
    """Leading (batch) dim over dp, everything else whole."""
    return Sharding(mesh, ("dp",))


def stacked_batch_sharding(mesh: Optional[DeviceMesh]) -> Sharding:
    """For (K, B, ...) stacks of K steps' batches: the step axis whole,
    each step's batch axis over dp."""
    return Sharding(mesh, (None, "dp"))


_COLUMN = ("q", "k", "v", "wi_0", "wi_1")  # (in, out): out split
_ROW = ("o", "wo")  # (in, out): in split
_SPLIT_DIM = {"col": 1, "row": 0}


def param_pspecs(state_dict) -> Dict[str, Optional[str]]:
    """Per state_dict name: "col" (q/k/v, wi_0/wi_1 of attention and MLP
    blocks), "row" (o, wo) or None (norms, embeddings, lm_head, relative
    bias, conditioning): the JAX package's megatron-style rules."""
    out = {}
    for name in state_dict:
        parts = name.split(".")
        block, leaf = (parts[-2], parts[-1]) if len(parts) > 1 else ("", "")
        spec = None
        if block in ("self_attn", "cross_attn", "mlp"):
            spec = "col" if leaf in _COLUMN else "row" if leaf in _ROW \
                else None
        out[name] = spec
    return out


def split_dim(spec: Optional[str]) -> Optional[int]:
    """A param_pspecs entry -> the dim split over tp (None: replicated)."""
    return None if spec is None else _SPLIT_DIM[spec]


def _spec_tuple(dim: Optional[int], axis: str = "tp") -> tuple:
    return () if dim is None else (None,) * dim + (axis,)


def param_shardings(mesh: Optional[DeviceMesh], state_dict
                    ) -> Dict[str, Sharding]:
    """Per state_dict name, its ``Sharding`` over the mesh."""
    return {k: Sharding(mesh, _spec_tuple(split_dim(s)))
            for k, s in param_pspecs(state_dict).items()}


def shard_tensor(t: torch.Tensor, dim: Optional[int],
                 mesh: Optional[DeviceMesh]) -> torch.Tensor:
    """This tp rank's slice of ``t`` along ``dim`` (None: ``t``), a
    contiguous copy (the whole tensor can then be freed)."""
    if dim is None or axis_size(mesh, "tp") == 1:
        return t
    return Sharding(mesh, _spec_tuple(dim)).local(t).clone(
        memory_format=torch.contiguous_format)


def gather_tensor(t: torch.Tensor, dim: Optional[int],
                  mesh: Optional[DeviceMesh], axis: str = "tp"
                  ) -> torch.Tensor:
    """``shard_tensor``'s inverse: the full tensor from every ``axis``
    rank's slice along ``dim``, on every rank (a zero-filled buffer summed
    over the axis)."""
    group = axis_group(mesh, axis)
    if dim is None or group is None:
        return t
    shape = list(t.shape)
    shape[dim] *= axis_size(mesh, axis)
    full = torch.zeros(shape, dtype=t.dtype, device=t.device)
    Sharding(mesh, _spec_tuple(dim, axis)).local(full).copy_(t)
    return all_reduce_(full, group)


def shard_params(state_dict, mesh: Optional[DeviceMesh]) -> dict:
    """Full state_dict -> this rank's: split leaves sliced over tp,
    replicated leaves as they are."""
    specs = param_pspecs(state_dict)
    return {k: shard_tensor(torch.as_tensor(v), split_dim(specs[k]), mesh)
            for k, v in state_dict.items()}


def gather_params(state_dict, mesh: Optional[DeviceMesh]) -> dict:
    """``shard_params``' inverse, on every rank (a collective over tp)."""
    specs = param_pspecs(state_dict)
    return {k: gather_tensor(v, split_dim(specs[k]), mesh)
            for k, v in state_dict.items()}


def local_config(cfg, mesh: Optional[DeviceMesh]):
    """A T5Config -> a tp rank's: num_heads / tp heads, d_ff / tp."""
    tp = axis_size(mesh, "tp")
    if cfg.num_heads % tp or cfg.d_ff % tp:
        raise ValueError(f"tp = {tp} must divide num_heads "
                         f"{cfg.num_heads} and d_ff {cfg.d_ff}")
    return cfg._replace(num_heads=cfg.num_heads // tp, d_ff=cfg.d_ff // tp)


# ---------------------------------------------------------------------- #
# the megatron operators                                                  #
# ---------------------------------------------------------------------- #


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over tp backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """The input summed over tp forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp_region(x: torch.Tensor, group) -> torch.Tensor:
    """In front of a column-split projection (x replicated over tp)."""
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp_region(x: torch.Tensor, group) -> torch.Tensor:
    """After a row-split projection: the partial products summed."""
    return x if group is None else _ReduceFromTP.apply(x, group)
