"""One rank of ``tests/test_torch_adafactor.py``'s tensor-parallel step:

    python _adafactor_tp_child.py RANK WORLD INIT_FILE OUT

joins a gloo group through ``file://INIT_FILE``, takes its tp slices of
``SPLITS``' leaves (``parallel/mesh.py``'s split: rows or columns), steps
them ``len(GRADS)`` times with Adafactor under the tp group, counting the
``all_reduce`` calls of each step, and saves its parameters, moments and
counts to OUT."""

import sys

import numpy as np
import torch
import torch.distributed as dist

SHAPES = [(24, 16), (16, 24), (12, 8), (16,)]
SPLITS = [0, 1, None, None]  # rows, columns, replicated, replicated
N_STEPS = 3
LR = 0.05


def draws():
    rng = np.random.default_rng(7)
    init = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.uniform(-3, 1)).astype(
        np.float32) for s in SHAPES] for _ in range(N_STEPS)]
    return init, grads


def local(x: np.ndarray, dim, rank: int, world: int) -> np.ndarray:
    """This rank's slice of ``x`` along ``dim`` (None: all of it)."""
    if dim is None:
        return x
    return np.split(x, world, axis=dim)[rank].copy()


def main(rank: int, world: int, init_file: str, out: str) -> None:
    from music2midi_tpu_torch.train.adafactor import Adafactor

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    calls = []
    all_reduce = dist.all_reduce

    def counted(*args, **kwargs):
        calls[-1] += 1
        return all_reduce(*args, **kwargs)

    dist.all_reduce = counted
    init, grads = draws()
    params = [torch.nn.Parameter(torch.from_numpy(local(x, d, rank, world)))
              for x, d in zip(init, SPLITS)]
    opt = Adafactor(params, lr=LR, warmup_init=False,
                    tp_group=dist.group.WORLD, split_dims=SPLITS)
    for gs in grads:
        for p, g, d in zip(params, gs, SPLITS):
            p.grad = torch.from_numpy(local(g, d, rank, world))
        calls.append(0)
        opt.step()
    torch.save({"params": [p.detach() for p in params],
                "moments": [{k: v.clone() for k, v in opt.state[p].items()
                             if k != "step"} for p in params],
                "calls": calls}, out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
