"""On the card: each cell's control, the program run one step of
precision below what its configuration states (``control`` in the
configuration's file), comes out not correct at the cell's own traffic
and widths, on three seeds (a 2-s window: the check reads the window's
first calls or steps).

    python3 -m pytest -m gpu benchmark/tests/test_bench_card.py

Skips without a CUDA card."""

from pathlib import Path

import pytest
import torch

from benchmark import spec
from benchmark.run import run_cell

pytestmark = pytest.mark.gpu
ROOT = Path(__file__).resolve().parents[2]
SEEDS = [2 ** 31 + 1001, 2 ** 31 + 1002, 2 ** 31 + 1003]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["record-bf16.catalogue", "train-r5.step",
                                  "record-bf16.upload"])
def test_the_control_is_not_correct(card, name, seed):
    cell = spec.find_cell(ROOT, name)
    control = cell.config["control"]
    override = control.get("serving", control.get("training"))
    try:
        out = run_cell(ROOT, cell, seed, 2.0, False, card, override)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    assert not out["correct"], out["checks"]
