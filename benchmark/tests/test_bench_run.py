"""The harness driven end to end on the CPU, past its look for a card: the
model of record under the cells' own configurations and limits, at a
small traffic size.  A sound run comes out correct; a run with the timed
path broken underneath comes out not correct, once for each fault the
cell can have."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.run import run_cell

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 99
SMALL = {"catalogue-fullmix": {"songs": 2, "seconds_min": 6.0,
                               "seconds_max": 9.0},
         "upload-fullmix": {"songs": 2, "seconds_min": 6.0,
                            "seconds_max": 9.0, "rate_per_s": 12.0,
                            "warm_widths": [8, 16, 32]},
         "train-windows-fullmix": {"songs": 2, "seconds_min": 9.0,
                                   "seconds_max": 9.0, "batch": 2,
                                   "windows": 6}}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The benchmark with its traffic cut small and the decode cap at 256
    tokens (CPU time); configurations, weights and limits as they are."""
    tmp = tmp_path_factory.mktemp("bench")
    pkg = tmp / "benchmark"
    shutil.copytree(ROOT / "benchmark", pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for name, changes in SMALL.items():
        f = pkg / "traffic" / f"{name}.json"
        f.write_text(json.dumps({**json.loads(f.read_text()), **changes}))
    for f in (pkg / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg["checkpoint"]["path"] = str(ROOT / cfg["checkpoint"]["path"])
        if "serving" in cfg:
            cfg["serving"]["decode_max_length"] = 256
        f.write_text(json.dumps(cfg))
    return tmp


def _run(tree, name, override=None):
    cell = spec.find_cell(tree, name, tree / "benchmark")
    return run_cell(tree, cell, SEED, 1.0, False, torch.device("cpu"),
                    override)


@pytest.mark.parametrize("name", ["record-bf16.catalogue",
                                  "record-bf16.upload"])
def test_a_sound_serving_run_is_correct(tree, name):
    out = _run(tree, name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "cpu"  # never a device metric


def test_a_sound_train_run_reports_its_checks(tree):
    """The training limits are the card's, set from its readings (~1e-7
    on every number); the CPU's kernels sum in other orders than the
    reference's here (the gradient gap reads ~4e-5), so this run shows
    only that every number is reported, far below any fault's reading
    (>= 0.04, PERF.md)."""
    out = _run(tree, "train-r5.step")
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    assert all(c["value"] < 1e-3 for c in out["checks"].values()), \
        out["checks"]
    assert out["failed"] == 0 and list(out)[-1] == "checks"


def _alter_token(monkeypatch):
    from music2midi_tpu_torch.infer import pipeline

    real = pipeline.generate_tokens

    def altered(*a, **kw):
        tokens, lengths = real(*a, **kw)
        tokens = tokens.clone()
        tokens[:, 1] = torch.where(tokens[:, 1] == 2, 3, tokens[:, 1] + 1)
        return tokens, lengths

    monkeypatch.setattr(pipeline, "generate_tokens", altered)


def _alter_answer(monkeypatch):
    from music2midi_tpu_torch.infer import pipeline

    real = pipeline.detokenize_to_host

    def altered(*a, **kw):
        rows = real(*a, **kw)
        return [r[:-1] if len(r) else np.array([[0.0, 0.05, 60, 80]])
                for r in rows]

    monkeypatch.setattr(pipeline, "detokenize_to_host", altered)


def _swap_answers(monkeypatch):
    from music2midi_tpu_torch.infer import pipeline

    real = pipeline.Music2MIDI._generate_locked

    def swapped(self, waves, cond_indices):
        return real(self, waves, cond_indices)[::-1]

    monkeypatch.setattr(pipeline.Music2MIDI, "_generate_locked", swapped)


SERVE_FAULTS = {"token_altered": _alter_token,
                "answer_altered": _alter_answer,
                "answers_swapped": _swap_answers}


@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS))
@pytest.mark.parametrize("name", ["record-bf16.catalogue",
                                  "record-bf16.upload"])
def test_a_broken_serving_path_is_not_correct(tree, name, fault,
                                              monkeypatch):
    SERVE_FAULTS[fault](monkeypatch)
    out = _run(tree, name)
    assert not out["correct"], out["checks"]


def _state_unchanged(monkeypatch):
    from music2midi_tpu_torch.train import adafactor

    monkeypatch.setattr(adafactor.Adafactor, "step",
                        lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from music2midi_tpu_torch.train import loop

    real = loop.to_device

    def half(batch, device):
        n = len(batch.waveform) // 2
        return real(loop.Batch(*(leaf[:n] for leaf in batch)), device)

    monkeypatch.setattr(loop, "to_device", half)


def _label_altered(monkeypatch):
    from music2midi_tpu_torch.train import loop

    real = loop.to_device

    def altered(batch, device):
        labels = np.array(batch.labels, copy=True)
        labels[:, 0] = np.where(labels[:, 0] >= 332, 133, labels[:, 0] + 1)
        return real(loop.Batch(batch.waveform, labels, batch.cond_index),
                    device)

    monkeypatch.setattr(loop, "to_device", altered)


TRAIN_FAULTS = {"state_unchanged": _state_unchanged,
                "half_batch": _half_batch,
                "label_altered": _label_altered}


@pytest.fixture(scope="module")
def sound_train(tree):
    return _run(tree, "train-r5.step")["checks"]


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_a_broken_train_step_is_not_correct(tree, sound_train, fault,
                                            monkeypatch):
    """Not correct, and by a number that the fault moves a hundredfold
    over the sound run's reading here (which the CPU's summation orders
    set, see above)."""
    TRAIN_FAULTS[fault](monkeypatch)
    out = _run(tree, "train-r5.step")
    assert not out["correct"], out["checks"]
    assert any(c["value"] > max(c["limit"], 100 * sound_train[k]["value"])
               for k, c in out["checks"].items()), out["checks"]


def test_a_traced_cpu_run_reports_no_device_metric(tree):
    cell = spec.find_cell(tree, "record-bf16.catalogue", tree / "benchmark")
    out = run_cell(tree, cell, SEED, 1.0, True, torch.device("cpu"))
    assert set(out["metrics"]) == {"batching.useful_row_share"}
    assert out["device"]["platform"] == "cpu"
