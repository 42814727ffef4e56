"""The port's bench (``music2midi_tpu_torch/bench.py``) against the root
``bench.py`` (CPU, small random weights).

Bars: the same flags plus ``--device``; ``_songs`` bit-equal to
``bench.py``'s; ``_decode_flops_from_stats`` equal to ``bench.py``'s on
the same stats; ``last_decode_stats`` of ``generate_batch`` equal to the
JAX engine's on two short songs in fp32; ``_run_workload`` returns every
field of ``bench.py``'s, and the result line every key of ``bench.py``'s
result dict, both read from its source; ``mfu`` null without a peak.
"""

import argparse
import ast
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from music2midi_tpu.config import default_config as jax_default_config
from music2midi_tpu.infer import Music2MIDI as JaxMusic2MIDI
from music2midi_tpu_torch import bench
from music2midi_tpu_torch.config import default_config
from music2midi_tpu_torch.infer import Music2MIDI

ROOT = Path(__file__).resolve().parent.parent
SMALL = {"num_layers": 2, "num_decoder_layers": 2, "d_model": 64,
         "d_ff": 96}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads per parallel test worker (see
    test_torch_pipeline.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def root_bench():
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small(cfg):
    for k, v in SMALL.items():
        cfg.model.t5[k] = v
    cfg.inference.batch_size = 8
    return cfg


@pytest.fixture(scope="module")
def engine():
    return Music2MIDI.from_random(_small(default_config()), seed=3,
                                  device="cpu", dtype=torch.bfloat16,
                                  decode_max_length=20)


@pytest.fixture(scope="module")
def short_songs():
    rng = np.random.default_rng(9)
    return [(rng.normal(size=n) * 0.1).astype(np.float32)
            for n in (16000 * 7, 16000 * 4)]


def test_flags_are_bench_py_flags_plus_device(root_bench, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    want = vars(root_bench.parse_args())
    got = vars(bench.parse_args([]))
    assert set(got) == set(want) | {"device"}
    assert got["device"] == "cuda"
    for k in want:
        assert got[k] == want[k], k


def test_songs_bit_equal_to_bench_py(root_bench):
    args = argparse.Namespace(audio_dir=None)
    got, want = bench._songs(args, 16000), root_bench._songs(args, 16000)
    assert len(got) == len(want) == bench.N_SONGS == 8
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        assert len(a) == 180 * 16000
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_decode_flops_from_stats_equal_bench_py(root_bench, engine,
                                                short_songs):
    engine.generate_batch(short_songs)
    assert engine.last_decode_stats
    assert bench._decode_flops_from_stats(engine) \
        == root_bench._decode_flops_from_stats(engine)


def test_decode_stats_equal_jax_engine_fp32(short_songs):
    port = Music2MIDI.from_random(_small(default_config()), seed=5,
                                  device="cpu", decode_max_length=20)
    ref = JaxMusic2MIDI.from_random(_small(jax_default_config()), seed=5,
                                    use_compilation_cache=False,
                                    decode_max_length=20)
    port.generate_batch(short_songs)
    ref.generate_batch(short_songs)
    assert port.last_decode_stats == ref.last_decode_stats
    assert port.last_decode_stats[0]["real_rows"] == 5


def _keys_of_dict(tree, func: str, target=None) -> set:
    """Keys of the dict literal that ``func`` returns (``target`` None)
    or assigns to ``target``."""
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if target is None and isinstance(node, ast.Return) and \
                isinstance(node.value, ast.Dict):
            return {k.value for k in node.value.keys}
        if target is not None and isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Dict) and \
                any(getattr(t, "id", None) == target for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no dict in {func}")


def test_run_workload_and_result_line_have_bench_py_keys(engine,
                                                         short_songs):
    tree = ast.parse((ROOT / "bench.py").read_text())
    head = bench._run_workload(engine, short_songs, groups=1, per_group=2,
                               lat_trials=2)
    assert _keys_of_dict(tree, "_run_workload") <= set(head)
    assert len(head["tput_sorted"]) == 2 and len(head["lat_sorted"]) == 2
    assert head["tokens_real"] > 0 and head["flops_per_call"] > 0
    assert head["flops_executed_per_call"] >= head["flops_per_call"]
    # the cap is 20 tokens: these random small weights run every chunk
    # to it
    rows = [r for s in head["decode_stats"] for r in s["row_steps"]]
    assert head["rows_at_cap"] == sum(r >= 19 for r in rows) == len(rows)
    args = bench.parse_args(["--device", "cpu"])
    args.ckpt = "weights.npz"
    result = bench.build_result(args, True, head, None, "cpu", None, head)
    want = _keys_of_dict(tree, "main", "result") | {
        "secondary_random_forced256"}
    assert want <= set(result)
    assert result["mfu"] is None and result["mfu_executed"] is None
    assert result["mode"] == "trained_eos"
    assert result["decode_steps"] == [s["steps"]
                                      for s in head["decode_stats"]]
    assert set(result["secondary_random_forced256"]) == {
        "songs_per_min", "mfu", "p50_song_latency_s"}
    peak = 1e12
    with_peak = bench.build_result(args, True, head, peak, "cpu")
    assert with_peak["mfu"] == round(
        head["flops_per_call"] / head["elapsed_median_s"] / peak, 4)
    assert "secondary_random_forced256" not in with_peak


def test_config_must_be_json(tmp_path):
    with pytest.raises(SystemExit, match="JSON"):
        bench._load_config(str(tmp_path / "config.yaml"))
    path = tmp_path / "config.json"
    path.write_text('{"inference": {"batch_size": 4}}')
    assert bench._load_config(str(path)) == {"inference": {"batch_size": 4}}
