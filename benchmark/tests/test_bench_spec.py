"""BENCHMARK.json against its contract, the pieces found by name from
files alone, and ``benchmark.run`` refusing to run without a card or
without the program."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import spec

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_to_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024
    cells = {w["name"]: w for w in b["workloads"]}
    configs = {c["name"]: c for c in b["configs"]}
    assert {w["config"] for w in cells.values()} == set(configs)
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) \
        == len(cells)
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert (ROOT / c["file"]).is_file()
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        for name in (w["name"], w["config"], w["traffic"]):
            assert NAME.match(name), name
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= set(cells)
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert (PKG / "metrics" / f"{m['name']}.py").is_file()
    for name in cells:
        cell = spec.find_cell(ROOT, name)
        reported = [m.name for m in cell.end_to_end]
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer, name
        assert (PKG / "traffic" / f"{cell.entry['traffic']}.json").is_file()
        t = cell.traffic
        assert (PKG / "kinds" / f"{t['kind']}.py").is_file()
        assert (PKG / "profiles" / f"{t['profile']}.py").is_file()
        if "arrivals" in t:
            assert (PKG / "arrivals" / f"{t['arrivals']}.py").is_file()


def test_roofline_and_mfu_metrics_are_named_as_shares():
    for m in _bench()["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A new traffic mix, configuration, cell and per-layer metric, as new
    files and new BENCHMARK.json entries, are found by name."""
    pkg = tmp_path / "benchmark"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    (pkg / "configs" / "dummy.json").write_text(
        (PKG / "configs" / "record-bf16.json").read_text())
    traffic = json.loads((PKG / "traffic" / "catalogue-fullmix.json")
                         .read_text())
    traffic["songs"] = 3
    (pkg / "traffic" / "dummy-mix.json").write_text(json.dumps(traffic))
    (pkg / "workloads" / "dummy.cell.json").write_text(json.dumps(
        {"config": "dummy", "traffic": "dummy-mix",
         "check": {"songs": 1, "limits": {"logit_gap_mean": 1.0}},
         "trace": {"calls": 1}}))
    (pkg / "metrics" / "dummy.count.py").write_text(
        "def read(ctx):\n    return len(ctx['calls']) or None\n")
    b["configs"].append({"name": "dummy", "source": "x", "reduced": [],
                         "file": "benchmark/configs/dummy.json", "why": "x"})
    b["workloads"].append({"name": "dummy.cell", "config": "dummy",
                           "traffic": "dummy-mix", "chips": 1, "why": "x"})
    b["end_to_end"][0]["workloads"].append("dummy.cell")
    b["per_layer"].append({"name": "dummy.count", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "x", "moves": b["end_to_end"][0]["name"],
                           "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.find_cell(tmp_path, "dummy.cell", pkg)
    assert cell.traffic["songs"] == 3 and cell.config["name"] == "record-bf16"
    assert [m.name for m in cell.per_layer] == ["dummy.count"]
    assert {m.name for m in cell.end_to_end} == {
        b["end_to_end"][0]["name"], "setup_s"}
    got = spec.read_per_layer(cell, {"calls": [1, 2]}, pkg)
    assert got == {"dummy.count": {"value": 2.0, "unit": "calls"}}
    assert spec.read_per_layer(cell, {"calls": []}, pkg) == {}


KIND = """
import numpy as np
from benchmark import generate


def run(root, cell, seed, seconds, traced, device, override=None):
    t = cell.traffic
    songs = generate.song_pool(t, seed, 16000, [6, 3], cell.pkg).result()
    times, which = generate.arrivals(t, seed, seconds, cell.pkg)
    peaks = [float(np.abs(s.wave).max()) for s in songs]
    return {"setup_s": 0.5, "e2e": {"dummy_requests": float(len(times))},
            "attempted": len(times), "failed": 0, "memory_peak_bytes": 0,
            "checks": {"peak": {"value": max(peaks), "limit": 0.5},
                       "songs": {"value": abs(len(set(which)) - len(songs)),
                                 "limit": 0}},
            "ctx": {"calls": []}}
"""
PROFILE = """
import numpy as np


def render(entropy, seconds, sr, bar):
    t = np.arange(int(round(seconds * sr))) / sr
    pitch = 60 + int(np.random.default_rng(list(entropy)).integers(12))
    wave = 0.25 * np.sin(2 * np.pi * 440.0 * 2 ** ((pitch - 69) / 12) * t)
    return wave.astype(np.float32), np.array([[0.0, seconds, pitch, 80.0]])
"""
ARRIVALS = """
import numpy as np


def schedule(traffic, seed, seconds):
    return np.arange(int(traffic["rate_per_s"] * seconds)) \\
        / float(traffic["rate_per_s"])
"""


def test_a_kind_a_profile_and_arrivals_are_added_by_files_alone(tmp_path):
    """A mix of a new kind, with songs of a new profile at a new arrival
    process, runs through ``run_cell`` from new files and entries alone."""
    import torch

    from benchmark.run import run_cell

    pkg = tmp_path / "benchmark"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "kinds" / "dummy_kind.py").write_text(KIND)
    (pkg / "profiles" / "dummy-sine.py").write_text(PROFILE)
    (pkg / "arrivals" / "dummy.even.py").write_text(ARRIVALS)
    (pkg / "traffic" / "dummy-mix.json").write_text(json.dumps(
        {"kind": "dummy_kind", "profile": "dummy-sine", "songs": 3,
         "seconds_min": 1.0, "seconds_max": 2.0, "bars": [2.0],
         "arrivals": "dummy.even", "rate_per_s": 4.0}))
    (pkg / "workloads" / "dummy.cell.json").write_text(json.dumps(
        {"config": "record-bf16", "traffic": "dummy-mix"}))
    b = _bench()
    b["workloads"].append({"name": "dummy.cell", "config": "record-bf16",
                           "traffic": "dummy-mix", "chips": 1, "why": "x"})
    b["end_to_end"].append({"name": "dummy_requests", "unit": "requests",
                            "better": "higher", "bound": 0.01,
                            "source": "host_clock",
                            "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.find_cell(tmp_path, "dummy.cell", pkg)
    out = run_cell(tmp_path, cell, 2 ** 31 + 5, 3.0, False,
                   torch.device("cpu"))
    assert out["correct"], out["checks"]
    assert out["metrics"] == {
        "dummy_requests": {"value": 12.0, "unit": "requests"},
        "setup_s": {"value": 0.5, "unit": "s"}}
    assert 0.24 < out["checks"]["peak"]["value"] <= 0.25
    with pytest.raises(FileNotFoundError, match="no kinds named"):
        spec.load("kinds", "absent_kind", pkg)


def _run(cwd, env_extra=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})}
    env["PYTHONPATH"] = str(cwd)
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "record-bf16.catalogue", "--seed", str(2 ** 31 + 7), "--seconds",
         "1", "--trace", "0"], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300)


def test_run_exits_without_a_card_and_prints_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_run_exits_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PKG, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla", "flax", "optax",
                                  "orbax.checkpoint", "music2midi_tpu",
                                  "music2midi_tpu.infer"])
def test_forbidden_modules_are_found_by_whole_top_level_name(monkeypatch,
                                                             name):
    from benchmark import run

    monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == [name.split(".")[0]]


def test_the_port_is_not_a_forbidden_module(monkeypatch):
    from benchmark import run

    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "music2midi_tpu_torch", object())
    monkeypatch.setitem(sys.modules, "music2midi_tpu_torch.infer", object())
    assert run.forbidden_modules() == []
