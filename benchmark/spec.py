"""Finding a cell's pieces by name, from files alone.

``BENCHMARK.json`` at the checkout's root lists the configurations, cells
and metrics; each piece is a file found by its name:

* a configuration:  ``benchmark/configs/<config>.json``
* a cell:           ``benchmark/workloads/<cell>.json``
* a traffic mix:    ``benchmark/traffic/<traffic>.json`` (data: the
  parameters ``generate.py`` reads)
* the runner of a mix's ``kind``: ``benchmark/kinds/<kind>.py``, whose
  ``run(root, cell, seed, seconds, traced, device, override)`` runs the
  cell once (``run.py`` says what it returns)
* the renderer of a mix's song ``profile``: ``benchmark/profiles/
  <profile>.py``, whose ``render(entropy, seconds, sr, bar)`` returns
  (waveform, performed notes)
* the arrival process of an open-loop mix: ``benchmark/arrivals/
  <arrivals>.py``, whose ``schedule(traffic, seed, seconds)`` returns the
  requests' scheduled times in the window
* a per-layer metric's reader: ``benchmark/metrics/<metric>.py``, whose
  ``read(ctx)`` returns the metric's value or None when the run gave it
  nothing to read.

A later change adds a cell, configuration, traffic mix, kind, profile,
arrival process or metric by adding files and entries; nothing here names
one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, NamedTuple

PKG = Path(__file__).resolve().parent


class Metric(NamedTuple):
    name: str
    unit: str


class Cell(NamedTuple):
    name: str
    entry: dict  # the cell's BENCHMARK.json entry
    spec: dict  # benchmark/workloads/<cell>.json
    config: dict  # benchmark/configs/<config>.json
    traffic: dict  # benchmark/traffic/<traffic>.json
    end_to_end: List[Metric]  # what a --trace 0 run reports
    per_layer: List[Metric]  # what a --trace 1 run reports
    pkg: Path  # the benchmark folder its pieces were found in


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(root: Path, name: str, pkg: Path = PKG) -> Cell:
    """The cell called ``name``, with its files; KeyError if unknown."""
    bench = _json(Path(root) / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(known: {sorted(entries)})")
    entry = entries[name]
    e2e = [Metric(m["name"], m["unit"]) for m in bench["end_to_end"]
           if _applies(m, name)]
    reported = {m.name for m in e2e}
    layer = [Metric(m["name"], m["unit"]) for m in bench["per_layer"]
             if _applies(m, name) and m["moves"] in reported]
    return Cell(name, entry, _json(pkg / "workloads" / f"{name}.json"),
                _json(pkg / "configs" / f"{entry['config']}.json"),
                _json(pkg / "traffic" / f"{entry['traffic']}.json"),
                e2e, layer, Path(pkg))


def load(folder: str, name: str, pkg: Path = PKG) -> ModuleType:
    """The module ``benchmark/<folder>/<name>.py``, loaded from its file
    (a name may hold ``.`` and ``-``); FileNotFoundError if there is
    none."""
    path = Path(pkg) / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} named {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{folder}.{name.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, pkg: Path = PKG) -> Callable[[dict], object]:
    """``read`` of ``benchmark/metrics/<name>.py``."""
    return load("metrics", name, pkg).read


def read_per_layer(cell: Cell, ctx: dict, pkg: Path = PKG
                   ) -> Dict[str, dict]:
    """Every per-layer metric of the cell that its reader found something
    for, as ``{name: {"value", "unit"}}``."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m.name, pkg)(ctx)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out
