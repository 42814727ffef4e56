"""Run one cell of the port's benchmark once, on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The cell, its configuration, its traffic
mix and its per-layer metrics are found by name from ``BENCHMARK.json``
and the files under ``benchmark/`` (``spec.py``).  Set-up (weights,
songs, warm-up of the cell's shapes) is timed as ``setup_s``; then the
window measures for ``--seconds``; with ``--trace 1`` a short traced
slice follows and the per-layer metrics are reported instead of the
end-to-end ones.  After the window the program is freed and the plain
reference judges what the window produced; each number compared is
printed beside its limit, as the last lines of standard error and under
``checks``, the last key of the result.  The last line of standard output
is the result, one JSON object.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), and when ``sys.modules`` holds JAX or the JAX
package once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

ROOT = Path.cwd()
#: the top-level module names no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "music2midi_tpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return p.parse_args(argv)


def _set_environment() -> None:
    """Keep libraries that could load JAX by themselves from doing so.
    The program's kernels build into its own ``_build/`` in the checkout
    (for sm_90a, so the driver compiles nothing at run time)."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(root: Path, cell, seed: int, seconds: float, traced: bool,
             device, override=None) -> dict:
    """One run of ``cell`` on ``device`` -> the result object (without the
    checks for a card or for forbidden modules: ``main`` makes those).

    The mix's ``kind`` names the runner, ``kinds/<kind>.py``, whose
    ``run(root, cell, seed, seconds, traced, device, override)`` returns
    ``setup_s``, ``e2e`` (each end-to-end metric but ``setup_s``),
    ``attempted``, ``failed``, ``memory_peak_bytes``, ``checks`` ({name:
    {"value", "limit"}}, correct where every value is within its limit),
    ``ctx`` (what the per-layer readers read; with ``trace`` a
    ``TracedSlice`` under ``ctx["trace"]["slice"]``) and optionally
    ``cards`` (cards used, 1 if absent) and ``generator_late_s``."""
    from .spec import load, read_per_layer

    runner = load("kinds", cell.traffic["kind"], cell.pkg).run
    out = runner(root, cell, seed, seconds, traced, device, override)
    checks = out["checks"]
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    for c in checks.values():  # JSON has no infinity: no reading is null
        if not math.isfinite(c["value"]):
            c["value"] = None
    if traced:
        metrics = read_per_layer(cell, out["ctx"])
    else:
        values = {**out["e2e"], "setup_s": out["setup_s"]}
        metrics = {m.name: {"value": float(values[m.name]), "unit": m.unit}
                   for m in cell.end_to_end}
    from .drive.common import device_block

    dev = device_block(device)
    dev["count"] = int(out.get("cards", 1))
    dev["memory_peak_bytes"] = int(out["memory_peak_bytes"])
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    if traced:
        summary = out["ctx"]["trace"]["slice"].summary()
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
    if "generator_late_s" in out:
        result["generator_late_s"] = out["generator_late_s"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    _set_environment()
    import torch

    from .spec import find_cell

    cell = find_cell(ROOT, args.workload)
    chips = int(cell.entry["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); {found} "
              "found", file=sys.stderr)
        return 2
    from .drive.common import card_power_limit

    print(f"card: {card_power_limit()}", file=sys.stderr)
    result = run_cell(ROOT, cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 3
    if "generator_late_s" in result:
        print(f"generator late (s): {json.dumps(result['generator_late_s'])}",
              file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
