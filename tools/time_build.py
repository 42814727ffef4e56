"""Time the two ways of building the port's CUDA kernels.

Run from the repository root on a machine with ``nvcc``:

    python3 tools/time_build.py [--rounds 2]

Builds ``music2midi_tpu_torch/csrc/*.cu`` into a scratch directory under
``music2midi_tpu_torch/_build/`` (gitignored) with the flags of
``ops/_build.py``, in turns (one, parallel, parallel, one, ...):

  * one: a single ``nvcc -shared`` over every source;
  * parallel: what ``ops/_build.py`` does, one ``nvcc -c`` per source, all
    started together, then one ``nvcc -shared`` link.

Prints one JSON line: the sources, each build's seconds in the order run,
and the median of each way.  Leaves nothing behind.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from music2midi_tpu_torch.ops import _build  # noqa: E402


def build_one(nvcc: str, sources: list, out: Path) -> None:
    _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
                      str(out / "one.so"), *map(str, sources)]])


def build_parallel(nvcc: str, sources: list, out: Path) -> None:
    objs = [out / f"{src.stem}.o" for src in sources]
    _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-c", str(src), "-o",
                      str(obj)] for src, obj in zip(sources, objs)])
    _build._run_all([[nvcc, "-shared", "-o", str(out / "parallel.so"),
                      *map(str, objs)]])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2,
                    help="pairs of (one, parallel) builds, in turns")
    args = ap.parse_args()
    nvcc = _build.find_nvcc()
    sources = _build._sources()
    scratch = _build.BUILD_DIR / "time_build"
    runs = {"one": [], "parallel": []}
    order = []
    for r in range(args.rounds):
        order += ["one", "parallel"] if r % 2 == 0 else ["parallel", "one"]
    try:
        for way in order:
            shutil.rmtree(scratch, ignore_errors=True)
            scratch.mkdir(parents=True)
            t0 = time.perf_counter()
            (build_one if way == "one" else build_parallel)(
                nvcc, sources, scratch)
            runs[way].append(time.perf_counter() - t0)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    print(json.dumps({
        "sources": [s.name for s in sources], "order": order,
        "seconds": runs,
        "median_s": {k: statistics.median(v) for k, v in runs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
