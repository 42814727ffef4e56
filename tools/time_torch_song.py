"""Time one 3-minute song through the PyTorch port's serving path.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/time_torch_song.py [--trials 9]

Loads the model of record in the bf16 serving mode, warms up on the
synthetic song ``chip_smoke.py`` times (seed 7), then times ``trials``
``generate`` calls on it (host clock, each ending in a synchronize) and
prints one JSON line: the checkout, the card's name and power limit, each
call's seconds, their median and the decode steps.  The script imports
the port from the checkout it sits in, so a copy of it placed in another
checkout times that one: run two checkouts alternately in one session to
compare them on the same card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trials", type=int, default=9)
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_torch_song: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import RECORD, synthetic_song
    from music2midi_tpu_torch.infer import Music2MIDI

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    engine = Music2MIDI.from_npz(RECORD, dtype=torch.bfloat16)
    song = synthetic_song(180.0, 16000, seed=7)
    engine.generate(audio_y=song)  # warm-up: kernel build, allocator
    times = []
    for _ in range(args.trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        midi = engine.generate(audio_y=song)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(json.dumps({
        "root": str(ROOT), "card": smi, "times_s": times,
        "p50_s": float(np.median(times)),
        "notes": len(midi.instruments[0].notes),
        "decode_steps": [s["steps"] for s in engine.last_decode_stats]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
