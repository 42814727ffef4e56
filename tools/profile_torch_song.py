"""Profile one 3-minute song through the PyTorch port's serving path.

Run from the repository root on a machine with a CUDA card:

    python3 tools/profile_torch_song.py

Loads the model of record in the bf16 serving mode, warms up on the same
synthetic song ``chip_smoke.py`` times (seed 7), then runs ``generate``
once under ``torch.profiler`` (``profiling.trace``) and prints: wall
time, the device's busy time (the union of its kernel intervals) and idle
share, the host's kernel and graph launches, and the kernels by total
device time.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_song: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import tempfile

    from chip_smoke import RECORD, synthetic_song
    from music2midi_tpu_torch import profiling
    from music2midi_tpu_torch.infer import Music2MIDI

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    engine = Music2MIDI.from_npz(RECORD, dtype=torch.bfloat16)
    song = synthetic_song(180.0, 16000, seed=7)
    engine.generate(audio_y=song)  # warm-up: kernel build, capture, allocator
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as td:
        with profiling.trace(td):
            with profiling.span("song"):
                t0 = time.perf_counter()
                engine.generate(audio_y=song)
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
        events = profiling.load_trace(td)
        rows = profiling.summarize_trace(td, top=20)
    window = profiling.annotation_window(events, "song")
    busy_us = profiling.device_busy_us(events, window)
    print(f"card: {smi}")
    print(f"wall_s={wall_s:.4f} device_busy_s={busy_us / 1e6:.4f} "
          f"idle_share={profiling.device_idle_share(events, window):.4f} "
          f"host_launches={profiling.host_launches(events, window)} "
          f"decode_steps={[s['steps'] for s in engine.last_decode_stats]}")
    for ms, n, name in rows:
        print(f"{ms:10.3f} ms x{n:6d}  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
