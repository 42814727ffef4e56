"""Profile one 3-minute song through the PyTorch port's serving path.

Run from the repository root on a machine with a CUDA card:

    python3 tools/profile_torch_song.py

Loads the model of record in the bf16 serving mode, warms up on the same
synthetic song ``chip_smoke.py`` times (seed 7), then runs ``generate``
once under ``torch.profiler`` and prints: wall time, the device's busy
time (the union of its kernel intervals) and idle share, and the kernels
by total device time.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def busy_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_song: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import RECORD, synthetic_song
    from music2midi_tpu_torch.infer import Music2MIDI

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    engine = Music2MIDI.from_npz(RECORD, dtype=torch.bfloat16)
    song = synthetic_song(180.0, 16000, seed=7)
    engine.generate(audio_y=song)  # warm-up: kernel build, allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        engine.generate(audio_y=song)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = busy_seconds(
        (e.time_range.start, e.time_range.end) for e in kernels)
    print(f"card: {smi}")
    print(f"wall_s={wall_s:.4f} device_busy_s={busy_us / 1e6:.4f} "
          f"idle_share={1 - busy_us / 1e6 / wall_s:.4f} "
          f"kernel_launches={len(kernels)} "
          f"decode_steps={[s['steps'] for s in engine.last_decode_stats]}")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20))
    return 0


if __name__ == "__main__":
    sys.exit(main())
