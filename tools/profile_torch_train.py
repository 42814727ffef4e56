"""Profile the PyTorch port's train step on the card at full width.

Run from the repository root on a machine with a CUDA card:

    python3 tools/profile_torch_train.py [--steps 5] [--batch 16]

Warm-starts from the model of record, dropout 0.1 and the reference's
relative-step Adafactor, on a seeded batch of 3-s windows at 22050 Hz
(261 encoder positions) with labels 90 wide.  For fp32 and bf16 mixed
precision it prints the host-clock split of a step into forward +
backward and the optimizer (each ending in a synchronize), then profiles
``--steps`` steps under ``torch.profiler``: wall time, the device's busy
time (the union of its kernel intervals) and idle share, kernel launches
a step, and the kernels by total device time.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--batch", type=int, default=16)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import RECORD
    from profile_torch_song import busy_seconds
    from music2midi_tpu_torch.bench import card_name_and_power_limit
    from music2midi_tpu_torch.config import default_config
    from music2midi_tpu_torch.models.t5 import t5_config_from
    from music2midi_tpu_torch.ops.mel import log_mel_config_from
    from music2midi_tpu_torch.train import Adafactor, Batch, make_train_step
    from music2midi_tpu_torch.train.loop import (
        TrainState,
        _loss,
        dropout_generator,
        to_device,
        trainable_model,
    )
    from music2midi_tpu_torch.weights import load_npz

    smi = card_name_and_power_limit()
    sd, rec_cfg = load_npz(RECORD)
    mel_cfg = log_mel_config_from(default_config())
    rng = np.random.default_rng(0)
    B = args.batch
    labels = rng.integers(3, 333, size=(B, 90)).astype(np.int32)
    labels[:, -1] = 2
    batch = Batch((rng.normal(size=(B, 66150)) * 0.1).astype(np.float32),
                  labels, rng.integers(0, 3, size=(B, 2)))
    print(f"card: {smi}")
    for dtype in (torch.float32, torch.bfloat16):
        cfg = t5_config_from(rec_cfg, dtype)
        model = trainable_model(sd, cfg, "cuda")
        state = TrainState(model, Adafactor(list(model.parameters())))
        step = make_train_step(cfg, mel_cfg)
        for _ in range(3):
            step(state, batch, 0)
        fb, opt = [], []
        for _ in range(args.steps):
            dev = to_device(batch, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state.optimizer.zero_grad(set_to_none=True)
            _loss(model, dev, dropout_generator(0, state.step, "cuda"), cfg,
                  mel_cfg, False).backward()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state.optimizer.step()
            torch.cuda.synchronize()
            fb.append(t1 - t0)
            opt.append(time.perf_counter() - t1)
            state.step += 1
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                step(state, batch, 0)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = busy_seconds(
            (e.time_range.start, e.time_range.end) for e in kernels)
        print(f"{dtype}: forward+backward median_ms="
              f"{np.median(fb) * 1e3:.3f} optimizer median_ms="
              f"{np.median(opt) * 1e3:.3f} | profiled {args.steps} steps: "
              f"wall_s={wall_s:.4f} device_busy_s={busy_us / 1e6:.4f} "
              f"idle_share={1 - busy_us / 1e6 / wall_s:.4f} "
              f"kernel_launches_per_step={len(kernels) / args.steps:.1f}")
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=12))
    return 0


if __name__ == "__main__":
    sys.exit(main())
