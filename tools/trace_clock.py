"""How far the device's clock in a ``torch.profiler`` trace strays from the
host's, and what that does to a count of kernels by timestamp.

Decodes a seeded random encoder output (the model of record in bf16, EOS
suppressed, 128 steps at width 64) under ``profiling.trace`` several
times, captured and eager, and prints for each run, as one JSON line:
the kernel-3 launches the wrappers counted, the kernel-3 kernels of the
trace launched in the host's ``span`` window (matched by correlation
id, ``profiling.device_kernels``), those stamped inside the window, and
the microseconds by which the device's last activity ends past the
window although the host synchronized inside it
(``profiling.device_clock_past``).  Needs a CUDA card:

    python3 tools/trace_clock.py [--runs 6]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = "decode_attention_int8_kernel"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from music2midi_tpu_torch import profiling
    from music2midi_tpu_torch.infer import Music2MIDI
    from music2midi_tpu_torch.infer.decode import (
        generate_tokens,
        generate_tokens_eager,
    )
    from music2midi_tpu_torch.ops import decode_attention as da

    if not torch.cuda.is_available():
        print("trace_clock: no CUDA device", file=sys.stderr)
        return 1
    eng = Music2MIDI.from_npz(ROOT / "checkpoints" / "model_of_record.npz",
                              dtype=torch.bfloat16)
    cfg = eng.t5_config
    g = torch.Generator(device="cuda").manual_seed(0)
    enc = torch.randn(64, 190, cfg.d_model, generator=g, device="cuda"
                      ).to(torch.bfloat16)
    dcfg = eng._dcfg()._replace(suppress_tokens=(2,), max_length=129)
    for name, fn in (("captured", generate_tokens),
                     ("eager", generate_tokens_eager)):
        if fn is generate_tokens:  # its capture, outside the traces
            fn(eng.model, enc, cfg, dcfg)
        for run in range(args.runs):
            da.decode_attention_int8.launches = 0
            with tempfile.TemporaryDirectory() as td:
                with profiling.trace(td):
                    with profiling.span("decode_call"):
                        fn(eng.model, enc, cfg, dcfg)
                        torch.cuda.synchronize()
                events = profiling.load_trace(td)
            window = profiling.annotation_window(events, "decode_call")
            stamped = sum(ev.get("cat") == "kernel" and KERNEL in ev["name"]
                          and window[0] <= ev["ts"] < window[1]
                          for ev in events)
            print(json.dumps({
                "run": f"{name} {run}",
                "counted": da.decode_attention_int8.launches,
                "launched_in_window": profiling.device_kernels(
                    events, (KERNEL,), window)[KERNEL],
                "stamped_in_window": stamped,
                "device_clock_past_us": round(
                    profiling.device_clock_past(events, window), 3),
                "window_ms": round((window[1] - window[0]) / 1e3, 3),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
