"""Checkpoint averaging CLI — write the mean of N checkpoints as an
inference export.

    python3 -m music2midi_tpu_torch.tools.average_checkpoints OUT_DIR
        SRC [SRC ...] [--weights ...]

The port of the repository's ``tools/average_checkpoints.py``.  Each SRC
is anything ``restore_params`` accepts: an npz from either package, a
``save_params`` export (SRC/params.pt, or the JAX package's orbax
SRC/params/), a training checkpoint root of either package (its latest
step_N taken), or a step_N dir.  The output is a ``save_params``
export, loadable by ``evaluate --ckpt OUT_DIR`` and
``Music2MIDI.from_checkpoint``.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="average N checkpoints into one inference export"
    )
    parser.add_argument("out_dir", type=str)
    parser.add_argument("sources", nargs="+", type=str)
    parser.add_argument(
        "--weights", nargs="+", type=float, default=None,
        help="per-source weights (default: uniform); normalized to sum 1",
    )
    args = parser.parse_args(argv)

    from ..train.checkpoint import average_params, save_params

    params, config = average_params(args.sources, args.weights)
    save_params(Path(args.out_dir), params, config)
    print(f"averaged {len(args.sources)} checkpoints -> {args.out_dir}")


if __name__ == "__main__":
    main()
