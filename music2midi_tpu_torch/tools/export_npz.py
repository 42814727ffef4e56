"""Export (optionally averaging) checkpoints into one .npz artifact.

    python3 -m music2midi_tpu_torch.tools.export_npz OUT.npz SRC [SRC ...]
        [--dtype bfloat16] [--weights ...]

The port of the repository's ``tools/export_npz.py``.  Each SRC is
anything ``restore_params`` accepts (an npz from either package, a
``save_params`` export, a training checkpoint root or step dir, the JAX
trainer's orbax directories among them, so a JAX run becomes an npz with
no JAX).  With
several sources the params are averaged (``average_params``) first.  The
output is the single-file checkpoint-of-record format, loadable by either
package's ``Music2MIDI.from_npz`` and by ``evaluate --ckpt OUT.npz``.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="export (averaged) checkpoints to a single .npz"
    )
    parser.add_argument("out", type=str, help="output .npz path")
    parser.add_argument("sources", nargs="+", type=str)
    parser.add_argument(
        "--dtype", type=str, default="bfloat16",
        choices=["bfloat16", "float16", "float32"],
        help="storage dtype for float weights (default bfloat16 — the "
             "serving dtype)",
    )
    parser.add_argument(
        "--weights", nargs="+", type=float, default=None,
        help="per-source averaging weights (default uniform)",
    )
    args = parser.parse_args(argv)

    from ..train.checkpoint import (
        average_params,
        restore_params,
        save_params_npz,
    )

    if len(args.sources) == 1 and args.weights is None:
        params, config = restore_params(args.sources[0])
    else:
        params, config = average_params(args.sources, args.weights)
    save_params_npz(args.out, params, config, dtype=args.dtype)
    size_mb = Path(args.out).stat().st_size / 1e6
    print(
        f"exported {len(args.sources)} source(s) -> {args.out} "
        f"({size_mb:.1f} MB, {args.dtype})"
    )


if __name__ == "__main__":
    main()
