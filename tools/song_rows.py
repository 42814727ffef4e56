"""Per-chunk decode lengths of the synthetic 3-minute song.

Run from the repository root:

    python3 tools/song_rows.py --engine torch [--device cuda|cpu]
        [--dtype bf16|fp32] [--max-length N] [--fp32-reduction]
    python3 tools/song_rows.py --engine jax [--dtype bf16|fp32]
        [--max-length N]

Takes the song ``chip_smoke.py`` times (seed 7, 60 chunks of 3 s in one
64-row bucket) and decodes it through one engine's own
``sample_tokens_batched``: the PyTorch port (``--engine torch``, on the
card by default) or the JAX package it is held against (``--engine
jax``, on the CPU; this imports jax, so it runs where jax is installed).
``bf16`` is the serving mode (int8 self- and cross-KV), ``fp32`` the
parity mode.  ``--fp32-reduction`` turns off cuBLAS's reduced-precision
reduction for bf16 matmuls (``torch.backends.cuda.matmul.
allow_bf16_reduced_precision_reduction = False``).

Prints one line: the set-up, seconds, decode steps, the chunks that
reached the ``--max-length`` cap without EOS, and every chunk's length
(start and EOS included).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _engine(args):
    if args.engine == "jax":
        import jax
        import jax.numpy as jnp

        jax.config.update("jax_platforms", "cpu")
        from music2midi_tpu.infer import Music2MIDI

        dtype = jnp.bfloat16 if args.dtype == "bf16" else jnp.float32
        eng = Music2MIDI.from_npz(ROOT / "checkpoints" / "model_of_record.npz",
                                  dtype=dtype, use_compilation_cache=False,
                                  decode_max_length=args.max_length)
        eng.collect_decode_stats = True
        return eng
    import torch

    from music2midi_tpu_torch.infer import Music2MIDI

    if args.fp32_reduction:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    return Music2MIDI.from_npz(ROOT / "checkpoints" / "model_of_record.npz",
                               dtype=dtype, device=args.device,
                               decode_max_length=args.max_length)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=("torch", "jax"), default="torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--max-length", type=int, default=1024)
    ap.add_argument("--fp32-reduction", action="store_true")
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    from chip_smoke import synthetic_song

    song = synthetic_song(180.0, 16000, seed=7)
    eng = _engine(args)
    t0 = time.perf_counter()
    tokens = eng.sample_tokens_batched(eng._chunk_waveform(song))
    secs = time.perf_counter() - t0
    lengths = [len(t) for t in tokens]
    at_cap = [i for i, t in enumerate(tokens)
              if len(t) == args.max_length and t[-1] != 2]
    where = "cpu" if args.engine == "jax" else args.device
    print(f"{args.engine} {args.dtype} on {where}"
          f"{' fp32-reduction' if args.fp32_reduction else ''}: "
          f"seconds={secs:.3f} steps={max(lengths) - 1} "
          f"at_cap={at_cap} lengths={lengths}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
