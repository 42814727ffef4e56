"""Offline batch conversion CLI of the port:
``python3 -m music2midi_tpu_torch.serve_batch OUT_DIR SONG...``.

The port of the repository's root ``serve_batch.py``: the same flags plus
``--device`` (default ``cuda``), the same per-song lines and the same final
JSON line (``songs``, ``seconds``, ``songs_per_min``, ``notes``).  Every
song goes through one ``Music2MIDI.generate_batch(audio_paths=...)`` call,
whose loads run on threads ahead of the card; a song that is not a WAV
needs ``ffmpeg``.

    python3 -m music2midi_tpu_torch.serve_batch covers/ songs/*.wav \\
        --ckpt checkpoints/model_of_record.npz --genre pop \\
        --difficulty intermediate
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from .evaluate import CONFIG_HELP, DTYPES, load_engine


def main(argv=None) -> dict:
    """Run the CLI; -> the final JSON line's values."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("out_dir", type=str)
    parser.add_argument("songs", nargs="+", type=str)
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--config", type=str, default=None, help=CONFIG_HELP)
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=list(DTYPES))
    parser.add_argument("--genre", type=str, default=None)
    parser.add_argument("--difficulty", type=str, default=None)
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device (default cuda; no fallback to the CPU)")
    args = parser.parse_args(argv)

    engine = load_engine(args.ckpt, args.config, args.dtype, args.device)
    names = {}
    if args.genre:
        names["genre"] = args.genre
    if args.difficulty:
        names["difficulty"] = args.difficulty
    cond = engine.cond_index_from_names(**names) if names else None

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = [Path(song) for song in args.songs]
    t0 = time.perf_counter()
    midis = engine.generate_batch(
        cond_indices=[cond] * len(paths), audio_paths=paths)
    elapsed = time.perf_counter() - t0
    total_notes = 0
    for path, midi in zip(paths, midis):
        out = out_dir / (path.stem + ".mid")
        midi.write(out)
        n = sum(len(i.notes) for i in midi.instruments)
        total_notes += n
        print(f"{out} ({n} notes)")
    result = {
        "songs": len(paths),
        "seconds": round(elapsed, 2),
        "songs_per_min": round(len(paths) / (elapsed / 60), 1),
        "notes": total_notes,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
