"""Prep stage 4: per-song alignment-quality metrics -> metadata YAML +
metrics.csv.

``python3 -m music2midi_tpu_torch.data.compute_metrics DATA_DIR
[--config CFG.yaml]``: the port
of the repository's ``data/compute_metrics.py``, writing the same files;
``metrics.csv`` goes to the working directory, as there, and is written
with the ``csv`` module as ``pandas.DataFrame.to_csv(index=False)`` writes
these columns.

Reference: data/compute_metrics.py — wp_std (std of warp-path skew),
max_beat_fluctuation (max RMS of the 2nd difference of aligned beat times
over 10 splits), max_note_density, time_diff_ratio; written back to each
song's metadata YAML and aggregated to metrics.csv.
"""

from __future__ import annotations

import argparse
import csv
import math
from pathlib import Path

import numpy as np

from ..midi import MidiFile
from ..config import resolve_config
from .metadata import dump_metadata, read_metadata

COLUMNS = ["piano_id", "opt_chroma_shift", "wp_std", "max_beat_fluctuation",
           "max_note_density", "time_diff_ratio", "genre", "difficulty"]


def rms(arr: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.asarray(arr) ** 2)))


def compute_metrics(meta_path: Path, data_dir: Path):
    meta = read_metadata(meta_path.read_text())
    piano_id = meta["piano"]["id"]
    audio_path = data_dir / "audio" / f"{piano_id}.wav"
    if not audio_path.exists():
        return None
    duration = meta["youtube"]["duration"]

    warp_path = np.load(data_dir / "warp_path" / f"{piano_id}.npy")
    beat_times = np.load(
        data_dir / "beat_times_aligned" / f"{piano_id}.npy"
    )
    midi = MidiFile(data_dir / "midi_transposed" / f"{piano_id}.mid")
    numpy_notes = np.load(data_dir / "midi_numpy" / f"{piano_id}.npy")

    wp_std = float(np.std(warp_path[0] - warp_path[1]))

    beat_times = np.append(beat_times, duration)
    beat_times = beat_times[np.diff(beat_times, prepend=-1) > 0.1]
    split_count = 10
    beat_splits = np.array_split(beat_times, split_count)
    max_beat_fluctuation = float(np.max(
        [rms(np.diff(np.diff(x))) for x in beat_splits if len(x) > 2]
    ))

    note_split_idx = np.searchsorted(
        numpy_notes[:, 0], [x[0] for x in beat_splits if len(x) > 1]
    )
    notes_split = np.array_split(numpy_notes, note_split_idx)
    duration_split = [x[-1] - x[0] for x in beat_splits if len(x) > 1]
    max_note_density = float(np.max(
        [len(n) / d for n, d in zip(notes_split, duration_split) if d > 0]
    ))

    midi_duration = midi.get_end_time()
    time_diff_ratio = abs(duration - midi_duration) / duration

    meta.setdefault("metrics", {})
    meta["metrics"].update(
        wp_std=wp_std,
        max_beat_fluctuation=max_beat_fluctuation,
        max_note_density=max_note_density,
        time_diff_ratio=float(time_diff_ratio),
    )
    meta_path.write_text(dump_metadata(meta, sort_keys=False))

    return [
        str(piano_id),
        meta["metrics"].get("opt_chroma_shift"),
        wp_std,
        max_beat_fluctuation,
        max_note_density,
        time_diff_ratio,
        meta["piano"]["genre"],
        meta["piano"]["difficulty"],
    ]


def _column(values: list) -> list:
    """One column's cells as pandas writes them: an all-int column as
    ints; a numeric column with a float or a None as float64 (repr, and ""
    for a missing value or NaN); anything else as str ("" for None)."""
    if all(type(v) is int for v in values):
        return [str(v) for v in values]
    if all(v is None or type(v) in (int, float) for v in values) \
            and any(v is not None for v in values):
        return ["" if v is None or math.isnan(v) else repr(float(v))
                for v in values]
    return ["" if v is None else str(v) for v in values]


def write_csv(path, rows: list) -> None:
    """``rows`` under COLUMNS, as ``DataFrame(rows, columns=COLUMNS)
    .to_csv(path, index=False)`` writes them."""
    cells = [_column([r[i] for r in rows]) for i in range(len(COLUMNS))]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(COLUMNS)
        writer.writerows(zip(*cells))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data_dir", type=str)
    parser.add_argument("--config", type=str, default=None,
                        help="config file, YAML or JSON (loaded, as every "
                             "stage loads it; no value of it is read here, "
                             "as in the root stage)")
    args = parser.parse_args(argv)
    resolve_config(args.config)
    data_dir = Path(args.data_dir)
    rows = []
    for meta_path in sorted(data_dir.glob("metadata/*.yaml")):
        try:
            row = compute_metrics(meta_path, data_dir)
        except (FileNotFoundError, KeyError) as e:
            print(f"{meta_path.stem}: skipped ({e})")
            continue
        if row is not None:
            rows.append(row)
    write_csv("metrics.csv", rows)
    print(f"wrote metrics.csv ({len(rows)} songs)")


if __name__ == "__main__":
    main()
