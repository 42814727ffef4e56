"""Prep stage 3: midi_aligned/*.mid -> midi_numpy/*.npy (N, 4) note arrays.

``python3 -m music2midi_tpu_torch.data.midi_to_numpy DATA_DIR
[--workers 8]``: the port of the repository's ``data/midi_to_numpy.py``,
writing the same files.

Reference: data/midi_to_numpy.py — flatten all instruments to
(start, end, pitch, velocity) rows, lexsort by onset > offset > pitch, clamp
each note's offset to the next same-pitch onset.  The O(n^2)-per-pitch numba
kernel is replaced by the native C++ ``m2m_fix_invalid_offsets``
(O(n log n), ``native.py``), with a numpy fallback.  Skip-if-exists resume
semantics kept.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .. import native
from ..midi import MidiFile
from ..utils import midi_to_numpy_notes


def fix_invalid_offsets(notes: np.ndarray) -> np.ndarray:
    if native.available():
        return native.fix_invalid_offsets(notes)
    # numpy fallback: same semantics (offset <= next same-pitch onset)
    for pitch in np.unique(notes[:, 2]):
        idx = notes[:, 2] == pitch
        tmp = notes[idx]
        order = np.argsort(tmp[:, 0], kind="stable")
        tmp = tmp[order]
        onsets = tmp[:, 0]
        for i in range(len(tmp)):
            later = onsets[onsets > onsets[i]]
            if len(later):
                tmp[i, 1] = min(tmp[i, 1], later.min())
        restored = np.empty_like(tmp)
        restored[order] = tmp
        notes[idx] = restored
    return notes


def process_one(midi_path: Path, output_dir: Path) -> None:
    output_path = output_dir / f"{midi_path.stem}.npy"
    if output_path.exists():
        print(f"{output_path} already exists")
        return
    notes = midi_to_numpy_notes(MidiFile(midi_path))
    if len(notes) == 0:
        print(f"{midi_path}: no notes, skipped")
        return
    np.save(output_path, fix_invalid_offsets(notes))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data_dir", type=str)
    parser.add_argument("--workers", type=int, default=8)
    args = parser.parse_args(argv)
    data_dir = Path(args.data_dir)
    output_dir = data_dir / "midi_numpy"
    output_dir.mkdir(exist_ok=True)
    paths = sorted(data_dir.glob("midi_aligned/*.mid"))
    with ThreadPoolExecutor(max_workers=args.workers) as pool:
        list(pool.map(lambda p: process_one(p, output_dir), paths))
    print(f"processed {len(paths)} files -> {output_dir}")


if __name__ == "__main__":
    main()
