"""Prep stage 2: align each song's MIDI to its audio via chroma+onset DTW.

``python3 -m music2midi_tpu_torch.data.align_audio_midi DATA_DIR
[--config CFG.yaml --workers 4]``: the port of the repository's
``data/align_audio_midi.py``, writing the same files.

Reference: data/align_audio_midi.py — synthesize the MIDI, find the optimal
chroma (key) shift, transpose if needed, compute a MrMsDTW warp path, make
it strictly monotonic, retime notes/bends/CCs, save aligned MIDI + warp
path + aligned beat times, and update metadata.  The synctoolbox feature/
DTW stack is replaced by ``data/align.py`` (first-party).
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..audio import load, normalize
from ..config import resolve_config
from ..midi import MidiFile
from .align import align_features
from .metadata import dump_metadata, read_metadata
from .midi_tools import simple_adjust_times, transpose_midi

ALIGN_SR = 22050  # reference align_audio_midi.py:331


def process_one(meta_path: Path, data_dir: Path, feature_rate: int) -> None:
    meta = read_metadata(meta_path.read_text())
    piano_id = meta["piano"]["id"]
    song_path = data_dir / "audio" / f"{piano_id}.wav"
    midi_path = data_dir / "midi" / f"{piano_id}.mid"
    wp_path = data_dir / "warp_path" / f"{piano_id}.npy"
    if wp_path.exists():
        print(f"{wp_path} already exists")
        return
    if not song_path.exists():
        print(f"{song_path} file not found")
        return

    song_audio, sr = load(song_path, sr=ALIGN_SR)
    song_audio = normalize(song_audio)
    midi = MidiFile(midi_path)
    midi_audio = normalize(midi.synthesize(fs=sr))

    # pass 1: key shift
    wp, opt_shift = align_features(song_audio, midi_audio, sr, feature_rate)
    if opt_shift != 0:
        # shift down if closer (reference align_audio_midi.py:283-287)
        shift = opt_shift if opt_shift <= abs(opt_shift - 12) else (
            opt_shift - 12
        )
        midi = transpose_midi(midi, shift)
        midi_audio = normalize(midi.synthesize(fs=sr))
        wp, opt_shift = align_features(
            song_audio, midi_audio, sr, feature_rate
        )

    midi.write(data_dir / "midi_transposed" / f"{piano_id}.mid")
    beat_times = midi.get_beats()
    beat_times_aligned = np.interp(beat_times, wp[1], wp[0])
    midi_aligned = simple_adjust_times(midi, wp[1], wp[0])
    midi_aligned.write(data_dir / "midi_aligned" / f"{piano_id}.mid")
    np.save(data_dir / "beat_times_aligned" / f"{piano_id}.npy",
            beat_times_aligned)
    np.save(wp_path, wp)

    meta["piano"]["num_tracks"] = len(midi.instruments)
    meta.setdefault("youtube", {})["duration"] = float(
        len(song_audio) / sr
    )
    meta["metrics"] = {"opt_chroma_shift": int(opt_shift)}
    meta_path.write_text(dump_metadata(meta, sort_keys=False))
    print(f"{piano_id}: aligned (chroma shift {opt_shift})")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data_dir", type=str)
    parser.add_argument("--config", type=str, default=None,
                        help="config file, YAML or JSON (default: the "
                             "repository's config.yaml)")
    parser.add_argument("--workers", type=int, default=4)
    args = parser.parse_args(argv)
    data_dir = Path(args.data_dir)
    for sub in ("midi_transposed", "midi_aligned", "warp_path",
                "beat_times_aligned"):
        (data_dir / sub).mkdir(exist_ok=True)
    config = resolve_config(args.config)
    feature_rate = int(config.dataset.dtw_feature_rate)
    metas = sorted(data_dir.glob("metadata/*.yaml"))
    with ThreadPoolExecutor(max_workers=args.workers) as pool:
        list(
            pool.map(
                lambda p: process_one(p, data_dir, feature_rate), metas
            )
        )


if __name__ == "__main__":
    main()
