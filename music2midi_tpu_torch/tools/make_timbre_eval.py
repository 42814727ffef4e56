"""Timbre-generalization eval corpus: re-render one split of a synthesized
corpus with the realistic-piano voice, reusing labels, metadata and split
as they are.

    python3 -m music2midi_tpu_torch.tools.make_timbre_eval SRC DST
        [--split test] [--seed 0] [--duration 40] [--sample_rate 22050]
        [--noise 0.003] [--no_verify]

The port of the repository's ``tools/make_timbre_eval.py``, writing the
same tree.  A synthetic corpus's performance MIDI is a pure function of
(seed, song index, duration) (``compose_song`` + ``warp_notes`` in
``data/synthesize_corpus.py``), and ``render_piano`` changes what the
notes sound like, never when, so the ``midi_numpy/`` labels of the
source's clean render stay valid for the re-rendered audio.  ``evaluate``
on DST then measures timbre generalization alone, song by song against
the source corpus's scores.

Before rendering, the first split song is re-rendered through the source
profile's clean path and must be byte-identical to the source's wav
(a wrong ``--seed`` or ``--duration`` stops the tool at once).  DST gets
a copy of ``dataset_split.npz``, symlinks to the source's
``midi_numpy/`` and ``metadata/`` files of the split, and the new wavs.
"""

from __future__ import annotations

import argparse
import os
import shutil
from pathlib import Path

import numpy as np

from ..audio import write_wav
from ..data.synthesize_corpus import compose_song, render_piano, warp_notes


def _song_index(pid: str) -> int:
    if not pid.startswith("synth"):
        raise ValueError(
            f"id {pid!r} is not a synthesize_corpus id (synthNNN) — this "
            "tool only re-renders corpora built by data.synthesize_corpus"
        )
    return int(pid[len("synth"):])


def _link(src: Path, dst: Path) -> None:
    if not src.exists():
        raise FileNotFoundError(src)
    target = src.resolve()
    if dst.is_symlink():
        if Path(os.readlink(dst)) == target:
            return
        dst.unlink()
    elif dst.exists():
        raise FileExistsError(f"{dst} exists and is not a symlink")
    os.symlink(target, dst)


def _clean_render(performed, i: int, args) -> np.ndarray:
    """The source corpus's clean-profile audio path (render, then the
    noise draw, in synthesize_corpus's order and dtypes)."""
    rng = np.random.default_rng([args.seed, i])
    y = performed.synthesize(fs=args.sample_rate).astype(np.float32)
    if args.noise > 0:
        y = y + rng.normal(0.0, args.noise, len(y)).astype(np.float32)
    peak = float(np.abs(y).max())
    if peak > 0:
        y *= 0.8 / peak
    return y


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", type=Path, help="prepared clean-profile corpus")
    ap.add_argument("dst", type=Path)
    ap.add_argument("--split", default="test",
                    choices=["test", "val", "train"])
    # must match the source corpus's synthesize_corpus invocation
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--duration", type=float, default=40.0)
    ap.add_argument("--sample_rate", type=int, default=22050)
    ap.add_argument("--noise", type=float, default=0.003)
    ap.add_argument("--no_verify", action="store_true",
                    help="skip the byte-identity check of the seed "
                         "derivation against the source corpus")
    args = ap.parse_args(argv)

    split = np.load(args.src / "dataset_split.npz", allow_pickle=True)
    ids = [str(p) for p in split[f"{args.split}_id"]]
    if not ids:
        raise SystemExit(f"{args.split} split of {args.src} is empty")

    for sub in ("audio", "midi_numpy", "metadata"):
        (args.dst / sub).mkdir(parents=True, exist_ok=True)
    shutil.copy2(args.src / "dataset_split.npz",
                 args.dst / "dataset_split.npz")

    verified = args.no_verify
    for pid in ids:
        i = _song_index(pid)
        for sub, ext in (("midi_numpy", ".npy"), ("metadata", ".yaml")):
            _link(args.src / sub / f"{pid}{ext}",
                  args.dst / sub / f"{pid}{ext}")
        wav_path = args.dst / "audio" / f"{pid}.wav"
        if wav_path.exists():
            print(f"{pid}: exists, skipped")
            continue
        song_seed = args.seed * 1000 + i
        score = compose_song(song_seed, args.duration)
        performed = warp_notes(score, song_seed, max_dev=0.05)
        if not verified:
            got = _clean_render(performed, i, args)
            tmp = args.dst / "audio" / f".verify_{pid}.wav"
            write_wav(tmp, got, args.sample_rate)
            same = (tmp.read_bytes()
                    == (args.src / "audio" / f"{pid}.wav").read_bytes())
            tmp.unlink()
            if not same:
                raise SystemExit(
                    f"seed-derivation check FAILED on {pid}: the re-derived "
                    "clean render differs from the source wav — wrong "
                    "--seed/--duration/--noise/--sample_rate for this corpus?"
                )
            print(f"{pid}: seed derivation verified (byte-identical clean "
                  "render)")
            verified = True
        rng = np.random.default_rng([args.seed, i, 88])
        y = render_piano(performed, args.sample_rate, rng)
        if args.noise > 0:
            y = y + rng.normal(0.0, args.noise, len(y)).astype(np.float32)
        peak = float(np.abs(y).max())
        if peak > 0:
            y *= 0.8 / peak
        write_wav(wav_path, y, args.sample_rate)
        print(f"{pid}: piano render, {len(y) / args.sample_rate:.1f}s")
    print(f"{args.dst}: {len(ids)} {args.split} songs re-rendered "
          "(labels/metadata/split symlinked from the source)")


if __name__ == "__main__":
    main()
