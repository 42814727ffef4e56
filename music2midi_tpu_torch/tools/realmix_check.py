"""Real-recording transfer probe as a CLI: how well does a checkpoint
transcribe a real produced mix?

    python3 -m music2midi_tpu_torch.tools.realmix_check CKPT.npz
        [CKPT.npz ...] [--audio PATH] [--dtype float32|bfloat16]
        [--device cuda]

The port of the repository's ``tools/realmix_check.py``, with the same
metrics, lines and exit code.  The mix is ``--audio PATH`` (any file
``audio.load`` reads, at 16 kHz, as it is), else pygame's
``examples/data/house_lo.wav`` (a real house loop with drums, bass and
chords) tiled to ~21 s when pygame is installed; with neither the tool
exits 1 and says so.  For each checkpoint it prints:

    n_notes  — structural floor (>= 30)
    overlap  — |top-3 duration-weighted note pitch classes  &
                audio's top-4 framewise chroma classes|  (>= 1)
    top_notes / audio_top4 — the histograms themselves

Exit 0 iff every checkpoint clears both floors.  Runs on ``cuda`` unless
``--device cpu`` is given; ``--dtype bfloat16`` is the serving mode.
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter
from pathlib import Path

import numpy as np

SR = 16000  # the model's rate


def real_loop():
    """pygame's house loop at 16 kHz, tiled to ~21 s (two full decode
    chunks), or None without pygame."""
    try:
        import pygame
    except ImportError:
        return None
    p = Path(pygame.__file__).parent / "examples" / "data" / "house_lo.wav"
    if not p.exists():
        return None
    from ..audio import load

    y, sr = load(p, sr=SR)
    return np.tile(y, 3), sr


def metrics(midi, y: np.ndarray, sr: int) -> dict:
    """The probe's numbers for a transcription `midi` of the audio y."""
    from ..data.align import chroma_features

    notes = midi.instruments[0].notes if midi.instruments else []
    weights = Counter()
    for n in notes:
        weights[n.pitch % 12] += n.end - n.start
    top_notes = {pc for pc, _ in weights.most_common(3)}
    chroma = chroma_features(y, sr)  # (12, T)
    frame_hist = np.bincount(np.argmax(chroma, axis=0), minlength=12)
    top_audio = set(np.argsort(frame_hist)[-4:].tolist())
    return {"n_notes": len(notes), "overlap": len(top_notes & top_audio),
            "top_notes": sorted(top_notes), "audio_top4": sorted(top_audio)}


def check(ckpt: str, y: np.ndarray, sr: int, dtype: str = "float32",
          device: str = "cuda") -> tuple:
    """-> (both floors cleared, the detail line) for one checkpoint."""
    import torch

    from ..infer import Music2MIDI

    engine = Music2MIDI.from_npz(
        ckpt, dtype={"float32": torch.float32,
                     "bfloat16": torch.bfloat16}[dtype], device=device)
    m = metrics(engine.generate(audio_y=y, sr=sr), y, sr)
    ok = m["n_notes"] >= 30 and m["overlap"] >= 1
    detail = (f"n_notes={m['n_notes']} overlap={m['overlap']} "
              f"top_notes={m['top_notes']} audio_top4={m['audio_top4']}")
    return ok, detail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpts", nargs="+")
    ap.add_argument("--audio", type=str, default=None,
                    help="the mix to transcribe (default: pygame's "
                         "house_lo.wav, tiled to ~21 s)")
    ap.add_argument("--dtype", type=str, default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.audio is not None:
        from ..audio import load

        y, sr = load(args.audio, sr=SR)
    else:
        fixture = real_loop()
        if fixture is None:
            print("realmix_check: no mix to transcribe: pass --audio PATH "
                  "(pygame's example audio is not installed)",
                  file=sys.stderr)
            return 1
        y, sr = fixture
    all_ok = True
    for ckpt in args.ckpts:
        ok, detail = check(ckpt, y, sr, args.dtype, args.device)
        print(f"{'PASS' if ok else 'FAIL'} {ckpt}: {detail}", flush=True)
        all_ok &= ok
    return 0 if all_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
