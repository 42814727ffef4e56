"""Serving pitch-calibration gate as a CLI: can this checkpoint transcribe
the pinned sparse in-domain figure at all, at the right pitch?

    python3 -m music2midi_tpu_torch.tools.calibration_check CKPT.npz
        [CKPT.npz ...] [--dither X] [--mel_floor X] [--device cuda]

The port of the repository's ``tools/calibration_check.py``, over
``calibration.check_checkpoint``: the fixture (an A4 figure rendered by
the corpus synth at 22050 Hz) goes through ``generate``'s 16 kHz resample
and the pinned ``check_midi`` assertions.  A fine-tune can gain mean
corpus chroma while losing the ability to transcribe sparse solo audio,
so this is a promotion gate and not only a test.

Prints one line per checkpoint, ``PASS``/``FAIL`` with the note evidence;
exits 0 iff every checkpoint passes.  Runs on ``cuda`` unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    from ..calibration import check_checkpoint

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ckpts", nargs="+")
    ap.add_argument(
        "--dither", type=float, default=None,
        help="override Music2MIDI.input_dither for the gate run")
    ap.add_argument(
        "--mel_floor", type=float, default=None,
        help="override Music2MIDI.mel_noise_floor for the gate run")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    overrides = {}
    if args.dither is not None:
        overrides["input_dither"] = args.dither
    if args.mel_floor is not None:
        overrides["mel_noise_floor"] = args.mel_floor
    all_ok = True
    for ckpt in args.ckpts:
        ok, detail = check_checkpoint(ckpt, device=args.device, **overrides)
        print(f"{'PASS' if ok else 'FAIL'} {ckpt}: {detail}", flush=True)
        all_ok &= ok
    return 0 if all_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
