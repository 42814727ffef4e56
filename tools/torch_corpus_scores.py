"""Make a synthetic corpus with the PyTorch port's data-prep chain and score
the model of record on it in four serving modes.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/torch_corpus_scores.py [--profile fullmix] [--songs 20]
        [--duration 40] [--seed 0] [--splits test train]
        [--out corpus_scores.json]

Every step is one of the port's CLIs in a subprocess, in a temporary
directory: ``python3 -m music2midi_tpu_torch.data.synthesize_corpus``,
``align_audio_midi``, ``midi_to_numpy``, ``compute_metrics`` and
``generate_split``; then ``python3 -m music2midi_tpu_torch.evaluate`` of
``checkpoints/model_of_record.npz`` on each split named in ``--splits``,
in fp32 (the parity mode), bf16, bf16 ``--int8_weights`` and bf16
``--kv_bits 4``.  Prints each stage's seconds, the songs that pass the
filters and the split's sizes, and for each split and mode the mean score
(from the CSV, unrounded), each song's score, the chunks decoded to the
1024-token cap and the seconds; each line ends with the card's name and
power limit.  The same numbers go to ``--out`` as JSON.  Any step that
fails stops the script with a non-zero exit (``chip_smoke.run_module``).
"""

from __future__ import annotations

import argparse
import csv
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MODES = {"fp32": ["--dtype", "float32"],
         "bf16": ["--dtype", "bfloat16"],
         "bf16_int8_weights": ["--dtype", "bfloat16", "--int8_weights"],
         "bf16_kv_bits_4": ["--dtype", "bfloat16", "--kv_bits", "4"]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", default="fullmix",
                        choices=["clean", "hard", "piano", "fullmix"])
    parser.add_argument("--songs", type=int, default=20)
    parser.add_argument("--duration", type=float, default=40.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--splits", nargs="+", default=["test"],
                        choices=["test", "val", "train"])
    parser.add_argument("--out", default="corpus_scores.json")
    args = parser.parse_args()
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import PREP_STAGES, RECORD, run_module

    if not torch.cuda.is_available():
        print("torch_corpus_scores: no CUDA device available",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    result = {"card": smi, "profile": args.profile, "songs": args.songs,
              "duration_s": args.duration, "seed": args.seed,
              "stage_s": {}, "scores": {}}
    with tempfile.TemporaryDirectory() as td:
        work = Path(td)
        root = work / "corpus"
        for stage in PREP_STAGES:
            argv = [str(root)]
            if stage == "synthesize_corpus":
                argv += ["--songs", str(args.songs), "--duration",
                         str(args.duration), "--seed", str(args.seed),
                         "--profile", args.profile]
            out, _, result["stage_s"][stage] = run_module(
                f"data.{stage}", argv, work)
        result["split_line"] = out.strip().splitlines()[-1]
        split = np.load(root / "dataset_split.npz", allow_pickle=True)
        result["split"] = {k: [str(x) for x in split[k]]
                           for k in split.files}
        print(f"stages (s): {result['stage_s']}; {args.songs} songs x "
              f"{args.duration:g} s ({args.profile}, seed {args.seed}): "
              f"{result['split_line']} [{smi}]", flush=True)
        for name in args.splits:
            for mode, flags in MODES.items():
                tag = f"{name}-{mode}"
                out, _, secs = run_module("evaluate", [
                    str(root), "--ckpt", str(RECORD), "--split", name,
                    "--name", tag, *flags], work)
                with open(work / "scores" / f"score-{tag}.csv") as f:
                    scores = {r["piano_id"]: float(r["score"])
                              for r in csv.DictReader(f)}
                cap_line = next(x for x in out.splitlines()
                                if x.startswith("chunks at the token cap"))
                at_cap, chunks = (int(w) for w in
                                  cap_line.split(": ")[1].split(" of "))
                row = {"mean_score": float(np.mean(list(scores.values()))),
                       "scores": scores, "chunks": chunks,
                       "chunks_at_cap": at_cap, "seconds": secs}
                result["scores"][tag] = row
                print(f"{name} split, {mode}: mean_score="
                      f"{row['mean_score']!r} over {len(scores)} songs, "
                      f"chunks at the cap {at_cap} of {chunks}, "
                      f"{secs:.3f} s (process start included) [{smi}]",
                      flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({"card": smi, "scores": {
        k: [v["mean_score"], v["chunks_at_cap"], v["chunks"]]
        for k, v in result["scores"].items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
