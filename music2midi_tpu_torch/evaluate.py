"""Evaluation CLI of the port: per-song melody chroma accuracy over a split
of a prepared corpus, written to ``scores/score-{name}.csv``.

    python3 -m music2midi_tpu_torch.evaluate DATA_DIR [--ckpt CKPT]
        [--config CFG.yaml] [--name NAME] [--dtype float32|bfloat16]
        [--device cuda]

The port of the repository's root ``evaluate.py``: the same flags plus
``--device`` (default ``cuda``), the same CSV columns and rows (written
with the standard ``csv`` module), the same per-song lines.  ``DATA_DIR``
holds ``dataset_split.npz``, ``audio/{id}.wav``, ``midi_numpy/{id}.npy``
and ``metadata/{id}.yaml`` (read by ``data/metadata.py::read_metadata``).
``--config`` takes a YAML config, such as ``configs/synth16k_aug_r5.yaml``,
or JSON, such as an npz's ``__config__`` (``config.load_config``); without
it the checkpoint's own config is used, else the repository's
``config.yaml`` (a ``config.yaml`` in the working directory is not read).
After the mean score it prints the chunks that decoded to the token cap
(``last_decode_stats``).

``--ckpt`` takes an npz export, the reference's Lightning ``.ckpt`` (or a
``.pt`` state dict), or a checkpoint directory of either package's
trainer: an export, a step dir or a training root, the JAX trainer's
orbax directories included (``Music2MIDI.from_checkpoint``).  With neither ``--ckpt`` nor
``--config`` it loads the model of record; with ``--config`` alone, random
weights.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np
import torch

from . import config as config_lib

#: the committed trained artifact; the CLIs fall back to it when neither
#: --ckpt nor --config is given
RECORD_CKPT = (Path(__file__).resolve().parent.parent / "checkpoints"
               / "model_of_record.npz")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CONFIG_HELP = ("config file, YAML or JSON (e.g. configs/synth16k_aug_r5.yaml "
               "or an npz's __config__); default: the checkpoint's own, "
               "else the repository's config.yaml")


def load_config(path):
    """A ``--config`` file (YAML or JSON) -> its ConfigNode (None -> None:
    the checkpoint's own config, else the repository's defaults)."""
    return None if path is None else config_lib.load_config(path)


def load_engine(ckpt, config_path, dtype: str = "float32", device=None,
                **kw):
    """-> a ``Music2MIDI`` for the CLIs.  dtype: float32 (parity mode) |
    bfloat16 (serving mode); device: ``cuda`` unless given; ``kw`` goes to
    the engine (e.g. ``decode_max_length``)."""
    from .infer import Music2MIDI

    if ckpt is None and config_path is None and RECORD_CKPT.exists():
        print(f"no --ckpt given; using the model of record: {RECORD_CKPT}")
        ckpt = str(RECORD_CKPT)
    config = load_config(config_path)
    kw = {"dtype": DTYPES[dtype], "device": device, **kw}
    if ckpt is None:
        print("WARNING: no checkpoint — running RANDOM weights; pass "
              "--ckpt (e.g. checkpoints/model_of_record.npz) for real "
              "transcriptions")
        return Music2MIDI.from_random(config=config, **kw)
    p = Path(ckpt)
    if p.suffix in (".ckpt", ".pt"):
        return Music2MIDI.from_torch_checkpoint(p, config, **kw)
    if p.suffix == ".npz":
        # the checkpoint's embedded config unless --config was given
        return Music2MIDI.from_npz(p, config, **kw)
    return Music2MIDI.from_checkpoint(p, config, **kw)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data_dir", type=str)
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--config", type=str, default=None, help=CONFIG_HELP)
    parser.add_argument("--name", type=str, default="music2midi")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=list(DTYPES))
    parser.add_argument(
        "--int8_weights", action="store_true",
        help="int8 weight-only quantization of the decode projections "
             "(serving-mode ablation; models/t5.py:_quantize_w)")
    parser.add_argument(
        "--kv_bits", type=int, default=8, choices=[8, 4],
        help="quantized-KV width in serving mode (4 = +-7 levels stored in "
             "int8; see infer/decode.py DecodeConfig.kv_bits)")
    parser.add_argument(
        "--dither", type=float, default=None,
        help="override Music2MIDI.input_dither (serving waveform dither "
             "RMS)")
    parser.add_argument(
        "--mel_floor", type=float, default=None,
        help="override Music2MIDI.mel_noise_floor (per-bin mel noise floor "
             "sigma)")
    parser.add_argument(
        "--split", type=str, default="test",
        choices=["test", "val", "train"],
        help="which dataset_split ids to score (test = the reference "
             "evaluation; train/val are overfit/selection diagnostics)")
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device (default cuda; no fallback to the CPU)")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; -> {"csv", "mean_score", "chunks", "chunks_at_cap"}."""
    args = parse_args(argv)

    # imported here: the serving modules import this module for
    # load_engine, and import nothing of the data package
    from .data.metadata import read_metadata
    from .evaluation import evaluate_batch
    from .utils import numpy_to_midi

    data_dir = Path(args.data_dir)
    split = np.load(data_dir / "dataset_split.npz", allow_pickle=True)
    test_ids = split[f"{args.split}_id"]
    engine = load_engine(args.ckpt, args.config, args.dtype, args.device)
    if args.int8_weights:
        engine.int8_weights = True
    engine.kv_bits = args.kv_bits  # != 8 implies quantized KV (_dcfg)
    if args.dither is not None:
        engine.input_dither = args.dither
    if args.mel_floor is not None:
        engine.mel_noise_floor = args.mel_floor

    cap = engine.decode_max_length - 1
    n_chunks = n_at_cap = 0
    rows = []
    for i, piano_id in enumerate(test_ids):
        meta = read_metadata(
            (data_dir / "metadata" / f"{piano_id}.yaml").read_text())
        genre = meta["piano"]["genre"]
        difficulty = meta["piano"]["difficulty"]
        # the ENGINE's config (possibly embedded in the checkpoint) maps
        # names -> indices
        cond_index = engine.cond_index_from_names(
            genre=genre, difficulty=difficulty)
        label_midi = numpy_to_midi(
            np.load(data_dir / "midi_numpy" / f"{piano_id}.npy"))
        output_midi = engine.generate(
            audio_path=data_dir / "audio" / f"{piano_id}.wav",
            cond_index=cond_index)
        for s in engine.last_decode_stats:
            n_chunks += len(s["row_steps"])
            n_at_cap += sum(r >= cap for r in s["row_steps"])
        score = evaluate_batch([label_midi], [output_midi])
        rows.append([piano_id, args.name, genre, difficulty, score])
        print(f"[{i + 1}/{len(test_ids)}] {piano_id}: score={score:.4f}")

    Path("scores").mkdir(exist_ok=True)
    out = f"scores/score-{args.name}.csv"
    with open(out, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["piano_id", "model", "genre", "difficulty", "score"])
        writer.writerows(rows)
    mean = float(np.mean([r[-1] for r in rows])) if rows else float("nan")
    print(f"mean score: {mean:.4f} -> {out}")
    print(f"chunks at the token cap ({cap + 1} tokens): {n_at_cap} of "
          f"{n_chunks}")
    return {"csv": out, "mean_score": mean, "chunks": n_chunks,
            "chunks_at_cap": n_at_cap}


if __name__ == "__main__":
    main()
