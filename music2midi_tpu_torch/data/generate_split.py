"""Prep stage 5: filter songs by quality thresholds, write the 80/10/10
train/val/test split.

``python3 -m music2midi_tpu_torch.data.generate_split DATA_DIR
[--config CFG.yaml]``: the port of the repository's
``data/generate_split.py``, writing the same ``dataset_split.npz`` with no
pandas and no sklearn.

Reference: data/generate_split.py — keep songs with opt_chroma_shift == 0
and exactly 2 MIDI tracks, filter by config.dataset.filter_threshold, split
with random_state=42, save dataset_split.npz.
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path

import numpy as np

from ..config import resolve_config
from .metadata import read_metadata


def train_test_split(ids: np.ndarray, test_size: float,
                     random_state: int) -> tuple:
    """sklearn's ``train_test_split(ids, test_size=..., random_state=...)``
    for a float ``test_size`` and shuffling on: ``ceil(test_size * n)``
    test ids first in the ``RandomState(random_state)`` permutation, the
    rest train.  -> (train, test)."""
    n_test = math.ceil(test_size * len(ids))
    if not 0 < n_test < len(ids):
        raise ValueError(f"cannot split {len(ids)} ids with test_size "
                         f"{test_size}")
    perm = np.random.RandomState(random_state).permutation(len(ids))
    return ids[perm[n_test:]], ids[perm[:n_test]]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data_dir", type=str)
    parser.add_argument("--config", type=str, default=None,
                        help="config file, YAML or JSON (default: the "
                             "repository's config.yaml)")
    args = parser.parse_args(argv)
    data_dir = Path(args.data_dir)
    config = resolve_config(args.config)
    threshold = config.dataset.filter_threshold

    metas = []
    for meta_path in sorted(data_dir.glob("metadata/*.yaml")):
        meta = read_metadata(meta_path.read_text())
        if meta.get("youtube") is None:
            continue
        metrics = meta.get("metrics", {})
        if metrics.get("opt_chroma_shift") != 0:
            continue
        if meta["piano"].get("num_tracks") != 2:
            continue
        metas.append(meta)
    if not metas:
        raise SystemExit("no songs pass the pre-filters")

    metric_keys = list(metas[0]["metrics"].keys())
    table = [dict(zip(metric_keys, (m["metrics"][k] for k in metric_keys)),
                  piano_id=m["piano"]["id"]) for m in metas]
    ids = np.array([
        row["piano_id"] for row in table
        if row["wp_std"] < threshold["wp_std"]
        and row["max_beat_fluctuation"] < threshold["max_beat_fluctuation"]
        and row["max_note_density"] < threshold["max_note_density"]
        and row["time_diff_ratio"] < threshold["time_diff_ratio"]
    ], dtype=object)
    if len(ids) < 3:
        raise SystemExit(
            f"only {len(ids)} songs pass the filters; need >= 3 to split"
        )
    train_ids, rest = train_test_split(ids, test_size=0.2, random_state=42)
    if len(rest) >= 2:
        val_ids, test_ids = train_test_split(rest, test_size=0.5,
                                             random_state=42)
    else:  # tiny dataset: reuse the remainder for both val and test
        val_ids = test_ids = rest
    np.savez(
        data_dir / "dataset_split.npz",
        train_id=train_ids, val_id=val_ids, test_id=test_ids,
    )
    print(
        f"split {len(ids)} songs -> train {len(train_ids)} / "
        f"val {len(val_ids)} / test {len(test_ids)}"
    )


if __name__ == "__main__":
    main()
