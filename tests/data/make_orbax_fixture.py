"""Generate orbax_small/ -- a JAX-written orbax checkpoint for the port.

The PyTorch port reads the JAX trainer's orbax checkpoints with its own
OCDBT / zarr reader and zstd decoder (``music2midi_tpu_torch/orbax.py``).
A machine without JAX cannot write such a directory, so this one is
committed.  It is written by the JAX package itself, on the CPU, from a
random initialisation (no trained weights), for a model narrow enough to
keep the whole directory under 2 MB: the repository's config with
d_model 16 (so 16 mel bins), d_ff 32 and one encoder and one decoder
layer; heads, d_kv and vocabulary as the model of record.

Contents:

  * ``run/step_00000003/``: ``save_train_state`` after 3 training steps
    under ``optax.MultiSteps(adafactor_hf(learning_rate=0.01,
    warmup_init=False), every_k_schedule=2)``, dropout 0 (so mid-cycle:
    ``mini_step`` 1 and non-zero ``acc_grads``), with its config.json;
  * ``export/``: ``save_params`` of the same parameters (float32) and the
    config;
  * ``params.npz``: ``save_params_npz`` of the same parameters (float32),
    their npz twin;
  * ``expected.json``: how the batch is made (a numpy seed; the wave's
    SHA-256), the learning rate and accumulation, the 3 losses before the
    save and the losses of 2 further JAX steps from the saved state.

Run from the repository root: python tests/data/make_orbax_fixture.py
"""

import hashlib
import json
import os
import shutil
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from music2midi_tpu.config import ConfigNode, default_config  # noqa: E402
from music2midi_tpu.models import init_params, t5_config_from  # noqa: E402
from music2midi_tpu.ops.mel import log_mel_config_from  # noqa: E402
from music2midi_tpu.train import adafactor_hf  # noqa: E402
from music2midi_tpu.train import loop as jloop  # noqa: E402
from music2midi_tpu.train.checkpoint import (  # noqa: E402
    save_params,
    save_params_npz,
    save_train_state,
)

OUT = Path(__file__).resolve().parent / "orbax_small"
T5 = dict(num_layers=1, num_decoder_layers=1, d_model=16, d_ff=32)
LR, EVERY_K, SEED = 0.01, 2, 0
BATCH, SECONDS = 2, 1.0
LABELS = [[140, 3, 60, 150, 4, 60, 2], [135, 3, 70, 2]]
COND = [[1, 0], [5, 2]]


def fixture_config() -> ConfigNode:
    tree = default_config().to_dict()
    tree["model"]["t5"].update(T5)
    tree["trainer"]["accumulate_grad_batches"] = EVERY_K
    return ConfigNode(tree)


def fixture_wave(sample_rate: int) -> np.ndarray:
    """The batch's wave: (BATCH, SECONDS at the model rate) from SEED."""
    rng = np.random.default_rng(SEED)
    n = int(SECONDS * sample_rate)
    return (rng.normal(size=(BATCH, n)) * 0.1).astype(np.float32)


def main() -> None:
    config = fixture_config()
    t5_cfg = t5_config_from(config)._replace(dropout_rate=0.0)
    mel_cfg = log_mel_config_from(config)
    num_cond = tuple(len(v) for v in config.conditioning.values())
    params = init_params(jax.random.PRNGKey(SEED), t5_cfg, num_cond)
    opt = optax.MultiSteps(adafactor_hf(learning_rate=LR, warmup_init=False),
                           every_k_schedule=EVERY_K)
    step = jloop.make_train_step(opt, t5_cfg, mel_cfg, donate=False)
    wave = fixture_wave(mel_cfg.sample_rate)
    batch = jloop.Batch(wave, jloop.pad_labels([np.array(x) for x in LABELS]),
                        np.array(COND, np.int32))
    state = jloop.init_train_state(params, opt)
    before, after = [], []
    for _ in range(3):
        state, loss = step(state, batch, jax.random.PRNGKey(0))
        before.append(float(loss))
    shutil.rmtree(OUT, ignore_errors=True)
    save_train_state(OUT / "run", state, config)
    saved = jax.tree.map(np.asarray, state.params)
    save_params(OUT / "export", saved, config)
    save_params_npz(OUT / "params.npz", saved, config, dtype="float32")
    for _ in range(2):
        state, loss = step(state, batch, jax.random.PRNGKey(0))
        after.append(float(loss))
    (OUT / "expected.json").write_text(json.dumps({
        "seed": SEED, "batch": BATCH, "seconds": SECONDS,
        "wave_sha256": hashlib.sha256(wave.tobytes()).hexdigest(),
        "labels": LABELS, "cond": COND, "lr": LR, "every_k": EVERY_K,
        "saved_step": 3, "losses_before_save": before,
        "losses_after_restore": after,
    }, indent=1) + "\n")
    size = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(f"wrote {OUT} ({size} bytes); losses {before} then {after}")


if __name__ == "__main__":
    main()
