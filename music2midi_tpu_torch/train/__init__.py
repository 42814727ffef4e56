"""Training: the step, HF-default Adafactor, checkpoints and the npz
export; the CLI is ``python3 -m music2midi_tpu_torch.train DATA_DIR``."""

from .adafactor import Adafactor, MultiSteps, adafactor_lr_at  # noqa: F401
from .loop import (  # noqa: F401
    Batch,
    TrainState,
    make_eval_step,
    make_multi_step,
    make_train_step,
    pad_labels,
)
