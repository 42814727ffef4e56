"""music2midi_tpu_torch: the PyTorch/CUDA port of music2midi_tpu.

Song -> MIDI piano cover on an NVIDIA Hopper card.  The JAX package
``music2midi_tpu`` is the reference this package is held against in the
tests; this package imports nothing of it, nor JAX, nor yaml.

Layering follows the JAX package:
  config        — one YAML tree shared by every layer (read and written
                  by yaml_subset, the YAML subset the configs use)
  weights       — npz checkpoint loader, JAX param tree -> state_dict
  ops           — log-mel (plain + CUDA kernel), device detokenizer
  models        — T5 encoder-decoder, quantized decode step, checkpoint
                  conversion (HF / Lightning -> state_dict)
  infer         — decode loop (greedy or sampled), whole-song Music2MIDI
                  pipeline
  parallel      — dp x tp over torch.distributed: process group, mesh,
                  sharding rules, the tensor-parallel operators
  profiling     — model FLOPs (MFU) and the card's bf16 peak
  bench         — the headline benchmark (python3 -m music2midi_tpu_torch.bench)
  tokenizer     — MIDI notes <-> 400-token event vocabulary
  midi / audio  — SMF and WAV I/O, synthesis, resampling

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .config import ConfigNode, default_config, load_config, resolve_config  # noqa: F401
