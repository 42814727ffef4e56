"""Configuration tree of the port.

A copy of ``music2midi_tpu/config.py``'s ``ConfigNode`` (a small
attribute-dict, OmegaConf-style) with the defaults of the repository's
``config.yaml`` kept as a Python dict, so that nothing here needs yaml:
a checkpoint's own config arrives as JSON inside the npz, and callers may
pass a mapping or a node.
"""

from __future__ import annotations

import copy
from typing import Any, Iterator, Mapping, Union

# the defaults of config.yaml at the repository root
DEFAULT_CONFIG: dict = {
    "dataset": {
        "sample_rate": 22050,
        "dtw_feature_rate": 50,
        "segment_duration": 3,
        "max_notes_per_second": 30,
        "filter_threshold": {
            "wp_std": 5,
            "max_beat_fluctuation": 1.2,
            "max_note_density": 25,
            "time_diff_ratio": 0.2,
        },
    },
    "spectrogram": {"n_fft": 2048, "hop_length": 256, "f_min": 20.0},
    "model": {
        "sample_rate": 16000,
        "t5": {
            "num_layers": 6,
            "num_decoder_layers": 6,
            "d_model": 384,
            "d_ff": 1152,
            "feed_forward_proj": "gated-gelu",
            "tie_word_embeddings": False,
            "tie_encoder_decoder": False,
            "vocab_size": 400,
            "n_positions": 1024,
            "relative_attention_num_buckets": 32,
            "pad_token_id": 0,
            "bos_token_id": 1,
            "eos_token_id": 2,
            "decoder_start_token_id": 1,
        },
    },
    "tokenizer": {
        "midi_quantize_ms": 50,
        "vocab_size": {"special": 5, "pitch": 128, "time": 200},
        "default_velocity": 80,
    },
    "trainer": {
        "max_epochs": 800,
        "accumulate_grad_batches": 1,
        "log_every_n_steps": 40,
    },
    "dataloader": {"batch_size": 16, "num_workers": 4},
    "inference": {"batch_size": 128},
    "conditioning": {
        "genre": ["electronic", "pop", "rock", "soundtrack", "world_music",
                  "classical"],
        "difficulty": ["beginner", "intermediate", "advanced"],
    },
}


class ConfigNode(Mapping):
    """Nested dot-access mapping: ``cfg.model.t5.d_model`` and
    ``**cfg.model.t5`` both work."""

    def __init__(self, data: Mapping[str, Any] | None = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[k] = _wrap(v)

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def __getattr__(self, key: str) -> Any:
        # during unpickling __getattr__ runs before __init__
        data = object.__getattribute__(self, "__dict__").get("_data")
        if data is None or key.startswith("__"):
            raise AttributeError(key)
        try:
            return data[key]
        except KeyError:
            raise AttributeError(key) from None

    def __getstate__(self) -> dict:
        return {"data": self.to_dict()}

    def __setstate__(self, state: dict) -> None:
        object.__setattr__(self, "_data", {})
        for k, v in state["data"].items():
            self._data[k] = _wrap(v)

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def keys(self):
        return self._data.keys()

    def values(self):
        return self._data.values()

    def items(self):
        return self._data.items()

    def to_dict(self) -> dict:
        """Recursively convert back to plain python containers."""
        return _unwrap(self)

    def copy(self) -> "ConfigNode":
        return ConfigNode(copy.deepcopy(self.to_dict()))

    def __repr__(self) -> str:
        return f"ConfigNode({self.to_dict()!r})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, ConfigNode):
            return self.to_dict() == other.to_dict()
        if isinstance(other, Mapping):
            return self.to_dict() == dict(other)
        return NotImplemented


def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigNode):
        return value
    if isinstance(value, Mapping):
        return ConfigNode(value)
    if isinstance(value, list):
        return [_wrap(v) for v in value]
    return value


def _unwrap(value: Any) -> Any:
    if isinstance(value, ConfigNode):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_unwrap(v) for v in value]
    return value


def default_config() -> ConfigNode:
    return ConfigNode(copy.deepcopy(DEFAULT_CONFIG))


def resolve_config(config: Union[ConfigNode, Mapping, None]) -> ConfigNode:
    """Accept a mapping, an existing node, or None (-> defaults).  A YAML
    path is not accepted: load it outside the port and pass the mapping."""
    if config is None:
        return default_config()
    if isinstance(config, ConfigNode):
        return config
    if isinstance(config, Mapping):
        return ConfigNode(config)
    raise TypeError(
        f"config must be a mapping, a ConfigNode or None, got {type(config)}"
    )
