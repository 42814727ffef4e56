"""Configuration tree of the port.

A copy of ``music2midi_tpu/config.py``: one YAML tree is the source of
truth for every layer, held in ``ConfigNode`` (a small attribute-dict,
OmegaConf-style).  The files are read and written by ``yaml_subset.py``,
since the card's machine has no yaml: ``load_config`` gives the tree
``yaml.safe_load`` gives for the repository's configs (``config.yaml``,
``configs/*.yaml``) and for JSON files, such as an npz's ``__config__``,
and raises ValueError, with the file and line, on YAML outside that
subset; ``save_config`` writes the bytes ``yaml.safe_dump(tree,
sort_keys=False)`` writes.  ``default_config()`` reads the repository's
``config.yaml``.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Iterator, Mapping, Union

from . import yaml_subset


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


def load_config(path: Union[str, Path]) -> ConfigNode:
    """Load a YAML (or JSON) config file into a ConfigNode."""
    text = Path(path).read_text()
    try:
        data = yaml_subset.load(text)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return ConfigNode(data or {})


def save_config(config: ConfigNode, path: Union[str, Path]) -> None:
    Path(path).write_text(yaml_subset.dump(_unwrap(config),
                                           sort_keys=False))


def default_config_path() -> Path:
    """The config.yaml that ships at the repo root."""
    return Path(__file__).resolve().parent.parent / "config.yaml"


def default_config() -> ConfigNode:
    return load_config(default_config_path())


def resolve_config(config: Union[str, Path, ConfigNode, Mapping, None]
                   ) -> ConfigNode:
    """Accept a path, a mapping, an existing node, or None (-> defaults)."""
    if config is None:
        return default_config()
    if isinstance(config, ConfigNode):
        return config
    if isinstance(config, Mapping):
        return ConfigNode(config)
    return load_config(config)
