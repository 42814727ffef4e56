"""Per-song metadata files, read and written without yaml.

The prep stages keep each song's metadata in ``metadata/{id}.yaml``: a
mapping whose values are scalars (str, int, float, bool, None) or mappings
of scalars, as ``data/download_youtube.py`` and the JAX package's stages
write it with ``yaml.safe_dump``.  The port has no yaml, so these are the
YAML subset of ``yaml_subset.py`` narrowed to that form (two levels of
mappings, no sequences, no comments):

  * ``read_metadata`` gives the value ``yaml.safe_load`` gives for such a
    file (``{}`` for an empty one), and raises ValueError on any other
    YAML;
  * ``dump_metadata`` writes the bytes ``yaml.safe_dump(meta)`` (or, with
    ``sort_keys=False``, ``yaml.safe_dump(meta, sort_keys=False)``) writes
    for such a value, and raises ValueError on any other value.
"""

from __future__ import annotations

from typing import Mapping

from .. import yaml_subset


def read_metadata(text: str) -> dict:
    """A metadata file as ``yaml.safe_dump`` writes it -> the same value
    ``yaml.safe_load`` gives: a mapping whose values are scalars or
    mappings of scalars (``{}`` for an empty one).  Raises ValueError on
    any other YAML (sequences, flow collections, block scalars, anchors,
    tags, comments, deeper nesting)."""
    return yaml_subset.load(text, comments=False, sequences=False,
                            max_depth=2)


def dump_metadata(meta: Mapping, sort_keys: bool = True) -> str:
    """The text ``yaml.safe_dump(meta, sort_keys=sort_keys)`` writes, for a
    mapping of str keys to scalars (str, int, float, bool, None) or to
    mappings of such scalars.  Raises ValueError on anything else (other
    types, lists, deeper nesting, empty / multiline / 128+-character keys,
    one mapping object at two places, which PyYAML would write as an
    anchor)."""
    return yaml_subset.dump(meta, sort_keys, sequences=False, max_depth=2)
