"""The JAX trainer's orbax checkpoints, read with neither orbax nor
tensorstore.

``music2midi_tpu/train/checkpoint.py`` saves every training state and
parameter export with ``orbax.checkpoint.StandardCheckpointer``, which
writes one directory in tensorstore's OCDBT format (an optionally
versioned B+tree key-value store in a few data files) holding one zarr v2
array per leaf of the tree.  This module reads such a directory in three
layers:

  * ``open_kvstore(dir)``: the OCDBT store as a read-only mapping from key
    to value bytes, at its latest generation.  It reads the manifest
    (``manifest.ocdbt``, or the highest ``manifest.<16 hex digits>`` when
    the manifest is numbered), takes the newest version of its version
    tree, and walks that version's B+tree, interior and leaf nodes, with
    their prefix-compressed keys.  Each manifest and node is found by a
    (data file, offset, length) reference and checked: its magic, its
    length, its format version and the CRC32C of its last 4 bytes.  A value
    is held inline in its leaf or is a (file, offset, length) reference
    into a data file (``ValueRef``), read when it is asked for.
  * ``read_array(kv, name)``: the zarr v2 array ``name`` (its ``.zarray``
    and its chunks ``name/i.j...``), C order, zstd-compressed or raw
    chunks, whole or regular chunks assembled.  ``bfloat16`` comes back
    as its uint16 bit pattern.
  * ``read_tree(dir)``: the saved pytree, rebuilt from ``_METADATA``
    (which key parts are dict keys and which list indices) with torch
    leaves, bfloat16 kept bit for bit.

The format is tensorstore's published "OCDBT storage format", confirmed
field by field against directories tensorstore writes (the tests hold
every key and value against ``tensorstore.KvStore``).  Nodes and chunks
are decoded by the package's own zstd decoder (``zstd.py``).  Out of
scope, and refused with a clear error: zarr v3, F order, zarr filters,
other compressors, and checkpoints written by more than one process
(``ocdbt.process_1`` and up).
"""

from __future__ import annotations

import itertools
import json
import math
from collections.abc import Mapping
from pathlib import Path, PurePosixPath
from typing import Dict, Iterator, List, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1  # the offset and length of an empty tree's root
_HEADER = 4 + 8  # magic (big-endian u32), total length (little-endian u64)


class ValueRef(NamedTuple):
    """A value stored out of line: ``length`` bytes at ``offset`` of the
    data file ``path`` (relative to the store's root)."""

    path: str
    offset: int
    length: int


class _Cursor:
    """Reads the fields of one decoded manifest or node."""

    def __init__(self, data: bytes, what: str):
        self.b = data
        self.i = 0
        self.what = what

    def fail(self, msg: str):
        raise ValueError(f"{self.what}: {msg} at byte {self.i}")

    def take(self, n: int) -> bytes:
        if n > len(self.b) - self.i:
            self.fail(f"truncated ({n} bytes wanted)")
        out = self.b[self.i:self.i + n]
        self.i += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return int.from_bytes(self.take(4), "little")

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            if shift > 63:
                self.fail("varint longer than 64 bits")
            byte = self.u8()
            value |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                break
        if value >= 1 << 64:
            self.fail("varint longer than 64 bits")
        return value

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.i != len(self.b):
            self.fail(f"{len(self.b) - self.i} bytes left over")


def _unframe(blob: bytes, magic: int, what: str) -> bytes:
    """A manifest or node file image -> its decoded body, after checking
    its magic, length, CRC32C trailer and format version."""
    if len(blob) < _HEADER + 2 + 4:
        raise ValueError(f"{what}: truncated ({len(blob)} bytes)")
    got = int.from_bytes(blob[:4], "big")
    if got != magic:
        raise ValueError(f"{what}: magic {got:#010x}, want {magic:#010x}")
    length = int.from_bytes(blob[4:12], "little")
    if length != len(blob):
        raise ValueError(f"{what}: length field {length} but {len(blob)} "
                         "bytes")
    crc = int.from_bytes(blob[-4:], "little")
    if zstd.crc32c(blob[:-4]) != crc:
        raise ValueError(f"{what}: CRC32C mismatch")
    cur = _Cursor(blob[:-4], what)
    cur.i = _HEADER
    version = cur.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version}, only 0 is read")
    compression = cur.varint()
    body = blob[cur.i:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise ValueError(f"{what}: unknown compression format {compression}")


def _safe_path(path: str, what: str) -> str:
    p = PurePosixPath(path)
    if p.is_absolute() or ".." in p.parts:
        raise ValueError(f"{what}: data file path {path!r} leaves the store")
    return path


def _data_files(cur: _Cursor) -> List[str]:
    """A data file table: prefix-compressed paths relative to the root."""
    n = cur.varint()
    if n == 0:
        return []
    prefix = [0] + cur.varints(n - 1)
    suffix = cur.varints(n)
    base = cur.varints(n)
    paths: List[str] = []
    prev = b""
    for i in range(n):
        if prefix[i] > len(prev):
            cur.fail("data file path prefix longer than the previous path")
        path = prev[:prefix[i]] + cur.take(suffix[i])
        if base[i] > len(path):
            cur.fail("data file base path longer than the path")
        paths.append(_safe_path(path.decode(), cur.what))
        prev = path
    return paths


def _refs(cur: _Cursor, n: int, files: List[str]) -> List[ValueRef]:
    """n (file, offset, length) references, stored column by column."""
    ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
    out = []
    for i, o, ln in zip(ids, offsets, lengths):
        if o == _MISSING and ln == _MISSING:
            out.append(None)  # an empty tree
        else:
            out.append(ValueRef(_file(cur, files, i), o, ln))
    return out


def _file(cur: _Cursor, files: List[str], i: int) -> str:
    """Data file ``i`` of a node's table (a table may list an empty path,
    which no value or node may refer to)."""
    if i >= len(files) or not files[i]:
        cur.fail(f"bad data file id {i} (a table of {len(files)})")
    return files[i]


class _Version(NamedTuple):
    generation: int
    root: object  # ValueRef, or None for an empty tree
    root_height: int
    num_keys: int


def _versions(cur: _Cursor, files: List[str]) -> List[_Version]:
    """A version tree leaf: the versions it holds, column by column."""
    n = cur.varint()
    gens = cur.varints(n)
    heights = [cur.u8() for _ in range(n)]
    roots = _refs(cur, n, files)
    num_keys = cur.varints(n)
    cur.varints(n)  # num_tree_bytes
    cur.varints(n)  # num_indirect_value_bytes
    for _ in range(n):
        cur.u64()  # commit time
    return [_Version(*v) for v in zip(gens, roots, heights, num_keys)]


def _version_nodes(cur: _Cursor, files: List[str]) -> int:
    """The manifest's references to the older version tree nodes (parsed
    to check the manifest; the newest version is always in the manifest
    itself).  -> how many there are."""
    n = cur.varint()
    cur.varints(n)  # generation number
    _refs(cur, n, files)
    cur.varints(n)  # number of generations below
    for _ in range(n):
        cur.u64()  # commit time
    for _ in range(n):
        cur.u8()  # height
    return n


class KvStore(Mapping):
    """An OCDBT store at its latest generation, read-only: keys are bytes,
    ``store[key]`` the value's bytes (read from its data file when it is
    not inline), ``store.ref(key)`` the value as stored (bytes, or a
    ``ValueRef``)."""

    def __init__(self, root: Union[str, Path]):
        self.root = Path(root)
        processes = sorted(self.root.glob("ocdbt.process_*"))
        if len(processes) > 1:
            raise ValueError(
                f"{self.root}: written by {len(processes)} processes "
                f"({', '.join(p.name for p in processes)}); only "
                "single-process checkpoints are read")
        version = self._latest_version()
        self.generation = version.generation
        self._entries: Dict[bytes, Union[bytes, ValueRef]] = {}
        if version.root is not None:
            self._walk(version.root, version.root_height, b"")
        if len(self._entries) != version.num_keys:
            raise ValueError(f"{self.root}: {len(self._entries)} keys found, "
                             f"the manifest says {version.num_keys}")

    # -- files ---------------------------------------------------------- #

    def _read(self, ref: ValueRef) -> bytes:
        path = self.root / ref.path
        try:
            with open(path, "rb") as f:
                f.seek(ref.offset)
                data = f.read(ref.length)
        except OSError as e:
            raise ValueError(f"{self.root}: cannot read {ref.path}: {e}") \
                from e
        if len(data) != ref.length:
            raise ValueError(f"{path}: {len(data)} bytes at offset "
                             f"{ref.offset}, want {ref.length}")
        return data

    # -- manifest and version tree --------------------------------------- #

    def _manifest(self, path: Path) -> Tuple[int, _Cursor]:
        what = str(path)
        cur = _Cursor(_unframe(path.read_bytes(), MANIFEST_MAGIC, what), what)
        cur.take(16)  # the store's uuid
        kind = cur.varint()
        cur.varint()  # max_inline_value_bytes
        cur.varint()  # max_decoded_node_bytes
        cur.u8()  # version_tree_arity_log2
        method = cur.varint()
        if method == 1:
            cur.u32()  # zstd level
        elif method != 0:
            cur.fail(f"unknown compression method {method}")
        return kind, cur

    def _latest_version(self) -> _Version:
        path = self.root / "manifest.ocdbt"
        if not path.is_file():
            raise FileNotFoundError(f"{self.root}: no manifest.ocdbt (not an "
                                    "OCDBT checkpoint)")
        kind, cur = self._manifest(path)
        if kind == 1:  # numbered: the newest manifest.<16 hex> holds it
            cur.end()
            numbered = [p for p in self.root.glob("manifest.*")
                        if len(p.suffix) == 17
                        and all(c in "0123456789abcdef" for c in p.suffix[1:])]
            if not numbered:
                raise ValueError(f"{self.root}: numbered manifest without a "
                                 "manifest.<number> file")
            kind, cur = self._manifest(max(numbered, key=lambda p: p.suffix))
        if kind != 0:
            cur.fail(f"unknown manifest kind {kind}")
        files = _data_files(cur)
        versions = _versions(cur, files)
        _version_nodes(cur, files)
        cur.end()
        if not versions:
            raise ValueError(f"{self.root}: the manifest holds no version")
        return max(versions, key=lambda v: v.generation)

    # -- B+tree ---------------------------------------------------------- #

    def _walk(self, ref: ValueRef, height: int, prefix: bytes) -> None:
        what = f"{self.root / ref.path}@{ref.offset}"
        cur = _Cursor(_unframe(self._read(ref), BTREE_MAGIC, what), what)
        got = cur.u8()
        if got != height:
            cur.fail(f"node height {got}, its parent says {height}")
        files = _data_files(cur)
        n = cur.varint()
        if n == 0:
            cur.fail("empty node")
        plen = [0] + cur.varints(n - 1)
        slen = cur.varints(n)
        common = cur.varints(n) if height else None
        keys: List[bytes] = []
        prev = b""
        for i in range(n):
            if plen[i] > len(prev):
                cur.fail("key prefix longer than the previous key")
            prev = prev[:plen[i]] + cur.take(slen[i])
            keys.append(prev)
        if height:
            children = _refs(cur, n, files)
            for _ in range(3):  # num_keys, num_tree_bytes, num_indirect...
                cur.varints(n)
            cur.end()
            for key, c, child in zip(keys, common, children):
                if child is None or c > len(key):
                    cur.fail("bad child reference")
                self._walk(child, height - 1, prefix + key[:c])
            return
        lengths = cur.varints(n)
        kinds = cur.varints(n)
        if any(k > 1 for k in kinds):
            cur.fail(f"unknown value kind {max(kinds)}")
        indirect = [i for i, k in enumerate(kinds) if k == 1]
        ids = cur.varints(len(indirect))
        offsets = cur.varints(len(indirect))
        values: List[Union[bytes, ValueRef]] = [b""] * n
        for i, file_id, offset in zip(indirect, ids, offsets):
            values[i] = ValueRef(_file(cur, files, file_id), offset,
                                 lengths[i])
        for i, k in enumerate(kinds):
            if k == 0:
                values[i] = cur.take(lengths[i])
        cur.end()
        last = next(reversed(self._entries), None)
        for key, value in zip(keys, values):
            key = prefix + key
            if last is not None and key <= last:
                cur.fail("keys out of order")
            self._entries[key] = value
            last = key

    # -- mapping --------------------------------------------------------- #

    def ref(self, key: bytes) -> Union[bytes, ValueRef]:
        return self._entries[key]

    def __getitem__(self, key: bytes) -> bytes:
        value = self._entries[key]
        return self._read(value) if isinstance(value, ValueRef) else value

    def __iter__(self) -> Iterator[bytes]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)


def open_kvstore(path: Union[str, Path]) -> KvStore:
    """The OCDBT store of an orbax checkpoint directory, read-only."""
    return KvStore(path)


# ---------------------------------------------------------------- zarr -- #

def _zarr_dtype(name: str, dtype) -> Tuple[np.dtype, str]:
    """A .zarray dtype -> (numpy dtype of the stored bytes, dtype name)."""
    if dtype == "bfloat16":
        return np.dtype("<u2"), "bfloat16"
    if not isinstance(dtype, str):
        raise ValueError(f"{name}: structured zarr dtype {dtype!r}")
    try:
        dt = np.dtype(dtype)
    except TypeError:
        raise ValueError(f"{name}: unknown zarr dtype {dtype!r}") from None
    if dt.kind not in "biuf":
        raise ValueError(f"{name}: zarr dtype {dtype!r} is not numeric")
    return dt, dt.newbyteorder("=").name


def _read(kv: Mapping, name: str) -> Tuple[np.ndarray, str]:
    try:
        meta = json.loads(kv[f"{name}/.zarray".encode()])
    except KeyError:
        if f"{name}/zarr.json".encode() in kv:
            raise ValueError(f"{name}: a zarr v3 array; only zarr v2 is "
                             "read") from None
        raise KeyError(f"{name}: no such array (no {name}/.zarray)") \
            from None
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')}, "
                         "only 2 is read")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}: order {meta['order']!r}, only C is read")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']!r} are not "
                         "read")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {compressor.get('id')!r}, only "
                         "zstd or none is read")
    stored, dtype_name = _zarr_dtype(name, meta["dtype"])
    shape = tuple(int(s) for s in meta["shape"])
    chunks = tuple(int(c) for c in meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ValueError(f"{name}: chunks {chunks} for shape {shape}")
    sep = meta.get("dimension_separator", ".")
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    out = np.empty(shape, stored.newbyteorder("="))
    want = math.prod(chunks) * stored.itemsize
    for idx in itertools.product(*(range(g) for g in grid)):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        try:
            raw = kv[key.encode()]
        except KeyError:
            raise ValueError(f"{key}: chunk missing") from None
        if compressor is not None:
            raw = zstd.decompress(raw)
        if len(raw) != want:
            raise ValueError(f"{key}: {len(raw)} bytes, want {want}")
        chunk = np.frombuffer(raw, stored).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    return out, dtype_name


def read_array(kv: Mapping, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of an OCDBT store (a ``KvStore``, or any
    mapping of bytes keys to bytes values) -> numpy, native byte order;
    ``bfloat16`` as its uint16 bit pattern."""
    return _read(kv, name)[0]


def _to_tensor(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(a)  # _read's own C-contiguous array
    return t.view(torch.bfloat16) if dtype_name == "bfloat16" else t


_EMPTY = {"Dict": dict, "List": list, "Tuple": tuple, "None": lambda: None}


def read_tree(path: Union[str, Path], under: Sequence[str] = ()):
    """The pytree an orbax ``StandardCheckpointer`` saved in ``path``:
    dicts (NamedTuples are saved as dicts of their fields) and lists, with
    CPU torch tensors as leaves, bfloat16 bit for bit.  ``under``: only the
    subtree at that key path (``("params",)``), the rest is not read."""
    path = Path(path)
    meta_file = path / "_METADATA"
    if not meta_file.is_file():
        raise FileNotFoundError(f"{path}: no _METADATA (not an orbax "
                                "checkpoint)")
    meta = json.loads(meta_file.read_text())
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{path}: not an OCDBT checkpoint")
    if meta.get("use_zarr3", False):
        raise ValueError(f"{path}: zarr v3 arrays; only zarr v2 is read")
    kv = open_kvstore(path)
    under = [str(u) for u in under]
    root: dict = {}
    for entry in meta["tree_metadata"].values():
        parts = entry["key_metadata"]
        keys = [str(p["key"]) for p in parts]
        if keys[:len(under)] != under:
            continue
        value_meta = entry["value_metadata"]
        kind = value_meta.get("value_type")
        if value_meta.get("skip_deserialize"):
            if kind not in _EMPTY:
                raise ValueError(f"{path}: leaf {'.'.join(keys)} of type "
                                 f"{kind!r} is not read")
            leaf = _EMPTY[kind]()
        else:
            leaf = _to_tensor(*_read(kv, ".".join(keys)))
        node = root
        rel = parts[len(under):]
        if not rel:
            return leaf
        for part in rel[:-1]:
            key = _node_key(part)
            node = node.setdefault(key, {})
        node[_node_key(rel[-1])] = leaf
    if not root:
        raise KeyError(f"{path}: nothing saved under {'.'.join(under)!r}")
    return _lists(root)


def _node_key(part: dict):
    """key_type 1 is a sequence index, 2 a dict key."""
    if part["key_type"] == 1:
        return int(part["key"])
    if part["key_type"] == 2:
        return str(part["key"])
    raise ValueError(f"unknown key_type {part['key_type']}")


def _lists(node):
    """Int-keyed dicts back into lists."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"list indices {sorted(node)} are not 0..n-1")
        return [_lists(node[i]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}
