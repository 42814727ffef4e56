"""ctypes bindings for the package's Zstandard decoder (``csrc/zstd_decode.cpp``).

Host code for the orbax checkpoint reader (``orbax.py``): every OCDBT node
and zarr chunk that tensorstore writes for a JAX training run is a zstd
frame, and every OCDBT node ends in a CRC32C of its bytes.  The decoder is
written from RFC 8878 (decompression only, no dictionaries); it is the
only implementation, with no Python fallback and no system ``libzstd``.

The library is built at first use, never at import: one ``g++`` into
``_build/`` next to this package (listed in ``.gitignore``), under the
kernel build's lock (``ops/_build.py``), its file name hashed over the
source and the flags.  A failed build raises with the compiler's output,
since nothing else here can read these files.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Union

from .ops import _build

SOURCE = _build.CSRC_DIR / "zstd_decode.cpp"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_log = ""

Bytes = Union[bytes, bytearray, memoryview]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return _build.BUILD_DIR / f"libm2m_zstd_{h.hexdigest()[:16]}.so"


def _compile(path: Path) -> None:
    """g++ the source into `path` (a temporary name, then an atomic rename:
    processes building at once each finish with a whole file)."""
    global _log
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("zstd decoder: no C++ compiler (g++ not on PATH "
                           "and $CXX unset)")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    _log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"zstd decoder: g++ failed (exit {proc.returncode}):\n{_log}")
    os.replace(tmp, path)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, sz = ctypes.c_void_p, ctypes.c_size_t
    lib.m2m_zstd_content_size.argtypes = [vp, sz]
    lib.m2m_zstd_content_size.restype = ctypes.c_int64
    lib.m2m_zstd_decompress.argtypes = [
        vp, sz, vp, sz, ctypes.POINTER(sz), ctypes.c_char_p, sz,
        ctypes.POINTER(sz)]
    lib.m2m_zstd_decompress.restype = ctypes.c_int
    lib.m2m_crc32c.argtypes = [vp, sz]
    lib.m2m_crc32c.restype = ctypes.c_uint32
    lib.m2m_xxh64.argtypes = [vp, sz, ctypes.c_uint64]
    lib.m2m_xxh64.restype = ctypes.c_uint64
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if it cannot be."""
    global _lib
    if _lib is not None:
        return _lib
    with _build._lock:
        if _lib is None:
            path = library_path()
            if not path.is_file():
                _compile(path)
            _lib = _declare(ctypes.CDLL(str(path)))
        return _lib


def build_log() -> str:
    """The compiler's output of this process's build ("" when the library
    was found built)."""
    return _log


def _pointer(data: bytes) -> int:
    """The address of a bytes object's buffer (no copy)."""
    return ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value or 0


def decompress(data: Bytes) -> bytes:
    """Decode a zstd stream: one or more frames, skippable frames among
    them.  Corrupt or truncated input raises ``ValueError`` naming the
    byte offset where it was found."""
    lib = get_lib()
    src = bytes(data)
    size = lib.m2m_zstd_content_size(_pointer(src), len(src))
    cap = int(size) if size >= 0 else 4 * len(src) + (1 << 16)
    err = ctypes.create_string_buffer(256)
    out_len, err_off = ctypes.c_size_t(), ctypes.c_size_t()
    while True:
        out = ctypes.create_string_buffer(max(cap, 1))
        status = lib.m2m_zstd_decompress(
            _pointer(src), len(src), ctypes.addressof(out), cap,
            ctypes.byref(out_len), err, len(err), ctypes.byref(err_off))
        if status == 0:
            return ctypes.string_at(ctypes.addressof(out), out_len.value)
        if status == 1:
            raise ValueError(f"zstd: {err.value.decode()} at byte "
                             f"{err_off.value} of {len(src)}")
        if size >= 0:  # more than the frames declare: caught as corrupt
            raise ValueError("zstd: output larger than the declared "
                             "content size")
        cap *= 2


def crc32c(data: Bytes) -> int:
    """CRC32C (Castagnoli) of ``data``, as OCDBT checks its nodes."""
    src = bytes(data)
    return int(get_lib().m2m_crc32c(_pointer(src), len(src)))


def xxh64(data: Bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (the low 32 bits are a zstd frame's checksum)."""
    src = bytes(data)
    return int(get_lib().m2m_xxh64(_pointer(src), len(src), seed))
