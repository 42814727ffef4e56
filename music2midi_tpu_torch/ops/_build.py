"""Build and load the package's hand-written CUDA kernels.

Each of ``music2midi_tpu_torch/csrc/*.cu`` is compiled by its own
``nvcc -c``, all started together, and one more ``nvcc`` links the objects
into one shared library with a plain C interface, which is loaded with
``ctypes``.  No PyTorch headers are included, so the build takes seconds
rather than the minutes a ``torch.utils.cpp_extension`` build takes.

The build runs at first use, never at import, into ``_build/`` next to
this package (listed in ``.gitignore``).  The library's file name carries
a hash of the sources and flags, so an edited source is rebuilt and a
stale library is never loaded.  Nothing here runs on a machine without
``nvcc``; the CPU paths of the package never call it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_float = ctypes.c_float
_c_int64 = ctypes.c_int64

# argtypes of every exported launcher: pointers and the stream as
# c_void_p (a bare Python int would be passed as a 32-bit int)
_SIGNATURES = {
    "m2m_log_mel_fft": [_c_void_p] * 9 + [_c_int] * 6 + [_c_float, _c_void_p],
    "m2m_log_mel_dft": [_c_void_p] * 9 + [_c_int] * 6 + [_c_float, _c_void_p],
    # (argument block, (b, h) pairs, q, q_sb, q_sh, fresh k, v, k scale,
    # v scale, bias window, step, stream)
    "m2m_decode_attention_int8": [_c_void_p, _c_int, _c_void_p, _c_int64,
                                  _c_int64] + [_c_void_p] * 5
                                 + [_c_int, _c_void_p],
    # (pointer to the argument struct, number of blocks, stream)
    "m2m_decode_attention_cross_t": [_c_void_p, _c_int, _c_void_p],
}


class BuildInfo:
    """What the last build (or cache hit) of this process did."""

    def __init__(self, path: Path, seconds: float, cached: bool, log: str):
        self.path = path
        self.seconds = seconds
        self.cached = cached
        self.log = log

    def ptxas_lines(self) -> list:
        """The register / shared-memory / spill lines of ``-Xptxas -v``."""
        keys = ("registers", "spill", "smem", "Compiling entry")
        return [ln.strip() for ln in self.log.splitlines()
                if any(k in ln for k in keys)]


_lib: Optional[ctypes.CDLL] = None
_info: Optional[BuildInfo] = None
# one build and one load a process, whichever thread launches first (the
# serving batcher's dispatcher thread may be the first)
_lock = threading.RLock()


def find_nvcc() -> str:
    """nvcc on PATH, else under CUDA_HOME or /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of music2midi_tpu_torch are built at first use and "
        "need the CUDA toolkit"
    )


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest(sources: list) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list) -> str:
    """Start every command at once, wait for all; raise on any failure.
    -> their output, in order."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed (exit {proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def build() -> BuildInfo:
    """Compile csrc/*.cu (if this exact source set is not built yet): one
    ``nvcc -c`` per source in parallel, then one link."""
    if _info is not None:
        return _info
    with _lock:
        return _info or _build()


def _build() -> BuildInfo:
    global _info
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    digest = _digest(sources)
    lib_path = BUILD_DIR / f"libm2m_kernels_{digest}.so"
    if lib_path.is_file():
        _info = BuildInfo(lib_path, 0.0, True, "")
        return _info
    nvcc = find_nvcc()
    obj_dir = BUILD_DIR / f"obj_{digest}_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    objs = [obj_dir / f"{src.stem}.o" for src in sources]
    tmp_path = lib_path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                    for src, obj in zip(sources, objs)])
    log += _run_all([[nvcc, "-shared", "-o", str(tmp_path),
                      *map(str, objs)]])
    seconds = time.perf_counter() - t0
    os.replace(tmp_path, lib_path)
    shutil.rmtree(obj_dir, ignore_errors=True)
    _info = BuildInfo(lib_path, seconds, False, log)
    return _info


def load() -> ctypes.CDLL:
    """The built library, with every launcher's argtypes declared."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build().path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _c_int
            _lib = lib
        return _lib


def check(status: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed, cudaError_t {status}")
