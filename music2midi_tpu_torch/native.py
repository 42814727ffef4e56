"""ctypes bindings for the host DSP library (``csrc/m2m_dsp.cpp``).

The port's own copy of ``music2midi_tpu/native.py``: the same C ABI, the
same argtypes and the same Python signatures, over a copy of the JAX
package's source (``native/m2m_dsp.cpp``) kept in ``csrc/``.  It is host
code: the phase-vocoder pitch shift of the training loader, polyphase
resampling, the banded DTW of the aligner and the offset clamp of
``midi_to_numpy``.

The library is built at first use, never at import: one ``g++`` with the
flags of ``native/Makefile`` into ``_build/`` next to this package (listed
in ``.gitignore``), under the kernel build's lock (``ops/_build.py``).  Its
file name carries a hash of the source, the flags and the host's CPU
(``-march=native``), so an edited source is rebuilt and a library built
for another CPU is never loaded.  A failed build is not an exception at
the call sites that have a numpy fallback (``dsp.pitch_shift``, the
aligner, ``midi_to_numpy``): ``available()`` is False and the compiler's
output is kept in ``build_log()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from .ops import _build

SOURCE = _build.CSRC_DIR / "m2m_dsp.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared"]  # native/Makefile's CXXFLAGS, and -shared

_lib: Optional[ctypes.CDLL] = None
_failed = False
_log = ""


def _cpu_identity() -> bytes:
    """The lines of /proc/cpuinfo that ``-march=native`` depends on."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keys = ("model name", "flags")
    return "\n".join(sorted({ln for ln in lines
                             if ln.split(":")[0].strip() in keys})).encode()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_identity())
    return _build.BUILD_DIR / f"libm2m_dsp_{h.hexdigest()[:16]}.so"


def _compile(path: Path) -> None:
    """g++ the source into `path` (a temporary name, then an atomic rename:
    processes building at once each finish with a whole file)."""
    global _log
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler: g++ not on PATH and $CXX unset")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    _log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (exit {proc.returncode})")
    os.replace(tmp, path)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.m2m_resample.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, f32p,
        ctypes.c_double,
    ]
    lib.m2m_resample.restype = ctypes.c_int
    lib.m2m_pitch_shift.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_double, f32p,
    ]
    lib.m2m_pitch_shift.restype = None
    lib.m2m_fix_invalid_offsets.argtypes = [f64p, ctypes.c_int64]
    lib.m2m_fix_invalid_offsets.restype = None
    lib.m2m_dtw_band.argtypes = [
        f32p, f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        i64p,
    ]
    lib.m2m_dtw_band.restype = ctypes.c_int64
    lib.m2m_version.restype = ctypes.c_int
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built first if needed), or None when it cannot
    be built or loaded; then ``build_log()`` says why."""
    global _lib, _failed, _log
    if _lib is not None or _failed:
        return _lib
    with _build._lock:
        if _lib is not None or _failed:
            return _lib
        try:
            path = library_path()
            if not path.is_file():
                _compile(path)
            _lib = _declare(ctypes.CDLL(str(path)))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _failed = True
            _log = "\n".join(filter(None, [_log, repr(e)]))
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_log() -> str:
    """The compiler's output of this process's build ("" when the library
    was found built), or why loading failed."""
    return _log


def _require() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable:\n{_log}")
    return lib


def pitch_shift(y: np.ndarray, sr: int, n_steps: float) -> np.ndarray:
    """Native phase-vocoder pitch shift; raises if the library is absent
    (callers dispatch via dsp.pitch_shift, which falls back to numpy)."""
    lib = _require()
    x = np.ascontiguousarray(y, dtype=np.float32)
    out = np.empty_like(x)
    lib.m2m_pitch_shift(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        x.size, int(sr), float(n_steps),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def resample(x: np.ndarray, up: int, down: int,
             beta: float = 14.769656459379492) -> np.ndarray:
    lib = _require()
    xin = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty((xin.size * up + down - 1) // down + 8, dtype=np.float32)
    n = lib.m2m_resample(
        xin.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        xin.size, up, down,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), beta,
    )
    return out[:n]


def dtw_band(
    fa: np.ndarray,
    fb: np.ndarray,
    lo: Optional[np.ndarray] = None,
    hi: Optional[np.ndarray] = None,
    weights=(1.5, 1.5, 2.0),
) -> np.ndarray:
    """Banded weighted-step DTW over cosine cost.

    fa: (d, n), fb: (d, m), time on axis 1 (as ``data/align.py``).  lo/hi:
    per-row-of-fa allowed column range [lo[i], hi[i]); default the full
    rectangle.  -> the warp path (2, L), start to end."""
    lib = _require()
    a = np.ascontiguousarray(fa.T, dtype=np.float32)  # (n, d)
    b = np.ascontiguousarray(fb.T, dtype=np.float32)  # (m, d)
    n, d = a.shape
    m = b.shape[0]
    lo_arr = (np.zeros(n, np.int64) if lo is None
              else np.ascontiguousarray(lo, np.int64))
    hi_arr = (np.full(n, m, np.int64) if hi is None
              else np.ascontiguousarray(hi, np.int64))
    out = np.empty(2 * (n + m), dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    length = lib.m2m_dtw_band(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        d, n, m,
        lo_arr.ctypes.data_as(i64p), hi_arr.ctypes.data_as(i64p),
        float(weights[0]), float(weights[1]), float(weights[2]),
        out.ctypes.data_as(i64p),
    )
    if length < 0:
        raise ValueError("m2m_dtw_band failed (empty input or bad band)")
    return out[: 2 * length].reshape(length, 2).T.copy()


def fix_invalid_offsets(notes: np.ndarray) -> np.ndarray:
    """Clamp each offset to the next same-pitch onset (in place when
    `notes` is a C-contiguous float64 array); -> the array."""
    lib = _require()
    arr = np.ascontiguousarray(notes, dtype=np.float64)
    lib.m2m_fix_invalid_offsets(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), arr.shape[0]
    )
    return arr
