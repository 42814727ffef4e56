"""The port's C++ DSP library (``music2midi_tpu_torch/native.py``) against
the JAX package's (``music2midi_tpu/native.py``) and against the port's
own numpy routes.

Both libraries are built here from the same source with the same ``g++``
flags.  Bars, those of ``tests/test_native.py``: the DTW path and
``fix_invalid_offsets`` equal; ``pitch_shift`` and ``resample`` within
``atol=1e-5`` (of each other, of the port's numpy pitch shift and of
scipy's ``resample_poly``).  The library is built at first use, never at
import, and a failed build leaves ``available()`` False with the
compiler's output in ``build_log()``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _jax_native import loaded as jax_native
from music2midi_tpu_torch import dsp as pdsp
from music2midi_tpu_torch import native as pnative
from music2midi_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent
SR = 16000


@pytest.fixture(scope="module")
def libs():
    """Both libraries loaded (the JAX package's through ``_jax_native``,
    which waits out other test processes building it)."""
    jnative = jax_native()
    assert pnative.available(), pnative.build_log()
    return jnative, pnative


def _tone(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    return (np.sin(2 * np.pi * 440 * t) + 0.3 * np.sin(2 * np.pi * 97 * t)
            + 0.1 * rng.normal(size=n)).astype(np.float32)


def test_source_is_the_jax_packages_copy():
    assert (ROOT / "music2midi_tpu_torch" / "csrc" / "m2m_dsp.cpp"
            ).read_bytes() == (ROOT / "native" / "m2m_dsp.cpp").read_bytes()


@pytest.mark.parametrize("steps", [-6, -1, 2, 5])
def test_pitch_shift_matches_jax_and_numpy(libs, steps):
    j, p = libs
    y = _tone(SR, 0)
    got = p.pitch_shift(y, SR, steps)
    assert got.dtype == np.float32 and len(got) == len(y)
    np.testing.assert_allclose(got, j.pitch_shift(y, SR, steps), atol=1e-5)
    np.testing.assert_allclose(
        got, pdsp.pitch_shift(y, SR, steps, prefer_native=False), atol=1e-5)


@pytest.mark.parametrize("up, down", [(160, 441), (2, 3), (3, 2),
                                      (441, 160)])
def test_resample_matches_jax_and_scipy(libs, up, down):
    from scipy.signal import resample_poly

    j, p = libs
    x = np.random.default_rng(1).normal(size=12345).astype(np.float32)
    got = p.resample(x, up, down)
    np.testing.assert_allclose(got, j.resample(x, up, down), atol=1e-5)
    want = resample_poly(x, up, down,
                         window=("kaiser", 14.769656459379492))
    n = min(len(want), len(got))
    assert abs(len(want) - len(got)) <= 1
    np.testing.assert_allclose(got[:n], want[:n].astype(np.float32),
                               atol=1e-5)


@pytest.mark.parametrize("banded", [False, True])
def test_dtw_band_equals_jax(libs, banded):
    j, p = libs
    rng = np.random.default_rng(2)
    fa = rng.random((24, 140)).astype(np.float32)
    fb = rng.random((24, 170)).astype(np.float32)
    fa /= np.linalg.norm(fa, axis=0)
    fb /= np.linalg.norm(fb, axis=0)
    lo = hi = None
    if banded:
        centre = np.linspace(0, 169, 140)
        lo = np.maximum(0, centre - 12).astype(np.int64)
        hi = np.minimum(170, centre + 13).astype(np.int64)
        lo[0], hi[-1] = 0, 170
    got = p.dtw_band(fa, fb, lo, hi)
    want = j.dtw_band(fa, fb, lo, hi)
    assert got.dtype == want.dtype and got.shape[0] == 2
    np.testing.assert_array_equal(got, want)
    assert tuple(got[:, 0]) == (0, 0) and tuple(got[:, -1]) == (139, 169)


def test_fix_invalid_offsets_equals_jax_and_the_definition(libs):
    j, p = libs
    notes = np.array([[0.0, 5.0, 60, 80], [1.0, 5.0, 60, 80],
                      [1.0, 6.0, 60, 90], [2.0, 9.0, 60, 80],
                      [0.5, 9.0, 62, 80]])
    np.testing.assert_array_equal(p.fix_invalid_offsets(notes.copy())[:, 1],
                                  [1.0, 2.0, 2.0, 9.0, 9.0])
    rng = np.random.default_rng(3)
    n = 300
    arr = np.stack([rng.uniform(0, 30, n), rng.uniform(0, 35, n),
                    rng.integers(60, 64, n).astype(float),
                    np.full(n, 80.0)], axis=1)
    want = arr.copy()
    for pitch in np.unique(want[:, 2]):
        idx = want[:, 2] == pitch
        tmp = want[idx]
        for i in range(len(tmp)):
            later = tmp[tmp[:, 0] > tmp[i, 0], 0]
            if len(later):
                tmp[i, 1] = min(tmp[i, 1], later.min())
        want[idx] = tmp
    got = p.fix_invalid_offsets(arr.copy())
    np.testing.assert_array_equal(got, j.fix_invalid_offsets(arr.copy()))
    np.testing.assert_array_equal(got, want)


def test_pitch_shift_dispatch(libs, monkeypatch):
    _, p = libs
    y = _tone(8000, 4)
    np.testing.assert_array_equal(pdsp.pitch_shift(y, SR, 2),
                                  p.pitch_shift(y, SR, 2))
    numpy_route = pdsp.pitch_shift(y, SR, 2, prefer_native=False)
    monkeypatch.setattr(p, "available", lambda: False)
    np.testing.assert_array_equal(pdsp.pitch_shift(y, SR, 2), numpy_route)
    np.testing.assert_array_equal(pdsp.pitch_shift(y, SR, 0), y)


def test_failed_build_is_kept_and_reported(tmp_path, monkeypatch):
    bad = tmp_path / "m2m_dsp.cpp"
    bad.write_text("int m2m_version() { return }\n")
    monkeypatch.setattr(pnative, "SOURCE", bad)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "_failed", False)
    monkeypatch.setattr(pnative, "_log", "")
    assert not pnative.available()
    assert "error" in pnative.build_log() and "g++ failed" in \
        pnative.build_log()
    assert list((tmp_path / "_build").glob("*.so")) == []
    with pytest.raises(RuntimeError, match="native library unavailable"):
        pnative.pitch_shift(np.zeros(16, np.float32), SR, 1)


def test_built_at_first_use_not_at_import():
    code = ("import music2midi_tpu_torch.native as n, "
            "music2midi_tpu_torch.dsp, music2midi_tpu_torch.data.dataset\n"
            "print(n._lib is None and not n._failed)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "True"
