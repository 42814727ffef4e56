"""Audio <-> MIDI alignment: chroma/onset features, multiscale DTW.

First-party replacement for the synctoolbox pipeline the reference uses for
dataset preparation (reference data/align_audio_midi.py:120-247:
audio_to_pitch_features -> chroma -> DLNCO onset features ->
sync_via_mrmsdtw -> make_path_strictly_monotonic).  synctoolbox/librosa are
not dependencies here; the algorithms are reimplemented in the same spirit:

  * STFT-based log-frequency pitch energies -> 12-bin chroma, quantized and
    smoothed (CENS-like), at a configurable feature rate
  * decaying locally-normalized chroma onset features (DLNCO-like) from
    half-wave-rectified chroma flux
  * optimal chroma shift: best of the 12 rotations under average cosine
    distance of downsampled chroma (reference
    compute_optimal_chroma_shift_wrapper)
  * multiscale DTW: full DTW on a coarse grid, then band-constrained DTW at
    full resolution around the coarse path (the memory restriction that
    gives MrMsDTW its name), step set {(1,0),(0,1),(1,1)} with weights
    [1.5, 1.5, 2.0] (reference align_audio_midi.py:241)

The output contract matches the reference: a warp path (2, L) in seconds
(song time, midi time), strictly monotonic after cleanup.

The port's own copy of ``music2midi_tpu/data/align.py``: numpy on the
host, as there, with the banded DTW in the port's C++ library
(``native.dtw_band``) where it is built, at the same two call sites.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# --------------------------------------------------------------------- #
# features                                                               #
# --------------------------------------------------------------------- #


def _blocked_power_spectra(
    x: np.ndarray, hop: int, n_fft: int, block: int = 2048
):
    """Yield (start_frame, power) float32 blocks of the STFT power spectrum
    of pre-padded signal `x`.  Blocking keeps peak memory ~block*n_fft
    floats instead of materializing a (T, n_fft) float64 frame matrix —
    the difference between ~2 s and ~70 s per 3-minute song on this host."""
    n_frames = 1 + (len(x) - n_fft) // hop
    window = np.hanning(n_fft).astype(np.float32)
    base = np.arange(n_fft)[None, :]
    for start in range(0, n_frames, block):
        stop = min(start + block, n_frames)
        idx = (np.arange(start, stop)[:, None] * hop + base)
        frames = x[idx] * window
        spec = np.fft.rfft(frames, axis=1)
        yield start, (spec.real ** 2 + spec.imag ** 2)


def chroma_features(
    audio: np.ndarray,
    sr: int,
    feature_rate: int = 50,
    tuning_cents: float = 0.0,
) -> np.ndarray:
    """(12, T) chroma energy at feature_rate frames/s, L2-normalized-ish
    with a log compression (CENS-like)."""
    hop = int(round(sr / feature_rate))
    n_fft = 4096
    pad = n_fft // 2
    x = np.pad(audio.astype(np.float32), pad, mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    freqs = np.fft.rfftfreq(n_fft, 1 / sr)
    # map bins to MIDI pitches 24..108 honoring the tuning offset
    with np.errstate(divide="ignore"):
        midi = 69 + 12 * np.log2(freqs / 440.0) - tuning_cents / 100.0
    midi[0] = -1
    pitch_bin = np.round(midi).astype(int)
    valid = (pitch_bin >= 24) & (pitch_bin <= 108)
    # bins -> chroma classes as one (n_bins, 12) projection matmul per block
    proj = np.zeros((len(freqs), 12), dtype=np.float32)
    proj[np.arange(len(freqs))[valid], pitch_bin[valid] % 12] = 1.0
    chroma = np.empty((12, n_frames))
    for start, power in _blocked_power_spectra(x, hop, n_fft):
        chroma[:, start:start + power.shape[0]] = (power @ proj).T
    # CENS-style: l1-normalize columns, quantize against energy-fraction
    # thresholds (synctoolbox quantize_chroma), l2-normalize for cosine
    # cost.  (A log1p compression here flattened the classes so badly the
    # key detector failed on clean synthetic tones.)
    col_sum = chroma.sum(axis=0)
    chroma = chroma / np.maximum(col_sum, 1e-12)
    levels = np.zeros_like(chroma)
    for thr in (0.05, 0.1, 0.2, 0.4):
        levels += chroma > thr
    levels /= 4.0
    norms = np.linalg.norm(levels, axis=0)
    return levels / np.maximum(norms, 1e-9)


def onset_features(chroma: np.ndarray, decay: int = 10) -> np.ndarray:
    """(12, T) DLNCO-like: half-wave-rectified chroma flux, locally
    normalized, convolved with a decaying kernel so onsets tolerate small
    misalignment."""
    flux = np.maximum(np.diff(chroma, axis=1, prepend=chroma[:, :1]), 0.0)
    # local normalization over a ~1s window
    win = 51
    kernel = np.ones(win) / win
    local = np.stack([np.convolve(f, kernel, mode="same") for f in flux])
    flux = flux / np.maximum(local.max(axis=0, keepdims=True), 1e-6)
    dk = np.sqrt(1.0 / np.arange(1, decay + 1))
    out = np.stack([np.convolve(f, dk, mode="full")[: f.shape[0]]
                    for f in flux])
    norms = np.linalg.norm(out, axis=0)
    return out / np.maximum(norms, 1e-9)


def estimate_tuning(audio: np.ndarray, sr: int) -> float:
    """Tuning deviation in fractional semitones (librosa.estimate_tuning
    spirit: histogram of spectral-peak pitch residuals)."""
    n_fft = 4096
    hop = 2048
    pad = n_fft // 2
    x = np.pad(audio.astype(np.float32), pad, mode="reflect")
    freqs = np.fft.rfftfreq(n_fft, 1 / sr)
    # running per-bin max magnitude over frames, block by block
    mags = np.zeros(len(freqs), dtype=np.float64)
    for _, power in _blocked_power_spectra(x, hop, n_fft):
        np.maximum(mags, power.max(axis=0), out=mags)
    mags = np.sqrt(mags)
    lo, hi = np.searchsorted(freqs, [55.0, 2093.0])
    seg = mags[lo:hi]
    peaks = np.where(
        (seg[1:-1] > seg[:-2]) & (seg[1:-1] > seg[2:])
        & (seg[1:-1] > 0.01 * seg.max())
    )[0] + 1 + lo
    if len(peaks) == 0:
        return 0.0
    # parabolic interpolation of peak frequency
    alpha = mags[peaks - 1]
    beta = mags[peaks]
    gamma = mags[peaks + 1]
    denom = alpha - 2 * beta + gamma
    shift = np.where(np.abs(denom) > 1e-12,
                     0.5 * (alpha - gamma) / np.where(denom == 0, 1, denom),
                     0.0)
    f = freqs[peaks] + shift * (freqs[1] - freqs[0])
    resid = (69 + 12 * np.log2(f / 440.0)) % 1.0
    resid = np.where(resid > 0.5, resid - 1.0, resid)
    hist, edges = np.histogram(resid, bins=50, range=(-0.5, 0.5))
    return float(edges[np.argmax(hist)] + 0.01)


def compute_optimal_chroma_shift(
    chroma_a: np.ndarray, chroma_b: np.ndarray, rate: int = 50
) -> int:
    """Best of 12 rotations of b by normalized DTW cost on ~1 Hz features
    (synctoolbox computes a DTW cost per shift: a plain per-column
    comparison fails when the two signals are time-stretched relative to
    each other).  != 0 means the inputs are in different keys."""
    step = max(1, rate)
    a = _avg_pool(chroma_a, step)
    b = _avg_pool(chroma_b, step)
    best, best_shift = np.inf, 0
    for shift in range(12):
        rb = np.roll(b, shift, axis=0)
        cost = _cost_matrix(a, rb)
        path = _dtw_full(a, rb, cost)
        total = cost[path[0], path[1]].sum() / path.shape[1]
        if total < best:
            best, best_shift = total, shift
    return best_shift


def shift_chroma(chroma: np.ndarray, shift: int) -> np.ndarray:
    return np.roll(chroma, shift, axis=0)


# --------------------------------------------------------------------- #
# DTW                                                                    #
# --------------------------------------------------------------------- #

_STEPS = ((1, 0), (0, 1), (1, 1))
_WEIGHTS = (1.5, 1.5, 2.0)  # reference align_audio_midi.py:241


def _cost_matrix(fa: np.ndarray, fb: np.ndarray) -> np.ndarray:
    """1 - cosine similarity of column features (both L2-normalized)."""
    return 1.0 - fa.T @ fb


def _native_dtw():
    """The C++ banded kernel, or None (pure-Python fallback below)."""
    from .. import native

    return native.dtw_band if native.available() else None


def _dtw_full(fa: np.ndarray, fb: np.ndarray, cost=None) -> np.ndarray:
    """Unbanded DTW on features — native kernel when built."""
    kernel = _native_dtw()
    if kernel is not None:
        return kernel(fa, fb)
    return dtw_path(_cost_matrix(fa, fb) if cost is None else cost)


def dtw_path(
    cost: np.ndarray, mask: np.ndarray | None = None
) -> np.ndarray:
    """Weighted-step DTW through `cost`; optional boolean mask of allowed
    cells (band constraint).  -> path (2, L) of (row, col), start to end."""
    n, m = cost.shape
    INF = np.inf
    D = np.full((n + 1, m + 1), INF)
    P = np.zeros((n, m), dtype=np.int8)
    D[1, 1] = cost[0, 0]
    allowed = mask if mask is not None else np.ones((n, m), bool)
    for i in range(1, n + 1):
        row_ok = allowed[i - 1]
        ci = cost[i - 1]
        for j in range(1, m + 1):
            if i == 1 and j == 1:
                continue
            if not row_ok[j - 1]:
                continue
            best = D[i - 1, j] + _WEIGHTS[0] * ci[j - 1]
            step = 0
            alt = D[i, j - 1] + _WEIGHTS[1] * ci[j - 1]
            if alt < best:
                best, step = alt, 1
            alt = D[i - 1, j - 1] + _WEIGHTS[2] * ci[j - 1]
            if alt < best:
                best, step = alt, 2
            if best < INF:
                D[i, j] = best
                P[i - 1, j - 1] = step
    # backtrack
    i, j = n - 1, m - 1
    path = [(i, j)]
    while i > 0 or j > 0:
        s = _STEPS[P[i, j]]
        i, j = i - s[0], j - s[1]
        if i < 0 or j < 0:
            break
        path.append((i, j))
    return np.array(path[::-1]).T


def dtw_path_fast(cost: np.ndarray, mask: np.ndarray | None = None
                  ) -> np.ndarray:
    """Vectorized-anti-diagonal variant of dtw_path for larger matrices."""
    n, m = cost.shape
    INF = np.float64(1e18)
    D = np.full((n, m), INF)
    P = np.zeros((n, m), dtype=np.int8)
    allowed = (mask if mask is not None else np.ones((n, m), bool))
    D[0, 0] = cost[0, 0] if allowed[0, 0] else INF
    # first row / column
    for j in range(1, m):
        if allowed[0, j]:
            D[0, j] = D[0, j - 1] + _WEIGHTS[1] * cost[0, j]
            P[0, j] = 1
    for i in range(1, n):
        if allowed[i, 0]:
            D[i, 0] = D[i - 1, 0] + _WEIGHTS[0] * cost[i, 0]
        prev = D[i - 1]
        cur = D[i]
        ci = cost[i]
        ok = allowed[i]
        # vectorized over j for steps (1,0) and (1,1); (0,1) needs a scan
        up = prev + _WEIGHTS[0] * ci
        diag = np.empty(m)
        diag[0] = INF
        diag[1:] = prev[:-1] + _WEIGHTS[2] * ci[1:]
        best = np.where(diag < up, diag, up)
        step = np.where(diag < up, 2, 0).astype(np.int8)
        # left-to-right scan folds in the (0,1) step
        for j in range(1, m):
            if not ok[j]:
                continue
            left = cur[j - 1] + _WEIGHTS[1] * ci[j]
            if j == 0:
                continue
            b = best[j]
            if left < b:
                cur[j] = left
                P[i, j] = 1
            else:
                cur[j] = b
                P[i, j] = step[j]
        if not ok[0]:
            cur[0] = INF
    i, j = n - 1, m - 1
    path = [(i, j)]
    while i > 0 or j > 0:
        s = _STEPS[P[i, j]]
        i2, j2 = i - s[0], j - s[1]
        if i2 < 0 or j2 < 0 or (i2 == i and j2 == j):
            break
        i, j = i2, j2
        path.append((i, j))
    return np.array(path[::-1]).T


def multiscale_dtw(
    fa: np.ndarray,
    fb: np.ndarray,
    coarse_factor: int = 50,
    band_radius: int = 100,
) -> np.ndarray:
    """Memory-restricted multiscale DTW (MrMsDTW-like): full DTW on
    `coarse_factor`-downsampled features, then band-constrained DTW at full
    resolution around the projected coarse path.  -> path (2, L)."""
    n, m = fa.shape[1], fb.shape[1]
    if n == 0 or m == 0:
        return np.zeros((2, 0), dtype=int)
    ca = _avg_pool(fa, coarse_factor)
    cb = _avg_pool(fb, coarse_factor)
    coarse = _dtw_full(ca, cb)
    # project coarse path to full resolution -> allowed band
    ci = coarse[0] * coarse_factor
    cj = coarse[1] * coarse_factor
    anchor_j = np.interp(np.arange(n), ci, cj)
    lo = np.maximum(0, (anchor_j - band_radius).astype(np.int64))
    hi = np.minimum(m, (anchor_j + band_radius).astype(np.int64) + 1)
    lo[0] = 0  # (0,0) and (n-1, m-1) must be reachable
    hi[-1] = m
    kernel = _native_dtw()
    if kernel is not None:
        return kernel(fa, fb, lo, hi)
    mask = np.zeros((n, m), dtype=bool)
    for i in range(n):
        mask[i, lo[i]:hi[i]] = True
    return dtw_path_fast(_cost_matrix(fa, fb), mask)


def _avg_pool(f: np.ndarray, k: int) -> np.ndarray:
    t = f.shape[1]
    n = max(1, t // k)
    out = np.stack(
        [f[:, i * k: (i + 1) * k].mean(axis=1) for i in range(n)], axis=1
    )
    norms = np.linalg.norm(out, axis=0)
    return out / np.maximum(norms, 1e-9)


def make_path_strictly_monotonic(path: np.ndarray) -> np.ndarray:
    """Keep only steps that advance BOTH axes (synctoolbox semantics:
    resulting path is strictly increasing in both rows)."""
    if path.shape[1] == 0:
        return path
    keep = [0]
    for k in range(1, path.shape[1]):
        if (path[0, k] > path[0, keep[-1]]
                and path[1, k] > path[1, keep[-1]]):
            keep.append(k)
    return path[:, keep]


def align_features(
    song_audio: np.ndarray,
    midi_audio: np.ndarray,
    sr: int,
    feature_rate: int = 50,
) -> Tuple[np.ndarray, int]:
    """Full pipeline: features for both signals -> optimal chroma shift ->
    shifted DTW -> strictly monotonic warp path in SECONDS (2, L):
    wp[0]=song time, wp[1]=midi time (reference get_warp_path)."""
    tune_a = estimate_tuning(song_audio, sr) * 100
    tune_b = estimate_tuning(midi_audio, sr) * 100
    ca = chroma_features(song_audio, sr, feature_rate, tune_a)
    cb = chroma_features(midi_audio, sr, feature_rate, tune_b)
    shift = compute_optimal_chroma_shift(ca, cb, feature_rate)
    cb = shift_chroma(cb, shift)
    oa = onset_features(ca)
    ob = onset_features(cb)
    # combine chroma + onset (synctoolbox stacks both feature families)
    fa = np.concatenate([ca, oa]) / np.sqrt(2.0)
    fb = np.concatenate([cb, ob]) / np.sqrt(2.0)
    wp = multiscale_dtw(fa, fb)
    wp = make_path_strictly_monotonic(wp)
    return wp / feature_rate, shift
