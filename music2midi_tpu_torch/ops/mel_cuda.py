"""The fused log-mel kernels for Hopper: wrappers, tables and launch counts.

``log_mel_spectrogram_cuda`` replaces
``music2midi_tpu/ops/mel_pallas.py::log_mel_spectrogram_pallas_fft`` (the
TPU's serving mel) with the FFT kernel of ``csrc/mel_fft.cu``;
``log_mel_spectrogram_dft_cuda`` replaces
``music2midi_tpu/ops/mel_pallas.py::log_mel_spectrogram_pallas`` (the TPU's
direct-DFT mel, on no serving path) with the kernel of ``csrc/mel_dft.cu``.
Both are built by ``ops/_build.py`` at first use; their plain PyTorch
version is ``ops/mel.py::log_mel_spectrogram``, and ``chip_smoke.py``
holds each kernel against it on the card.

Bound of the FFT kernel on the H100 at the serving shape (64 x 48000 wave
-> 64 x 188 x 384):
bytes are 64*48000*4 read + 64*188*384*4 written = 30.8 MB, ~9 us at
3.35 TB/s; operations are the real FFT's 2.5 N log2 N = 56 k fp32 flops
per frame plus the window, the power and the mel triangles, 65.5 k a
frame and 0.79 GFLOP in all, ~12 us at the 67 TFLOP/s fp32 rate
(``chip_smoke.py::mel_bound``).  So the kernel is bound by operations,
though only just, and its design keeps every
intermediate (frames, spectrum, power) in shared memory so that the bytes
stay at the minimum.  The direct-DFT kernel does the same function with
some 130x the operations, as a 3xTF32 tensor-core matrix product
(``csrc/mel_dft.cu``).  Measured times are in
PERF.md.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .mel import (
    LogMelConfig,
    apply_noise_floor,
    filterbank_for,
    hann_window,
    log_mel_spectrogram,
    num_frames,
)

_SMEM_LIMIT = 232448  # bytes of shared memory a block can use (H100)
_MAX_N_FFT = 4096  # the largest of csrc/mel_fft.cu's instances
_FFT_FRAMES = 8  # frames a CTA of csrc/mel_fft.cu


def fft_smem_bytes(cfg: LogMelConfig) -> int:
    """Shared memory of one CTA of ``csrc/mel_fft.cu`` (its
    ``mel_fft_smem_floats``): the twiddles (n_fft / 2 and R1 x 32
    complex, R1 = n_fft / 64), the window, the samples of 8 frames and an
    R1 x 33 complex buffer a frame."""
    n_fft = cfg.n_fft
    r1 = n_fft // 64
    span = -(-((_FFT_FRAMES - 1) * cfg.hop_length + n_fft) // 4) * 4
    return 4 * (n_fft + 2 * r1 * 32 + n_fft + span
                + _FFT_FRAMES * 2 * r1 * 33)


def check_shape(n_samples: int, cfg: LogMelConfig) -> None:
    """The TPU kernel's guard (256 | n_fft, 128 | hop) plus this kernel's
    own: a power-of-two n_fft up to 4096 (one instance of the kernel
    each), a tile of 8 frames that fits in shared memory, and a wave
    longer than the reflect pad."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    if n_fft % 256 != 0 or hop % 128 != 0:
        raise ValueError("mel kernel requires 256 | n_fft and 128 | hop")
    if n_fft & (n_fft - 1) or n_fft > _MAX_N_FFT:
        raise ValueError(
            f"mel kernel requires a power-of-two n_fft <= {_MAX_N_FFT}"
        )
    if fft_smem_bytes(cfg) > _SMEM_LIMIT:
        raise ValueError(f"mel kernel: 8 frames at hop {hop} need "
                         f"{fft_smem_bytes(cfg)} bytes of shared memory, "
                         f"over {_SMEM_LIMIT}")
    if n_samples <= n_fft // 2:
        raise ValueError(
            f"reflect pad of {n_fft // 2} needs more than {n_samples} samples"
        )


@functools.lru_cache(maxsize=8)
def _tables(cfg: LogMelConfig, device: torch.device) -> tuple:
    """Device tables: Hann window, (cos, sin) twiddles, and each mel bin's
    nonzero span [lo, hi) with its weights, from the float32 filterbank
    the plain version multiplies by."""
    n_fft = cfg.n_fft
    k = np.arange(n_fft // 2, dtype=np.float64)
    ang = 2.0 * np.pi * k / n_fft
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    fb = filterbank_for(cfg)  # (n_freqs, n_mels)
    lo = np.zeros(cfg.n_mels, np.int32)
    hi = np.zeros(cfg.n_mels, np.int32)
    off = np.zeros(cfg.n_mels, np.int32)
    weights = []
    pos = 0
    for m in range(cfg.n_mels):
        nz = np.nonzero(fb[:, m])[0]
        if len(nz):
            lo[m], hi[m] = nz[0], nz[-1] + 1
        off[m] = pos
        weights.append(fb[lo[m]:hi[m], m])
        pos += hi[m] - lo[m]
    wts = np.concatenate(weights + [np.zeros(1, np.float32)])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (dev(hann_window(n_fft)), dev(tw), dev(lo), dev(hi), dev(off),
            dev(wts))


@functools.lru_cache(maxsize=8)
def _fft_twiddles(cfg: LogMelConfig, device: torch.device) -> torch.Tensor:
    """(R1, 32, 2) float32 on the device, R1 = n_fft / 64: [k1][m2] the
    (cos, sin) of 2 pi m2 k1 / (n_fft / 2), the twiddles between the two
    passes (R1 and 32 points) of the kernel's n_fft / 2 point FFT, from
    float64 (the angle reduced modulo the period first)."""
    k1, m2 = np.meshgrid(np.arange(cfg.n_fft // 64), np.arange(32),
                         indexing="ij")
    ang = 2.0 * np.pi * ((2 * m2 * k1) % cfg.n_fft) / cfg.n_fft
    tw2 = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(tw2)).to(device)


def mel_nnz(cfg: LogMelConfig) -> int:
    """Nonzero filterbank weights: the multiply-adds of the mel step."""
    return int(np.count_nonzero(filterbank_for(cfg)))


def log_mel_spectrogram_cuda(
    wave: torch.Tensor, cfg: LogMelConfig = LogMelConfig()
) -> torch.Tensor:
    """(B, S) float32 CUDA wave -> (B, F, n_mels) float32 log-mel, one
    launch of the fused kernel on the current stream."""
    if wave.device.type != "cuda":
        raise ValueError(f"mel kernel needs a CUDA tensor, got {wave.device}")
    if wave.dtype != torch.float32:
        raise ValueError(f"mel kernel needs float32, got {wave.dtype}")
    if wave.dim() != 2:
        raise ValueError(f"mel kernel needs (B, S), got {tuple(wave.shape)}")
    if not wave.is_contiguous():
        raise ValueError("mel kernel needs a contiguous wave")
    B, S = wave.shape
    check_shape(S, cfg)
    F = num_frames(S, cfg)
    out = torch.empty((B, F, cfg.n_mels), dtype=torch.float32,
                      device=wave.device)
    if B == 0:
        return out
    hann, tw, lo, hi, off, wts = _tables(cfg, wave.device)
    tw2 = _fft_twiddles(cfg, wave.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(wave.device).cuda_stream
    status = lib.m2m_log_mel_fft(
        wave.data_ptr(), out.data_ptr(), hann.data_ptr(), tw.data_ptr(),
        tw2.data_ptr(), lo.data_ptr(), hi.data_ptr(), off.data_ptr(),
        wts.data_ptr(),
        B, S, F, cfg.n_fft, cfg.hop_length, cfg.n_mels,
        float(cfg.log_floor), stream,
    )
    _build.check(status, "m2m_log_mel_fft")
    log_mel_spectrogram_cuda.launches += 1
    return out


log_mel_spectrogram_cuda.launches = 0


def dft_smem_bytes(cfg: LogMelConfig) -> int:
    """Shared memory of one block of ``csrc/mel_dft.cu`` (its
    ``dft_smem_words``): a ring of two 64 KB basis stages (one of which
    holds the power tile at a chunk's end), the wave segment of 64 frames
    with 4 pad words every 256, the window and two words a frame."""
    def skew(n):
        return n + 4 * (n >> 8)

    seg = -(-skew(63 * cfg.hop_length + cfg.n_fft + 1) // 4) * 4
    words = 2 * 16384 + seg + cfg.n_fft + 2 * 64
    return 4 * words


def check_shape_dft(n_samples: int, cfg: LogMelConfig) -> None:
    """The TPU kernel's guard (hop | n_fft) plus this kernel's own: 8 | hop
    (16-byte frame reads), a power-of-two n_fft from 256 to 2048 (bins in
    chunks of 128), a frame tile that fits in shared memory, and a wave
    longer than the reflect pad."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    if n_fft % hop != 0 or hop % 8 != 0:
        raise ValueError("direct-DFT mel kernel requires hop | n_fft and "
                         "8 | hop")
    if n_fft & (n_fft - 1) or not 256 <= n_fft <= 2048:
        raise ValueError("direct-DFT mel kernel requires a power-of-two "
                         "n_fft from 256 to 2048")
    if dft_smem_bytes(cfg) > _SMEM_LIMIT:
        raise ValueError(f"direct-DFT mel kernel: a 64-frame tile at hop "
                         f"{hop} needs {dft_smem_bytes(cfg)} bytes of shared "
                         f"memory, over {_SMEM_LIMIT}")
    if n_samples <= n_fft // 2:
        raise ValueError(
            f"reflect pad of {n_fft // 2} needs more than {n_samples} samples"
        )


_DFT_CHUNK = 128  # bins per chunk of the kernel
_DFT_STAGE = 32  # K rows per stage of the kernel


def _tf32_rna(x: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32 (10 mantissa bits), ties away from zero:
    ``cvt.rna.tf32.f32``."""
    u = x.astype(np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_tables(cfg: LogMelConfig, device: torch.device) -> tuple:
    """The DFT kernel's basis and chunk table on the device.

    basis: the periodic Hann window times cos and sin of 2 pi n k / n_fft
    for n, k < n_fft / 2, each computed in float64 (the angle from
    (n k) mod n_fft), rounded once to float32 and split into a TF32 high
    part and a TF32 low part (the kernel's 3xTF32),
    laid out as the kernel's stages: for each chunk of 128 bins and stage
    of 32 rows n, [cos|sin][hi|lo] tiles of 8 x 4 core matrices
    [n / 4][k / 8][k % 8][n % 4] (wgmma's K-major operand), each stage one
    contiguous 64 KB.  chunk_mels: (n_chunks, 2) int32, the range of mel
    bins whose triangle meets each chunk's bins (the last chunk also holds
    the Nyquist bin n_fft / 2)."""
    n_fft = cfg.n_fft
    K = n_fft // 2
    n_chunks, n_stages = K // _DFT_CHUNK, K // _DFT_STAGE
    n = np.arange(K, dtype=np.int64)
    ang = 2.0 * np.pi * ((n[:, None] * n[None, :]) % n_fft) / n_fft
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)  # periodic, float64
    # each stage's 32 rows n in the kernel's order: row L of a stage (core
    # matrix L / 4, column L % 4) holds n = 8 (L % 4) + 2 (L / 8) + (L / 4) % 2
    L = np.arange(_DFT_STAGE)
    order = (8 * (L % 4) + 2 * (L // 8) + (L // 4) % 2)
    rows = (np.arange(n_stages)[:, None] * _DFT_STAGE + order[None]).reshape(-1)
    ang, hann = ang[rows], hann[rows]
    tiles = []
    for trig in (np.cos, np.sin):
        x = (hann[:, None] * trig(ang)).astype(np.float32)  # [row][k]
        hi = _tf32_rna(x)
        lo = _tf32_rna(x - hi)
        tiles.append(np.stack([hi, lo]))  # [hi|lo][n][k]
    t = np.stack(tiles)  # [kind][hl][n][k]
    t = t.reshape(2, 2, n_stages, _DFT_STAGE // 4, 4, n_chunks, 16, 8)
    # -> [chunk][stage][kind][hl][n / 4][k / 8][k % 8][n % 4]
    basis = t.transpose(5, 2, 0, 1, 3, 6, 7, 4)
    _, _, lo, hi, _, _ = _tables(cfg, torch.device("cpu"))
    lo, hi = lo.numpy(), hi.numpy()
    chunk_mels = np.zeros((n_chunks, 2), np.int32)
    for c in range(n_chunks):
        c0, c1 = c * _DFT_CHUNK, (c + 1) * _DFT_CHUNK + (c == n_chunks - 1)
        meet = np.nonzero((lo < c1) & (hi > c0) & (hi > lo))[0]
        if len(meet):
            chunk_mels[c] = meet[0], meet[-1] + 1
    return (torch.from_numpy(np.ascontiguousarray(basis)).to(device),
            torch.from_numpy(chunk_mels).to(device))


def log_mel_spectrogram_dft_cuda(
    wave: torch.Tensor, cfg: LogMelConfig = LogMelConfig()
) -> torch.Tensor:
    """(B, S) float32 wave -> (B, F, n_mels) float32 log-mel as a direct
    DFT: one launch of the kernel on the current stream for a CUDA tensor,
    the plain version for a CPU tensor.  The shape guard runs first, on
    either device."""
    if wave.dim() != 2:
        raise ValueError(f"mel kernel needs (B, S), got {tuple(wave.shape)}")
    B, S = wave.shape
    check_shape_dft(S, cfg)
    if wave.device.type != "cuda":
        return log_mel_spectrogram(wave, cfg)
    wave = wave.to(torch.float32).contiguous()
    F = num_frames(S, cfg)
    out = torch.empty((B, F, cfg.n_mels), dtype=torch.float32,
                      device=wave.device)
    if B == 0:
        return out
    hann, _, lo, hi, off, wts = _tables(cfg, wave.device)
    basis, chunk_mels = _dft_tables(cfg, wave.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(wave.device).cuda_stream
    status = lib.m2m_log_mel_dft(
        wave.data_ptr(), out.data_ptr(), hann.data_ptr(), basis.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), off.data_ptr(), wts.data_ptr(),
        chunk_mels.data_ptr(), B, S, F, cfg.n_fft, cfg.hop_length,
        cfg.n_mels, float(cfg.log_floor), stream,
    )
    _build.check(status, "m2m_log_mel_dft")
    log_mel_spectrogram_dft_cuda.launches += 1
    return apply_noise_floor(out, cfg)


log_mel_spectrogram_dft_cuda.launches = 0
