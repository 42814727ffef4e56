"""Waveform I/O and resampling.

The port's own copy of ``music2midi_tpu/audio.py`` for WAV: RIFF/WAVE
reading (PCM 8/16/24/32 and float32/64), 16-bit writing, and polyphase
windowed-sinc resampling (scipy.signal.resample_poly, Kaiser beta 14.77).
Other containers (decoded through an ``ffmpeg`` subprocess in the JAX
package) are not supported here: pass a ``.wav``.
"""

from __future__ import annotations

import struct
from math import gcd
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
from scipy.signal import resample_poly


def read_wav(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """-> (samples (channels, n) float32 in [-1, 1], sample_rate)."""
    data = Path(path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    fmt_body = b""
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_body = body
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        # the real format code is the first 2 bytes of the SubFormat GUID
        # in the fmt extension (offset 24 = 16 base + cbSize(2) +
        # validbits(2) + channelmask(4))
        if len(fmt_body) >= 26:
            audio_format = struct.unpack("<H", fmt_body[24:26])[0]
        else:
            raise ValueError(
                f"{path}: extensible WAV without a SubFormat GUID"
            )
    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                 - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
        elif bits == 32:
            x = (np.frombuffer(raw, dtype="<i4").astype(np.float32)
                 / 2147483648.0)
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        dtype = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format code {audio_format}")
    return x.reshape(-1, channels).T.copy(), sample_rate


def write_wav(
    path: Union[str, Path], samples: np.ndarray, sample_rate: int
) -> None:
    """Write float32 (n,) or (channels, n) samples as 16-bit PCM."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[None]
    interleaved = np.clip(x.T, -1.0, 1.0)
    pcm = np.round(interleaved * 32767.0).astype("<i2").tobytes()
    channels = x.shape[0]
    byte_rate = sample_rate * channels * 2
    hdr = (
        b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
        + b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                                byte_rate, channels * 2, 16)
        + b"data" + struct.pack("<I", len(pcm))
    )
    Path(path).write_bytes(hdr + pcm)


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase windowed-sinc resampling along the last axis."""
    if orig_sr == target_sr:
        return np.asarray(x, dtype=np.float32)
    g = gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    y = resample_poly(x, up, down, axis=-1, window=("kaiser", 14.769656459))
    return y.astype(np.float32)


def load(
    path: Union[str, Path],
    sr: Optional[int] = 22050,
    offset: float = 0.0,
    duration: Optional[float] = None,
    mono: bool = True,
) -> Tuple[np.ndarray, int]:
    """librosa.load-compatible for WAV: -> (mono float32 waveform, sr).

    sr=None keeps the native rate.  offset/duration crop BEFORE resampling
    (like librosa), so window boundaries land on native-rate samples.
    """
    path = Path(path)
    if path.suffix.lower() != ".wav":
        raise ValueError(f"cannot decode {path.suffix}: provide a .wav")
    x, native_sr = read_wav(path)
    if offset or duration is not None:
        i0 = int(round(offset * native_sr))
        i1 = (
            x.shape[1] if duration is None
            else i0 + int(round(duration * native_sr))
        )
        x = x[:, i0:i1]
    if mono:
        x = x.mean(axis=0)
    if sr is not None and sr != native_sr:
        x = resample(x, native_sr, sr)
        native_sr = sr
    return x.astype(np.float32), native_sr
