"""Serving helpers: video download, A/V post-processing, preview synthesis.

The port's own copy of ``music2midi_tpu/serve/webui_utils.py``.  FFmpeg /
yt-dlp / FluidSynth are optional: every entry point checks availability
and raises a clear ToolMissingError naming what to install; the WAV-only
path (synthesized piano preview) works with zero external tools.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..audio import write_wav
from ..midi import MidiFile


class ToolMissingError(RuntimeError):
    pass


def _require(binary: str) -> None:
    if shutil.which(binary) is None:
        raise ToolMissingError(
            f"'{binary}' is required for this operation but is not "
            f"installed on this host"
        )


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def video_stream_present(file_path: Path) -> bool:
    """True if the file has a video stream (reference webui_utils.py:78-96);
    False when ffmpeg is unavailable (audio-only handling)."""
    if not ffmpeg_available():
        return False
    return not subprocess.call(
        [
            "ffmpeg", "-loglevel", "panic", "-i", str(file_path),
            "-map", "v", "-vframes", "1", "-c", "copy", "-f", "null", "-",
        ]
    )


def post_process(video_path: Path, audio_path: Path) -> None:
    """Merge the piano audio into the video container and re-split so the
    two streams share a duration and stay in sync during playback
    (reference webui_utils.py:9-63)."""
    _require("ffmpeg")
    output_dir = video_path.parent / "post-processed"
    output_dir.mkdir(exist_ok=True)
    merged = output_dir / "merged.mp4"
    out_video = output_dir / video_path.name
    out_audio = output_dir / audio_path.name
    subprocess.run(
        [
            "ffmpeg", "-loglevel", "error", "-i", str(video_path),
            "-i", str(audio_path), "-map", "0", "-map", "1", "-c", "copy",
            str(merged), "-y",
        ],
        check=True,
    )
    video_args = ["-map", "0:v"] if video_stream_present(merged) else []
    subprocess.run(
        ["ffmpeg", "-loglevel", "error", "-i", str(merged)]
        + video_args
        + [
            "-map", "0:a:0", "-c", "copy", str(out_video), "-y",
            "-map", "0:a:1", str(out_audio), "-y",
        ],
        check=True,
    )
    out_video.replace(video_path)
    out_audio.replace(audio_path)
    shutil.rmtree(output_dir)


def download_video(url: str, video_path: Path) -> None:
    """yt-dlp download at <=720p into an mp4 (reference
    webui_utils.py:66-75)."""
    try:
        import yt_dlp
    except ImportError as e:
        raise ToolMissingError("yt-dlp is required to download videos") from e
    _require("ffmpeg")
    ydl_opts = {
        "format_sort": ["res:720"],
        "merge_output_format": "mp4",
        "noprogress": True,
        "outtmpl": {"default": str(video_path)},
        "quiet": True,
    }
    with yt_dlp.YoutubeDL(ydl_opts) as ydl:
        ydl.download(url)


def render_preview(midi: MidiFile, audio_path: Path, fs: int = 48000) -> None:
    """Synthesize the MIDI to an audio preview.  Uses FluidSynth when the
    python binding + a soundfont are available (reference webui.py:65-67),
    else the built-in additive synthesizer -> 16-bit WAV."""
    try:
        import fluidsynth  # noqa: F401  (rarely present; keep the hook)

        raise ImportError  # no soundfont management here yet: use builtin
    except ImportError:
        y = midi.synthesize(fs=fs)
    write_wav(audio_path, np.asarray(y, dtype=np.float32), fs)
