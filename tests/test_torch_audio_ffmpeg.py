"""The port's ``audio.load`` / ``get_duration`` for files that are not WAV,
through an ``ffmpeg`` subprocess, against the JAX package's.

A fake ``ffmpeg`` on ``PATH`` (a Python script in ``tmp_path``) logs its
argv and writes known float32 samples at the rate it is asked for.  Bars:
both packages give the same array (exactly), the same rate and the same
argv, with and without ``offset`` / ``duration``; with ``PATH`` cleared
both raise the same ``ValueError`` from ``load`` and the same exception
from ``get_duration``; a WAV never starts the subprocess.
"""

import json
import sys

import numpy as np
import pytest

from music2midi_tpu import audio as jax_audio
from music2midi_tpu_torch import audio as port_audio

SECONDS = 2.5

_FAKE = r'''#!{python}
import json, sys
import numpy as np
argv = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(json.dumps(argv) + "\n")
rate = int(argv[argv.index("-ar") + 1])
t = np.arange(int({seconds} * rate)) / rate
y = (0.5 * np.sin(2 * np.pi * 440.0 * t) + 0.1 * np.cos(t)).astype("<f4")
sys.stdout.buffer.write(y.tobytes())
'''


@pytest.fixture
def fake_ffmpeg(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "argv.log"
    script = bin_dir / "ffmpeg"
    script.write_text(_FAKE.format(python=sys.executable, log=str(log),
                                   seconds=SECONDS))
    script.chmod(0o755)
    monkeypatch.setenv("PATH", str(bin_dir))
    song = tmp_path / "song.mp3"
    song.write_bytes(b"ID3 not really an mp3")
    return song, log


def _argv(log):
    lines = log.read_text().splitlines()
    log.write_text("")
    return [json.loads(line) for line in lines]


@pytest.mark.parametrize("kw", [
    {"sr": 16000},
    {"sr": 22050, "offset": 0.5},
    {"sr": 16000, "offset": 0.25, "duration": 1.0},
    {"sr": None, "duration": 2.0},
    {"sr": 16000, "mono": False},
])
def test_load_through_ffmpeg_equals_jax(fake_ffmpeg, kw):
    song, log = fake_ffmpeg
    got, got_sr = port_audio.load(song, **kw)
    port_argv = _argv(log)
    want, want_sr = jax_audio.load(song, **kw)
    assert port_argv == _argv(log)
    assert got_sr == want_sr == (kw["sr"] or 44100)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert port_argv[0][-3:] == ["-ar", str(got_sr), "-"]
    n = int(SECONDS * got_sr) - int(round(kw.get("offset", 0.0) * got_sr))
    if "duration" in kw:
        n = int(round(kw["duration"] * got_sr))
    assert got.shape[-1] == n


def test_get_duration_through_ffmpeg_equals_jax(fake_ffmpeg):
    song, log = fake_ffmpeg
    got = port_audio.get_duration(song)
    port_argv = _argv(log)
    assert got == jax_audio.get_duration(song) == SECONDS
    assert port_argv == _argv(log)


def test_wav_never_starts_ffmpeg(fake_ffmpeg, tmp_path):
    _, log = fake_ffmpeg
    wave = np.sin(np.arange(8000) / 10.0).astype(np.float32) * 0.5
    port_audio.write_wav(tmp_path / "a.wav", wave, 8000)
    got, sr = port_audio.load(tmp_path / "a.wav", sr=16000)
    want, _ = jax_audio.load(tmp_path / "a.wav", sr=16000)
    np.testing.assert_array_equal(got, want)
    assert sr == 16000 and not log.exists()


def test_without_ffmpeg_both_raise_alike(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    song = tmp_path / "song.mp4"
    song.write_bytes(b"\0" * 64)
    errors = []
    for mod in (port_audio, jax_audio):
        with pytest.raises(ValueError) as e:
            mod.load(song, sr=16000)
        errors.append(str(e.value))
    assert errors[0] == errors[1] == \
        "cannot decode .mp4 without ffmpeg; provide a .wav"
    kinds = []
    for mod in (port_audio, jax_audio):
        with pytest.raises(OSError) as e:
            mod.get_duration(song)
        kinds.append(type(e.value))
    assert kinds[0] is kinds[1]
