"""The port's serving layer on the CPU: ``serve/batcher.py``,
``serve/webui_utils.py``, ``generate_batch(audio_paths=...)``'s prefetch
and the kernel build's lock.

Bars: the four cases of ``tests/test_batcher.py`` on the port's batcher
(concurrent requests equal individual ``generate``; requests coalesce; a
cancelled request does not kill the dispatcher; a bad request fails only
itself, and nothing is enqueued after ``close``); the port's batcher gives
the JAX batcher's notes on the same waveforms (model of record, fp32);
the dispatcher thread runs the engine with grad mode off and no tensor
requiring grad; ``generate_batch(audio_paths=...)`` equals
``generate_batch(waveforms=...)`` on the same loaded audio, in input
order with more paths than the look-ahead, and leaves no thread behind;
``webui_utils`` raises ``ToolMissingError`` without yt-dlp / ffmpeg and
``render_preview`` writes the JAX preview's WAV bytes; concurrent first
calls build the kernels once.
"""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from music2midi_tpu.infer import Music2MIDI as JaxMusic2MIDI
from music2midi_tpu.serve.batcher import DynamicBatcher as JaxBatcher
from music2midi_tpu.serve import webui_utils as jax_webui_utils
from music2midi_tpu.utils import numpy_to_midi as jax_numpy_to_midi
from music2midi_tpu_torch.audio import load, resample, write_wav
from music2midi_tpu_torch.calibration import render_fixture
from music2midi_tpu_torch.infer import Music2MIDI
from music2midi_tpu_torch.ops import _build
from music2midi_tpu_torch.serve import webui_utils
from music2midi_tpu_torch.serve.batcher import DynamicBatcher
from music2midi_tpu_torch.utils import numpy_to_midi

RECORD = Path(__file__).resolve().parent.parent / "checkpoints" \
    / "model_of_record.npz"


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads per parallel test worker (see
    test_torch_pipeline.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def engine():
    return Music2MIDI.from_random(seed=0, decode_max_length=16, device="cpu")


@pytest.fixture(scope="module")
def record():
    # the fixture's rows end by step 43 (test_torch_pipeline.py): a cap of
    # 64 changes no token and spares the JAX side its larger cache phases
    return Music2MIDI.from_npz(RECORD, device="cpu", decode_max_length=64)


@pytest.fixture(scope="module")
def fixture_halves():
    wav, sr = render_fixture()
    y = resample(wav, sr, 16000)
    return [y[:6 * 16000], y[6 * 16000:]]


def _notes(m):
    return [(n.start, n.end, n.pitch, n.velocity) for i in m.instruments
            for n in i.notes]


def test_concurrent_requests_match_individual(engine):
    rng = np.random.default_rng(0)
    songs = [(rng.normal(size=4 * 16000) * 0.2).astype(np.float32)
             for _ in range(3)]
    individual = [engine.generate(audio_y=s) for s in songs]
    batcher = DynamicBatcher(engine, max_wait_ms=200.0)
    try:
        futures = [batcher.submit(waveform=s) for s in songs]
        results = [f.result(timeout=120) for f in futures]
    finally:
        batcher.close()
    for a, b in zip(individual, results):
        assert _notes(a) == _notes(b)


def test_requests_coalesce_into_one_batch(engine, monkeypatch):
    calls = []
    orig = engine.generate_batch

    def spy(waveforms, cond_indices=None, **kw):
        calls.append(len(waveforms))
        return orig(waveforms, cond_indices=cond_indices, **kw)

    monkeypatch.setattr(engine, "generate_batch", spy)
    batcher = DynamicBatcher(engine, max_wait_ms=300.0)
    try:
        rng = np.random.default_rng(1)
        songs = [(rng.normal(size=int(3.5 * 16000)) * 0.2).astype(np.float32)
                 for _ in range(3)]
        futs = []
        barrier = threading.Barrier(3)

        def go(s):
            barrier.wait()
            futs.append(batcher.submit(waveform=s))

        threads = [threading.Thread(target=go, args=(s,)) for s in songs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for f in list(futs):
            f.result(timeout=120)
        assert calls and max(calls) >= 2, calls
    finally:
        batcher.close()


def test_cancelled_request_does_not_kill_dispatcher(engine):
    batcher = DynamicBatcher(engine, max_wait_ms=400.0)
    try:
        rng = np.random.default_rng(3)
        doomed = batcher.submit(
            waveform=(rng.normal(size=16000) * 0.2).astype(np.float32))
        cancelled = doomed.cancel()
        survivor = batcher.submit(
            waveform=(rng.normal(size=16000) * 0.2).astype(np.float32))
        assert survivor.result(timeout=120) is not None
        if cancelled:
            assert doomed.cancelled()
    finally:
        batcher.close()


def test_bad_request_does_not_kill_good_ones(engine):
    batcher = DynamicBatcher(engine, max_wait_ms=200.0)
    try:
        rng = np.random.default_rng(2)
        good = batcher.submit(
            waveform=(rng.normal(size=16000) * 0.2).astype(np.float32))
        bad = batcher.submit(audio_path="/nonexistent/file.wav")
        with pytest.raises(FileNotFoundError):
            bad.result(timeout=120)
        assert good.result(timeout=120) is not None
        later = batcher.submit(
            waveform=(rng.normal(size=16000) * 0.2).astype(np.float32))
        assert later.result(timeout=120) is not None
    finally:
        batcher.close()
    with pytest.raises(RuntimeError):
        batcher.submit(waveform=np.zeros(16000, np.float32))


def test_batch_exception_fails_only_that_batch(engine, monkeypatch):
    orig = engine.generate_batch
    state = {"fail": True}

    def flaky(waveforms, cond_indices=None, **kw):
        if state.pop("fail", False):
            raise RuntimeError("device lost")
        return orig(waveforms, cond_indices=cond_indices, **kw)

    monkeypatch.setattr(engine, "generate_batch", flaky)
    batcher = DynamicBatcher(engine, max_wait_ms=300.0)
    try:
        wave = np.zeros(16000, np.float32)
        first = [batcher.submit(waveform=wave) for _ in range(2)]
        for f in first:
            with pytest.raises(RuntimeError, match="device lost"):
                f.result(timeout=120)
        assert batcher.submit(waveform=wave).result(timeout=120) is not None
    finally:
        batcher.close()


def test_batcher_notes_equal_jax_batcher_fp32(record, fixture_halves):
    ref = JaxMusic2MIDI.from_npz(RECORD, use_compilation_cache=False,
                                 decode_max_length=64)
    results = []
    for make, eng in ((DynamicBatcher, record), (JaxBatcher, ref)):
        # both songs ride one generate_batch in each package
        batcher = make(eng, max_batch_songs=2, max_wait_ms=5000.0)
        try:
            futs = [batcher.submit(waveform=w) for w in fixture_halves]
            results.append([f.result(timeout=300) for f in futs])
        finally:
            batcher.close()
    got, want = results
    assert sum(len(_notes(m)) for m in got) > 0
    for g, w in zip(got, want):
        assert _notes(g) == _notes(w)


def test_dispatcher_runs_without_grad(engine, monkeypatch):
    seen = []
    orig = engine._decode

    def spy(encoder_hidden, generator=None):
        tokens, lengths = orig(encoder_hidden, generator)
        seen.append((torch.is_grad_enabled(), encoder_hidden.requires_grad,
                     tokens.requires_grad, threading.current_thread().name))
        return tokens, lengths

    monkeypatch.setattr(engine, "_decode", spy)
    batcher = DynamicBatcher(engine)
    try:
        batcher.submit(waveform=np.zeros(16000, np.float32)).result(
            timeout=120)
    finally:
        batcher.close()
    ((grad_on, enc_grad, tok_grad, thread),) = seen
    assert thread != threading.main_thread().name
    assert not (grad_on or enc_grad or tok_grad)


def _song(k: int) -> np.ndarray:
    """Song k: a few synthesized notes around pitch 55 + 2k, 1.5-4 s."""
    notes = np.array([[0.2 + 0.5 * j, 0.6 + 0.5 * j, 55 + 2 * k + j % 3, 90]
                      for j in range(2 + k % 4)], float)
    return numpy_to_midi(notes).synthesize(fs=16000) * 0.8


def _call_threads() -> int:
    """Live threads other than the engines' persistent staging pools (made
    at an engine's first ``generate_batch``, ended when it is collected):
    a call's own threads must all end before it returns."""
    return sum(not t.name.startswith("m2m-stage")
               for t in threading.enumerate())


def test_audio_paths_prefetch_equals_waveforms_in_order(record, tmp_path):
    paths = []
    for k in range(10):  # more songs than the look-ahead of 8
        paths.append(tmp_path / f"song{k}.wav")
        write_wav(paths[-1], _song(k), 16000)
    waves = [load(p, sr=16000)[0] for p in paths]
    conds = [[k % 6, k % 3] for k in range(10)]
    before = _call_threads()
    by_path = record.generate_batch(audio_paths=paths, cond_indices=conds)
    assert _call_threads() == before
    by_wave = record.generate_batch(waves, cond_indices=conds)
    assert [_notes(m) for m in by_path] == [_notes(m) for m in by_wave]
    assert len({tuple(_notes(m)) for m in by_path}) > 5  # songs differ
    with pytest.raises(FileNotFoundError):
        record.generate_batch(audio_paths=paths[:3] + [tmp_path / "no.wav"])
    assert _call_threads() == before


def test_webui_utils_tools_missing(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setitem(sys.modules, "yt_dlp", None)  # blocks the import
    assert not webui_utils.ffmpeg_available()
    assert not webui_utils.video_stream_present(tmp_path / "x.mp4")
    with pytest.raises(webui_utils.ToolMissingError, match="yt-dlp"):
        webui_utils.download_video("https://example.invalid/v",
                                   tmp_path / "v.mp4")
    with pytest.raises(webui_utils.ToolMissingError, match="ffmpeg"):
        webui_utils.post_process(tmp_path / "v.mp4", tmp_path / "a.wav")
    assert issubclass(webui_utils.ToolMissingError, RuntimeError)


def test_render_preview_writes_jax_bytes(tmp_path):
    rng = np.random.default_rng(4)
    onset = np.sort(rng.uniform(0, 4, 12))
    notes = np.stack([onset, onset + rng.uniform(0.1, 1.0, 12),
                      rng.integers(40, 90, 12), rng.integers(30, 127, 12)], 1)
    webui_utils.render_preview(numpy_to_midi(notes), tmp_path / "port.wav",
                               fs=16000)
    jax_webui_utils.render_preview(jax_numpy_to_midi(notes),
                                   tmp_path / "jax.wav", fs=16000)
    data = (tmp_path / "port.wav").read_bytes()
    assert data[:4] == b"RIFF"
    assert data == (tmp_path / "jax.wav").read_bytes()


def test_concurrent_first_calls_build_once(monkeypatch):
    """The dispatcher thread may launch first in a cold process: many
    threads asking for the kernels at once build them once."""
    monkeypatch.setattr(_build, "_info", None)
    calls = []

    def fake_build():
        calls.append(threading.current_thread().name)
        threading.Event().wait(0.05)
        _build._info = _build.BuildInfo(Path("lib.so"), 0.05, False, "")
        return _build._info

    monkeypatch.setattr(_build, "_build", fake_build)
    got = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: got.append(_build.build()))
                   for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert len(calls) == 1 and len(got) == 32
    assert all(info is got[0] for info in got)
