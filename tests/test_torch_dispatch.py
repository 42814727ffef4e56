"""``generate_batch``'s dispatcher and staged upload (CPU).

The calling thread stages each batch (stack, zero-pad, transport-encode,
in row slices on the engine's 2-thread pool) into one of two buffers while
one card thread of the call uploads, runs and detokenizes the batch
before.  Bars:
  * the MIDI files byte-equal to the serial per-batch path (the parent
    commit's ``generate_batch``, reproduced below on the engine's own
    ``_run_batch``) and to the JAX engine's ``generate_batch``, in fp32 and
    in bf16 (int16 transport), with batches that cross songs and pad to
    their bucket: on small random weights (whose tokens form no notes) and
    on the model of record with piano figures (many notes, 64-token cap);
  * one thread, not the caller's, runs every batch, its upload and its
    sampling generator; staging batch k + 1 happens while batch k runs;
  * an exception in batch k reaches the caller, and the engine serves the
    next call; two threads' calls on one engine take turns;
  * no thread of a call outlives it, and the staging pool's threads end
    when the engine is collected;
  * batch k draws from ``_sample_rng(k)``: each batch's tokens equal to
    the serial path's with the same generators, twice, and another seed
    draws others.
"""

import gc
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from music2midi_tpu.config import default_config as jax_default_config
from music2midi_tpu.infer import Music2MIDI as JaxMusic2MIDI
from music2midi_tpu_torch.config import default_config
from music2midi_tpu_torch.infer import Music2MIDI
from music2midi_tpu_torch.infer.pipeline import _bucket
from music2midi_tpu_torch.ops.detokenize import detokenize_to_host
from music2midi_tpu_torch.utils import numpy_to_midi

RECORD = Path(__file__).resolve().parent.parent / "checkpoints" \
    / "model_of_record.npz"

SMALL = {"num_layers": 2, "num_decoder_layers": 2, "d_model": 64,
         "d_ff": 96}
SR = 16000
BATCH = 8  # >= 2 x 4 row slices: the staging pool splits every batch
# 5 + 9 + 4 + 2 = 20 chunks: batches of 8, 8 and 4 (bucket 8)
SECONDS = (14.0, 26.0, 11.0, 5.0)
CONDS = ([0, 0], [3, 1], [5, 2], [1, 0])


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads per parallel test worker (see
    test_torch_pipeline.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _small(cfg):
    for k, v in SMALL.items():
        cfg.model.t5[k] = v
    cfg.inference.batch_size = BATCH
    return cfg


def _engine(dtype=torch.float32):
    return Music2MIDI.from_random(_small(default_config()), seed=2,
                                  device="cpu", decode_max_length=24,
                                  dtype=dtype)


@pytest.fixture(scope="module")
def songs():
    rng = np.random.default_rng(5)
    return [(rng.normal(size=int(s * SR)) * 0.1).astype(np.float32)
            for s in SECONDS]


def _bytes(midis, tmp_path, tag):
    out = []
    for i, m in enumerate(midis):
        m.write(tmp_path / f"{tag}{i}.mid")
        out.append((tmp_path / f"{tag}{i}.mid").read_bytes())
    return out


def _serial(engine, waves, conds):
    """The parent commit's ``generate_batch``: every batch stacked, padded,
    run and detokenized on the calling thread, in order."""
    max_bs = int(engine.config.inference.batch_size)
    n_cond = engine.num_conditioning
    per_chunk, spans, rows, cs, idx = [], [], [], [], []
    engine.last_decode_stats = []

    def dispatch():
        n = len(rows)
        b = _bucket(n, max_bs)
        batch = np.zeros((b, rows[0].shape[0]), np.float32)
        batch[:n] = np.stack(rows)
        cond = np.zeros((b, n_cond), np.int64)
        cond[:n] = np.stack(cs)
        rng = engine._sample_rng(len(engine.last_decode_stats))
        tokens = engine._run_batch(batch, cond, n, rng)
        start = torch.as_tensor(idx) * engine._n_steps()
        per_chunk.extend(detokenize_to_host(tokens, start,
                                            engine.tokenizer.time_step))
        rows.clear(), cs.clear(), idx.clear()

    total = 0
    for wave, cond in zip(waves, conds):
        chunks = engine._chunk_waveform(wave)
        spans.append((total, total + len(chunks)))
        total += len(chunks)
        for k, row in enumerate(chunks):
            rows.append(row)
            cs.append(np.asarray(cond, np.int64))
            idx.append(k)
            if len(rows) == max_bs:
                dispatch()
    if rows:
        dispatch()
    return [numpy_to_midi(np.concatenate(per_chunk[s:e]) if e > s
                          else np.zeros((0, 4))) for s, e in spans]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatcher_bytes_equal_serial_and_jax(songs, tmp_path, dtype):
    engine = _engine(getattr(torch, dtype))
    got = _bytes(engine.generate_batch(songs, cond_indices=CONDS), tmp_path,
                 "got")
    stats = engine.last_decode_stats
    assert [s["real_rows"] for s in stats] == [8, 8, 4]
    assert [s["batch_width"] for s in stats] == [8, 8, 8]
    serial = _bytes(_serial(engine, songs, CONDS), tmp_path, "serial")
    assert got == serial
    assert engine.last_decode_stats == stats
    if dtype == "float32":  # the JAX engine's fp32 parity mode
        ref = JaxMusic2MIDI.from_random(_small(jax_default_config()), seed=2,
                                        decode_max_length=24,
                                        use_compilation_cache=False)
        want = _bytes(ref.generate_batch(songs, cond_indices=CONDS),
                      tmp_path, "jax")
        assert got == want
        assert stats == ref.last_decode_stats


def _piano_figure(seconds, seed):
    """Chords and melody notes through the port's synthesizer, at 16 kHz
    (``test_torch_batch.py``'s figure)."""
    rng = np.random.default_rng(seed)
    notes, t = [], 0.0
    while t < seconds - 0.5:
        for p in rng.choice(np.arange(55, 80), size=rng.integers(1, 3),
                            replace=False):
            notes.append([t, t + float(rng.uniform(0.3, 0.9)), int(p), 90])
        t += float(rng.choice([0.5, 0.75]))
    wave = numpy_to_midi(np.array(notes)).synthesize(fs=SR)
    out = np.zeros(int(seconds * SR), np.float32)
    out[:min(len(out), len(wave))] = wave[:len(out)]
    return out / max(1e-6, float(np.abs(out).max())) * 0.8


def test_dispatcher_bytes_equal_serial_and_jax_on_the_record(tmp_path):
    """The model of record, fp32, 5 + 4 chunks of piano figures in a batch
    of 8 and one of 1 (bucket 8), capped at 64 tokens in both engines."""
    figures = [_piano_figure(s, seed) for seed, s in enumerate((14.0, 10.0))]
    conds = CONDS[1:3]
    mine = Music2MIDI.from_npz(RECORD, device="cpu", decode_max_length=64)
    ref = JaxMusic2MIDI.from_npz(RECORD, decode_max_length=64,
                                 use_compilation_cache=False)
    for eng in (mine, ref):
        eng.config.inference.batch_size = BATCH
    got = _bytes(mine.generate_batch(figures, cond_indices=conds), tmp_path,
                 "got")
    assert [s["real_rows"] for s in mine.last_decode_stats] == [8, 1]
    assert all(len(m) > 200 for m in got)  # many notes
    assert got == _bytes(_serial(mine, figures, conds), tmp_path, "serial")
    assert got == _bytes(ref.generate_batch(figures, cond_indices=conds),
                         tmp_path, "jax")


def test_one_thread_runs_every_batch_and_staging_overlaps(songs,
                                                         monkeypatch):
    """The card thread waits, inside batch k, until the calling thread has
    begun staging batch k + 1: a serial dispatcher would never get there
    and the wait would time out."""
    engine = _engine()
    seen = {"run": [], "upload": [], "rng": []}
    staged = [threading.Event() for _ in range(4)]
    overlapped = []
    run, upload, rng = engine._run_batch, engine._upload, engine._sample_rng
    stage = engine._stage
    count = {"stage": 0}

    def staging(slot, rows, b):
        staged[count["stage"]].set()
        count["stage"] += 1
        return stage(slot, rows, b)

    def running(batch, cond, n, generator=None):
        k = len(seen["run"])
        seen["run"].append(threading.get_ident())
        if k + 1 < 3:
            overlapped.append(staged[k + 1].wait(timeout=60))
        return run(batch, cond, n, generator)

    def uploading(slot, b):
        seen["upload"].append(threading.get_ident())
        return upload(slot, b)

    def sample_rng(k):
        seen["rng"].append(threading.get_ident())
        return rng(k)

    monkeypatch.setattr(engine, "_stage", staging)
    monkeypatch.setattr(engine, "_run_batch", running)
    monkeypatch.setattr(engine, "_upload", uploading)
    monkeypatch.setattr(engine, "_sample_rng", sample_rng)
    engine.generate_batch(songs, cond_indices=CONDS)
    ids = seen["run"] + seen["upload"] + seen["rng"]
    assert len(seen["run"]) == 3 and len(set(ids)) == 1
    assert ids[0] != threading.get_ident()
    assert overlapped == [True, True]


def test_calls_from_two_threads_take_turns(songs, tmp_path, monkeypatch):
    """Two threads call ``generate_batch`` on one engine at once, with
    other songs each: one call's staging and batches all end before the
    other's begin (the staging buffers are the engine's), and each call
    gets the serial path's bytes."""
    engine = _engine()
    sets = [(songs, CONDS), (songs[::-1], CONDS[::-1])]
    want = [_bytes(_serial(engine, w, c), tmp_path, f"want{i}")
            for i, (w, c) in enumerate(sets)]
    stage, run = engine._stage, engine._run_batch
    # thread (the object: a card thread's ident may be reused by the next
    # call's) -> [first start, last end]
    spans = {"stage": {}, "run": {}}

    def mark(kind):
        t = time.perf_counter()
        spans[kind].setdefault(threading.current_thread(), [t, t])[1] = t

    def staging(slot, rows, b):
        mark("stage")
        stage(slot, rows, b)
        mark("stage")

    def running(batch, cond, n, generator=None):
        mark("run")
        out = run(batch, cond, n, generator)
        mark("run")
        return out

    monkeypatch.setattr(engine, "_stage", staging)
    monkeypatch.setattr(engine, "_run_batch", running)
    start = threading.Barrier(2)
    got = [None, None]

    def call(i):
        start.wait()
        got[i] = engine.generate_batch(sets[i][0], cond_indices=sets[i][1])

    threads = [threading.Thread(target=call, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for kind in ("stage", "run"):
        (_, first_end), (second_start, _) = sorted(spans[kind].values())
        assert first_end < second_start, kind
    for i in (0, 1):
        assert _bytes(got[i], tmp_path, f"got{i}") == want[i]


def test_exception_in_batch_k_reaches_the_caller(songs, tmp_path,
                                                 monkeypatch):
    engine = _engine()
    want = _bytes(engine.generate_batch(songs, cond_indices=CONDS), tmp_path,
                  "want")
    run = engine._run_batch
    calls = []

    def failing(batch, cond, n, generator=None):
        calls.append(n)
        if len(calls) == 2:
            raise RuntimeError("batch 1 failed")
        return run(batch, cond, n, generator)

    monkeypatch.setattr(engine, "_run_batch", failing)
    with pytest.raises(RuntimeError, match="batch 1 failed"):
        engine.generate_batch(songs, cond_indices=CONDS)
    monkeypatch.setattr(engine, "_run_batch", run)
    again = _bytes(engine.generate_batch(songs, cond_indices=CONDS),
                   tmp_path, "again")
    assert again == want


def _live(prefix):
    return [t for t in threading.enumerate() if t.name.startswith(prefix)]


def test_no_thread_outlives_the_call_or_the_engine(songs):
    engine = _engine()
    before = {t.ident for t in threading.enumerate()}
    engine.generate_batch(songs, cond_indices=CONDS)
    new = [t for t in threading.enumerate() if t.ident not in before]
    assert new and all(t.name.startswith("m2m-stage") for t in new)
    engine.generate_batch(songs[:2], cond_indices=CONDS[:2])
    assert {t.ident for t in threading.enumerate()} - before \
        == {t.ident for t in new}  # the pool is kept, nothing else is new
    del engine
    gc.collect()
    deadline = time.monotonic() + 30
    for t in new:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in new)
    assert not _live("m2m-card")


def test_sampled_batch_k_draws_from_sample_rng_k(songs, monkeypatch):
    """The small random weights form no notes, so the tokens each batch
    decodes are compared: the dispatcher's equal to the serial path's with
    the same generators, the same again on a second call, and another
    ``sample_seed`` draws others."""
    engine = _engine()
    engine.temperature, engine.top_k, engine.sample_seed = 1.0, 5, 3
    drawn, tokens = [], []
    rng, run = engine._sample_rng, engine._run_batch

    def sample_rng(k):
        drawn.append(k)
        return rng(k)

    def running(batch, cond, n, generator=None):
        out = run(batch, cond, n, generator)
        tokens.append(out.clone())
        return out

    monkeypatch.setattr(engine, "_sample_rng", sample_rng)
    monkeypatch.setattr(engine, "_run_batch", running)

    def call(fn):
        drawn.clear()
        tokens.clear()
        fn(engine, songs, CONDS)
        return list(drawn), list(tokens)

    def batched(e, w, c):
        return e.generate_batch(w, cond_indices=c)

    got_k, got = call(batched)
    assert got_k == [0, 1, 2]
    ser_k, ser = call(_serial)
    assert ser_k == got_k
    assert all(torch.equal(a, b) for a, b in zip(got, ser))
    assert all(torch.equal(a, b) for a, b in zip(got, call(batched)[1]))
    engine.sample_seed = 4
    other = call(batched)[1]
    assert not all(torch.equal(a, b) for a, b in zip(got, other))
