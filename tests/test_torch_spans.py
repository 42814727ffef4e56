"""The port's spans (``profiling.span``) on the CPU.

Bars: one ``generate_batch`` through ``DynamicBatcher`` gives the serving
call's span tree (each span on its thread under its parent, the request
ids of the ``request`` spans those of the ``dispatch`` that served them,
``decode`` carrying its steps and host syncs); a train step gives
``train.step`` over ``h2d``, ``forward``, ``backward`` and ``optimizer``
(carrying the Adafactor kernel's launches, none on the CPU, and the
leaves updated), which ``train.optimizer_launches_per_step`` reads;
nothing records with no profiler and no ``recording()``; the buffer keeps
the newest spans and counts what it dropped, from 16 threads at once with
no span lost or misparented; spans recorded under
``torch.profiler`` lie inside the clock range of its host events; the
engine's ``on_batch_tokens`` hook sees what ``_run_batch`` returns, under
the benchmark's recorder too.
"""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from music2midi_tpu_torch import profiling
from music2midi_tpu_torch.config import resolve_config
from music2midi_tpu_torch.infer import Music2MIDI
from music2midi_tpu_torch.models.t5 import T5Config, init_params
from music2midi_tpu_torch.ops.mel import log_mel_config_from
from music2midi_tpu_torch.serve.batcher import DynamicBatcher
from music2midi_tpu_torch.train.loop import (
    Batch,
    TrainState,
    make_optimizer,
    make_train_step,
    trainable_model,
)

SR = 16000
CARD_LEAVES = {"upload", "mel", "encode", "decode", "tokens", "detokenize"}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads per parallel test worker (see
    test_torch_pipeline.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _empty_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@pytest.fixture(scope="module")
def engine():
    eng = Music2MIDI.from_random(seed=0, decode_max_length=16, device="cpu")
    eng.config.inference.batch_size = 4  # two batches for three songs
    return eng


def _songs(n=3, seconds=4):
    rng = np.random.default_rng(0)
    return [(rng.normal(size=seconds * SR) * 0.2).astype(np.float32)
            for _ in range(n)]


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


def _within(child, parent):
    return parent["t0_ns"] <= child["t0_ns"] <= child["t1_ns"] \
        <= parent["t1_ns"]


def test_a_batcher_call_gives_the_serving_span_tree(engine):
    batcher = DynamicBatcher(engine, max_batch_songs=3, max_wait_ms=2000)
    try:
        with profiling.recording():
            futures = [batcher.submit(waveform=w) for w in _songs()]
            midis = [f.result(timeout=600) for f in futures]
    finally:
        batcher.close()
    assert len(midis) == 3
    records = profiling.spans()
    by = _by_name(records)
    ids = {r["id"]: r for r in records}
    assert [r["t0_ns"] for r in records] == sorted(r["t0_ns"]
                                                   for r in records)
    assert all(r["t1_ns"] >= r["t0_ns"] for r in records)

    requests = by["request"]
    assert sorted(r["attrs"]["request"] for r in requests) == [0, 1, 2]
    assert all(r["thread"] == "MainThread" and r["parent"] is None
               for r in requests)
    (dispatch,) = by["dispatch"]
    (collect,) = by["collect"]
    assert dispatch["thread"] == collect["thread"] == "m2m-batcher"
    assert collect["attrs"] == {"songs": 3}
    assert sorted(dispatch["attrs"]["requests"]) == [0, 1, 2]
    assert collect["t1_ns"] <= dispatch["t0_ns"]
    for r in requests:  # each request ends once its dispatch has served it
        assert r["t0_ns"] <= collect["t1_ns"]
        assert r["t1_ns"] >= dispatch["t1_ns"] - 1

    (root,) = by["generate_batch"]
    assert root["parent"] == dispatch["id"] and _within(root, dispatch)
    assert root["thread"] == "m2m-batcher"
    assert root["attrs"] == {"songs": 3, "chunks": 6}
    stages = by["stage"]
    assert [s["attrs"] for s in stages] == [
        {"k": 0, "width": 4, "rows": 4}, {"k": 1, "width": 4, "rows": 2}]
    assert all(s["parent"] == root["id"] and s["thread"] == root["thread"]
               for s in stages)
    assert sorted(ids[w["parent"]]["name"] for w in by["slot_wait"]) \
        == ["stage", "stage"]
    (midi,) = by["midi"]
    assert midi["parent"] == root["id"] and _within(midi, root)

    batches = by["batch"]
    assert [b["attrs"] for b in batches] == [{"k": 0}, {"k": 1}]
    for b in batches:
        assert b["parent"] == root["id"] and _within(b, root)
        assert b["thread"].startswith("m2m-card")
        kids = [r for r in records if r["parent"] == b["id"]]
        assert {r["name"] for r in kids} == CARD_LEAVES
        assert all(r["thread"] == b["thread"] and _within(r, b)
                   for r in kids)
    for d in by["decode"]:
        a = d["attrs"]
        assert a["steps"] >= 1 and a["syncs"] >= 1
        assert a["steps"] == a["syncs"] * engine.unroll
        assert a["captures"] == 0 and a["replays"] == 0  # eager on a CPU


def test_a_train_step_gives_its_four_parts():
    cfg = T5Config(d_kv=16, num_heads=2, d_ff=64, num_layers=1,
                   num_decoder_layers=1)
    model = trainable_model(
        {k: torch.from_numpy(v) for k, v in init_params(0, cfg).items()},
        cfg, "cpu")
    state = TrainState(model, make_optimizer(model))
    step = make_train_step(cfg, log_mel_config_from(resolve_config(None)))
    rng = np.random.default_rng(1)
    batch = Batch(rng.normal(size=(2, SR)).astype(np.float32) * 0.1,
                  rng.integers(3, 400, size=(2, 6)).astype(np.int32),
                  np.zeros((2, 2), np.int64))
    step(state, batch)
    with profiling.recording():
        step(state, batch)
        step(state, batch)
    records = profiling.spans()
    roots = [r for r in records if r["name"] == "train.step"]
    assert [r["attrs"] for r in roots] == [{"step": 1}, {"step": 2}]
    for root in roots:
        assert root["parent"] is None
        kids = [r for r in records if r["parent"] == root["id"]]
        assert [r["name"] for r in kids] == ["h2d", "forward", "backward",
                                            "optimizer"]
        assert all(_within(r, root) for r in kids)
        assert kids[-1]["attrs"] == {
            "launches": 0,
            "tensors": sum(p.requires_grad for p in model.parameters())}
    assert len(records) == 10


def test_the_optimizer_launches_metric_reads_the_optimizer_spans(
        monkeypatch):
    """``benchmark/metrics/train.optimizer_launches_per_step.py``: the
    ``optimizer`` spans' launches over their number in the traced slice;
    nothing where the spans carry no count (a program before the
    counter), without spans or without a card."""
    from types import SimpleNamespace

    from benchmark import spec

    def span(sid, name, t0, t1, parent=None, **attrs):
        return {"name": name, "id": sid, "parent": parent, "thread": "t",
                "t0_ns": t0 * 1000, "t1_ns": t1 * 1000, "attrs": attrs}

    ctx = {"on_card": True, "trace": {"slice": SimpleNamespace(
        events=[], window=(0.0, 100.0))}}
    read = spec.metric_reader("train.optimizer_launches_per_step")
    steps = [span(1, "train.step", 0, 40, step=0),
             span(2, "optimizer", 30, 40, 1, launches=4, tensors=146),
             span(3, "train.step", 50, 90, step=1),
             span(4, "optimizer", 75, 90, 3, launches=8, tensors=146),
             span(5, "optimizer", 200, 300, None, launches=99)]  # outside
    monkeypatch.setattr(profiling, "spans", lambda: steps)
    assert read(ctx) == 6.0
    assert read({**ctx, "on_card": False}) is None
    monkeypatch.setattr(profiling, "spans", lambda: [
        {**s, "attrs": {}} if s["name"] == "optimizer" else s
        for s in steps])
    assert read(ctx) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(ctx) is None


def test_nothing_records_without_a_profiler_or_recording(engine):
    sp = profiling.span("x", n=1)
    with sp as inner:
        inner.set(n=2)
    sp.end()
    assert sp.id is None
    engine.generate_batch(_songs(1, 3))
    assert profiling.spans() == [] and profiling.spans_dropped() == 0


def test_the_buffer_keeps_the_newest_and_counts_what_it_dropped(
        monkeypatch):
    monkeypatch.setattr(profiling, "_LOG", profiling.SpanLog(4))
    with profiling.recording():
        for i in range(10):
            with profiling.span(f"s{i}", i=i):
                pass
    assert [r["name"] for r in profiling.spans()] == ["s6", "s7", "s8",
                                                      "s9"]
    assert profiling.spans_dropped() == 6
    profiling.clear_spans()
    assert profiling.spans() == [] and profiling.spans_dropped() == 0


def test_threads_lose_no_span_and_no_drop_count(monkeypatch):
    monkeypatch.setattr(profiling, "_LOG", profiling.SpanLog(1000))
    threads, per = 16, 500
    start = threading.Barrier(threads)

    def work():
        start.wait(timeout=60)
        for i in range(per):
            with profiling.span("outer"):
                with profiling.span("inner", i=i):
                    pass

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(before)
    assert not any(t.is_alive() for t in pool)
    records = profiling.spans()
    assert len(records) == 1000
    assert profiling.spans_dropped() == 2 * threads * per - 1000
    assert len({r["id"] for r in records}) == 1000
    by_id = {r["id"]: r for r in records}
    for r in records:  # a parent is on the same thread, never crossed
        if r["name"] == "inner" and r["parent"] in by_id:
            assert by_id[r["parent"]]["thread"] == r["thread"]
        if r["name"] == "outer":
            assert r["parent"] is None


def test_spans_under_the_profiler_share_its_host_clock():
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer") as outer:
            for _ in range(20):
                with profiling.span("inner"):
                    x = torch.tanh(x @ x)
            with profiling.span("adopted", parent=outer.id + 1000):
                pass
    events = list(prof.profiler.kineto_results.events())
    lo = min(e.start_ns() for e in events)
    hi = max(e.start_ns() + e.duration_ns() for e in events)
    records = profiling.spans()
    assert len(records) == 22
    for r in records:
        assert lo <= r["t0_ns"] <= r["t1_ns"] <= hi, (r, lo, hi)
    by = _by_name(records)
    (outer_rec,) = by["outer"]
    assert all(r["parent"] == outer_rec["id"] for r in by["inner"])
    assert by["adopted"][0]["parent"] == outer_rec["id"] + 1000
    # the span entered record_function: its annotation starts with it
    (note,) = [e for e in events if e.name() == "outer"]
    assert abs(note.start_ns() - outer_rec["t0_ns"]) < 1_000_000
    mm = [e for e in events if e.name() == "aten::mm"]
    assert len(mm) == 20 and all(
        outer_rec["t0_ns"] <= e.start_ns() <= outer_rec["t1_ns"] for e in mm)


def test_the_tokens_hook_sees_what_run_batch_returns(engine):
    from benchmark.drive.serve import Recorder

    seen, returned = [], []
    real = engine._run_batch

    def run_batch(*args, **kwargs):
        returned.append(real(*args, **kwargs))
        return returned[-1]

    engine.on_batch_tokens = lambda k, tokens: seen.append((k, tokens))
    try:
        engine._run_batch = run_batch
        recorder = Recorder(engine)
        recorder.call(_songs(), [None] * 3, [0, 1, 2])
    finally:
        engine.on_batch_tokens = None
        del engine._run_batch
    assert [k for k, _ in seen] == [0, 1]
    assert len(returned) == 2
    for (_, hooked), ret, rec in zip(seen, returned,
                                     recorder.calls[0]["tokens"]):
        assert hooked is ret and torch.equal(rec, ret)
    assert len(engine.last_decode_stats) == 2
