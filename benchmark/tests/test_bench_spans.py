"""The span arithmetic (``frozen/spans.py``) and the per-layer metrics that
read the program's spans, on synthetic spans and device activity with
answers worked by hand; each reader returns None with no spans, without
a card, without a traced slice, and for a program that keeps no spans."""

from types import SimpleNamespace

import pytest

from benchmark import spec
from benchmark.frozen import spans as fs
from music2midi_tpu_torch import profiling

WINDOW = (0.0, 100.0)  # microseconds, the trace's unit
EVENTS = [{"name": f"k{i}", "cat": "device", "ts": s, "dur": e - s,
           "corr": i} for i, (s, e) in enumerate([(10.0, 20.0),
                                                  (30.0, 60.0),
                                                  (70.0, 80.0)])]


def _span(sid, name, t0, t1, parent=None, **attrs):
    return {"name": name, "id": sid, "parent": parent, "thread": "t",
            "t0_ns": int(t0 * 1000), "t1_ns": int(t1 * 1000),
            "attrs": attrs}


SERVE = [
    _span(1, "generate_batch", 0, 100, songs=2, chunks=130),
    _span(2, "batch", 5, 66, 1, k=0),
    _span(3, "decode", 25, 65, 2, steps=10, syncs=10, replays=10,
          captures=0),
    _span(5, "batch", 66, 95, 1, k=1),
    _span(4, "decode", 68, 82, 5, steps=4, syncs=2, replays=2,
          captures=0),
    # a span of an earlier slice, outside the window: read by nothing
    _span(9, "decode", 200, 300, None, steps=100, syncs=100, replays=100,
          captures=0),
]
BATCHER = [
    _span(10, "request", 0, 50, request=0),
    _span(11, "request", 10, 60, request=1),
    _span(12, "request", 55, 95, request=2),
    _span(13, "collect", 0, 30, songs=2),
    _span(14, "collect", 55, 70, songs=1),
    _span(20, "dispatch", 30, 50, requests=[0, 1]),
    _span(21, "dispatch", 70, 90, requests=[2]),
]
TRAIN = [
    _span(30, "train.step", 0, 40, step=0),
    _span(31, "h2d", 0, 5, 30),
    _span(32, "forward", 5, 20, 30),
    _span(33, "inner", 8, 12, 32),
    _span(34, "backward", 20, 30, 30),
    _span(35, "optimizer", 30, 40, 30),
    _span(40, "train.step", 50, 90, step=1),
    _span(41, "forward", 50, 60, 40),
    _span(42, "backward", 60, 75, 40),
    _span(43, "optimizer", 75, 90, 40),
]
# (metric, the spans it reads, its value worked by hand)
READINGS = [
    # decode spans cover 25-65 and 68-82 (54 us); the card idles in
    # 25-30, 60-65, 68-70 and 80-82 (14 us)
    ("decode.device_idle_share", SERVE, 100.0 * 14 / 54),
    # outside decode in the call: 0-25, 65-68, 82-100; idle 0-10, 20-25,
    # 65-68, 82-100 (36 us) over 2 batches
    ("serve.idle_outside_decode_ms_per_batch", SERVE, 36 / 2 / 1e3),
    ("decode.host_syncs_per_step", SERVE, 12 / 14),
    # waits 30 + 20 + 15 of request time 50 + 50 + 40
    ("batcher.dispatch_wait_share", BATCHER, 100.0 * 65 / 140),
    ("batcher.collect_ms_per_batch", BATCHER, (30 + 15) / 2 / 1e3),
    # forward self times 15 - 4 and 10
    ("train.forward_host_ms", TRAIN, (11 + 10) / 2 / 1e3),
    ("train.backward_host_ms", TRAIN, (10 + 15) / 2 / 1e3),
    ("train.optimizer_host_ms", TRAIN, (10 + 15) / 2 / 1e3),
]
METRICS = [name for name, _, _ in READINGS]


def _ctx(on_card=True):
    return {"on_card": on_card, "trace": {"slice": SimpleNamespace(
        events=EVENTS, window=WINDOW)}}


def test_interval_arithmetic_by_hand():
    assert fs.union([(5, 6), (0, 2), (1, 3), (4, 4)]) == [(0, 3), (5, 6)]
    assert fs.subtract([(0, 10), (20, 30)], [(2, 3), (5, 22), (29, 40)]) \
        == [(0, 2), (3, 5), (22, 29)]
    assert fs.subtract([(0, 10)], []) == [(0, 10)]
    assert fs.subtract([(0, 10)], [(0, 10)]) == []
    assert fs.clip([(-5, 5), (50, 150), (200, 300)], WINDOW) \
        == [(0, 5), (50, 100)]
    assert fs.length([(0, 3), (5, 6)]) == 4
    assert fs.idle_us([(0, 100)], EVENTS, WINDOW) == 50.0
    assert fs.idle_us([(15, 35)], EVENTS, WINDOW) == 10.0


def test_self_time_takes_off_the_children_once():
    parent = {"id": 1, "t0": 0.0, "t1": 10.0}
    kids = [{"id": 2, "parent": 1, "t0": 1.0, "t1": 4.0},
            {"id": 3, "parent": 1, "t0": 3.0, "t1": 5.0},
            {"id": 4, "parent": 2, "t0": 1.5, "t1": 2.0},  # a grandchild
            {"id": 5, "parent": 1, "t0": 9.0, "t1": 12.0}]  # runs past it
    assert fs.self_us(parent, kids) == pytest.approx(10 - 4 - 1)


def test_slice_spans_cut_to_the_window_in_microseconds(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: SERVE)
    got = fs.slice_spans(_ctx())
    assert [s["id"] for s in got] == [1, 2, 3, 5, 4]
    assert got[0]["t0"] == 0.0 and got[0]["t1"] == 100.0


@pytest.mark.parametrize("name,records,want", READINGS,
                         ids=[r[0] for r in READINGS])
def test_each_reader_by_hand(monkeypatch, name, records, want):
    monkeypatch.setattr(profiling, "spans", lambda: records)
    assert spec.metric_reader(name)(_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", METRICS)
def test_each_reader_finds_nothing_to_read(monkeypatch, name):
    read = spec.metric_reader(name)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(_ctx()) is None
    monkeypatch.setattr(profiling, "spans", lambda: SERVE + BATCHER + TRAIN)
    assert read(_ctx(on_card=False)) is None
    assert read({"on_card": True, "trace": None}) is None
    # a program without spans (the parent of this metric): nothing to read
    monkeypatch.delattr(profiling, "spans")
    assert read(_ctx()) is None

