"""The generator: the same seed gives the same inputs, another seed other
inputs over the same set of sizes."""

import json
from pathlib import Path

import numpy as np

from benchmark import generate

PKG = Path(__file__).resolve().parents[1]
BIG = 2 ** 31 + 12345  # past 32 signed bits, as the check's seeds are


def _traffic(name, **kw):
    t = json.loads((PKG / "traffic" / f"{name}.json").read_text())
    t.update(kw)
    return t


def _pool(seed):
    t = _traffic("catalogue-fullmix", songs=3, seconds_min=3.0,
                 seconds_max=5.0)
    return generate.song_pool(t, seed, 16000, [6, 3]).result()


def test_songs_repeat_for_a_seed_and_differ_across_seeds():
    a, b, c = _pool(BIG), _pool(BIG), _pool(BIG + 1)
    for x, y in zip(a, b):
        assert np.array_equal(x.wave, y.wave)
        assert np.array_equal(x.cond, y.cond)
    assert any(not np.array_equal(x.wave[:len(y.wave)], y.wave[:len(x.wave)])
               for x, y in zip(a, c))
    # the same set of sizes, in another order
    assert sorted(len(s.wave) for s in a) == sorted(len(s.wave) for s in c)
    assert sorted(len(s.wave) for s in a) == [48000, 64000, 80000]
    for s in a:  # a 16-bit recording, peak 0.8
        assert np.array_equal(np.round(s.wave * 32768), s.wave * 32768)
        assert abs(float(np.abs(s.wave).max()) - 0.8) < 1e-4


def test_arrivals_repeat_and_keep_their_set_of_gaps():
    t = _traffic("upload-fullmix", rate_per_s=4.0)
    ta, wa = generate.arrivals(t, BIG, 30.0)
    tb, wb = generate.arrivals(t, BIG, 30.0)
    tc, wc = generate.arrivals(t, BIG + 1, 30.0)
    assert np.array_equal(ta, tb) and np.array_equal(wa, wb)
    assert len(ta) == len(tc) == 120
    assert not np.array_equal(ta, tc)
    assert ta[0] == 0.0 and ta[-1] < 30.0 and np.all(np.diff(ta) > 0)
    q = (np.arange(120) + 0.5) / 120
    gaps = -np.log1p(-q)
    gaps *= 30.0 / gaps.sum()
    for times in (ta, tc):  # each gap one of the same 120 quantiles
        d = np.diff(times)
        assert np.abs(d[:, None] - gaps[None, :]).min(1).max() < 1e-9
    # every song of the pool served equally often, give or take one
    counts = np.bincount(wa, minlength=t["songs"])
    assert counts.max() - counts.min() <= 1


def test_train_batches_repeat_and_keep_their_shapes():
    t = _traffic("train-windows-fullmix", songs=2, seconds_min=9.0,
                 seconds_max=9.0, batch=2, windows=6)

    def batches(seed):
        songs = generate.song_pool(t, seed, 16000, [6, 3]).result()
        return generate.train_batches(t, songs, seed, 16000)

    a, b, c = batches(BIG), batches(BIG), batches(BIG + 1)
    assert len(a) == len(c) == 3
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert np.array_equal(u, v)
    assert not all(np.array_equal(x.wave, y.wave) for x, y in zip(a, c))
    for x in a:
        assert x.wave.shape == (2, 48000)
        assert (x.labels[:, 0] >= 133).all()  # each window opens on a time
        for row in x.labels:
            assert (row[row != -100] == 2).sum() == 1  # one EOS, last
            assert row[row != -100][-1] == 2
