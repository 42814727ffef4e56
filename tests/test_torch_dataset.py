"""The port's data pipeline against the JAX package's.

A tiny prepared corpus that the test writes itself (``audio/*.wav`` at
22050 Hz, ``midi_numpy/*.npy``, ``metadata/*.yaml`` through
``yaml.safe_dump``, as ``data/synthesize_corpus.py`` writes them).  With
augmentation on and both packages' ``native.available`` patched to False
(both sides take numpy's pitch shift), the same
``np.random.Generator`` gives the same ``__getitem__`` in both packages,
and one seed the same ``DataLoader`` batches: waveforms within 1e-6,
notes, labels and conditioning exactly.  The port's loader gives the same
batches with spawned process workers and with thread workers.  The port's
metadata reader equals ``yaml.safe_load`` on files ``yaml.safe_dump``
wrote, and raises on other YAML.  ``dsp.py`` and the audio helpers match
the JAX package's numpy path within 1e-6.
"""

import math
import multiprocessing
import random
import string

import numpy as np
import pytest
import yaml

from music2midi_tpu import audio as jaudio
from music2midi_tpu import dsp as jdsp
from music2midi_tpu import native
from music2midi_tpu.config import default_config as jax_default_config
from music2midi_tpu.data import dataset as jds
from music2midi_tpu_torch import audio as paudio
from music2midi_tpu_torch import dsp as pdsp
from music2midi_tpu_torch import native as pnative
from music2midi_tpu_torch.config import default_config
from music2midi_tpu_torch.data import dataset as pds

SR = 22050


@pytest.fixture(autouse=True)
def _numpy_pitch_shift(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(pnative, "available", lambda: False)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    for d in ("audio", "midi_numpy", "metadata"):
        (root / d).mkdir()
    genres = default_config().conditioning.genre
    ids = []
    for i, seconds in enumerate((7.0, 9.5, 4.0)):
        pid = f"s{i}"
        ids.append(pid)
        n = 30
        onsets = np.sort(rng.uniform(0, seconds - 0.3, n))
        notes = np.stack([onsets, onsets + rng.uniform(0.05, 0.6, n),
                          rng.integers(40, 90, n), np.full(n, 80)], 1)
        np.save(root / "midi_numpy" / f"{pid}.npy", notes)
        t = np.arange(int(seconds * SR)) / SR
        wave = 0.3 * np.sin(2 * np.pi * 220 * (1 + i) * t) \
            + rng.normal(size=t.shape) * 0.05
        paudio.write_wav(root / "audio" / f"{pid}.wav",
                         wave.astype(np.float32), SR)
        with open(root / "metadata" / f"{pid}.yaml", "w") as f:
            yaml.safe_dump({"piano": {
                "id": pid, "genre": genres[i],
                "difficulty": "advanced"}}, f)
    return root, ids


def _pair(corpus, **dataset_cfg):
    root, ids = corpus
    jcfg = jax_default_config()
    pcfg = default_config()
    for cfg in (jcfg, pcfg):
        for k, v in dataset_cfg.items():
            cfg.dataset[k] = v
    return (jds.Music2MIDIDataset(root, ids, jcfg),
            pds.Music2MIDIDataset(root, ids, pcfg))


def test_getitem_matches_jax(corpus):
    jset, pset = _pair(corpus)
    assert pset.cond_indices == jset.cond_indices
    for seed in range(8):
        for i in range(len(pset)):
            jw, jn, jc = jset.__getitem__(i, np.random.default_rng(seed))
            pw, pn, pc = pset.__getitem__(i, np.random.default_rng(seed))
            assert pw.dtype == np.float32 and pw.shape == jw.shape
            np.testing.assert_allclose(pw, jw, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(pn, jn)
            assert pc == jc


@pytest.mark.parametrize("shuffle, drop_last", [(True, True),
                                                (False, False)])
def test_loader_batches_match_jax(corpus, shuffle, drop_last):
    jset, pset = _pair(corpus)
    kw = dict(batch_size=2, num_workers=0, shuffle=shuffle, seed=3,
              drop_last=drop_last)
    jl, pl = jds.DataLoader(jset, **kw), pds.DataLoader(pset, **kw)
    assert len(jl) == len(pl)
    for _ in range(2):  # two epochs: the shuffle reseeds per epoch
        jb, pb = list(jl), list(pl)
        assert len(jb) == len(pb) > 0
        for a, b in zip(jb, pb):
            np.testing.assert_allclose(b.waveform, a.waveform, atol=1e-6)
            np.testing.assert_array_equal(b.labels, a.labels)
            assert b.labels.dtype == a.labels.dtype
            np.testing.assert_array_equal(b.cond_index, a.cond_index)


def test_loader_workers_give_the_same_batches(corpus, caplog):
    """Spawned workers (augmentation on, no C++ library) and threads
    (off) give the batches of no workers; an epoch left after one batch
    stops its workers."""
    _, pset = _pair(corpus)
    kw = dict(batch_size=2, shuffle=True, seed=1, drop_last=False)
    plain = list(pds.DataLoader(pset, num_workers=0, **kw))
    spawned = pds.DataLoader(pset, num_workers=2, **kw)
    assert spawned.use_processes  # augment on: numpy pitch shift
    assert not pset.native_dsp  # fixed when made, pickled to the workers
    assert "spawn process workers" in caplog.text
    for a, b in zip(plain, spawned):
        np.testing.assert_array_equal(a.waveform, b.waveform)
        np.testing.assert_array_equal(a.labels, b.labels)
    early = iter(pds.DataLoader(pset, num_workers=2, batch_size=1, seed=1))
    np.testing.assert_array_equal(next(early).labels,
                                  list(pds.DataLoader(
                                      pset, num_workers=0, batch_size=1,
                                      seed=1))[0].labels)
    early.close()
    assert multiprocessing.active_children() == []
    _, quiet = _pair(corpus, augment=False)
    threads = pds.DataLoader(quiet, num_workers=2, **kw)
    assert not threads.use_processes
    for a, b in zip(pds.DataLoader(quiet, num_workers=0, **kw), threads):
        np.testing.assert_array_equal(a.waveform, b.waveform)
        np.testing.assert_array_equal(a.labels, b.labels)


def test_notes_segment_matches_jax():
    rng = np.random.default_rng(2)
    notes = np.sort(rng.uniform(0, 10, (40, 4)), axis=0)
    for shift in (False, True):
        np.testing.assert_array_equal(
            pds.get_notes_segment(notes, 3.0, 6.0, shift),
            jds.get_notes_segment(notes, 3.0, 6.0, shift))


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


def test_metadata_reader_equals_safe_load():
    rng = random.Random(0)
    chars = string.ascii_letters + string.digits + " :#'\"-_.,!?&*{}[]|>@%`~\\/\té日本"
    specials = ["yes", "No", "null", "~", "012", "0x1f", "1:30", "1.5",
                ".inf", "", " lead", "trail ", "- x", "a: b", "#c", "-",
                "2024-01-01", "1e5", "+7", "0b101"]

    def scalar():
        r = rng.random()
        if r < 0.1:
            return None
        if r < 0.2:
            return rng.choice([True, False])
        if r < 0.3:
            return rng.randint(-10 ** 6, 10 ** 6)
        if r < 0.4:
            return rng.choice([rng.uniform(-1e6, 1e6), 1e-5, 3.0,
                               float("inf"), -float("inf")])
        if r < 0.5:
            return rng.choice(specials)
        return "".join(rng.choice(chars) for _ in range(rng.randint(0, 150)))

    cases = [{"piano": {"id": "abc", "genre": "pop", "difficulty": "beginner"}},
             {"piano": {"id": "x", "num_tracks": 2},
              "youtube": {"id": "dQw", "duration": 212.5,
                          "title": "A title: with 'quotes' & # marks " * 4},
              "metrics": {"opt_chroma_shift": -3, "wp_std": 0.0123}},
             {"youtube": {}}, {}]
    for _ in range(400):
        meta = {}
        for _ in range(rng.randint(0, 4)):
            key = rng.choice(["piano", "youtube", "metrics", "some key",
                              "a:b", "1", "-k"])
            meta[key] = ({rng.choice(["id", "title", "url", "k k", "x"]):
                          scalar() for _ in range(rng.randint(0, 5))}
                         if rng.random() < 0.7 else scalar())
        cases.append(meta)
    for i, meta in enumerate(cases):
        kw = [{}, {"sort_keys": False}, {"width": 20},
              {"allow_unicode": True}][i % 4]
        text = yaml.safe_dump(meta, **kw)
        assert _same(pds.read_metadata(text), yaml.safe_load(text)), text


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n", "a: [1, 2]\n", "a: |\n  x\n", "a:\n  b:\n    c: 1\n",
    "a: &x 1\n", "- 1\n", "a: !!str 1\n", "a: 2024-01-01\n", "a: b # c\n"])
def test_metadata_reader_raises_on_other_yaml(text):
    with pytest.raises(ValueError):
        pds.read_metadata(text)


def test_dsp_matches_jax_numpy_path():
    rng = np.random.default_rng(4)
    y = (rng.normal(size=SR) * 0.2).astype(np.float32)
    for n_steps in (-6, -1, 0, 3, 5):
        np.testing.assert_allclose(
            pdsp.pitch_shift(y, SR, n_steps),
            jdsp.pitch_shift(y, SR, n_steps, prefer_native=False),
            rtol=0, atol=1e-6)
    D = pdsp.stft(y.astype(np.float64))
    np.testing.assert_allclose(D, jdsp.stft(y.astype(np.float64)),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        pdsp.istft(D, length=len(y)), jdsp.istft(D, length=len(y)),
        rtol=0, atol=1e-9)
    np.testing.assert_allclose(pdsp.time_stretch(y, 1.2),
                               jdsp.time_stretch(y, 1.2), rtol=0, atol=1e-9)


def test_audio_helpers_match_jax(corpus):
    root, ids = corpus
    for pid in ids:
        path = root / "audio" / f"{pid}.wav"
        assert paudio.get_duration(path) == jaudio.get_duration(path)
    x = np.array([0.0, -0.5, 0.25], np.float32)
    np.testing.assert_array_equal(paudio.normalize(x), jaudio.normalize(x))
    z = np.zeros(4, np.float32)
    assert paudio.normalize(z) is z
