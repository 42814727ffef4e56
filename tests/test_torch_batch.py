"""Port throughput entry point ``generate_batch`` and ``warmup`` (CPU).

Bars: in the fp32 parity mode the notes of every song, and the decode
stats of every batch, are exactly the JAX engine's ``generate_batch`` on
the same weights, waveforms and per-song conditioning, with batches that
cross song boundaries (random small weights, whose greedy tokens form no
notes, and the model of record on synthesized piano figures, which
form many); each song also equals the port's own ``generate``; the WAV
route gives the same notes as the waveform route; the argument errors
raise ``ValueError``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from music2midi_tpu.config import default_config as jax_default_config
from music2midi_tpu.infer import Music2MIDI as JaxMusic2MIDI
from music2midi_tpu_torch.audio import load, write_wav
from music2midi_tpu_torch.config import default_config
from music2midi_tpu_torch.infer import Music2MIDI
from music2midi_tpu_torch.utils import numpy_to_midi

RECORD = Path(__file__).resolve().parent.parent / "checkpoints" \
    / "model_of_record.npz"

SMALL = {"num_layers": 2, "num_decoder_layers": 2, "d_model": 64,
         "d_ff": 96}
SR = 16000
# 1 + 4 + 3 chunks in batches of 4: [s0, s1, s1, s1], [s1, s2, s2, s2]
SECONDS = (2.5, 10.0, 7.0)
CONDS = ([0, 0], [3, 1], [5, 2])


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
    cfg.inference.batch_size = 4
    return cfg


@pytest.fixture(scope="module")
def engine():
    return Music2MIDI.from_random(_small(default_config()), seed=2,
                                  device="cpu", decode_max_length=24)


@pytest.fixture(scope="module")
def songs():
    rng = np.random.default_rng(5)
    return [(rng.normal(size=int(s * SR)) * 0.1).astype(np.float32)
            for s in SECONDS]


def _notes(midi):
    return [(n.start, n.end, n.pitch, n.velocity)
            for n in midi.instruments[0].notes]


def test_generate_batch_equals_jax_and_generate_fp32(engine, songs):
    ref = JaxMusic2MIDI.from_random(_small(jax_default_config()), seed=2,
                                    decode_max_length=24,
                                    use_compilation_cache=False)
    want = ref.generate_batch(songs, cond_indices=CONDS)
    got = engine.generate_batch(songs, cond_indices=CONDS)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert _notes(g) == _notes(w)
    stats = engine.last_decode_stats
    assert [s["real_rows"] for s in stats] == [4, 4]
    assert [s["batch_width"] for s in stats] == [4, 4]
    assert set(stats[0]) == {"batch_width", "real_rows", "steps",
                             "tokens_real", "row_steps"}
    assert stats == ref.last_decode_stats
    for song, cond, g in zip(songs, CONDS, got):
        assert _notes(engine.generate(audio_y=song, cond_index=cond)) \
            == _notes(g)


def _piano_figure(seconds, seed):
    """Chords and melody notes through the port's synthesizer, at 16 kHz."""
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


def test_generate_batch_record_notes_equal_jax_fp32():
    """The model of record on three piano figures: many notes, all equal
    to the JAX engine's, song by song.  A 64-token cap keeps the CPU run
    short; both engines stop every row at it alike."""
    songs = [_piano_figure(s, seed) for seed, s in enumerate(SECONDS)]
    mine = Music2MIDI.from_npz(RECORD, device="cpu", decode_max_length=64)
    ref = JaxMusic2MIDI.from_npz(RECORD, decode_max_length=64,
                                 use_compilation_cache=False)
    for eng in (mine, ref):
        eng.config.inference.batch_size = 4
    got = mine.generate_batch(songs, cond_indices=CONDS)
    want = ref.generate_batch(songs, cond_indices=CONDS)
    assert [_notes(g) for g in got] == [_notes(w) for w in want]
    assert all(len(_notes(g)) > 0 for g in got)
    assert mine.last_decode_stats == ref.last_decode_stats
    for song, cond, g in zip(songs, CONDS, got):
        assert _notes(mine.generate(audio_y=song, cond_index=cond)) \
            == _notes(g)


def test_generate_batch_from_wav_paths(engine, songs, tmp_path):
    paths = []
    for i, song in enumerate(songs[:2]):
        paths.append(str(tmp_path / f"song{i}.wav"))
        write_wav(paths[-1], song, SR)
    from_wav = engine.generate_batch(audio_paths=paths,
                                     cond_indices=CONDS[:2])
    from_wave = engine.generate_batch(
        [load(p, sr=SR)[0] for p in paths], cond_indices=CONDS[:2])
    assert [_notes(m) for m in from_wav] == [_notes(m) for m in from_wave]
    assert len(engine.last_decode_stats) == 2  # 5 chunks: 4 + 1 (bucket 4)


@pytest.mark.parametrize("kwargs", [
    {},
    {"waveforms": [np.zeros(SR, np.float32)], "audio_paths": ["x.wav"]},
    {"waveforms": [np.zeros(SR, np.float32)], "cond_indices": [[0, 0]] * 2},
])
def test_generate_batch_argument_errors(engine, kwargs):
    with pytest.raises(ValueError):
        engine.generate_batch(**kwargs)


def test_warmup_runs_both_paths(engine):
    engine.last_decode_stats = []
    engine.warmup([8])
    # generate ran last: 8 silent chunks in two batches of 4
    assert [s["real_rows"] for s in engine.last_decode_stats] == [4, 4]
