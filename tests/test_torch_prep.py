"""The port's data-prep chain against the repository's JAX-package stages.

  * the metadata writer (``data/metadata.py::dump_metadata``) writes the
    bytes ``yaml.safe_dump`` writes, with and without ``sort_keys``, on
    hypothesis-made metadata (PyYAML's trouble spots among them: floats
    as ``1.0e-05`` and ``.inf``, strings that read as other types, lines
    folded at 80 columns, ``-0.0``), and raises outside its subset;
  * every stage, on one synthesised corpus in each of the four profiles
    (4 songs x 12 s, seed 0, the port's stage and the JAX package's stage
    in this process): ``synthesize_corpus``, ``align_audio_midi``,
    ``midi_to_numpy``, ``compute_metrics`` and ``generate_split`` write
    the same files, byte for byte (``dataset_split.npz``: the same arrays
    of the same dtype), or stop with the same message;
  * the split's ``train_test_split`` equals sklearn's for n = 3 ... 40;
  * a resumed ``synthesize_corpus`` writes what a fresh one writes;
  * the loader, with the C++ library and thread workers, gives the JAX
    loader's thread-worker batches within the pitch shift's bar (1e-5,
    ``tests/test_native.py``'s), and the same batches with no workers and
    with spawned processes; its warnings follow the JAX loader's
    conditions.
"""

import importlib.util
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from _jax_native import loaded as jax_native
from music2midi_tpu import native as jnative
from music2midi_tpu.config import default_config as jax_default_config
from music2midi_tpu.data import dataset as jds
from music2midi_tpu_torch import native as pnative
from music2midi_tpu_torch.config import default_config
from music2midi_tpu_torch.data import dataset as pds
from music2midi_tpu_torch.data import generate_split
from music2midi_tpu_torch.data.metadata import dump_metadata, read_metadata

ROOT = Path(__file__).resolve().parent.parent
STAGES = ("align_audio_midi", "midi_to_numpy", "compute_metrics",
          "generate_split")
SONGS, SECONDS, SEED = "4", "12", "0"


def _jax_stage(name: str):
    """The repository's ``data/{name}.py`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"jax_prep_{name}", ROOT / "data" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv, monkeypatch, jax: bool):
    """-> the message of a SystemExit, else None."""
    try:
        if jax:
            monkeypatch.setattr(sys, "argv", ["stage", *argv])
            main()
        else:
            main(argv)
    except SystemExit as e:
        return str(e)
    return None


def _port_stage(name: str):
    return importlib.import_module(f"music2midi_tpu_torch.data.{name}")


# --------------------------------------------------------------- metadata


_TROUBLE = ["yes", "No", "null", "~", "0.5", "1e5", "-0.0", "a: b", "#c",
            "a #b", "- x", "? y", "=", "<<", "!", "&a", "*b", "2024-01-01",
            "0x1f", "012", "1:30", "", " lead", "trail ", "---", "...",
            "x\n", "a\n\nb", "a \nb", "tab\there", "\xe9", "\u65e5\u672c",
            "\x85", "quote 'single' and \"double\""]
_scalars = st.one_of(
    st.none(), st.booleans(), st.integers(),
    st.floats(allow_nan=True, allow_infinity=True),
    st.sampled_from([1e-05, -0.0, 1e17, 2.5e-300, float("inf"),
                     -float("inf")]),
    st.sampled_from(_TROUBLE), st.text(max_size=120),
    st.text(alphabet="ab :#'\"-\n\\", max_size=200),
    st.from_regex(r"[a-z]{1,12}( [a-z]{1,12}){8,30}", fullmatch=True))
_keys = st.one_of(
    st.sampled_from(["piano", "youtube", "metrics", "id", "genre",
                     "difficulty", "opt_chroma_shift", "wp_std", "yes", "1",
                     "null", "a: b", "k k"]),
    st.text(alphabet=st.characters(blacklist_categories=("Cs",),
                                   blacklist_characters="\n\x85\u2028\u2029"),
            min_size=1, max_size=30))
_metadata = st.dictionaries(
    _keys, st.one_of(_scalars, st.dictionaries(_keys, _scalars,
                                               max_size=6)), max_size=6)


@pytest.mark.parametrize("sort_keys", [True, False])
@settings(max_examples=250, deadline=None,
          suppress_health_check=list(HealthCheck))
@given(meta=_metadata)
def test_metadata_writer_equals_safe_dump(sort_keys, meta):
    want = yaml.safe_dump(meta, sort_keys=sort_keys)
    assert dump_metadata(meta, sort_keys=sort_keys) == want


def test_metadata_writer_on_the_stages_values():
    meta = {"piano": {"id": "synth000", "genre": "pop",
                      "difficulty": "beginner", "num_tracks": 2},
            "youtube": {"duration": 40.00004535147392, "title": "x " * 60},
            "metrics": {"opt_chroma_shift": 0, "wp_std": 1e-05,
                        "max_beat_fluctuation": float("inf"),
                        "max_note_density": -0.0, "time_diff_ratio": 0.5},
            "flags": {"yes": "yes", "null": "null", "ratio": "0.5",
                      "colon": "a: b", "none": None, "ok": True},
            "empty": {}}
    for sort_keys in (True, False):
        text = dump_metadata(meta, sort_keys=sort_keys)
        assert text == yaml.safe_dump(meta, sort_keys=sort_keys)
        assert read_metadata(text) == yaml.safe_load(text)
    assert "1.0e-05" in text and ".inf" in text and "-0.0" in text
    assert "'yes'" in text and "'0.5'" in text and "'a: b'" in text
    assert max(len(line) for line in text.splitlines()) <= 84
    assert dump_metadata({}) == yaml.safe_dump({}) == "{}\n"


@pytest.mark.parametrize("meta", [
    {"a": [1, 2]}, {"a": {"b": {"c": 1}}}, {"a": np.float64(1.0)},
    {"a": b"x"}, {1: "x"}, {"": 1}, {"a\nb": 1}, {"k" * 130: 1}, [1]])
def test_metadata_writer_raises_outside_its_subset(meta):
    with pytest.raises(ValueError):
        dump_metadata(meta)


def test_metadata_writer_raises_on_a_shared_mapping():
    inner = {"x": 1}
    with pytest.raises(ValueError):
        dump_metadata({"a": inner, "b": inner})


# ----------------------------------------------------------------- stages


def _files(root: Path) -> dict:
    return {p.relative_to(root): p for p in sorted(root.rglob("*"))
            if p.is_file()}


def _assert_same_tree(got: Path, want: Path) -> None:
    a, b = _files(got), _files(want)
    assert sorted(a) == sorted(b)
    for rel in a:
        if rel.suffix == ".npz":
            x = np.load(a[rel], allow_pickle=True)
            y = np.load(b[rel], allow_pickle=True)
            assert x.files == y.files, rel
            for k in x.files:
                assert x[k].dtype == y[k].dtype, (rel, k)
                np.testing.assert_array_equal(x[k], y[k], err_msg=str(rel))
        else:
            assert a[rel].read_bytes() == b[rel].read_bytes(), rel


@pytest.mark.parametrize("profile", ["clean", "hard", "piano", "fullmix"])
def test_stages_write_the_jax_stages_files(profile, tmp_path, monkeypatch):
    jax_native()  # both sides on the C++ DTW and offset fix
    assert pnative.available(), pnative.build_log()
    cfg = str(ROOT / "config.yaml")
    sides = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    argv = ["--songs", SONGS, "--duration", SECONDS, "--seed", SEED,
            "--profile", profile]
    for side, root in sides.items():
        main = (_jax_stage if side == "jax" else _port_stage)(
            "synthesize_corpus").main
        assert _run(main, [str(root), *argv], monkeypatch,
                    side == "jax") is None
    _assert_same_tree(sides["port"], sides["jax"])
    for stage in STAGES:
        stops = {}
        for side, root in sides.items():
            monkeypatch.chdir(root)  # metrics.csv goes to the cwd
            extra = [] if stage == "midi_to_numpy" else ["--config", cfg]
            if side == "jax":
                stops[side] = _run(_jax_stage(stage).main,
                                   [str(root), *extra], monkeypatch, True)
            else:
                stops[side] = _run(_port_stage(stage).main, [str(root)],
                                   monkeypatch, False)
        assert stops["port"] == stops["jax"], stage
        _assert_same_tree(sides["port"], sides["jax"])
    port = sides["port"]
    assert len(list((port / "metadata").glob("*.yaml"))) == int(SONGS)
    for sub in ("midi_aligned", "midi_transposed", "warp_path",
                "beat_times_aligned", "midi_numpy"):
        assert len(list((port / sub).iterdir())) == int(SONGS), sub
    header = (port / "metrics.csv").read_text().splitlines()[0]
    assert header.startswith("piano_id,opt_chroma_shift,wp_std")
    if stops["port"] is None:
        split = np.load(port / "dataset_split.npz", allow_pickle=True)
        assert len(split["train_id"]) >= 2 and len(split["test_id"]) >= 1


def test_train_test_split_equals_sklearn():
    from sklearn.model_selection import train_test_split

    for n in range(3, 41):
        ids = np.array([f"s{i:03d}" for i in range(n)], dtype=object)
        for size in (0.2, 0.5):
            got = generate_split.train_test_split(ids, size, 42)
            want = train_test_split(ids, test_size=size, random_state=42)
            assert len(got) == 2
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            assert len(got[1]) == math.ceil(size * n)


def test_synthesize_corpus_resume_writes_a_fresh_runs_files(tmp_path):
    synth = _port_stage("synthesize_corpus").main
    fresh, resumed = tmp_path / "fresh", tmp_path / "resumed"
    argv = ["--songs", "3", "--duration", "4", "--seed", "5"]
    for root in (fresh, resumed):
        synth([str(root), *argv])
    for pid in ("synth001", "synth002"):
        for sub, ext in (("audio", "wav"), ("metadata", "yaml"),
                         ("midi", "mid")):
            (resumed / sub / f"{pid}.{ext}").unlink()
    before = (resumed / "audio" / "synth000.wav").stat().st_mtime_ns
    synth([str(resumed), *argv])
    assert (resumed / "audio" / "synth000.wav").stat().st_mtime_ns == before
    _assert_same_tree(resumed, fresh)


# ----------------------------------------------------------------- loader


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A clean corpus through the port's chain: -> (root, train ids)."""
    root = tmp_path_factory.mktemp("corpus")
    cwd = os.getcwd()
    _port_stage("synthesize_corpus").main(
        [str(root), "--songs", SONGS, "--duration", SECONDS, "--seed",
         SEED])
    os.chdir(root)
    try:
        for stage in STAGES:
            _port_stage(stage).main([str(root)])
    finally:
        os.chdir(cwd)
    split = np.load(root / "dataset_split.npz", allow_pickle=True)
    ids = [str(x) for x in split["train_id"]] + [str(split["test_id"][0])]
    return root, ids


def _batches(loader) -> list:
    return list(loader)


def test_loader_threads_equal_jax_and_every_worker_kind(corpus, caplog):
    root, ids = corpus
    jax_native()
    assert pnative.available(), pnative.build_log()
    jset = jds.Music2MIDIDataset(root, ids, jax_default_config())
    pset = pds.Music2MIDIDataset(root, ids, default_config())
    assert pset.native_dsp
    kw = dict(batch_size=2, shuffle=True, seed=7, drop_last=False)
    jl = jds.DataLoader(jset, num_workers=2, **kw)
    threads = pds.DataLoader(pset, num_workers=2, **kw)
    assert not jl.use_processes and not threads.use_processes
    assert "spawn" not in caplog.text
    for _ in range(2):  # two epochs
        got, want = _batches(threads), _batches(jl)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.waveform, b.waveform, rtol=0,
                                       atol=1e-5)
            np.testing.assert_array_equal(a.labels, b.labels)
            np.testing.assert_array_equal(a.cond_index, b.cond_index)
    base = _batches(pds.DataLoader(pset, num_workers=2, **kw))
    for other in (pds.DataLoader(pset, num_workers=0, **kw),
                  pds.DataLoader(pset, num_workers=2, use_processes=True,
                                 **kw)):
        for a, b in zip(base, _batches(other)):
            np.testing.assert_array_equal(a.waveform, b.waveform)
            np.testing.assert_array_equal(a.labels, b.labels)


@pytest.mark.parametrize("native_built, use_processes, cache", [
    (True, False, "cache_audio"), (True, True, "cache_audio"),
    (False, False, "cache_augment_mb"), (True, True, "cache_augment_mb"),
    (False, False, None)])
def test_loader_warnings_follow_jax(corpus, caplog, monkeypatch,
                                    native_built, use_processes, cache):
    root, ids = corpus
    if native_built:
        jax_native()
    else:
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(pnative, "available", lambda: False)
    kinds = {}
    for side, mod, cfg in (("jax", jds, jax_default_config()),
                           ("port", pds, default_config())):
        if cache == "cache_audio":
            cfg.dataset["cache_audio"] = True
        elif cache == "cache_augment_mb":
            cfg.dataset["cache_augment_mb"] = 8
        caplog.clear()
        loader = mod.DataLoader(mod.Music2MIDIDataset(root, ids, cfg),
                                num_workers=2, use_processes=use_processes)
        kinds[side] = (loader.use_processes,
                       "spawn process workers" in caplog.text,
                       "cache_audio with process workers" in caplog.text,
                       "cache_augment_mb with process workers"
                       in caplog.text)
    assert kinds["port"] == kinds["jax"]
    assert kinds["port"][0] == (use_processes or not native_built)
