"""The port's CLIs against the repository's root ones, on the CPU:
``music2midi_tpu_torch.evaluate`` vs root ``evaluate.py`` and
``music2midi_tpu_torch.serve_batch`` vs root ``serve_batch.py``, and
``load_engine``'s dispatch.

The checkpoint is one small npz written here by the JAX package's own
``save_params_npz``: the model of record cut to its first 2 encoder and 2
decoder layers, with that 2 + 2-layer config embedded.  Both sides load it
through their CLI's ``load_engine``, whose engine gets a decode cap of 64
tokens here (the same on both sides) to keep the JAX programs small.  The
corpus is 3 short synthetic songs laid out as the data-prep chain
(``music2midi_tpu_torch.data``) lays one out.

Bars (fp32): the CSV rows equal, the columns ``piano_id``, ``model``,
``genre``, ``difficulty`` exactly and ``score`` within 1e-6; the MIDI files
``serve_batch`` writes are byte-identical (so the notes per song are
equal) and the JSON line has the root's keys; ``load_engine`` dispatches
on the suffix, honours an npz's embedded config unless ``--config`` is
given, and falls back to the model of record, else random weights.

``--config configs/synth16k_aug_r5.yaml``, one case per CLI of the port:
the CLI runs as ``python3 -m`` runs it until it has loaded the file, and
so does its root twin; the trees they load are equal, leaf types
included, and the objects each package builds from its tree (the
``t5_config_from`` and ``log_mel_config_from`` configs, the dataloader's
batch and workers, the conditioning lists, the dataset section) are
equal.  Nothing is trained or decoded.
"""

import csv
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import evaluate as root_evaluate
import music2midi_tpu.config as jax_config
from music2midi_tpu.infer import Music2MIDI as JaxMusic2MIDI
from music2midi_tpu.models.t5 import t5_config_from as jax_t5_config_from
from music2midi_tpu.ops.mel import log_mel_config_from as jax_mel_config_from
from music2midi_tpu.train.checkpoint import save_params_npz
import music2midi_tpu_torch.config as port_config
from music2midi_tpu_torch import evaluate, serve_batch
from music2midi_tpu_torch.audio import write_wav
from music2midi_tpu_torch.config import default_config
from music2midi_tpu_torch.infer import Music2MIDI
from music2midi_tpu_torch.models.t5 import t5_config_from
from music2midi_tpu_torch.ops.mel import log_mel_config_from

RECORD = Path(__file__).resolve().parent.parent / "checkpoints" \
    / "model_of_record.npz"
CAP = 64
SONGS = (("s00", 5.0, "pop", "beginner"), ("s01", 4.0, "rock", "advanced"),
         ("s02", 6.5, "classical", "intermediate"))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    for d in ("audio", "midi_numpy", "metadata"):
        (root / d).mkdir()
    for i, (pid, seconds, genre, difficulty) in enumerate(SONGS):
        notes = chip_smoke.synthetic_notes(seconds, 10 + i)
        write_wav(root / "audio" / f"{pid}.wav",
                  chip_smoke.synthetic_song(seconds, 22050, 0, notes), 22050)
        np.save(root / "midi_numpy" / f"{pid}.npy", notes)
        (root / "metadata" / f"{pid}.yaml").write_text(
            f"piano:\n  difficulty: {difficulty}\n  genre: {genre}\n"
            f"  id: {pid}\n")
    ids = np.array([s[0] for s in SONGS])
    np.savez(root / "dataset_split.npz", train_id=ids, val_id=ids[:1],
             test_id=ids)
    return root


@pytest.fixture(scope="module")
def small_npz(tmp_path_factory):
    ref = JaxMusic2MIDI.from_npz(RECORD, use_compilation_cache=False)
    params = dict(ref.params)
    for stack in ("encoder", "decoder"):
        params[stack] = {**params[stack],
                         "layers": params[stack]["layers"][:2]}
    cfg = ref.config.to_dict()
    cfg["model"]["t5"]["num_layers"] = 2
    cfg["model"]["t5"]["num_decoder_layers"] = 2
    from music2midi_tpu.config import ConfigNode

    path = tmp_path_factory.mktemp("ckpt") / "small.npz"
    save_params_npz(path, params, ConfigNode(cfg), dtype="float32")
    return path


@pytest.fixture
def capped(monkeypatch):
    """Every CLI engine decodes at most CAP tokens a chunk."""
    for module in (root_evaluate, evaluate, serve_batch):
        orig = module.load_engine

        def load(*args, _orig=orig, **kw):
            engine = _orig(*args, **kw)
            engine.decode_max_length = CAP
            return engine

        monkeypatch.setattr(module, "load_engine", load)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_evaluate_equals_root(corpus, small_npz, capped, tmp_path,
                              monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["evaluate.py", str(corpus), "--ckpt",
                                      str(small_npz), "--name", "root"])
    root_evaluate.main()
    res = evaluate.main([str(corpus), "--ckpt", str(small_npz), "--name",
                         "port", "--device", "cpu"])
    out = capsys.readouterr().out
    want = _rows(tmp_path / "scores" / "score-root.csv")
    got = _rows(tmp_path / "scores" / "score-port.csv")
    assert res["csv"] == "scores/score-port.csv"
    assert len(got) == len(want) == len(SONGS)
    assert list(got[0]) == list(want[0]) == [
        "piano_id", "model", "genre", "difficulty", "score"]
    for g, w in zip(got, want):
        assert (g["piano_id"], g["genre"], g["difficulty"]) == \
            (w["piano_id"], w["genre"], w["difficulty"])
        assert (g["model"], w["model"]) == ("port", "root")
        assert abs(float(g["score"]) - float(w["score"])) <= 1e-6
    assert any(float(g["score"]) > 0 for g in got)
    assert res["chunks"] == sum(-(-int(s[1] * 16000) // 48000)
                                for s in SONGS)
    assert f"chunks at the token cap ({CAP} tokens): " \
        f"{res['chunks_at_cap']} of {res['chunks']}" in out
    assert f"mean score: {res['mean_score']:.4f}" in out


def test_serve_batch_equals_root(corpus, small_npz, capped, tmp_path,
                                 monkeypatch, capsys):
    import serve_batch as root_serve_batch

    songs = sorted(str(p) for p in (corpus / "audio").glob("*.wav"))
    monkeypatch.setattr(sys, "argv", [
        "serve_batch.py", str(tmp_path / "root"), *songs, "--ckpt",
        str(small_npz), "--dtype", "float32", "--genre", "rock"])
    root_serve_batch.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = serve_batch.main([str(tmp_path / "port"), *songs, "--ckpt",
                            str(small_npz), "--dtype", "float32", "--genre",
                            "rock", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == got and set(got) == set(want)
    assert got["songs"] == want["songs"] == len(songs)
    assert got["notes"] == want["notes"] > 0
    for song in songs:
        name = Path(song).stem + ".mid"
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "root" / name).read_bytes()


def test_load_engine_dispatch(small_npz, tmp_path, monkeypatch, capsys):
    eng = evaluate.load_engine(str(small_npz), None, device="cpu")
    assert int(eng.config.model.t5.num_layers) == 2  # the embedded config
    cfg = default_config().to_dict()
    cfg["model"]["t5"].update(num_layers=2, num_decoder_layers=2)
    cfg["inference"]["batch_size"] = 8
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    eng = evaluate.load_engine(str(small_npz), str(tmp_path / "cfg.json"),
                               "bfloat16", "cpu")
    assert int(eng.config.inference.batch_size) == 8
    assert eng.t5_config.dtype == torch.bfloat16
    # a YAML --config (the repository's form) overrides the embedded one
    cfg["inference"]["batch_size"] = 4
    port_config.save_config(cfg, tmp_path / "c.yaml")
    eng = evaluate.load_engine(str(small_npz), str(tmp_path / "c.yaml"),
                               device="cpu")
    assert int(eng.config.inference.batch_size) == 4

    calls = []
    for name in ("from_torch_checkpoint", "from_checkpoint"):
        monkeypatch.setattr(Music2MIDI, name, classmethod(
            lambda cls, p, config, _n=name, **kw: calls.append(
                (_n, Path(p).name, config, kw["device"]))))
    for ckpt in ("a.ckpt", "b.pt", "run_dir"):
        evaluate.load_engine(str(tmp_path / ckpt), None, device="cpu")
    assert calls == [("from_torch_checkpoint", "a.ckpt", None, "cpu"),
                     ("from_torch_checkpoint", "b.pt", None, "cpu"),
                     ("from_checkpoint", "run_dir", None, "cpu")]
    # a directory with no checkpoint: JAX restore_params' error
    with pytest.raises(FileNotFoundError, match="no checkpoint under"):
        Music2MIDI.from_orbax(tmp_path / "orbax")

    # no checkpoint: random weights when a config is given
    eng = evaluate.load_engine(None, str(tmp_path / "cfg.json"), device="cpu")
    assert "RANDOM weights" in capsys.readouterr().out
    assert int(eng.config.model.t5.num_layers) == 2
    # no card and no --device cpu: no fallback to the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            evaluate.load_engine(str(small_npz), None)


def test_load_engine_defaults_to_model_of_record(monkeypatch, tmp_path,
                                                 capsys):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "config.yaml").write_text("model: {t5: {num_layers: 2}}\n")
    eng = evaluate.load_engine(None, None, "bfloat16", "cpu")
    assert "model of record" in capsys.readouterr().out
    assert int(eng.config.model.t5.num_layers) == 6  # config.yaml unread
    emb = eng.model.state_dict()["shared_embedding"].float()
    assert float(emb.abs().max()) > 1.0  # trained, not an init


RECIPE = Path(__file__).resolve().parent.parent / "configs" \
    / "synth16k_aug_r5.yaml"


class _Loaded(Exception):
    """Raised by the spy once a CLI has loaded its config."""


def _loaded_config(monkeypatch, module, path: str, run):
    """Run `run` with `module.load_config` spied on until it loads `path`;
    -> the tree it loaded."""
    real, seen = module.load_config, []

    def spy(p):
        node = real(p)
        if str(p) == path:
            seen.append(node)
            raise _Loaded
        return node

    monkeypatch.setattr(module, "load_config", spy)
    with pytest.raises(_Loaded):
        run()
    monkeypatch.setattr(module, "load_config", real)
    return seen[0].to_dict()


def _typed(tree):
    if isinstance(tree, dict):
        return {k: _typed(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_typed(v) for v in tree]
    return (type(tree).__name__, tree)


def _built(tree, t5_from, mel_from) -> dict:
    """What a CLI builds from its config tree, comparable across the two
    packages (the dtype field is each framework's own object)."""
    node = port_config.ConfigNode(tree)
    t5 = t5_from(node)._asdict()
    t5.pop("dtype")
    return {"t5": _typed(t5), "mel": _typed(mel_from(node)._asdict()),
            "dataloader": (int(node.dataloader.batch_size),
                           int(node.dataloader.num_workers)),
            "conditioning": _typed(node.conditioning.to_dict()),
            "dataset": _typed(node.dataset.to_dict())}


CLI_ARGV = {  # the port's module -> (the root twin's script, argv)
    "train": ("train.py", ["{corpus}", "--out_dir", "{tmp}", "--device",
                           "cpu"]),
    "evaluate": ("evaluate.py", ["{corpus}"]),
    "serve_batch": ("serve_batch.py", ["{tmp}/out", "{corpus}/audio/s00.wav"]),
    "webui": ("webui.py", []),
    "bench": ("bench.py", ["--ckpt", "{record}"]),
    "data.synthesize_corpus": ("data/synthesize_corpus.py", ["{tmp}/syn"]),
    "data.align_audio_midi": ("data/align_audio_midi.py", ["{tmp}/corpus"]),
    "data.compute_metrics": ("data/compute_metrics.py", ["{tmp}/corpus"]),
    "data.generate_split": ("data/generate_split.py", ["{tmp}/corpus"]),
}


@pytest.mark.parametrize("module", list(CLI_ARGV))
def test_cli_config_is_the_jax_clis(module, corpus, tmp_path, monkeypatch):
    script, argv = CLI_ARGV[module]
    argv = [a.format(corpus=corpus, tmp=tmp_path, record=RECORD)
            for a in argv] + ["--config", str(RECIPE)]
    (tmp_path / "corpus" / "metadata").mkdir(parents=True)
    monkeypatch.chdir(tmp_path)
    root = Path(__file__).resolve().parent.parent

    def run_port():
        monkeypatch.setattr(sys, "argv", [module] + argv + (
            ["--device", "cpu"] if module in (
                "evaluate", "serve_batch", "webui", "bench") else []))
        runpy.run_module(f"music2midi_tpu_torch.{module}",
                         run_name="__main__")

    def run_root():
        monkeypatch.setattr(sys, "argv", [script] + argv)
        runpy.run_path(str(root / script), run_name="__main__")

    got = _loaded_config(monkeypatch, port_config, str(RECIPE), run_port)
    want_tree = jax_config.load_config(RECIPE).to_dict()
    assert _typed(got) == _typed(want_tree)
    if module == "data.compute_metrics":
        # the root stage takes --config and reads no value of it
        assert "load_config" not in (root / script).read_text()
    else:
        want_tree = _loaded_config(monkeypatch, jax_config, str(RECIPE),
                                   run_root)
    assert got["dataset"]["sample_rate"] == 16000
    want = _built(want_tree, jax_t5_config_from, jax_mel_config_from)
    assert _built(got, t5_config_from, log_mel_config_from) == want
    assert want["dataloader"] == (16, 4)
