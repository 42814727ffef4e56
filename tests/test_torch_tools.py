"""The port's checkpoint tools against the repository's, on the CPU.

The checkpoints are small npz files written here by the JAX package's
``save_params_npz``: the model of record cut to its first 2 encoder and 2
decoder layers (as ``tests/test_torch_cli.py`` builds one), and a second
one with every float leaf scaled by 1.5, for averaging.  Bars:

  * ``calibration.check_checkpoint`` gives the JAX function's
    ``(ok, detail)`` exactly, and ``tools.calibration_check`` prints the
    root tool's lines and exit code (both engines capped at 64 decode
    tokens a chunk, the same on both sides, to keep the JAX programs
    small);
  * ``tools.export_npz`` writes the arrays, dtypes and config of root
    ``tools/export_npz.py`` (one source, bf16; two weighted sources, fp32)
    and prints its line;
  * ``tools.average_checkpoints`` writes the parameters of root
    ``tools/average_checkpoints.py`` (an orbax export there, ``params.pt``
    here), equal bit for bit, with the same config;
  * ``tools.make_timbre_eval`` writes the root tool's tree, byte for byte
    and link for link, on a 2-song clean corpus of ~10-s songs, and
    prints its lines;
  * ``tools.realmix_check``'s metrics equal the root tool's on the same
    notes and audio (pygame's house loop here), its CLI prints the root
    tool's line format and exit code, and without audio it exits 1.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from music2midi_tpu import calibration as jcal
from music2midi_tpu import midi as jmidi
from music2midi_tpu.config import ConfigNode
from music2midi_tpu.infer import Music2MIDI as JaxMusic2MIDI
from music2midi_tpu.train import checkpoint as jckpt
from music2midi_tpu_torch import calibration as pcal
from music2midi_tpu_torch import midi as pmidi
from music2midi_tpu_torch.audio import write_wav
from music2midi_tpu_torch.data import synthesize_corpus
from music2midi_tpu_torch.infer import Music2MIDI
from music2midi_tpu_torch.tools import (
    average_checkpoints,
    calibration_check,
    export_npz,
    make_timbre_eval,
    realmix_check,
)
from music2midi_tpu_torch.weights import load_npz, restore_params

ROOT = Path(__file__).resolve().parent.parent
RECORD = ROOT / "checkpoints" / "model_of_record.npz"
CAP = 64


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _root_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"root_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def npzs(tmp_path_factory):
    """-> (small npz, its leaves x 1.5), both fp32, 2 + 2 layers."""
    ref = JaxMusic2MIDI.from_npz(RECORD, use_compilation_cache=False)
    params = dict(ref.params)
    for stack in ("encoder", "decoder"):
        params[stack] = {**params[stack],
                         "layers": params[stack]["layers"][:2]}
    cfg = ref.config.to_dict()
    cfg["model"]["t5"]["num_layers"] = 2
    cfg["model"]["t5"]["num_decoder_layers"] = 2
    import jax

    d = tmp_path_factory.mktemp("ckpt")
    small, scaled = d / "small.npz", d / "scaled.npz"
    jckpt.save_params_npz(small, params, ConfigNode(cfg), dtype="float32")
    jckpt.save_params_npz(
        scaled, jax.tree.map(lambda a: np.asarray(a, np.float32) * 1.5
                             if np.issubdtype(np.asarray(a).dtype,
                                              np.floating)
                             else a, params),
        ConfigNode(cfg), dtype="float32")
    return small, scaled


@pytest.fixture
def capped(monkeypatch):
    """Every engine the gate builds decodes at most CAP tokens a chunk."""
    for cls in (JaxMusic2MIDI, Music2MIDI):
        orig = cls.from_npz.__func__

        def load(klass, *args, _orig=orig, **kw):
            engine = _orig(klass, *args, **kw)
            engine.decode_max_length = CAP
            return engine

        monkeypatch.setattr(cls, "from_npz", classmethod(load))


def test_check_checkpoint_equals_jax(npzs, capped):
    small, _ = npzs
    for overrides in ({}, {"input_dither": 0.0, "mel_noise_floor": 0.003}):
        got = pcal.check_checkpoint(small, device="cpu", **overrides)
        want = jcal.check_checkpoint(small, **overrides)
        assert got == want
        assert isinstance(got[0], bool) and got[1].startswith("notes=")
    with pytest.raises(AttributeError):
        pcal.check_checkpoint(small, device="cpu", no_such_knob=1)


def test_calibration_check_cli_prints_the_root_tools_lines(
        npzs, capped, monkeypatch, capsys):
    small, _ = npzs
    monkeypatch.setattr(sys, "argv", ["calibration_check.py", str(small),
                                      "--dither", "0.0"])
    want_rc = _root_tool("calibration_check").main()
    want = capsys.readouterr().out.strip().splitlines()
    rc = calibration_check.main([str(small), "--dither", "0.0",
                                 "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    assert got == want and rc == want_rc
    assert got[0].startswith(("PASS ", "FAIL ")) and f"{small}: notes=" in \
        got[0]


def _assert_same_npz(got: Path, want: Path) -> None:
    a, b = np.load(got), np.load(want)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert json.loads(a["__config__"].tobytes()) == \
        json.loads(b["__config__"].tobytes())


@pytest.mark.parametrize("case", ["one_source_bf16", "two_sources_fp32"])
def test_export_npz_equals_the_root_tool(npzs, tmp_path, monkeypatch,
                                         capsys, case):
    small, scaled = npzs
    if case == "one_source_bf16":
        args = [str(small)]
    else:
        args = [str(small), str(scaled), "--dtype", "float32", "--weights",
                "1", "3"]
    monkeypatch.setattr(sys, "argv", ["export_npz.py",
                                      str(tmp_path / "root.npz"), *args])
    _root_tool("export_npz").main()
    want = capsys.readouterr().out.strip()
    export_npz.main([str(tmp_path / "port.npz"), *args])
    got = capsys.readouterr().out.strip()
    _assert_same_npz(tmp_path / "port.npz", tmp_path / "root.npz")
    n = 1 if case == "one_source_bf16" else 2
    assert got.startswith(f"exported {n} source(s) -> ")
    assert got.split("(")[-1] == want.split("(")[-1]  # size, dtype
    sd, _ = load_npz(tmp_path / "port.npz")
    assert all(t.dtype == (torch.bfloat16 if case == "one_source_bf16"
                           else torch.float32)
               for t in sd.values() if t.is_floating_point())


def test_average_checkpoints_equals_the_root_tool(npzs, tmp_path,
                                                  monkeypatch, capsys):
    small, scaled = npzs
    args = [str(small), str(scaled), "--weights", "2", "1"]
    monkeypatch.setattr(sys, "argv", ["average_checkpoints.py",
                                      str(tmp_path / "root"), *args])
    _root_tool("average_checkpoints").main()
    want = capsys.readouterr().out.strip()
    average_checkpoints.main([str(tmp_path / "port"), *args])
    got = capsys.readouterr().out.strip()
    assert got == want.replace(str(tmp_path / "root"),
                               str(tmp_path / "port"))
    # the root tool's orbax export, re-read there and written as an npz
    jparams, jcfg = jckpt.restore_params(tmp_path / "root")
    jckpt.save_params_npz(tmp_path / "root.npz", jparams, jcfg,
                          dtype="float32")
    want_sd, want_cfg = load_npz(tmp_path / "root.npz")
    got_sd, got_cfg = restore_params(tmp_path / "port")
    assert (tmp_path / "port" / "params.pt").exists()
    assert got_cfg == want_cfg
    assert sorted(got_sd) == sorted(want_sd)
    for k, t in got_sd.items():
        assert t.dtype == want_sd[k].dtype, k
        assert torch.equal(t, want_sd[k]), k


def _tree(root: Path) -> dict:
    """relative path -> (a link's resolved target or None, bytes)."""
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            out[str(p.relative_to(root))] = (
                os.path.realpath(p) if p.is_symlink() else None,
                p.read_bytes())
    return out


def test_make_timbre_eval_equals_the_root_tool(tmp_path, monkeypatch,
                                               capsys):
    src = tmp_path / "src"
    synthesize_corpus.main([str(src), "--songs", "2", "--duration", "10"])
    (src / "midi_numpy").mkdir()
    ids = np.array(["synth000", "synth001"])
    for pid in ids:
        np.save(src / "midi_numpy" / f"{pid}.npy", np.zeros((1, 4)))
    np.savez(src / "dataset_split.npz", train_id=ids[:0], val_id=ids[:0],
             test_id=ids)
    capsys.readouterr()
    args = ["--duration", "10"]
    monkeypatch.setattr(sys, "argv", ["make_timbre_eval.py", str(src),
                                      str(tmp_path / "root"), *args])
    _root_tool("make_timbre_eval").main()
    want = capsys.readouterr().out
    make_timbre_eval.main([str(src), str(tmp_path / "port"), *args])
    got = capsys.readouterr().out
    assert got == want.replace(str(tmp_path / "root"),
                               str(tmp_path / "port"))
    assert "seed derivation verified" in got
    port, root = _tree(tmp_path / "port"), _tree(tmp_path / "root")
    assert sorted(port) == sorted(root) == [
        "audio/synth000.wav", "audio/synth001.wav", "dataset_split.npz",
        "metadata/synth000.yaml", "metadata/synth001.yaml",
        "midi_numpy/synth000.npy", "midi_numpy/synth001.npy"]
    assert port == root
    assert port["metadata/synth000.yaml"][0] == str(
        (src / "metadata" / "synth000.yaml").resolve())  # a link
    # a wrong --seed is caught by the byte-identity check
    with pytest.raises(SystemExit, match="seed-derivation"):
        make_timbre_eval.main([str(src), str(tmp_path / "bad"), *args,
                               "--seed", "1"])


def _notes(n: int, seed: int):
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.uniform(0, 20, n))
    return [(float(s), float(s + rng.uniform(0.05, 1.5)),
             int(rng.integers(36, 90)), 80) for s in starts]


@pytest.mark.parametrize("n_notes", [0, 5, 40])
def test_realmix_metrics_equal_the_root_tool(n_notes, monkeypatch):
    root = _root_tool("realmix_check")
    fixture = root.real_loop()
    got_fixture = realmix_check.real_loop()
    if fixture is None:  # no pygame: the same chords on both sides
        t = np.arange(21 * 16000) / 16000
        y = sum(np.sin(2 * np.pi * f * t) for f in (220.0, 277.2, 329.6))
        fixture = (y.astype(np.float32) * 0.2, 16000)
        assert got_fixture is None
    else:
        np.testing.assert_array_equal(got_fixture[0], fixture[0])
        assert got_fixture[1] == fixture[1]
    y, sr = fixture
    midis = []
    for mod in (jmidi, pmidi):
        m = mod.MidiFile()
        if n_notes:
            inst = mod.Instrument(program=0)
            inst.notes = [mod.Note(s, e, p, v) for s, e, p, v in
                          _notes(n_notes, n_notes)]
            m.instruments.append(inst)
        midis.append(m)

    class Stub:
        def __init__(self, midi):
            self.midi = midi

        def generate(self, **kw):
            return self.midi

    monkeypatch.setattr(JaxMusic2MIDI, "from_npz", classmethod(
        lambda cls, *a, **kw: Stub(midis[0])))
    want_ok, want = root.check("x.npz", y, sr)
    got = realmix_check.metrics(midis[1], y, sr)
    assert (f"n_notes={got['n_notes']} overlap={got['overlap']} "
            f"top_notes={got['top_notes']} audio_top4={got['audio_top4']}"
            ) == want
    monkeypatch.setattr(Music2MIDI, "from_npz", classmethod(
        lambda cls, *a, **kw: Stub(midis[1])))
    assert realmix_check.check("x.npz", y, sr, device="cpu") == (want_ok,
                                                                 want)
    assert want_ok == (n_notes >= 30 and got["overlap"] >= 1)


def test_realmix_check_cli(npzs, capped, tmp_path, monkeypatch, capsys):
    small, _ = npzs
    t = np.arange(3 * 16000) / 16000
    write_wav(tmp_path / "mix.wav",
              (0.3 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32),
              16000)
    rc = realmix_check.main([str(small), "--audio", str(tmp_path / "mix.wav"),
                             "--device", "cpu"])
    (line,) = capsys.readouterr().out.strip().splitlines()
    assert line.startswith(("PASS ", "FAIL ")) and \
        f"{small}: n_notes=" in line and " audio_top4=[" in line
    assert rc == (0 if line.startswith("PASS ") else 1)
    monkeypatch.setattr(realmix_check, "real_loop", lambda: None)
    assert realmix_check.main([str(small), "--device", "cpu"]) == 1
    assert "--audio" in capsys.readouterr().err
