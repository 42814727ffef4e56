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
    here), equal bit for bit, with the same config.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from music2midi_tpu import calibration as jcal
from music2midi_tpu.config import ConfigNode
from music2midi_tpu.infer import Music2MIDI as JaxMusic2MIDI
from music2midi_tpu.train import checkpoint as jckpt
from music2midi_tpu_torch import calibration as pcal
from music2midi_tpu_torch.infer import Music2MIDI
from music2midi_tpu_torch.tools import (
    average_checkpoints,
    calibration_check,
    export_npz,
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
