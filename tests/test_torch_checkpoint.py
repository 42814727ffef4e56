"""The port's checkpoints against the JAX package's.

  * the npz export both ways, bit for bit: a file the port's
    ``save_params_npz`` writes reads back through JAX ``load_params_npz``
    equal to the port's parameters cast to the export dtype (bfloat16,
    float16, float32; integer leaves kept), config included; and a JAX
    export reads back through the port's ``load_params_npz``;
  * ``average_params`` within 1e-6 of JAX's on the same npz files, and the
    port's restore dispatch (npz, ``save_params`` dir, training root, step
    dir) giving the same parameters;
  * the training state round trip bit-exact (parameters, Adafactor
    moments, step), ``torch.load(weights_only=True)`` reading it;
  * ``keep=3`` pruning and ``latest_checkpoint`` as JAX's on the same
    step directories;
  * ``Music2MIDI.from_checkpoint`` on each layout, and ``from_orbax``
    pointing at it.
"""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

from music2midi_tpu.config import ConfigNode as JConfigNode
from music2midi_tpu.models import t5 as jt5
from music2midi_tpu.train import checkpoint as jck
from music2midi_tpu_torch.config import default_config
from music2midi_tpu_torch.infer import Music2MIDI
from music2midi_tpu_torch.models.t5 import T5Config, init_params
from music2midi_tpu_torch.train import checkpoint as pck
from music2midi_tpu_torch.train.adafactor import Adafactor
from music2midi_tpu_torch.train.loop import TrainState, trainable_model
from music2midi_tpu_torch.weights import params_from_jax

TINY = dict(num_layers=1, num_decoder_layers=1, d_ff=64)


def _config():
    cfg = default_config()
    for k, v in TINY.items():
        cfg.model.t5[k] = v
    return cfg


def _params(seed=0):
    cfg = T5Config(**TINY)
    sd = {k: torch.from_numpy(v) for k, v in init_params(seed, cfg).items()}
    sd["encoder.layers.0.ln1"] = sd["encoder.layers.0.ln1"] * 1.001
    return sd


def _jax_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _jax_leaves(v, prefix + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _jax_leaves(v, prefix + (str(i),))
    else:
        yield ".".join(prefix), np.asarray(tree)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_port_npz_reads_back_through_jax_bit_equal(tmp_path, dtype):
    sd = _params()
    sd["int_leaf"] = torch.arange(-3, 5, dtype=torch.int8)
    cfg = _config()
    pck.save_params_npz(tmp_path / "p.npz", sd, cfg, dtype=dtype)
    tree, jcfg = jck.load_params_npz(tmp_path / "p.npz")
    assert jcfg.to_dict() == cfg.to_dict()
    got = dict(_jax_leaves(tree))
    assert set(got) == set(sd)
    assert isinstance(tree["encoder"]["layers"], list)
    assert isinstance(tree["conditioning"], list)
    for k, t in sd.items():
        a = got[k]
        if not t.is_floating_point():
            assert a.dtype == np.int8
            np.testing.assert_array_equal(a, t.numpy())
            continue
        want = t.to(getattr(torch, dtype))
        if dtype == "bfloat16":
            assert a.dtype == ml_dtypes.bfloat16
            np.testing.assert_array_equal(
                a.view(np.uint16),
                want.view(torch.int16).numpy().view(np.uint16))
        else:
            assert a.dtype == np.dtype(dtype)
            np.testing.assert_array_equal(a, want.numpy())


def test_jax_npz_reads_back_through_the_port_bit_equal(tmp_path):
    tree = jt5.init_params(1, jt5.T5Config(**TINY))
    cfg = JConfigNode(_config().to_dict())
    jck.save_params_npz(tmp_path / "j.npz", tree, cfg)
    sd, pcfg = pck.load_params_npz(tmp_path / "j.npz")
    assert pcfg.to_dict() == cfg.to_dict()
    want = dict(_jax_leaves(tree))
    assert set(sd) == set(want)
    for k, t in sd.items():
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy().view(np.uint16),
            want[k].astype(ml_dtypes.bfloat16).view(np.uint16))
    # and the port writes the same file back
    pck.save_params_npz(tmp_path / "again.npz", sd, pcfg)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "again.npz") \
            as b:
        assert set(a.files) == set(b.files)
        assert json.loads(bytes(a["__dtypes__"])) == json.loads(
            bytes(b["__dtypes__"]))
        for k in a.files:
            if k not in ("__dtypes__", "__config__"):
                np.testing.assert_array_equal(a[k], b[k])


def test_average_params_matches_jax(tmp_path):
    srcs = []
    for i in range(3):
        path = tmp_path / f"{i}.npz"
        pck.save_params_npz(path, _params(i), _config() if i == 1 else None,
                            dtype="float32")
        srcs.append(path)
    weights = [1.0, 3.0, 0.5]
    got, cfg = pck.average_params(srcs, weights)
    want, jcfg = jck.average_params(srcs, weights)
    assert cfg.to_dict() == jcfg.to_dict()
    want = params_from_jax(want)
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6)
    with pytest.raises(ValueError):
        pck.average_params([])
    with pytest.raises(ValueError):
        pck.average_params(srcs, [1.0, -1.0, 0.0])


def _state(sd, lr=0.01):
    model = trainable_model(sd, T5Config(**TINY), "cpu")
    return TrainState(model, Adafactor(list(model.parameters()), lr=lr))


def _step(state, seed):
    g = torch.Generator().manual_seed(seed)
    for p in state.model.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    state.optimizer.step()
    state.step += 1


def test_train_state_round_trip_bit_exact(tmp_path):
    sd = _params()
    state = _state(sd)
    for s in range(3):
        _step(state, s)
    path = pck.save_train_state(tmp_path / "ckpt", state, _config())
    assert path.name == "step_00000003"
    torch.load(path / "state.pt", weights_only=True)
    fresh, cfg = pck.restore_train_state(tmp_path / "ckpt", _state(sd))
    assert cfg.to_dict() == _config().to_dict()
    assert fresh.step == 3
    for (k, a), b in zip(state.model.named_parameters(),
                         fresh.model.parameters()):
        assert torch.equal(a, b), k
    for a, b in zip(state.optimizer.state.values(),
                    fresh.optimizer.state.values()):
        assert a.keys() == b.keys() and a["step"] == b["step"] == 3
        for k in a:
            if k != "step":
                assert b[k].dtype == torch.float32 and torch.equal(a[k], b[k])
    # restored, the run goes on as the unbroken one
    _step(state, 9)
    _step(fresh, 9)
    for a, b in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)


def test_pruning_and_latest_match_jax(tmp_path):
    state = _state(_params())
    for _ in range(5):
        _step(state, 0)
        pck.save_train_state(tmp_path / "port", state, keep=3)
        (tmp_path / "jax" / f"step_{state.step:08d}").mkdir(parents=True)
        jck._prune_old(tmp_path / "jax", 3)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["step_00000003", "step_00000004", "step_00000005"]
    assert pck.latest_checkpoint(tmp_path / "port").name == \
        jck.latest_checkpoint(tmp_path / "jax").name
    assert pck.latest_checkpoint(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        pck.restore_params(tmp_path / "jax")


def test_restore_params_layouts_and_from_checkpoint(tmp_path):
    state = _state(_params())
    _step(state, 1)
    cfg = _config()
    pck.save_train_state(tmp_path / "root", state, cfg)
    params = {k: v.detach().clone() for k, v in
              state.model.state_dict().items()}
    pck.save_params(tmp_path / "export", params, cfg)
    pck.save_params_npz(tmp_path / "p.npz", params, cfg, dtype="float32")
    for src in (tmp_path / "root", tmp_path / "root" / "step_00000001",
                tmp_path / "export", tmp_path / "p.npz"):
        got, got_cfg = pck.restore_params(src)
        assert got_cfg.to_dict() == cfg.to_dict()
        assert set(got) == set(params)
        for k in params:
            assert torch.equal(got[k], params[k]), (src, k)
        engine = Music2MIDI.from_checkpoint(src, device="cpu")
        assert engine.t5_config.num_layers == 1
        for k, v in engine.model.state_dict().items():
            assert torch.equal(v, params[k])
    # a directory with no checkpoint: JAX restore_params' error
    with pytest.raises(FileNotFoundError, match="no checkpoint under"):
        Music2MIDI.from_orbax(tmp_path, device="cpu")
