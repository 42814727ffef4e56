"""The port's dp x tp mesh (``music2midi_tpu_torch/parallel``) against one
device and the JAX mesh, in gloo processes on the CPU.

Process groups (one per case family, started together by a module
fixture, each child with its own 120-s timeout, a ``file://`` store and no
TCP port of its own, and the imports the card's machine lacks blocked by
a ``sitecustomize`` on its path):

  * 2 ranks, meshes (2, 1) then (1, 2); 4 ranks, mesh (2, 2): each runs
    ``tests/_torch_parallel_child.py`` (the cases the test process also
    runs on one device);
  * ``python3 -m torch.distributed.run --standalone --nproc_per_node 2 -m
    music2midi_tpu_torch.train ... --tp 2 --max_steps 1 --device cpu``
    on a corpus written as ``tests/test_torch_train.py::_write_corpus``.

Bars (fp32):

  * two Adafactor steps (lr 0.05, dropout 0) on
    ``tests/_distributed_trainstep.py``'s batch, whose dp shards hold
    unequal label lengths: the losses at each mesh within rtol 1e-5 of
    JAX ``make_train_step`` on ``make_mesh(jax.devices()[:dp*tp], dp,
    tp)`` and of the port on one device;
  * the gathered parameters after step 2 against the port's one-device
    parameters at rtol 1e-5 / atol 1e-7, as far as the reference itself
    holds it: the largest excess of any element over that tolerance may
    not exceed the JAX mesh's over JAX on one device (same mesh, same
    steps).  Adafactor divides each update by its column's and row's
    gradient RMS, so a column whose gradient cancels to near zero (some
    k columns: softmax ignores a key bias common to all keys) takes a
    step of full size made of summation-order noise; the JAX mesh puts
    431-553 elements 3.3e-6 to 6.0e-6 off JAX on one device here, the
    port's mesh 30-133 elements at most 1.9e-6 off the port;
  * dropout 0.1 at (2, 2): losses within rtol 1e-5 and parameters at the
    bar above (its JAX excess that of dropout 0) of the one-device port's
    (each rank draws the full masks);
  * step 1's gradients of the replicated parameters equal on every rank
    (the tp ranks' through the "copy" operator, bit for bit) and within
    1e-5 of each leaf's largest of one device's (fp32 sums over the
    batch's tokens in another order);
  * ``shard_params`` -> ``gather_params`` is the identity, bit for bit;
  * ``Music2MIDI(mesh=...)``: ``generate_batch``'s notes and
    ``sample_tokens_batched``'s tokens on tests/test_decode_pipeline.py's
    chunks equal the one-device port's and JAX ``Music2MIDI(...,
    mesh=make_mesh(dp=2, tp=2))``'s, token for token; the tp ranks of a
    dp rank run the same decode steps;
  * a checkpoint saved at (1, 2) after step 1 and restored at (1, 1)
    takes step 2 of the one-device trajectory (the loss within rtol 1e-5,
    the parameters at the bar above);
  * ``maybe_initialize``'s environment cases, ``param_pspecs`` against
    JAX ``param_pspecs`` name for name, and the CLI: one ``log.jsonl``
    written by rank 0 alone, and a checkpoint of whole parameters.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_parallel_child as child
from music2midi_tpu.config import default_config as jax_default_config
from music2midi_tpu.infer import Music2MIDI as JaxMusic2MIDI
from music2midi_tpu.models import init_params as jax_init_params
from music2midi_tpu.models import t5_config_from as jax_t5_config_from
from music2midi_tpu.ops.mel import LogMelConfig as JaxMelConfig
from music2midi_tpu.parallel import mesh as jmesh
from music2midi_tpu.train import adafactor_hf
from music2midi_tpu.train import loop as jloop
from music2midi_tpu_torch.config import default_config
from music2midi_tpu_torch.parallel import distributed
from music2midi_tpu_torch.parallel import mesh as pmesh
from music2midi_tpu_torch.train.checkpoint import restore_train_state
from music2midi_tpu_torch.train.loop import (
    TrainState,
    make_optimizer,
    make_train_step,
    trainable_model,
)
from music2midi_tpu_torch.weights import params_from_jax, restore_params
from test_torch_train import _write_corpus

ROOT = Path(__file__).resolve().parent.parent
MESHES = [(2, 1), (1, 2), (2, 2)]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
           "zstandard", "ml_dtypes", "yaml", "omegaconf", "transformers",
           "music2midi_tpu", "wandb")
CHILD_TIMEOUT = 120
RTOL, ATOL = 1e-5, 1e-7
_SITECUSTOMIZE = """
import sys
BLOCKED = set({blocked!r})

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked on the card's machine: {{name}}")
        return None

sys.meta_path.insert(0, _Blocker())
"""
_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT", "M2M_DISTRIBUTED",
               "M2M_DIST_BACKEND")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _child_env(block_dir: Path) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENV}
    env["PYTHONPATH"] = os.pathsep.join([str(block_dir), str(ROOT)])
    env["OMP_NUM_THREADS"] = "1"
    return env


def _cli_config(tmp: Path) -> Path:
    cfg = default_config().to_dict()
    cfg["model"]["t5"].update(num_layers=2, num_decoder_layers=2, d_ff=128)
    cfg["dataloader"].update(batch_size=2, num_workers=0)
    cfg["trainer"].update(log_every_n_steps=1)
    path = tmp / "config.json"
    path.write_text(json.dumps(cfg))
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the three process groups, and while they run compute the
    references in this process; -> their outputs."""
    tmp = tmp_path_factory.mktemp("parallel")
    block = tmp / "block"
    block.mkdir()
    (block / "sitecustomize.py").write_text(
        _SITECUSTOMIZE.format(blocked=BLOCKED))
    env = _child_env(block)
    procs = []  # (label, Popen)
    for world, spec in ((4, {"meshes": [[2, 2]], "dropout_mesh": [2, 2]}),
                        (2, {"meshes": [[2, 1], [1, 2]],
                             "ckpt_mesh": [1, 2]})):
        spec = {**spec, "store": str(tmp / f"store{world}"),
                "out": str(tmp / "out")}
        for r in range(world):
            procs.append((f"world {world} rank {r}", subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "_torch_parallel_child.py"),
                 json.dumps(spec)],
                env={**env, "RANK": str(r), "WORLD_SIZE": str(world)},
                cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    data = tmp / "data"
    _write_corpus(data, n_songs=2)
    procs.append(("torchrun", subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "music2midi_tpu_torch.train",
         str(data), "--device", "cpu", "--config", str(_cli_config(tmp)),
         "--out_dir", str(tmp / "runs"), "--name", "cli", "--tp", "2",
         "--max_steps", "1"],
        env=env, cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)))
    try:
        refs = {
            "one": child.train(),
            "one_dropout": child.train(dropout=0.1),
            "engine": child.engine(),
            "jax": {m: _jax_train(*m) for m in [(1, 1)] + MESHES},
            "jax_engine": _jax_engine(),
        }
        outs = {}
        for label, p in procs:
            out, _ = p.communicate(timeout=CHILD_TIMEOUT)
            outs[label] = out
            assert p.returncode == 0, f"{label} failed:\n{out[-6000:]}"
    finally:
        for _, p in procs:
            p.kill()
            p.communicate()
    return {"tmp": tmp, "outs": outs, **refs}


def _jax_train(dp: int, tp: int) -> dict:
    """Two JAX ``make_train_step`` steps on the (dp, tp) mesh of this
    process's virtual CPU devices, the child's batch, init and lr ->
    {"losses", "params" (flat numpy)}."""
    cfg = jax_t5_config_from(jax_default_config())._replace(
        num_layers=2, num_decoder_layers=2, d_ff=128, dropout_rate=0.0)
    mesh = jmesh.make_mesh(jax.devices()[:dp * tp], dp=dp, tp=tp)
    host = jax_init_params(0, cfg)
    params = jax.device_put(host, jmesh.param_shardings(mesh, host))
    b = child.train_batch()
    bshard = jmesh.batch_sharding(mesh)
    batch = jloop.Batch(*(jax.device_put(np.asarray(x), bshard) for x in b))
    opt = adafactor_hf(learning_rate=child.LR, warmup_init=False)
    state = jloop.init_train_state(params, opt)
    step = jloop.make_train_step(opt, cfg, JaxMelConfig(
        **child.MEL._asdict()), donate=False)
    losses = []
    for i in range(2):
        state, loss = step(state, batch, jax.random.PRNGKey(i))
        losses.append(float(loss))
    params = params_from_jax(jax.tree.map(np.asarray, state.params))
    return {"losses": losses,
            "params": {k: v.numpy() for k, v in params.items()}}


def _jax_engine() -> dict:
    eng = JaxMusic2MIDI.from_random(
        seed=0, decode_max_length=child.ENGINE_MAX_LEN,
        mesh=jmesh.make_mesh(jax.devices()[:4], dp=2, tp=2),
        use_compilation_cache=False)
    songs = child.engine_songs()
    notes = [[(n.start, n.end, n.pitch) for i in m.instruments
              for n in i.notes] for m in eng.generate_batch(songs)]
    tokens = eng.sample_tokens_batched(eng._chunk_waveform(songs[0]))
    return {"notes": notes, "tokens": [[int(t) for t in row]
                                       for row in tokens]}


def _rank_outputs(runs, dp: int, tp: int) -> list:
    out = runs["tmp"] / "out" / f"{dp}x{tp}"
    return [(json.loads((out / f"rank{r}.json").read_text()),
             np.load(out / f"rank{r}.npz")) for r in range(dp * tp)]


def _excess(got, want: dict) -> float:
    """The largest amount by which an element of ``got`` (a mapping of the
    same names) lies outside rtol 1e-5 / atol 1e-7 of ``want``; <= 0 when
    every element is within."""
    assert sorted(got) == sorted(want)
    return max(float((np.abs(got[k] - v) - (ATOL + RTOL * np.abs(v))).max())
               for k, v in want.items())


def _assert_params(got: dict, want: dict, prefix: str, runs, mesh) -> None:
    """``got``'s ``prefix`` leaves against ``want`` at rtol 1e-5 / atol
    1e-7, as far as the JAX mesh ``mesh`` holds JAX on one device."""
    mine = _excess({k[len(prefix):]: got[k] for k in got
                    if k.startswith(prefix)}, want)
    ref = _excess(runs["jax"][mesh]["params"], runs["jax"][(1, 1)]["params"])
    assert mine <= max(ref, 0.0), (mine, ref)


# --------------------------------------------------------------------- #
# in this process                                                        #
# --------------------------------------------------------------------- #


def test_maybe_initialize_environment(monkeypatch, tmp_path):
    for k in _LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    assert not distributed.should_initialize()
    assert distributed.maybe_initialize(device="cpu") is False
    monkeypatch.setenv("M2M_DISTRIBUTED", "1")
    assert distributed.should_initialize()
    monkeypatch.delenv("M2M_DISTRIBUTED")
    # half a pair
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="WORLD_SIZE must be set"):
        distributed.maybe_initialize(device="cpu")
    monkeypatch.delenv("RANK")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="RANK must be set"):
        distributed.maybe_initialize(device="cpu")
    # nccl with more ranks than cards: raises, naming gloo
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="gloo"):
        distributed.maybe_initialize(device="cuda")
    cuda = torch.device("cuda")
    with pytest.raises(RuntimeError, match="M2M_DIST_BACKEND=gloo"):
        distributed.choose_backend(cuda, "nccl", local_world=2 + torch.cuda.device_count())
    assert distributed.choose_backend(cuda, "gloo", local_world=4) == "gloo"
    monkeypatch.setenv("M2M_DIST_BACKEND", "gloo")
    assert distributed.choose_backend(cuda, local_world=4) == "gloo"
    monkeypatch.delenv("M2M_DIST_BACKEND")
    assert distributed.choose_backend(torch.device("cpu")) == "gloo"
    with pytest.raises(ValueError, match="gloo"):
        distributed.choose_backend(torch.device("cpu"), "nccl")
    # torchrun's variables: a world of one on the CPU
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    try:
        info = distributed.maybe_initialize(
            device="cpu", init_method=f"file://{tmp_path / 'store'}")
        assert info == distributed.DistInfo("gloo", torch.device("cpu"), 0, 1)
        assert distributed.maybe_initialize(device="cpu") is info
        mesh = pmesh.make_mesh(device_type="cpu")
        assert (pmesh.axis_size(mesh, "dp"), pmesh.axis_size(mesh, "tp")) \
            == (1, 1)
        assert pmesh.axis_group(mesh, "tp") is None
        with pytest.raises(ValueError, match=r"dp\*tp = 2\*1 != 1"):
            pmesh.make_mesh(dp=2, device_type="cpu")
    finally:
        distributed.shutdown()
    assert not torch.distributed.is_initialized()


def test_param_pspecs_match_jax():
    cfg = jax_t5_config_from(jax_default_config())._replace(
        num_layers=2, num_decoder_layers=2, d_ff=128)
    tree = jax_init_params(0, cfg)
    want = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        else:
            spec = tuple(node)
            while spec and spec[-1] is None:
                spec = spec[:-1]
            want[".".join(path)] = spec

    walk(jmesh.param_pspecs(tree), [])
    got = pmesh.param_shardings(None, params_from_jax(tree))
    assert sorted(got) == sorted(want)
    assert {k: s.spec for k, s in got.items()} == want
    assert sum(s.spec == (None, "tp") for s in got.values()) == 5 * 2 + 8 * 2
    for port, jax_spec in ((pmesh.replicate(None), ()),
                           (pmesh.batch_sharding(None), ("dp",)),
                           (pmesh.stacked_batch_sharding(None), (None, "dp"))):
        assert port.spec == jax_spec
    x = np.arange(24).reshape(4, 6)
    np.testing.assert_array_equal(pmesh.batch_sharding(None).local(x), x)


# --------------------------------------------------------------------- #
# the process groups                                                     #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_train_steps_match_jax_and_one_device(runs, mesh):
    ranks = _rank_outputs(runs, *mesh)
    one = runs["one"]
    for result, _ in ranks:
        assert result["backend"] == "gloo" and result["device"] == "cpu"
        assert result["roundtrip"]  # shard_params -> gather_params
        losses = result["dropout0/losses"]
        np.testing.assert_allclose(losses, one["losses"], rtol=RTOL)
        np.testing.assert_allclose(losses, runs["jax"][mesh]["losses"],
                                   rtol=RTOL)
    np.testing.assert_allclose(one["losses"], runs["jax"][mesh]["losses"],
                               rtol=RTOL)
    _assert_params(ranks[0][1], one["params"], "dropout0/params/", runs,
                   mesh)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_replicated_gradients_equal_on_every_rank(runs, mesh):
    ranks = _rank_outputs(runs, *mesh)
    prefix = "dropout0/grads/"
    first = ranks[0][1]
    names = [k for k in first if k.startswith(prefix)]
    assert f"{prefix}decoder.rel_bias" in names and len(names) > 10
    for _, arrays in ranks[1:]:
        for k in names:
            np.testing.assert_array_equal(arrays[k], first[k], err_msg=k)
    want = runs["one"]["grads"]
    assert sorted(k[len(prefix):] for k in names) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(first[prefix + k], v, rtol=0,
                                   atol=1e-5 * float(np.abs(v).max()),
                                   err_msg=k)


def test_dropout_step_2x2_equals_one_device(runs):
    ranks = _rank_outputs(runs, 2, 2)
    one = runs["one_dropout"]
    assert one["losses"] != runs["one"]["losses"]  # the masks did act
    for result, _ in ranks:
        np.testing.assert_allclose(result["dropout0.1/losses"],
                                   one["losses"], rtol=RTOL)
    _assert_params(ranks[0][1], one["params"], "dropout0.1/params/", runs,
                   (2, 2))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_engine_mesh_tokens_equal_one_device_and_jax(runs, mesh):
    dp, tp = mesh
    ranks = _rank_outputs(runs, dp, tp)
    one, jax_mesh = runs["engine"], runs["jax_engine"]
    assert one["tokens"] == jax_mesh["tokens"]
    assert [[tuple(n) for n in s] for s in one["notes"]] == \
        [[tuple(n) for n in s] for s in jax_mesh["notes"]]
    for result, _ in ranks:
        eng = result["engine"]
        assert eng["tokens"] == one["tokens"]
        assert eng["notes"] == [[list(n) for n in s] for s in one["notes"]]
        assert all(s["captured"] is False for s in eng["stats"])
        assert all(s["batch_width"] % dp == 0 for s in eng["stats"])
    for d in range(dp):  # a dp rank's tp ranks left the loop together
        steps = {json.dumps([s["loop_steps"] for s in
                             ranks[d * tp + t][0]["engine"]["stats"]])
                 for t in range(tp)}
        assert len(steps) == 1, steps


def test_tp_checkpoint_resumes_on_one_device(runs):
    cfg = child.tiny_config()
    full = {k: torch.from_numpy(v)
            for k, v in child.init_params(0, cfg).items()}
    model = trainable_model(full, cfg, "cpu")
    state = TrainState(model, make_optimizer(model, lr=child.LR))
    ckpt = runs["tmp"] / "out" / "1x2" / "ckpt"
    state, _ = restore_train_state(ckpt, state)
    assert state.step == 1
    state, loss = make_train_step(cfg, child.MEL)(state, child.train_batch())
    one = runs["one"]
    np.testing.assert_allclose(float(loss), one["losses"][1], rtol=RTOL)
    got = {f"p/{k}": v.numpy() for k, v in model.state_dict().items()}
    _assert_params(got, one["params"], "p/", runs, (1, 2))


def test_train_cli_under_torchrun_at_tp2(runs):
    out = runs["outs"]["torchrun"]
    for r in range(2):
        assert f"rank {r}/2: backend gloo device cpu" in out, out[-4000:]
    run = runs["tmp"] / "runs" / "cli"
    records = [json.loads(line) for line in
               (run / "log.jsonl").read_text().splitlines()]
    train = [r for r in records if "train/loss" in r]
    assert [r["step"] for r in train] == [1]  # one writer
    assert np.isfinite(train[0]["train/loss"])
    assert [r for r in records if r.get("done")] == [records[-1]]
    params, _ = restore_params(run / "ckpt" / "step_00000001")
    assert tuple(params["encoder.layers.0.self_attn.q"].shape) == (384, 512)
    assert tuple(params["decoder.layers.1.mlp.wo"].shape) == (128, 384)
    assert sorted(p.name for p in (run / "ckpt").iterdir()) == \
        ["step_00000001"]
