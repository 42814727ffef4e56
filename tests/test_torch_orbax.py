"""The port's orbax reader (``music2midi_tpu_torch/orbax.py``) against
orbax and tensorstore, and the JAX trainer's runs served and resumed in
the port.

  * every key and value of OCDBT stores that ``tensorstore`` writes (small
    nodes, many versions, a numbered manifest, no compression) and that
    ``ocp.StandardCheckpointer`` and the JAX package's
    ``save_train_state`` / ``save_params`` write, byte for byte against
    ``tensorstore.KvStore``; ``read_tree`` against orbax's restore;
  * the model of record at full width through JAX ``load_params_npz`` ->
    ``save_params`` (bfloat16) and ``save_train_state`` (float32): port
    ``restore_params`` equals JAX ``restore_params`` bit for bit, every
    leaf, for the export, the training root and the step dir;
  * a narrow model's JAX train state after 3 steps under
    ``optax.MultiSteps(k=2)`` (mid-cycle, non-zero ``acc_grads``) resumed
    in the port for 3 more steps against JAX's 3 more, at
    ``tests/test_torch_train.py``'s bars, on one device and in 4 gloo
    ranks at (dp, tp) = (2, 2);
  * ``Music2MIDI.from_orbax`` fp32 tokens on the calibration fixture equal
    JAX ``from_orbax``'s;
  * the train CLI's ``--ckpt`` and ``--init_from`` on the JAX directories,
    in a subprocess that blocks what the card's machine lacks (JAX, orbax,
    tensorstore, zstandard among them); the full-width JAX state with a
    plain ``adafactor_hf`` into the port's ``Adafactor``; ``export_npz``
    of a JAX run;
  * refusals that name what is wrong: a mismatched optimizer or model,
    zarr v3, F order, filters, a missing chunk, a multi-process
    checkpoint, a corrupt node.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

from music2midi_tpu.config import default_config as jax_default_config
from music2midi_tpu.infer import Music2MIDI as JaxMusic2MIDI
from music2midi_tpu.models import init_params, t5_config_from
from music2midi_tpu.ops.mel import LogMelConfig as JMelConfig
from music2midi_tpu.train import adafactor_hf
from music2midi_tpu.train import checkpoint as jck
from music2midi_tpu.train import loop as jloop
from music2midi_tpu_torch import orbax
from music2midi_tpu_torch.audio import resample
from music2midi_tpu_torch.calibration import render_fixture
from music2midi_tpu_torch.infer import Music2MIDI
from music2midi_tpu_torch.models import t5 as pt5
from music2midi_tpu_torch.ops.mel import LogMelConfig as PMelConfig
from music2midi_tpu_torch.train import loop as ploop
from music2midi_tpu_torch.train.adafactor import MultiSteps
from music2midi_tpu_torch.train.checkpoint import restore_train_state
from music2midi_tpu_torch.weights import params_from_jax, restore_params
from test_torch_train import _write_corpus

ROOT = Path(__file__).resolve().parent.parent
RECORD = ROOT / "checkpoints" / "model_of_record.npz"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
           "zstandard", "ml_dtypes", "yaml", "omegaconf", "transformers",
           "music2midi_tpu", "wandb")
NARROW = dict(num_layers=1, num_decoder_layers=1, d_model=64, d_ff=64)
MEL = dict(n_fft=256, hop_length=128, n_mels=64)
LR, EVERY_K = 0.01, 2
CHILD_TIMEOUT = 240


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_config():
    cfg = jax_default_config()
    for k, v in NARROW.items():
        cfg.model.t5[k] = v
    cfg.trainer.accumulate_grad_batches = EVERY_K
    cfg.dataloader.batch_size = 2
    cfg.dataloader.num_workers = 0
    cfg.trainer.log_every_n_steps = 1
    return cfg


def _batches(n: int):
    rng = np.random.default_rng(7)
    labels = jloop.pad_labels(
        [np.array([140, 3, 60, 150, 4, 60, 2]), np.array([135, 3, 70, 2])])
    cond = np.array([[1, 0], [5, 2]], np.int32)
    return [((rng.normal(size=(2, 4096)) * 0.1).astype(np.float32), labels,
             cond) for _ in range(n)]


def _port_state(sd, cfg, mesh=None):
    model = ploop.trainable_model(sd, cfg, "cpu", mesh)
    opt = ploop.make_optimizer(model, lr=LR, warmup_init=False)
    return ploop.TrainState(model, MultiSteps(opt, EVERY_K))


# ------------------------------------------------------------------ #
# the JAX run, the children that resume it, and the model of record   #
# ------------------------------------------------------------------ #

_MESH_CHILD = r"""
import json, sys
from pathlib import Path
BLOCKED = set(json.loads(sys.argv[1]))

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked on the card's machine: {name}")
        return None

sys.meta_path.insert(0, _Blocker())
import numpy as np, torch
torch.set_num_threads(1)
from music2midi_tpu_torch.models import t5 as pt5
from music2midi_tpu_torch.ops.mel import LogMelConfig
from music2midi_tpu_torch.parallel import maybe_initialize_distributed
from music2midi_tpu_torch.parallel.distributed import shutdown
from music2midi_tpu_torch.parallel.mesh import gather_params, make_mesh
from music2midi_tpu_torch.train import loop as ploop
from music2midi_tpu_torch.train.adafactor import MultiSteps
from music2midi_tpu_torch.train.checkpoint import restore_train_state
from music2midi_tpu_torch.weights import restore_params

spec = json.loads(sys.argv[2])
info = maybe_initialize_distributed(device="cpu",
                                    init_method=f"file://{spec['store']}")
mesh = make_mesh(2, 2, "cpu")
sd, config = restore_params(spec["ckpt"])
cfg = pt5.t5_config_from(config)._replace(dropout_rate=0.0)
model = ploop.trainable_model(sd, cfg, "cpu", mesh)
opt = ploop.make_optimizer(model, lr=spec["lr"], warmup_init=False)
state = ploop.TrainState(model, MultiSteps(opt, spec["every_k"]))
state, _ = restore_train_state(spec["ckpt"], state, mesh)
step = ploop.make_train_step(cfg, LogMelConfig(**spec["mel"]), mesh)
data = np.load(spec["batches"])
losses = []
for i in range(3):
    b = ploop.Batch(data[f"wave{i}"], data[f"labels{i}"], data[f"cond{i}"])
    state, loss = step(state, b, 0)
    losses.append(float(loss))
params = gather_params(state.model.state_dict(), mesh)
if info.rank == 0:
    out = Path(spec["out"])
    out.write_text(json.dumps({"losses": losses, "step": state.step,
                               "mini_step": state.optimizer.mini_step}))
    np.savez(out.with_suffix(".npz"),
             **{k: v.numpy() for k, v in params.items()})
print(f"rank {info.rank}: ok", flush=True)
shutdown()
"""

_CLI_CHILD = r"""
import json, sys
BLOCKED = set(json.loads(sys.argv[1]))

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked on the card's machine: {name}")
        return None

sys.meta_path.insert(0, _Blocker())
from music2midi_tpu_torch.train.__main__ import main
for argv in json.loads(sys.argv[2]):
    main(argv)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX run (3 steps, saved, then 3 more) and the model of
    record's orbax directories, made here while the 4 gloo ranks and the
    CLI run resume the saved state in their own processes."""
    tmp = tmp_path_factory.mktemp("orbax")
    config = _jax_config()
    jcfg = t5_config_from(config)._replace(dropout_rate=0.0)
    params = init_params(jax.random.PRNGKey(0), jcfg)
    opt = optax.MultiSteps(adafactor_hf(learning_rate=LR, warmup_init=False),
                           every_k_schedule=EVERY_K)
    step = jloop.make_train_step(opt, jcfg, JMelConfig(**MEL), donate=False)
    state = jloop.init_train_state(params, opt)
    batches = _batches(6)
    for b in batches[:3]:
        state, _ = step(state, jloop.Batch(*b), jax.random.PRNGKey(0))
    run = tmp / "jax_run"
    jck.save_train_state(run, state, config)
    jck.save_params(tmp / "jax_export", state.params, config)
    np.savez(tmp / "batches.npz", **{
        f"{name}{i}": a for i, b in enumerate(batches[3:])
        for name, a in zip(("wave", "labels", "cond"), b)})

    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT)}
    procs = []
    spec = {"store": str(tmp / "store"), "ckpt": str(run), "lr": LR,
            "every_k": EVERY_K, "mel": MEL, "batches": str(tmp / "batches.npz"),
            "out": str(tmp / "mesh.json")}
    for r in range(4):
        procs.append((f"rank {r}", subprocess.Popen(
            [sys.executable, "-c", _MESH_CHILD, json.dumps(BLOCKED),
             json.dumps(spec)],
            env={**env, "RANK": str(r), "WORLD_SIZE": "4"}, cwd=tmp,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    data = tmp / "data"
    _write_corpus(data, n_songs=2)
    cfg_path = tmp / "config.json"
    cfg_path.write_text(json.dumps(config.to_dict()))
    common = [str(data), "--device", "cpu", "--config", str(cfg_path),
              "--out_dir", str(tmp / "runs"), "--lr", str(LR)]
    procs.append(("cli", subprocess.Popen(
        [sys.executable, "-c", _CLI_CHILD, json.dumps(BLOCKED), json.dumps([
            common + ["--name", "resumed", "--ckpt", str(run),
                      "--max_steps", "5"],
            common + ["--name", "warm", "--init_from", str(tmp / "jax_export"),
                      "--max_steps", "1"]])],
        env=env, cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)))
    try:
        jlosses = []
        for b in batches[3:]:
            state, loss = step(state, jloop.Batch(*b), jax.random.PRNGKey(0))
            jlosses.append(float(loss))
        record = _record_dirs(tmp / "record")
        outs = {}
        for label, p in procs:
            out, _ = p.communicate(timeout=CHILD_TIMEOUT)
            outs[label] = out
            assert p.returncode == 0, f"{label} failed:\n{out[-6000:]}"
    finally:
        for _, p in procs:
            p.kill()
            p.communicate()
    return {"tmp": tmp, "run": run, "export": tmp / "jax_export",
            "batches": batches, "jax_losses": jlosses,
            "jax_params": params_from_jax(jax.tree.map(np.asarray,
                                                       state.params)),
            "record": record, "outs": outs}


def _record_dirs(root: Path) -> dict:
    """The model of record as a JAX ``save_params`` export (its bfloat16
    weights) and as a JAX training root (float32 masters, a fresh
    Adafactor state)."""
    params, cfg = jck.load_params_npz(RECORD)
    jck.save_params(root / "export", params, cfg)
    f32 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    state = jloop.init_train_state(f32, adafactor_hf())
    jck.save_train_state(root / "run", state, cfg)
    return {"export": root / "export", "run": root / "run",
            "step": root / "run" / "step_00000000"}


# ------------------------------------------------------------------ #
# the key-value store and the tree                                    #
# ------------------------------------------------------------------ #

def _ocdbt_spec(path: Path, config=None) -> dict:
    """tensorstore's spec of the OCDBT store at ``path``."""
    spec = ts.KvStore.Spec(f"file://{path}/|ocdbt:").to_json()
    return {**spec, "config": config} if config else spec


def _tensorstore_kv(path: Path) -> dict:
    kv = ts.KvStore.open(_ocdbt_spec(path)).result()
    return {k: kv.read(k).result().value for k in kv.list().result()}


def _assert_same_store(path: Path) -> None:
    want = _tensorstore_kv(path)
    got = orbax.open_kvstore(path)
    assert list(got) == sorted(want)
    for k, v in want.items():
        assert got[k] == v, k
    assert any(isinstance(got.ref(k), orbax.ValueRef) for k in got)


def _mixed_tree():
    rng = np.random.default_rng(0)
    return {
        "w": rng.normal(size=(40, 50)).astype(np.float32),
        "bf": rng.normal(size=(33, 17)).astype(ml_dtypes.bfloat16),
        "half": rng.normal(size=7).astype(np.float16),
        "ints": [np.arange(600, dtype=np.int32), np.int32(-5),
                 {"u8": np.arange(256, dtype=np.uint8),
                  "i64": np.arange(-3, 300, dtype=np.int64)}],
        "step": np.int32(7),
        "scalar": np.float32(0.25),
    }


def test_kvstore_matches_tensorstore(tmp_path):
    # StandardCheckpointer's own layout, over every dtype the trainer saves
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(tmp_path / "std", _mixed_tree())
    ckptr.wait_until_finished()
    _assert_same_store(tmp_path / "std")
    # interior B+tree nodes, out-of-line values, a version tree with
    # nodes below the manifest (12 generations at arity 4)
    small = {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 20,
             "version_tree_arity_log2": 2}
    for name, config in (("small", small),
                         ("numbered", {"manifest_kind": "numbered",
                                       "compression": None})):
        kv = ts.KvStore.open(_ocdbt_spec(tmp_path / name, config)).result()
        for c in range(7):
            with ts.Transaction() as txn:
                for i in range(30):
                    kv.with_transaction(txn)[f"k{c:02d}_{i:03d}".encode()] = (
                        b"v%d_%d" % (c, i)) * (1 + (i % 5) * 8)
        kv[b"k00_000"] = b"rewritten " * 9  # a later version of a key
        _assert_same_store(tmp_path / name)
    assert orbax.open_kvstore(tmp_path / "small").generation > 8
    assert len(list((tmp_path / "numbered").glob("manifest.0*"))) > 1


def test_jax_written_stores_match_tensorstore(world):
    for path in (world["run"] / "step_00000003" / "state",
                 world["export"] / "params", world["record"]["export"]
                 / "params"):
        _assert_same_store(path)


def test_read_tree_matches_orbax_restore(tmp_path):
    tree = _mixed_tree()
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(tmp_path / "std", tree)
    ckptr.wait_until_finished()
    want = ckptr.restore(tmp_path / "std")
    got = orbax.read_tree(tmp_path / "std")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = params_from_jax(got)
    assert len(flat_w) == len(flat_g)
    for kpath, leaf in flat_w:
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", None)))
                       for k in kpath)
        a, t = np.asarray(leaf), flat_g[key]
        assert tuple(t.shape) == a.shape, key
        if a.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16, key
            assert t.view(torch.int16).numpy().tobytes() == a.tobytes(), key
        else:
            assert t.numpy().dtype == a.dtype and np.array_equal(
                t.numpy(), a), key
    assert isinstance(got["ints"], list) and got["step"].shape == ()
    sub = orbax.read_tree(tmp_path / "std", under=("ints", "2"))
    assert set(sub) == {"u8", "i64"}
    assert np.array_equal(orbax.read_array(orbax.open_kvstore(
        tmp_path / "std"), "w"), tree["w"])


@pytest.mark.parametrize("layout", ["export", "run", "step"])
def test_restore_params_equals_jax_at_full_width(world, layout):
    path = world["record"][layout]
    got, cfg = restore_params(path)
    want, jcfg = jck.restore_params(path)
    assert cfg.to_dict() == jcfg.to_dict()
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(got) > 100
    for kpath, leaf in flat:
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", None)))
                       for k in kpath)
        a, t = np.asarray(leaf), got[key]
        assert str(t.dtype).split(".")[1] == a.dtype.name, key
        bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        assert bits.numpy().tobytes() == a.tobytes(), key


# ------------------------------------------------------------------ #
# resuming the JAX run                                                #
# ------------------------------------------------------------------ #

def _assert_params(got, want, rtol=2e-5, atol=5e-6):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), want[k].numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


def test_resumed_jax_multisteps_state_matches_jax(world):
    sd, config = restore_params(world["run"])
    cfg = pt5.t5_config_from(config)._replace(dropout_rate=0.0)
    state, saved_cfg = restore_train_state(world["run"], _port_state(sd, cfg))
    assert saved_cfg.to_dict() == config.to_dict()
    assert state.step == 3 and state.optimizer.mini_step == 1
    assert {s["step"] for s in state.optimizer.inner.state.values()} == {1}
    assert all(float(a.abs().max()) > 0 for a in state.optimizer.acc)
    step = ploop.make_train_step(cfg, PMelConfig(**MEL))
    losses = []
    for b in world["batches"][3:]:
        state, loss = step(state, ploop.Batch(*b), 0)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, world["jax_losses"], rtol=1e-5)
    _assert_params({k: v.detach().numpy() for k, v in
                    state.model.state_dict().items()}, world["jax_params"])
    assert state.optimizer.mini_step == 0 and state.step == 6


def test_resumed_under_a_2x2_mesh_matches_jax(world):
    for r in range(4):
        assert f"rank {r}: ok" in world["outs"][f"rank {r}"]
    res = json.loads((world["tmp"] / "mesh.json").read_text())
    assert res["step"] == 6 and res["mini_step"] == 0
    np.testing.assert_allclose(res["losses"], world["jax_losses"], rtol=1e-5)
    with np.load(world["tmp"] / "mesh.npz") as z:
        _assert_params({k: z[k] for k in z.files}, world["jax_params"])


def test_train_cli_resumes_and_warm_starts_from_jax_dirs(world):
    out = world["outs"]["cli"]
    assert f"resumed from {world['run']} at step 3" in out, out[-4000:]
    assert f"warm start: params from {world['export']}" in out, out[-4000:]
    runs = world["tmp"] / "runs"
    records = [json.loads(line) for line in
               (runs / "resumed" / "log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "train/loss" in r] == [4, 5]
    assert (runs / "resumed" / "ckpt" / "step_00000005" / "state.pt").exists()
    assert (runs / "warm" / "ckpt" / "step_00000001" / "state.pt").exists()


def test_resume_refuses_a_different_optimizer_or_model(world):
    sd, config = restore_params(world["run"])
    cfg = pt5.t5_config_from(config)
    model = ploop.trainable_model(sd, cfg, "cpu")
    plain = ploop.TrainState(model, ploop.make_optimizer(model, lr=LR))
    with pytest.raises(ValueError, match="opt_state.inner_opt_state: an "
                                         "optax.MultiSteps state"):
        restore_train_state(world["run"], plain)
    deeper = cfg._replace(num_layers=2)
    sd2 = {k: torch.from_numpy(v)
           for k, v in pt5.init_params(0, deeper).items()}
    with pytest.raises(ValueError, match=r"encoder\.layers\.1\."):
        restore_train_state(world["run"], _port_state(sd2, deeper))


def test_plain_adafactor_state_at_full_width(world):
    """The model of record's JAX state with a plain ``adafactor_hf`` (no
    MultiSteps), into the port's ``Adafactor`` at full width."""
    sd, config = restore_params(world["record"]["run"])
    cfg = pt5.t5_config_from(config)
    model = ploop.trainable_model(sd, cfg, "cpu")
    state = ploop.TrainState(model, ploop.make_optimizer(model))
    state, _ = restore_train_state(world["record"]["run"], state)
    assert state.step == 0
    params = dict(model.named_parameters())
    for p, st in state.optimizer.state.items():
        assert st["step"] == 0
        if p.ndim >= 2:
            assert st["row"].shape == p.shape[:-1]
            assert st["col"].shape == p.shape[:-2] + p.shape[-1:]
        else:
            assert st["v"].shape == p.shape
        assert all(float(st[k].abs().max()) == 0 for k in ("row", "col", "v")
                   if k in st)
    assert len(state.optimizer.state) == len(params)


def test_export_npz_of_a_jax_run(world, tmp_path):
    from music2midi_tpu_torch.tools import export_npz
    from music2midi_tpu_torch.weights import load_npz

    export_npz.main([str(tmp_path / "run.npz"), str(world["run"]),
                     "--dtype", "float32"])
    got, cfg = load_npz(tmp_path / "run.npz")
    want, want_cfg = restore_params(world["run"])
    assert cfg.to_dict() == want_cfg.to_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


# ------------------------------------------------------------------ #
# serving the JAX run                                                 #
# ------------------------------------------------------------------ #

def test_from_orbax_fp32_tokens_equal_jax(world):
    wave = resample(*render_fixture(), 16000)
    export = world["record"]["export"]
    # the fixture's rows end by step 43 (tests/test_torch_pipeline.py): a
    # 64-token cap changes no token
    mine = Music2MIDI.from_orbax(export, device="cpu", decode_max_length=64)
    ref = JaxMusic2MIDI.from_orbax(export, use_compilation_cache=False,
                                   decode_max_length=64)
    got = mine.sample_tokens_batched(mine._chunk_waveform(wave))
    want = ref.sample_tokens_batched(ref._chunk_waveform(wave))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mine.sample_notes(wave),
                                  ref.sample_notes(wave))


# ------------------------------------------------------------------ #
# refusals                                                            #
# ------------------------------------------------------------------ #

def _zarray(**over) -> bytes:
    meta = {"chunks": [2, 2], "compressor": None, "dtype": "<f4",
            "fill_value": None, "filters": None, "order": "C",
            "shape": [3, 4], "zarr_format": 2, **over}
    return json.dumps(meta).encode()


def test_zarr_reader_assembles_chunks_and_refuses_the_rest():
    full = np.arange(12, dtype=np.float32).reshape(3, 4)
    kv = {b"a/.zarray": _zarray()}
    for i in range(2):
        for j in range(2):
            chunk = np.zeros((2, 2), np.float32)
            part = full[2 * i:2 * i + 2, 2 * j:2 * j + 2]
            chunk[:part.shape[0], :part.shape[1]] = part
            kv[f"a/{i}.{j}".encode()] = chunk.tobytes()
    assert np.array_equal(orbax.read_array(kv, "a"), full)
    big = {**kv, b"a/.zarray": _zarray(dtype=">f4")}
    big.update({k: np.frombuffer(v, "<f4").astype(">f4").tobytes()
                for k, v in kv.items() if not k.endswith(b".zarray")})
    assert np.array_equal(orbax.read_array(big, "a"), full)
    for over, match in (({"zarr_format": 3}, "zarr_format 3"),
                        ({"order": "F"}, "order 'F'"),
                        ({"filters": [{"id": "delta"}]}, "filters"),
                        ({"compressor": {"id": "blosc"}}, "'blosc'")):
        with pytest.raises(ValueError, match=match):
            orbax.read_array({**kv, b"a/.zarray": _zarray(**over)}, "a")
    del kv[b"a/1.0"]
    with pytest.raises(ValueError, match=r"a/1\.0: chunk missing"):
        orbax.read_array(kv, "a")
    with pytest.raises(ValueError, match="zarr v3"):
        orbax.read_array({b"b/zarr.json": b"{}"}, "b")


def test_multi_process_and_corrupt_checkpoints_raise(world, tmp_path):
    src = world["export"] / "params"
    multi = tmp_path / "multi"
    shutil.copytree(src, multi)
    (multi / "ocdbt.process_1").mkdir()
    with pytest.raises(ValueError, match="written by 2 processes"):
        orbax.open_kvstore(multi)
    bad = tmp_path / "bad"
    shutil.copytree(src, bad)
    node = next((bad / "d").iterdir())
    blob = bytearray(node.read_bytes())
    blob[20] ^= 0x10
    node.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="CRC32C mismatch"):
        orbax.open_kvstore(bad)
    with pytest.raises(FileNotFoundError, match="no checkpoint under"):
        restore_params(tmp_path / "nothing")
