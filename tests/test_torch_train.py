"""The port's training path against the JAX package's (fp32, CPU).

Small model (2 + 2 layers, d_ff 128, n_fft 256 / hop 128, as
``tests/test_train.py::tiny_setup``); inputs made from a numpy seed and
passed between the packages as numpy arrays.  Bars:

  * ``t5_forward`` with dropout 0: loss within 1e-5 absolute, logits
    within 1e-5, autograd's gradient of every leaf within rtol 1e-4 /
    atol 1e-6 of ``jax.value_and_grad``'s (fp32; summation order apart);
  * ``shift_right`` equal; ``cross_entropy_loss`` within 1e-6 relative,
    and exactly 0 on an all-ignored batch;
  * bf16 mixed precision: loss within 2e-2 relative of JAX's bf16 mode;
  * dropout held to its distribution, not to JAX's bits: keep share
    0.9 +- 0.01, kept entries scaled by 1/0.9; one generator seed gives
    one loss; ``deterministic=True`` equals rate 0;
  * 5 train steps from the same parameters (fixed lr 0.01, and the
    reference's relative step with warm-up) against JAX
    ``make_train_step``: losses within rtol 1e-5, parameters within rtol
    2e-5 / atol 5e-6, and each leaf's movement over the 5 steps within
    rtol 1e-4 and 1e-3 of its largest.  The warm-up's first steps move a
    parameter by ~1e-6 x RMS, a few float32 ulps, too little to compare
    at such a bar (``tests/test_torch_adafactor.py`` holds them update
    by update), so the warm-up run takes its 5 steps from an optimizer
    at step 3000 (both sides; fresh moments), where the warm-up step
    3e-3 x RMS is still the smaller of the two;
  * accumulation k = 2 against ``optax.MultiSteps`` at the same bars;
  * the multi-step equal to the single steps, and a dropout run resumed
    from a checkpoint at step 3 equal to an unbroken 5-step run, bit for
    bit (the same CPU arithmetic);
  * the eval step within 1e-5 of JAX ``make_eval_step``;
  * the train CLI in a subprocess that blocks the imports the card's
    machine lacks: 3 steps write ``log.jsonl`` and ``step_00000003``, and
    ``--ckpt`` resumes to step 5.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from music2midi_tpu.config import default_config
from music2midi_tpu.models import init_params, t5_config_from
from music2midi_tpu.models import t5 as jt5
from music2midi_tpu.ops.mel import LogMelConfig as JMelConfig
from music2midi_tpu.ops.mel import log_mel_spectrogram as jax_mel
from music2midi_tpu.train import adafactor_hf
from music2midi_tpu.train import loop as jloop
from music2midi_tpu_torch.models import t5 as pt5
from music2midi_tpu_torch.ops.mel import LogMelConfig as PMelConfig
from music2midi_tpu_torch.ops.mel import log_mel_spectrogram as port_mel
from music2midi_tpu_torch.train import loop as ploop
from music2midi_tpu_torch.train.adafactor import Adafactor, MultiSteps
from music2midi_tpu_torch.train.checkpoint import (
    restore_train_state,
    save_train_state,
)
from music2midi_tpu_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
MEL = dict(n_fft=256, hop_length=128, n_mels=384)
TINY = dict(num_layers=2, num_decoder_layers=2, d_ff=128)
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "yaml",
           "omegaconf", "transformers", "music2midi_tpu", "wandb")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfgs(dropout=0.0, dtype="float32"):
    jcfg = t5_config_from(default_config())._replace(
        dropout_rate=dropout, dtype=getattr(jnp, dtype), **TINY)
    pcfg = pt5.T5Config(**{**jcfg._asdict(), "dtype": getattr(torch, dtype)})
    return jcfg, pcfg


@pytest.fixture(scope="module")
def setup():
    params = init_params(jax.random.PRNGKey(0), _cfgs()[0])
    rng = np.random.default_rng(0)
    wave = rng.normal(size=(2, 4096)).astype(np.float32) * 0.1
    labels = jloop.pad_labels(
        [np.array([140, 3, 60, 150, 4, 60, 2]), np.array([135, 3, 70, 2])])
    cond = np.array([[1, 0], [5, 2]], np.int32)
    return params, wave, labels, cond


def _model(params, pcfg):
    return ploop.trainable_model(params_from_jax(params), pcfg, "cpu")


def _jax_loss(params, wave, labels, cond, jcfg):
    mel = jax.lax.stop_gradient(jax_mel(wave, JMelConfig(**MEL)))
    embeds = jt5.conditioning_prepend(params, mel, cond)
    return jt5.t5_forward(params, embeds, labels, jcfg)


def _port_loss(model, wave, labels, cond, pcfg, deterministic=True,
               generator=None):
    b = ploop.to_device(ploop.Batch(wave, labels, cond), "cpu")
    with torch.no_grad():
        mel = port_mel(b.waveform, PMelConfig(**MEL))
    embeds = pt5.conditioning_prepend(model, mel, b.cond_index)
    return pt5.t5_forward(model, embeds, b.labels, pcfg, deterministic,
                          generator)


def test_t5_forward_loss_logits_and_grads_match_jax(setup):
    params, wave, labels, cond = setup
    jcfg, pcfg = _cfgs()

    def jloss(p):
        return _jax_loss(p, wave, labels, cond, jcfg)

    (jl, jlogits), jgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    model = _model(params, pcfg)
    loss, logits = _port_loss(model, wave, labels, cond, pcfg)
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-5)
    want = params_from_jax(jgrads)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_decoder_attention_mask_matches_jax(setup):
    """``decoder_attention_mask`` (keys with 0 masked, on top of causal):
    logits within 1e-5 of JAX ``decoder_forward``'s."""
    params = setup[0]
    jcfg, pcfg = _cfgs()
    rng = np.random.default_rng(6)
    enc = rng.normal(size=(2, 11, 384)).astype(np.float32)
    ids = rng.integers(3, 400, size=(2, 7))
    mask = np.ones((2, 7), np.int32)
    mask[0, 4:] = 0
    mask[1, 2] = 0
    want = jt5.decoder_forward(params, jnp.asarray(ids), jnp.asarray(enc),
                               jcfg, decoder_attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = pt5.decoder_forward(
            _model(params, pcfg), torch.from_numpy(ids),
            torch.from_numpy(enc), pcfg,
            decoder_attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_shift_right_and_cross_entropy_on_ignored_rows():
    jcfg, pcfg = _cfgs()
    rng = np.random.default_rng(1)
    labels = rng.integers(3, 400, size=(4, 9)).astype(np.int32)
    labels[0, 5:] = -100
    labels[1, :] = -100  # a row with nothing to score
    labels[3, 0] = -100
    logits = rng.normal(size=(4, 9, 400)).astype(np.float32) * 3
    np.testing.assert_array_equal(
        pt5.shift_right(torch.from_numpy(labels), pcfg).numpy(),
        np.asarray(jt5.shift_right(jnp.asarray(labels), jcfg)))
    got = float(pt5.cross_entropy_loss(torch.from_numpy(logits),
                                       torch.from_numpy(labels)))
    want = float(jt5.cross_entropy_loss(jnp.asarray(logits),
                                        jnp.asarray(labels)))
    assert got == pytest.approx(want, rel=1e-6)
    none = np.full_like(labels, -100)
    assert float(pt5.cross_entropy_loss(torch.from_numpy(logits),
                                        torch.from_numpy(none))) == 0.0
    assert float(jt5.cross_entropy_loss(jnp.asarray(logits),
                                        jnp.asarray(none))) == 0.0


def test_bf16_loss_matches_jax_bf16(setup):
    params, wave, labels, cond = setup
    jcfg, pcfg = _cfgs(dtype="bfloat16")
    jl, _ = jax.jit(lambda p: _jax_loss(p, wave, labels, cond, jcfg))(params)
    with torch.no_grad():
        loss, logits = _port_loss(_model(params, pcfg), wave, labels, cond,
                                  pcfg)
    assert logits.dtype == torch.bfloat16
    assert float(loss) == pytest.approx(float(jl), rel=2e-2)


def test_dropout_distribution_and_scale():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = pt5.dropout(x, 0.1, g)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) <= 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.9))
    yb = pt5.dropout(x.bfloat16(), 0.1, g)
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb[yb != 0].float(),
                       torch.full_like(yb[yb != 0].float(),
                                       float(torch.tensor(1.0).bfloat16()
                                             / 0.9)))
    assert pt5.dropout(x, 0.1, None) is x
    assert pt5.dropout(x, 0.0, g) is x


def test_dropout_seeded_and_deterministic(setup):
    params, wave, labels, cond = setup
    _, pcfg = _cfgs(dropout=0.1)
    model = _model(params, pcfg)

    def loss(seed=None, deterministic=False, cfg=pcfg):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return float(_port_loss(model, wave, labels, cond, cfg,
                                    deterministic, g)[0])

    assert loss(5) == loss(5)
    assert loss(5) != loss(6)
    _, rate0 = _cfgs(dropout=0.0)
    assert loss(deterministic=True) == loss(7, cfg=rate0)
    with pytest.raises(ValueError, match="Generator"):
        loss(None)


def _jax_run(params, opt, batches, dropout=0.0, opt_step=0):
    jcfg, _ = _cfgs(dropout=dropout)
    step = jloop.make_train_step(opt, jcfg, JMelConfig(**MEL), donate=False)
    state = jloop.init_train_state(params, opt)
    if opt_step:
        state = state._replace(opt_state=state.opt_state._replace(
            step=jnp.asarray(opt_step, jnp.int32)))
    losses = []
    for b in batches:
        state, loss = step(state, jloop.Batch(*b), jax.random.PRNGKey(0))
        losses.append(float(loss))
    return params_from_jax(state.params), losses


def _port_state(params, pcfg, lr, warmup_init=True, every_k=1, opt_step=0):
    model = _model(params, pcfg)
    opt = Adafactor(list(model.parameters()), lr=lr, warmup_init=warmup_init)
    if opt_step:  # fresh moments at opt_step, as _jax_run's
        saved = opt.state_dict()
        saved["state"] = {
            i: {"step": opt_step, **(
                {"row": torch.zeros(p.shape[:-1]),
                 "col": torch.zeros(p.shape[:-2] + p.shape[-1:])}
                if p.ndim >= 2 else {"v": torch.zeros(p.shape)})}
            for i, p in enumerate(model.parameters())}
        opt.load_state_dict(saved)
    if every_k > 1:
        opt = MultiSteps(opt, every_k)
    return ploop.TrainState(model, opt)


def _port_run(state, pcfg, batches, seed=0):
    step = ploop.make_train_step(pcfg, PMelConfig(**MEL))
    losses = []
    for b in batches:
        state, loss = step(state, ploop.Batch(*b), seed)
        losses.append(float(loss))
    return state, losses


def _assert_params(model, want, rtol=2e-5, atol=5e-6):
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


def _batches(setup, n, seed=3):
    _, wave, labels, cond = setup
    rng = np.random.default_rng(seed)
    return [(wave + rng.normal(size=wave.shape).astype(np.float32) * 0.01,
             labels, cond) for _ in range(n)]


@pytest.mark.parametrize("lr", [0.01, None])
def test_five_train_steps_match_jax(setup, lr):
    params = setup[0]
    _, pcfg = _cfgs()
    batches = _batches(setup, 5)
    warmup = lr is None
    opt_step = 3000 if warmup else 0
    assert 1e-6 * (opt_step + 5) < (opt_step + 5) ** -0.5  # still warming
    want, jlosses = _jax_run(
        params, adafactor_hf(learning_rate=lr, warmup_init=warmup), batches,
        opt_step=opt_step)
    state, losses = _port_run(
        _port_state(params, pcfg, lr, warmup, opt_step=opt_step), pcfg,
        batches)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert state.step == 5
    _assert_params(state.model, want)
    init = params_from_jax(params)
    for k, p in state.model.named_parameters():
        moved = want[k].numpy() - init[k].numpy()
        assert np.abs(moved).max() > 0, k
        np.testing.assert_allclose(p.detach().numpy() - init[k].numpy(),
                                   moved, rtol=1e-4,
                                   atol=1e-3 * np.abs(moved).max(),
                                   err_msg=k)
    opt_steps = {s["step"] for s in state.optimizer.state.values()}
    assert opt_steps == {opt_step + 5}


def test_accumulation_matches_optax_multisteps(setup):
    params = setup[0]
    _, pcfg = _cfgs()
    batches = _batches(setup, 4, seed=5)
    opt = optax.MultiSteps(adafactor_hf(learning_rate=0.01,
                                        warmup_init=False),
                           every_k_schedule=2)
    want, jlosses = _jax_run(params, opt, batches)
    state, losses = _port_run(_port_state(params, pcfg, 0.01, False, 2),
                              pcfg, batches)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _assert_params(state.model, want)
    inner = state.optimizer.inner
    assert {s["step"] for s in inner.state.values()} == {2}
    assert state.step == 4


def test_multi_step_equals_single_steps(setup):
    params = setup[0]
    _, pcfg = _cfgs(dropout=0.1)
    batches = _batches(setup, 3, seed=9)
    single, losses = _port_run(_port_state(params, pcfg, 0.01, False),
                               pcfg, batches, seed=4)
    multi = _port_state(params, pcfg, 0.01, False)
    stacked = ploop.Batch(*(np.stack(leaf) for leaf in zip(*batches)))
    multi, mlosses = ploop.make_multi_step(pcfg, PMelConfig(**MEL))(
        multi, stacked, 4)
    assert mlosses.tolist() == losses
    assert multi.step == single.step == 3
    for (k, a), b in zip(single.model.named_parameters(),
                         multi.model.parameters()):
        assert torch.equal(a, b), k


def test_resumed_dropout_run_equals_unbroken_run(setup, tmp_path):
    params = setup[0]
    _, pcfg = _cfgs(dropout=0.1)
    batches = _batches(setup, 5, seed=11)
    unbroken, losses = _port_run(_port_state(params, pcfg, None), pcfg,
                                 batches, seed=2)
    first, first_losses = _port_run(_port_state(params, pcfg, None), pcfg,
                                    batches[:3], seed=2)
    save_train_state(tmp_path / "ckpt", first)
    resumed, _ = restore_train_state(tmp_path / "ckpt",
                                     _port_state(params, pcfg, None))
    assert resumed.step == 3
    resumed, rest = _port_run(resumed, pcfg, batches[3:], seed=2)
    assert first_losses + rest == losses
    for (k, a), b in zip(unbroken.model.named_parameters(),
                         resumed.model.parameters()):
        assert torch.equal(a, b), k


def test_eval_step_matches_jax(setup):
    params, wave, labels, cond = setup
    jcfg, pcfg = _cfgs(dropout=0.1)
    want = jloop.make_eval_step(jcfg, JMelConfig(**MEL))(
        params, jloop.Batch(wave, labels, cond))
    got = ploop.make_eval_step(pcfg, PMelConfig(**MEL))(
        _model(params, pcfg), ploop.Batch(wave, labels, cond))
    assert not got.requires_grad
    assert abs(float(got) - float(want)) <= 1e-5


def test_pad_labels_matches_jax():
    rows = [np.array([5, 6, 7]), np.array([9]), np.array([1, 2, 3, 4])]
    np.testing.assert_array_equal(ploop.pad_labels(rows),
                                  jloop.pad_labels(rows))


# --------------------------------------------------------------------- #
# the CLI                                                                #
# --------------------------------------------------------------------- #


def _write_corpus(root: Path, n_songs=4, seconds=7.0, sr=22050, seed=0):
    from music2midi_tpu_torch.audio import write_wav

    rng = np.random.default_rng(seed)
    for d in ("audio", "midi_numpy", "metadata"):
        (root / d).mkdir(parents=True, exist_ok=True)
    ids = [f"song{i}" for i in range(n_songs)]
    for pid in ids:
        onsets = np.sort(rng.uniform(0, seconds - 0.5, size=24))
        notes = np.stack([onsets, onsets + rng.uniform(0.1, 0.5, 24),
                          rng.integers(48, 80, 24), np.full(24, 80)], 1)
        np.save(root / "midi_numpy" / f"{pid}.npy", notes)
        write_wav(root / "audio" / f"{pid}.wav",
                  (rng.normal(size=int(seconds * sr)) * 0.1).astype(
                      np.float32), sr)
        with open(root / "metadata" / f"{pid}.yaml", "w") as f:
            yaml.safe_dump({"piano": {
                "id": pid, "genre": "pop", "difficulty": "beginner"}}, f)
    np.savez(root / "dataset_split.npz", train_id=np.array(ids),
             val_id=np.array(ids[:2]), test_id=np.array(ids[2:]))


_CLI = r"""
import json, runpy, sys
BLOCKED = set(json.loads(sys.argv[1]))

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked on the card's machine: {name}")
        return None

sys.meta_path.insert(0, _Blocker())
sys.argv = ["train"] + sys.argv[2:]
runpy.run_module("music2midi_tpu_torch.train", run_name="__main__")
"""


def test_train_cli_runs_and_resumes(tmp_path):
    data = tmp_path / "data"
    _write_corpus(data)
    cfg = default_config().to_dict()
    cfg["model"]["t5"].update(TINY)
    cfg["dataloader"].update(batch_size=2, num_workers=0)
    cfg["trainer"].update(log_every_n_steps=1)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    common = [str(data), "--device", "cpu", "--config", str(cfg_path),
              "--out_dir", str(tmp_path / "runs"), "--name", "cli"]

    def run(*extra):
        proc = subprocess.run(
            [sys.executable, "-c", _CLI, json.dumps(BLOCKED), *common,
             *extra],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env={**os.environ, "OMP_NUM_THREADS": "2"})
        assert proc.returncode == 0, proc.stderr[-4000:]
        return proc

    run("--max_steps", "3", "--eval_in_train")
    out = tmp_path / "runs" / "cli"
    ckpt = out / "ckpt"
    assert (ckpt / "step_00000003" / "state.pt").exists()
    assert (ckpt / "step_00000003" / "config.json").exists()
    records = [json.loads(line) for line in
               (out / "log.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert all(0.0 <= r["train/score"] <= 1.0 for r in records
               if "train/score" in r)
    assert any("val/loss" in r for r in records)
    assert records[-1] == {**records[-1], "step": 3, "done": True}

    run("--max_steps", "5", "--ckpt", str(ckpt))
    assert (ckpt / "step_00000005" / "state.pt").exists()
    records = [json.loads(line) for line in
               (out / "log.jsonl").read_text().splitlines()]
    assert records[-1]["step"] == 5 and records[-1]["done"]
    assert [r["step"] for r in records if "train/loss" in r][-2:] == [4, 5]


def test_train_cli_steps_per_dispatch(tmp_path):
    """``--steps_per_dispatch 2`` over 3 steps: groups of 2 and 1, one log
    line a group, the checkpoint at step 3 (in process, on the CPU)."""
    from music2midi_tpu_torch.train.__main__ import main

    data = tmp_path / "data"
    _write_corpus(data, n_songs=2)
    cfg = default_config().to_dict()
    cfg["model"]["t5"].update(TINY)
    cfg["dataloader"].update(batch_size=2, num_workers=0)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    main([str(data), "--device", "cpu", "--config",
          str(tmp_path / "config.json"), "--out_dir", str(tmp_path / "runs"),
          "--name", "k", "--max_steps", "3", "--steps_per_dispatch", "2",
          "--dtype", "bfloat16"])
    out = tmp_path / "runs" / "k"
    records = [json.loads(line) for line in
               (out / "log.jsonl").read_text().splitlines()]
    groups = [r for r in records if "dispatch_steps" in r]
    assert [(r["step"], r["dispatch_steps"]) for r in groups] == [(2, 2),
                                                                   (3, 1)]
    assert all(np.isfinite(r["train/loss"]) for r in groups)
    assert (out / "ckpt" / "step_00000003" / "state.pt").exists()
    assert records[-1]["done"] and records[-1]["step"] == 3


def test_train_cli_rejects_tensor_parallelism(tmp_path):
    from music2midi_tpu_torch.train.__main__ import main

    with pytest.raises(SystemExit, match="--tp"):
        main([str(tmp_path), "--tp", "2", "--device", "cpu"])
