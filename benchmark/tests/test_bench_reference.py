"""The plain reference against the port's plain float32 path at a tiny
size on the CPU: the same weights file, the same inputs."""

import numpy as np
import pytest
import torch

from benchmark.reference import model as ref
from benchmark.reference.adafactor import Adafactor as RefAdafactor

MEL = {"sr": 16000, "n_fft": 2048, "hop": 256, "f_min": 20.0, "n_mels": 384}
SIZES = {"d_model": 384, "d_kv": 64, "num_heads": 8, "d_ff": 64,
         "num_layers": 2, "num_decoder_layers": 2, "vocab_size": 400,
         "relative_attention_num_buckets": 32,
         "relative_attention_max_distance": 128,
         "layer_norm_epsilon": 1e-6, "dropout_rate": 0.1, "pad_token_id": 0,
         "eos_token_id": 2, "decoder_start_token_id": 1}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A random 2 + 2-layer model written as an npz by the port, and the
    port's model of it."""
    from music2midi_tpu_torch.config import resolve_config
    from music2midi_tpu_torch.models.t5 import init_params, t5_config_from
    from music2midi_tpu_torch.train.checkpoint import save_params_npz
    from music2midi_tpu_torch.train.loop import trainable_model
    from music2midi_tpu_torch.weights import load_npz

    cfg = resolve_config(None).to_dict()
    cfg["model"]["t5"].update(num_layers=2, num_decoder_layers=2, d_ff=64)
    cfg = resolve_config(cfg)
    path = tmp_path_factory.mktemp("tiny") / "tiny.npz"
    params = init_params(3, t5_config_from(cfg), (6, 3))
    save_params_npz(path, {k: torch.from_numpy(v) for k, v in params.items()},
                    cfg)
    sd, _ = load_npz(path)
    t5 = t5_config_from(cfg, dtype=torch.float32)
    return path, cfg, t5, trainable_model(sd, t5, "cpu")


def _wave(n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        0, 0.2, (n, 48000)).astype(np.float32))


def test_log_mel_is_the_ports():
    from music2midi_tpu_torch.ops.mel import LogMelConfig, log_mel_spectrogram

    wave = _wave(2)
    got = ref.log_mel(wave, **MEL)
    want = log_mel_spectrogram(wave, LogMelConfig())
    assert got.shape == want.shape == (2, 188, 384)
    assert torch.allclose(got, want, atol=2e-4, rtol=0)


def test_teacher_forced_logits_are_the_ports(tiny):
    from music2midi_tpu_torch.models.t5 import (conditioning_prepend,
                                                decoder_forward, encode)
    from music2midi_tpu_torch.ops.mel import LogMelConfig, log_mel_spectrogram

    path, _, t5, model = tiny
    p = ref.load_params(path, "cpu")
    wave = _wave(3, 1)
    cond = torch.tensor([[0, 1], [5, 2], [3, 0]])
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        3, 400, (3, 20)))
    ids[:, 0] = 1
    with torch.no_grad():
        mel = log_mel_spectrogram(wave, LogMelConfig())
        enc = encode(model, conditioning_prepend(model, mel, cond), t5)
        want = decoder_forward(model, ids, enc, t5)
        drop = ref.Dropout(0.0, None)
        got_enc = ref.encode(p, SIZES, ref.encoder_inputs(
            p, ref.log_mel(wave, **MEL), cond), drop)
        got = ref.decode_logits(p, SIZES, ids, got_enc, drop)
    assert torch.allclose(got, want, atol=2e-4, rtol=1e-4)


def test_training_loss_with_dropout_is_the_ports(tiny):
    from music2midi_tpu_torch.ops.mel import LogMelConfig
    from music2midi_tpu_torch.train.loop import (Batch, _loss,
                                                 dropout_generator, to_device)

    path, _, t5, model = tiny
    p = ref.load_params(path, "cpu")
    labels = np.full((2, 12), -100, np.int64)
    labels[0, :10] = np.r_[np.random.default_rng(3).integers(3, 333, 9), 2]
    labels[1, :6] = np.r_[np.random.default_rng(4).integers(3, 333, 5), 2]
    cond = np.array([[1, 2], [4, 0]])
    batch = to_device(Batch(_wave(2, 5).numpy(), labels, cond), "cpu")
    want = _loss(model, batch, dropout_generator(9, 0, "cpu"), t5,
                 LogMelConfig(), False)
    word = np.random.SeedSequence((9, 0)).generate_state(1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(word))
    got = ref.train_loss(p, SIZES, MEL, batch.waveform, batch.cond_index,
                         batch.labels, gen)
    assert float(got.detach()) == pytest.approx(float(want.detach()),
                                                rel=1e-5)
    nodrop = ref.train_loss(p, SIZES, MEL, batch.waveform, batch.cond_index,
                            batch.labels, None)
    assert abs(float(nodrop.detach()) - float(want.detach())) > 1e-3


def test_adafactor_is_the_ports():
    from music2midi_tpu_torch.train.adafactor import Adafactor

    g = torch.Generator().manual_seed(0)
    shapes = {"w": (16, 8), "t": (32, 8), "b": (8,)}
    init = {k: torch.randn(s, generator=g) * 0.05 for k, s in shapes.items()}
    grads = [{k: torch.randn(s, generator=g) for k, s in shapes.items()}
             for _ in range(3)]
    mine = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    opt = Adafactor(list(mine.values()))
    theirs = {k: v.clone() for k, v in init.items()}
    ref_opt = RefAdafactor(theirs)
    for step in grads:
        for k, v in mine.items():
            v.grad = step[k].clone()
        opt.step()
        ref_opt.step(step)
    for k in shapes:
        moved = (theirs[k] - init[k]).norm()
        assert float((mine[k].detach() - theirs[k]).norm()) \
            <= 1e-5 * float(moved)


def test_logit_gaps_read_zero_on_greedy_tokens_and_grow_on_others(tiny):
    from benchmark.reference.judge import mean_logit_gap

    path = tiny[0]
    p = ref.load_params(path, "cpu")
    waves = _wave(2, 7).numpy()
    conds = np.array([[0, 1], [2, 0]])
    drop = ref.Dropout(0.0, None)
    with torch.no_grad():
        enc = ref.encode(p, SIZES, ref.encoder_inputs(
            p, ref.log_mel(torch.from_numpy(waves), **MEL),
            torch.from_numpy(conds)), drop)
        ids = torch.ones((2, 1), dtype=torch.long)
        for _ in range(6):  # the reference's own greedy tokens
            nxt = ref.decode_logits(p, SIZES, ids, enc, drop)[:, -1].argmax(-1)
            ids = torch.cat([ids, nxt[:, None]], 1)
    tokens = [row.numpy() for row in ids]
    assert mean_logit_gap(p, SIZES, MEL, waves, conds, tokens, "cpu") == 0.0
    tokens[1] = tokens[1].copy()
    tokens[1][6] = (tokens[1][6] + 7) % 400  # the last: no later position
    with torch.no_grad():  # the one altered position's gap, over all 12
        logits = ref.decode_logits(p, SIZES, torch.from_numpy(
            tokens[1][None, :6]), enc[1:], drop)[0, -1]
    want = float(logits.max() - logits[tokens[1][6]]) / 12
    got = mean_logit_gap(p, SIZES, MEL, waves, conds, tokens, "cpu")
    assert want > 0.0 and got == pytest.approx(want, rel=1e-4)
