"""Port tests that need an NVIDIA card: each CUDA kernel against its plain
version at the serving shapes and at ``chip_smoke.py``'s bars, and the
serving path through the kernels.  They skip without a card; on a machine
with one (whose Python may lack jax, which ``tests/conftest.py``
imports): ``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
"""

import itertools
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from music2midi_tpu_torch.models.t5 import _quantize_kv, _split_heads
from music2midi_tpu_torch.ops import decode_attention as da
from music2midi_tpu_torch.ops import mel_cuda
from music2midi_tpu_torch.ops.mel import LogMelConfig, log_mel_spectrogram

pytestmark = pytest.mark.gpu

RECORD = Path(__file__).resolve().parent.parent / "checkpoints" \
    / "model_of_record.npz"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("kernel", ["fft", "dft"])
@pytest.mark.parametrize("n_samples", [48000, 41234])
def test_mel_kernel_matches_plain_on_card(card, n_samples, kernel):
    """The TPU kernel's bars: noise within 1e-3 in the log domain, silence
    on the log floor within 1e-4, the tone's argmax mel bin equal (a
    tone's near-silent bins sit at fp32 round-off in both versions)."""
    fn = {"fft": mel_cuda.log_mel_spectrogram_cuda,
          "dft": mel_cuda.log_mel_spectrogram_dft_cuda}[kernel]
    cfg = LogMelConfig()
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(6, n_samples)) * 0.3).astype(np.float32)
    t = np.arange(n_samples) / cfg.sample_rate
    w[1] = np.sin(2 * np.pi * 440 * t)
    w[2] = 0.0
    x = torch.from_numpy(w).to(card)
    before = fn.launches
    got = fn(x, cfg)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = log_mel_spectrogram(x, cfg)
    assert got.shape == ref.shape
    noise = [0, 3, 4, 5]
    assert float((got[noise] - ref[noise]).abs().max()) <= 1e-3
    assert float((got[2] - math.log(1e-6)).abs().max()) <= 1e-4
    assert int(got[1].mean(0).argmax()) == int(ref[1].mean(0).argmax())


def _int8_inputs(card, L, seed):
    """Seeded (64, 8, L, 64) int8 K/V through the port's _quantize_kv, a
    bf16 query, fresh rows and a bias row, on the card."""
    g = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=g).to(card)

    B, H, D = 64, 8, 64
    return (normal(B, H, 1, D).to(torch.bfloat16),
            _quantize_kv(normal(B, H, L, D)), _quantize_kv(normal(B, H, L, D)),
            _quantize_kv(normal(B, H, 1, D)), _quantize_kv(normal(B, H, 1, D)),
            normal(1, H, 1, L))


def _close(got, ref, bar=2e-2):
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    err = float((got.float() - ref.float()).abs().max())
    assert err <= bar, err


@pytest.mark.parametrize("round_pv", [False, True])
@pytest.mark.parametrize("step", [0, 63, 127, 1022])
def test_int8_causal_kernel_matches_plain_on_card(card, step, round_pv):
    """Over the whole 1024-long cache, and over the views the decode loop
    passes (the visible prefix and the bias row's window): 2e-2 on the
    bf16 outputs, with ``p * vs`` in f32 (the TPU kernel's arithmetic) and
    rounded to bf16 (the serving route's)."""
    q, k, v, kn, vn, bias = _int8_inputs(card, 1024, step)
    before = da.decode_attention_int8.launches
    got = da.decode_attention_int8(q, k, v, bias, step, kn, vn, causal=True,
                                   round_pv=round_pv)
    assert da.decode_attention_int8.launches == before + 1
    _close(got, da.decode_attention_int8_plain(q, k, v, bias, step, kn, vn,
                                               causal=True,
                                               round_pv=round_pv))
    n = step + 1
    k_pre = (k[0][:, :, :n], k[1][..., :n])
    v_pre = (v[0][:, :, :n], v[1][..., :n])
    _close(da.decode_attention_int8(q, k_pre, v_pre, bias[0, :, 0, :n],
                                    step, kn, vn, causal=True,
                                    round_pv=round_pv), got, 0.0)


def _cross_inputs(card, L, seed):
    """A bf16 query and int8 cross K/V laid out as ``precompute_cross_kv``
    lays them out: ``_quantize_kv`` of a ``_split_heads`` view of a
    (B, L, H*D) projection, so keys sit H*D bytes apart."""
    g = torch.Generator().manual_seed(seed)
    B, H, D = 64, 8, 64

    def proj():
        x = torch.randn(B, L, H * D, generator=g).to(card, torch.bfloat16)
        return _quantize_kv(_split_heads(x, H, D))

    q = torch.randn(B, H, 1, D, generator=g).to(card, torch.bfloat16)
    return q, proj(), proj()


@pytest.mark.parametrize("round_pv", [False, True])
@pytest.mark.parametrize("enc_len", [190, 150])
def test_int8_cross_and_cross_t_kernels_match_plain_on_card(card, enc_len,
                                                            round_pv):
    """The int8 kernel's cross route with both ``round_pv`` settings, and
    the transposed-cross kernel on the padded layout of
    ``transpose_cross_entry`` (rows of 190 keys 192 bytes apart)."""
    q, k, v = _cross_inputs(card, 190, enc_len)
    assert k[0].stride(2) == 8 * 64
    got = da.decode_attention_int8(q, k, v, None, None, None, None,
                                   causal=False, enc_len=enc_len,
                                   round_pv=round_pv)
    _close(got, da.decode_attention_int8_plain(
        q, k, v, None, None, None, None, causal=False, enc_len=enc_len,
        round_pv=round_pv))
    kt, vt = da.transpose_cross_entry(k), da.transpose_cross_entry(v)
    assert kt[0].shape == (64, 8, 64, 190) and kt[0].stride(2) == 192
    before = da.decode_attention_cross_t.launches
    got_t = da.decode_attention_cross_t(q, kt, vt, enc_len=enc_len)
    assert da.decode_attention_cross_t.launches == before + 1
    _close(got_t, da.decode_attention_cross_t_plain(q, kt, vt,
                                                    enc_len=enc_len))
    # keys >= enc_len are masked whatever the pad bytes hold
    for t in (kt[0], vt[0]):
        torch.as_strided(t, (64, 8, 64, 192), t.stride())[..., 190:] = 127
    _close(da.decode_attention_cross_t(q, kt, vt, enc_len=enc_len), got_t,
           0.0)


@pytest.mark.parametrize("pallas_cross", [False, True])
def test_serving_path_launches_the_kernel(card, pallas_cross):
    from music2midi_tpu_torch.audio import resample
    from music2midi_tpu_torch.calibration import check_midi, render_fixture
    from music2midi_tpu_torch.infer import Music2MIDI

    wav, sr = render_fixture()
    engine = Music2MIDI.from_npz(RECORD, dtype=torch.bfloat16)
    engine.pallas_cross = pallas_cross
    counters = (mel_cuda.log_mel_spectrogram_cuda,
                da.decode_attention_int8, da.decode_attention_cross_t)
    before = [f.launches for f in counters]
    midi = engine.generate(audio_y=resample(wav, sr, 16000))
    mel, int8, cross_t = (f.launches - b for f, b in zip(counters, before))
    steps = engine.last_decode_stats[0]["steps"]
    assert mel == 1
    # 6 self blocks per step, and 6 cross blocks in one kernel or the other
    assert int8 == (6 if pallas_cross else 12) * steps
    assert cross_t == (6 * steps if pallas_cross else 0)
    ok, detail = check_midi(midi)
    assert ok, detail


@pytest.mark.parametrize("round_pv", [False, True])
@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 512, 1023, 1024])
def test_int8_causal_kernel_at_key_group_boundaries(card, n, round_pv):
    """Keys 0..n-1 of a 1024-long cache at the edges of the kernel's key
    groups (its 256 threads take 64 keys a load and 128 a group of two
    loads in flight) and at the cache's end: 2e-2 against the plain
    version, and junk bytes, scales and bias past the visible keys change
    nothing."""
    q, k, v, kn, vn, bias = _int8_inputs(card, 1024, n)
    step = n - 1
    got = da.decode_attention_int8(q, k, v, bias, step, kn, vn, causal=True,
                                   round_pv=round_pv)
    _close(got, da.decode_attention_int8_plain(q, k, v, bias, step, kn, vn,
                                               causal=True,
                                               round_pv=round_pv))
    for t in (k[0], v[0]):
        t[:, :, n:] = 127
    for t in (k[1], v[1]):
        t[..., n:] = 1e3
    bias[..., n:] = 1e3
    _close(da.decode_attention_int8(q, k, v, bias, step, kn, vn, causal=True,
                                    round_pv=round_pv), got, 0.0)


@pytest.mark.parametrize("round_pv", [False, True])
@pytest.mark.parametrize("enc_len", [1, 150, 190])
def test_int8_cross_kernel_on_the_engine_layout(card, enc_len, round_pv):
    """The cross route on ``precompute_cross_kv``'s layout (keys 512 bytes
    apart), keys past ``enc_len`` filled with junk."""
    q, k, v = _cross_inputs(card, 190, enc_len + 7)
    assert k[0].stride(2) == 8 * 64
    for t in (k[0], v[0]):
        t[:, :, enc_len:] = -127
    for t in (k[1], v[1]):
        t[..., enc_len:] = 1e3
    args = (q, k, v, None, None, None, None, False, enc_len, round_pv)
    _close(da.decode_attention_int8(*args),
           da.decode_attention_int8_plain(*args))


def test_plan_route_equals_public_function_on_card(card):
    """The launch plan over a decode loop's caches (``init_kv_cache``'s
    self buffers, ``precompute_cross_kv``'s cross layout, the engine's
    bias rows) against ``decode_attention_int8`` on the same operands: the
    same kernel, so equal bit for bit, at steps 0, 255, 256, 700 and 1023,
    and one launch counted per call."""
    from music2midi_tpu_torch.models.t5 import decoder_bias_rows, T5Config

    B, H, D, L = 64, 8, 64, 1024
    g = torch.Generator().manual_seed(11)
    cache = []
    for _ in range(2):
        entries = [_quantize_kv(torch.randn(B, H, L, D, generator=g).to(card))
                   for _ in range(2)]
        cache.append(tuple(entries))
    cross = [_cross_inputs(card, 190, 20 + i)[1:] for i in range(2)]
    cfg = T5Config()
    rel = torch.randn(cfg.relative_attention_num_buckets, H,
                      generator=g).to(card)
    rows = decoder_bias_rows(rel, L, cfg)
    plan = da.Int8AttentionPlan(cache, rows, cross, enc_len=150)
    qkv = torch.randn(B, 1, 3 * H * D, generator=g).to(card, torch.bfloat16)
    q = _split_heads(qkv[..., :H * D], H, D)
    kn = _quantize_kv(_split_heads(qkv[..., H * D:2 * H * D], H, D))
    vn = _quantize_kv(_split_heads(qkv[..., 2 * H * D:], H, D))
    for i, step in itertools.product(range(2), (0, 255, 256, 700, 1023)):
        n = step + 1
        (k8, ks), (v8, vs) = cache[i]
        before = da.decode_attention_int8.launches
        got = plan.causal(i, q, kn, vn, step).clone()
        assert da.decode_attention_int8.launches == before + 1
        _close(got, da.decode_attention_int8(
            q, (k8[:, :, :n], ks[..., :n]), (v8[:, :, :n], vs[..., :n]),
            rows[:, L - n:], step, kn, vn, causal=True, round_pv=True), 0.0)
    for i in range(2):
        _close(plan.cross(i, q).clone(), da.decode_attention_int8(
            q, *cross[i], None, None, None, None, causal=False, enc_len=150,
            round_pv=True), 0.0)


def _close_rel(got, ref, bar=1e-5):
    """f32 outputs: max |diff| over max |ref| within ``bar``."""
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == torch.float32
    err = float((got - ref).abs().max()) / float(ref.abs().max())
    assert err <= bar, err


@pytest.mark.parametrize("where", ["causal 31", "causal 127", "causal 1022",
                                   "cross 190", "cross 150"])
def test_int8_kernel_f32_instance_matches_plain_on_card(card, where):
    """A float32 query launches the f32 instance (an fp32 engine with int8
    KV): f32 output within 1e-5 of the plain version relative to its
    largest value (only the order of the f32 sums differs), one launch a
    call, and its launch plan equal to it bit for bit."""
    route, n = where.split()
    n = int(n)
    if route == "causal":
        q, k, v, kn, vn, bias = _int8_inputs(card, 1024, n)
        q = q.float() + 1e-3 * torch.randn_like(q, dtype=torch.float32)
        args = (q, k, v, bias, n, kn, vn, True, 0, True)
    else:
        q, k, v = _cross_inputs(card, 190, n)
        q = q.float() + 1e-3 * torch.randn_like(q, dtype=torch.float32)
        args = (q, k, v, None, None, None, None, False, n, True)
    before = da.decode_attention_int8.launches
    got = da.decode_attention_int8(*args)
    assert da.decode_attention_int8.launches == before + 1
    _close_rel(got, da.decode_attention_int8_plain(*args))
    if route == "causal":
        L = k[0].shape[2]
        rows = torch.zeros(8, L, device=card)
        rows[:, L - n - 1:] = bias[0, :, 0, :n + 1]
        plan = da.Int8AttentionPlan([(k, v)], rows, dtype=torch.float32)
        plan_out = plan.causal(0, q, kn, vn, n)
    else:
        rows = torch.zeros(8, k[0].shape[2], device=card)
        plan = da.Int8AttentionPlan([(k, v)], rows, [(k, v)], enc_len=n,
                                    dtype=torch.float32)
        plan_out = plan.cross(0, q)
    torch.cuda.synchronize()
    assert torch.equal(plan_out, got)


@pytest.mark.parametrize("round_pv", [False, True])
@pytest.mark.parametrize("where", ["causal 127", "causal 1022", "cross 190"])
def test_int8_kernel_on_4bit_entries_matches_plain_on_card(card, where,
                                                           round_pv):
    """``kv_bits=4`` caches (+-7 levels stored in int8) through the same
    kernel: 2e-2 against the plain version on the bf16 outputs."""
    route, n = where.split()
    n = int(n)
    g = torch.Generator().manual_seed(n)

    def q4(*shape):
        return _quantize_kv(torch.randn(*shape, generator=g).to(card), 4)

    B, H, D = 64, 8, 64
    q = torch.randn(B, H, 1, D, generator=g).to(card, torch.bfloat16)
    k, v = q4(B, H, 1024 if route == "causal" else n, D), \
        q4(B, H, 1024 if route == "causal" else n, D)
    assert int(k[0].abs().max()) == 7
    if route == "causal":
        bias = torch.randn(1, H, 1, 1024, generator=g).to(card)
        args = (q, k, v, bias, n, q4(B, H, 1, D), q4(B, H, 1, D), True, 0,
                round_pv)
    else:
        args = (q, k, v, None, None, None, None, False, n, round_pv)
    _close(da.decode_attention_int8(*args),
           da.decode_attention_int8_plain(*args))


@pytest.mark.parametrize("option", ["int8_weights", "kv_bits=4", "unroll=8",
                                    "fp32 int8_kv"])
def test_engine_options_launch_the_kernel(card, option):
    """Each decode option of the engine on the calibration fixture runs
    the int8 kernel in all 12 attention blocks of every step it runs (the
    fp32 engine through its f32 instance; ``unroll=8`` runs on to the next
    multiple of 8 steps), with tokens out; ``unroll=8`` gives the tokens
    of ``unroll=1``."""
    from music2midi_tpu_torch.audio import resample
    from music2midi_tpu_torch.calibration import render_fixture
    from music2midi_tpu_torch.infer import Music2MIDI

    wav, sr = render_fixture()
    dtype = torch.float32 if option.startswith("fp32") else torch.bfloat16
    engine = Music2MIDI.from_npz(RECORD, dtype=dtype)
    chunks = engine._chunk_waveform(resample(wav, sr, 16000))
    base = engine.sample_tokens_batched(chunks) if option == "unroll=8" \
        else None
    if option == "int8_weights":
        engine.int8_weights = True
    elif option == "kv_bits=4":
        engine.kv_bits = 4
    elif option == "unroll=8":
        engine.unroll = 8
    else:
        engine.int8_kv = True
    before = da.decode_attention_int8.launches
    tokens = engine.sample_tokens_batched(chunks)
    steps = engine.last_decode_stats[0]["steps"]
    run = min(-(-steps // engine.unroll) * engine.unroll,
              engine.decode_max_length - 1)
    assert da.decode_attention_int8.launches - before == 12 * run
    assert all(len(t) > 1 for t in tokens)
    if base is not None:
        assert all(np.array_equal(a, b) for a, b in zip(tokens, base))


@pytest.mark.parametrize("batch,n_samples,n_fft,hop", [
    (64, 48000, 2048, 256), (1, 41234, 2048, 256), (128, 48000, 2048, 256),
    (3, 33000, 2048, 256), (5, 40000, 256, 128), (5, 40000, 512, 128),
    (5, 40000, 1024, 256), (5, 40000, 4096, 1024)])
def test_fft_mel_kernel_tiles_of_frames(card, batch, n_samples, n_fft, hop):
    """The FFT mel kernel at the serving batch, at the calibration length,
    at twice the serving batch, and at 129 frames (a last tile of one
    frame; 188 and 162 frames end in part-tiles too), and its other
    instances (n_fft 256, 512, 1024 and 4096: 4, 8, 16 and 64 points a
    lane in the first pass, where 2048 has 32), the last at the largest
    hop whose tile fits in shared memory: noise rows within
    1e-3 of the plain version in the log domain wherever the plain mel
    power is ten times the log floor or more, and within 1e-2 below that
    (near the floor d log P = dP / P magnifies fp32 round-off: among the
    128-chunk draw's 9.2 M values, bins a few times the floor miss 1e-3),
    silence on the log floor within 1e-4, the tone's argmax mel bin
    equal."""
    cfg = LogMelConfig(n_fft=n_fft, hop_length=hop)
    rng = np.random.default_rng(batch + n_samples)
    w = (rng.normal(size=(batch, n_samples)) * 0.3).astype(np.float32)
    t = np.arange(n_samples) / cfg.sample_rate
    special = batch >= 3
    if special:
        w[1] = np.sin(2 * np.pi * 440 * t)
        w[2] = 0.0
    x = torch.from_numpy(w).to(card)
    got = mel_cuda.log_mel_spectrogram_cuda(x, cfg)
    torch.cuda.synchronize()
    ref = log_mel_spectrogram(x, cfg)
    assert got.shape == ref.shape
    noise = [r for r in range(batch) if not special or r not in (1, 2)]
    err = (got[noise] - ref[noise]).abs()
    clear = ref[noise] >= math.log(10 * cfg.log_floor)
    assert float(err[clear].max()) <= 1e-3
    assert float(err.max()) <= 1e-2
    if special:
        assert float((got[2] - math.log(1e-6)).abs().max()) <= 1e-4
        assert int(got[1].mean(0).argmax()) == int(ref[1].mean(0).argmax())



def test_train_step_on_card_matches_cpu(card):
    """One fp32 train step of the model of record at full width (6 + 6
    layers, d_model 384) on 3-s windows at 22050 Hz (261 encoder
    positions), dropout 0, on the card and on the CPU from the same
    parameters and batch, no TF32 (PyTorch's default): loss within 1e-4
    relative and the parameter updates' cosine >= 0.999, the bars of
    ``chip_smoke.py``'s training phase.  A fixed lr of 1e-2: the relative
    step's first lr moves a parameter by a few ulps only."""
    from music2midi_tpu_torch.config import default_config
    from music2midi_tpu_torch.models.t5 import t5_config_from
    from music2midi_tpu_torch.ops.mel import log_mel_config_from
    from music2midi_tpu_torch.train import Adafactor, Batch, make_train_step
    from music2midi_tpu_torch.train.loop import TrainState, trainable_model
    from music2midi_tpu_torch.weights import load_npz

    assert not torch.backends.cuda.matmul.allow_tf32
    sd, rec_cfg = load_npz(RECORD)
    config = default_config()
    cfg = t5_config_from(rec_cfg, torch.float32)._replace(dropout_rate=0.0)
    mel_cfg = log_mel_config_from(config)
    rng = np.random.default_rng(0)
    labels = np.full((4, 120), -100, np.int32)
    for i, n in enumerate((120, 64, 97, 30)):
        labels[i, :n] = rng.integers(3, 333, n)
        labels[i, n - 1] = 2
    batch = Batch((rng.normal(size=(4, 66150)) * 0.1).astype(np.float32),
                  labels, np.array([[0, 0], [1, 2], [5, 1], [3, 0]]))
    loss, update = {}, {}
    for dev in (card, torch.device("cpu")):
        model = trainable_model(sd, cfg, dev)
        state = TrainState(model, Adafactor(list(model.parameters()),
                                            lr=1e-2))
        before = torch.cat([p.detach().flatten().double().cpu()
                            for p in model.parameters()])
        _, l = make_train_step(cfg, mel_cfg)(state, batch, 0)
        loss[dev.type] = float(l)
        update[dev.type] = torch.cat([p.detach().flatten().double().cpu()
                                      for p in model.parameters()]) - before
    assert np.isfinite(loss["cuda"])
    assert abs(loss["cuda"] - loss["cpu"]) <= 1e-4 * abs(loss["cpu"])
    cos = torch.nn.functional.cosine_similarity(update["cuda"],
                                                update["cpu"], dim=0)
    assert float(cos) >= 0.999


def test_batcher_on_card_gives_generate_batch_notes(card):
    """The batcher's dispatcher thread serves on the card what
    ``generate_batch`` gives on the main thread (bf16 serving, kernels 1
    and 3 launched from that thread), with no more memory at its peak."""
    import threading

    from music2midi_tpu_torch.audio import resample
    from music2midi_tpu_torch.calibration import render_fixture
    from music2midi_tpu_torch.infer import Music2MIDI
    from music2midi_tpu_torch.serve.batcher import DynamicBatcher

    wav, sr = render_fixture()
    y = resample(wav, sr, 16000)
    songs = [y[:6 * 16000], y[6 * 16000:], y[3 * 16000:9 * 16000]]
    engine = Music2MIDI.from_npz(RECORD, dtype=torch.bfloat16)
    engine.generate_batch(songs)  # warm: kernels built, allocator sized
    torch.cuda.reset_peak_memory_stats()
    want = engine.generate_batch(songs)
    main_peak = torch.cuda.max_memory_allocated()
    counters = (mel_cuda.log_mel_spectrogram_cuda, da.decode_attention_int8)
    before = [f.launches for f in counters]
    torch.cuda.reset_peak_memory_stats()
    batcher = DynamicBatcher(engine, max_batch_songs=len(songs),
                             max_wait_ms=5000.0)
    try:
        futures = [batcher.submit(waveform=s) for s in songs]
        got = [f.result(timeout=300) for f in futures]
    finally:
        batcher.close()
    assert not batcher._thread.is_alive()
    thread_peak = torch.cuda.max_memory_allocated()
    assert all(f.launches > b for f, b in zip(counters, before))
    for g, w in zip(got, want):
        assert [(n.start, n.end, n.pitch, n.velocity)
                for n in g.instruments[0].notes] == \
            [(n.start, n.end, n.pitch, n.velocity)
             for n in w.instruments[0].notes]
    assert sum(len(m.instruments[0].notes) for m in got) > 0
    assert thread_peak <= main_peak
