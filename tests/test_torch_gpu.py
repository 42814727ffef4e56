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
    step's first lr moves a parameter by a few ulps only.  The decode
    step's kernels 7-10 never launch."""
    from music2midi_tpu_torch.config import default_config
    from music2midi_tpu_torch.models.t5 import t5_config_from
    from music2midi_tpu_torch.ops import decode_fused as df
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
    fused = [w.launches for w in df.wrappers()]
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
    assert [w.launches for w in df.wrappers()] == fused
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


@pytest.mark.parametrize("round_pv", [False, True])
@pytest.mark.parametrize("n", [1, 2, 64, 65, 128, 129, 255, 256, 257, 512,
                               1023, 1024])
def test_int8_causal_kernel_device_step_at_key_group_boundaries(card, n,
                                                                round_pv):
    """Kernel 3 through a launch plan over a 1024-long cache, its step
    read from device memory (keys 0..n-1), at the edges of its key groups:
    2e-2 against the plain version over the prefix and the bias window,
    bit for bit the host step's call, one launch a call; junk past the
    visible keys (bytes, scales, the bias row's columns before the window)
    changes nothing; a step past the cache writes NaN."""
    L = 1024
    q, k, v, kn, vn, bias = _int8_inputs(card, L, n)
    rows = bias[0, :, 0, :]
    plan = da.Int8AttentionPlan([(k, v)], rows, round_pv=round_pv)
    step = torch.full((), n - 1, dtype=torch.int32, device=card)
    before = da.decode_attention_int8.launches
    got = plan.causal(0, q, kn, vn, step).clone()
    assert da.decode_attention_int8.launches == before + 1
    _close(got, da.decode_attention_int8_plain(
        q, (k[0][:, :, :n], k[1][..., :n]), (v[0][:, :, :n], v[1][..., :n]),
        rows[:, L - n:], n - 1, kn, vn, causal=True, round_pv=round_pv))
    _close(plan.causal(0, q, kn, vn, n - 1).clone(), got, 0.0)
    for t in (k[0], v[0]):
        t[:, :, n:] = 127
    for t in (k[1], v[1]):
        t[..., n:] = 1e3
    rows[:, :L - n] = 1e3
    _close(plan.causal(0, q, kn, vn, step).clone(), got, 0.0)
    step.fill_(L)
    out = plan.causal(0, q, kn, vn, step)
    torch.cuda.synchronize()
    assert bool(torch.isnan(out.float()).all())


@pytest.mark.parametrize("route", ["serving", "pallas_cross", "unroll=8",
                                   "sampling", "fp32"])
def test_captured_decode_equals_eager_on_card(card, route):
    """The decode loop as one captured program (``generate_tokens``: the
    first call captures, the second replays) against its eager twin on the
    calibration fixture's encoder output: tokens and lengths equal bit for
    bit; the replay counts kernel 3's launches, 12 a step (6, beside 6 of
    kernel 4, under ``pallas_cross``; none in fp32)."""
    from music2midi_tpu_torch.audio import resample
    from music2midi_tpu_torch.calibration import render_fixture
    from music2midi_tpu_torch.infer import Music2MIDI
    from music2midi_tpu_torch.infer.decode import (
        generate_tokens,
        generate_tokens_eager,
    )

    wav, sr = render_fixture()
    engine = Music2MIDI.from_npz(RECORD, dtype=torch.float32
                                 if route == "fp32" else torch.bfloat16)
    if route == "pallas_cross":
        engine.pallas_cross = True
    elif route == "unroll=8":
        engine.unroll = 8
    elif route == "sampling":
        engine.temperature, engine.top_k, engine.sample_seed = 1.0, 10, 5
    batch, cond = engine._pad_batch(engine._chunk_waveform(
        resample(wav, sr, 16000)))
    enc = engine._encoder(engine._log_mel(engine._device_wave(batch)), cond)
    dcfg = engine._dcfg()
    want_t, want_l = generate_tokens_eager(engine.model, enc,
                                           engine.t5_config, dcfg,
                                           engine._sample_rng(0))
    for _ in range(2):
        before = (da.decode_attention_int8.launches,
                  da.decode_attention_cross_t.launches)
        got_t, got_l = generate_tokens(engine.model, enc, engine.t5_config,
                                       dcfg, engine._sample_rng(0))
        torch.cuda.synchronize()
        assert torch.equal(got_t, want_t) and torch.equal(got_l, want_l)
        steps = int(want_l.max()) - 1
        run = -(-steps // dcfg.unroll) * dcfg.unroll
        int8 = da.decode_attention_int8.launches - before[0]
        cross_t = da.decode_attention_cross_t.launches - before[1]
        if route == "fp32":
            assert (int8, cross_t) == (0, 0)
        elif route == "pallas_cross":
            assert (int8, cross_t) == (6 * run, 6 * run)
        else:
            assert (int8, cross_t) == (12 * run, 0)


# ROADMAP C1: on chip_smoke.py's song (the model of record in bf16, int8
# KV) the kernel route agrees with plain _attention_int8 on the card on
# 0.971503 of greedy tokens (tools/song_agreement.py, H100); the bar is a
# floor just under that reading.  Against the JAX engine's decode of the
# same encoder output (tools/c1_distance.py) the kernel route reads
# 0.747850 and the plain route 0.739404.
C1_BAR = 0.96


def test_kernel_route_holds_the_c1_bar_on_the_song(card):
    """The song's encoder output (``chip_smoke.py``'s synthetic 3-minute
    song, seed 7, through the serving mel kernel and the bf16 encoder)
    decoded by the kernel route (kernel 3 with ``round_pv``) and by plain
    ``_attention_int8``: greedy-token agreement, each row compared up to
    the longer of its two lengths, at least ``C1_BAR``."""
    import sys

    from music2midi_tpu_torch.infer import Music2MIDI
    from music2midi_tpu_torch.infer.decode import generate_tokens

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from chip_smoke import synthetic_song

    engine = Music2MIDI.from_npz(RECORD, dtype=torch.bfloat16)
    chunks = engine._chunk_waveform(synthetic_song(180.0, 16000, seed=7))
    batch, cond = engine._pad_batch(chunks)
    enc = engine._encoder(engine._log_mel(engine._device_wave(batch)), cond)
    runs = [generate_tokens(engine.model, enc, engine.t5_config,
                            engine._dcfg()._replace(pallas_attention=on))
            for on in (True, False)]
    (t_k, l_k), (t_p, l_p) = [(t.cpu().numpy(), n.cpu().numpy())
                              for t, n in runs]
    same = total = 0
    for r in range(len(chunks)):
        m = int(max(l_k[r], l_p[r]))
        same += int((t_k[r, :m] == t_p[r, :m]).sum())
        total += m
    assert same / total >= C1_BAR, (same, total)


# --------------------------------------------------------------------- #
# the multi-tensor Adafactor kernel (csrc/adafactor.cu)                  #
# --------------------------------------------------------------------- #

ADAFACTOR_STEPS = 3
_ADAFACTOR_INPUTS = {}


def _adafactor_inputs():
    """The model of record's 146 floating leaves (fp32, as
    ``trainable_model`` makes the masters) and ADAFACTOR_STEPS steps of
    numpy-made gradients, each leaf at a scale of its own (1e-4 to 1)."""
    if not _ADAFACTOR_INPUTS:
        from music2midi_tpu_torch.weights import load_npz

        sd, _ = load_npz(RECORD)
        leaves = [v.float().numpy() for v in sd.values()
                  if v.is_floating_point()]
        rng = np.random.default_rng(19)
        grads = [[(rng.standard_normal(x.shape, np.float32)
                   * np.float32(10.0 ** rng.uniform(-4, 0))) for x in leaves]
                 for _ in range(ADAFACTOR_STEPS)]
        _ADAFACTOR_INPUTS.update(leaves=leaves, grads=grads)
    return _ADAFACTOR_INPUTS["leaves"], _ADAFACTOR_INPUTS["grads"]


def _adafactor(leaves, device, lr):
    from music2midi_tpu_torch.train import Adafactor

    params = [torch.nn.Parameter(torch.from_numpy(x.copy()).to(device))
              for x in leaves]
    return params, Adafactor(params, lr=lr, warmup_init=lr is None)


def _kernel_run(card, lr=None):
    """Three kernel steps from the model of record -> (params, optimizer,
    launches a step)."""
    leaves, grads = _adafactor_inputs()
    params, opt = _adafactor(leaves, card, lr)
    launches = []
    for gs in grads:
        for p, g in zip(params, gs):
            p.grad = torch.from_numpy(g).to(card)
        n = opt.launches
        opt.step()
        launches.append(opt.launches - n)
    torch.cuda.synchronize()
    return params, opt, launches


@pytest.mark.parametrize("lr", [None, 1e-2])
def test_adafactor_kernel_matches_plain_on_model_of_record(card, lr):
    """The kernel on the model of record's 146 leaves against the plain
    version on the CPU, step by step from the same parameters (each step
    starts the kernel's leaves from the plain version's), with the
    recipe's relative step and a fixed lr: every moment within 1e-6
    relative, and each step's parameter change within 1e-5 relative plus
    an ulp of the parameter (the two may round p + step apart).  Only the
    sums differ (sum p^2, the row and column sums of g^2, the row
    factor's sum, sum upd^2): the kernel adds tile partials in its fixed
    order, PyTorch on the CPU in its own; every product, square root and
    division is the same float32 op."""
    leaves, grads = _adafactor_inputs()
    kp, kopt = _adafactor(leaves, card, lr)
    cp, copt = _adafactor(leaves, torch.device("cpu"), lr)
    for k, gs in enumerate(grads, 1):
        with torch.no_grad():
            for a, b in zip(kp, cp):
                a.copy_(b)
        before = [b.detach().numpy().copy() for b in cp]
        for a, b, g in zip(kp, cp, gs):
            a.grad, b.grad = torch.from_numpy(g).to(card), \
                torch.from_numpy(g.copy())
        kopt.step()
        copt.step()
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(kp, cp)):
            got, want = a.detach().cpu().numpy(), b.detach().numpy()
            excess = np.abs(got - want) - (
                1e-5 * np.abs(want - before[i])
                + np.spacing(np.maximum(np.abs(before[i]), np.abs(want))))
            assert excess.max() <= 0, (f"step {k}, leaf {i}: parameter "
                                       f"change off by {excess.max()}")
            for key, m in copt.state[b].items():
                if key != "step":
                    np.testing.assert_allclose(
                        kopt.state[a][key].cpu().numpy(), m.numpy(),
                        rtol=1e-6, atol=0,
                        err_msg=f"step {k}, leaf {i}: moment {key}")


def test_adafactor_kernel_is_deterministic(card):
    """No float atomics: two runs give the same parameters and moments
    bit for bit."""
    (p1, o1, _), (p2, o2, _) = _kernel_run(card), _kernel_run(card)
    for a, b in zip(p1, p2):
        assert torch.equal(a, b)
        for key, m in o1.state[a].items():
            if key != "step":
                assert torch.equal(m, o2.state[b][key])


def test_adafactor_kernel_launches_four_a_step(card):
    """4 a step by the optimizer's count and by the wrapper's, which
    ``chip_smoke.py`` reads beside the other kernels'."""
    from music2midi_tpu_torch.train.adafactor import adafactor_kernel

    n = adafactor_kernel.launches
    _, opt, launches = _kernel_run(card)
    assert launches == [4] * ADAFACTOR_STEPS
    assert adafactor_kernel.launches - n == 4 * ADAFACTOR_STEPS
    assert opt.tensors == 146


def test_adafactor_kernel_step_never_waits_on_the_card(card):
    """Under ``torch.cuda.set_sync_debug_mode("error")``, from a fresh
    optimizer (its tables written at the first step): no step
    synchronizes with the card."""
    leaves, grads = _adafactor_inputs()
    params, opt = _adafactor(leaves, card, None)
    on_card = [[torch.from_numpy(g).to(card) for g in gs] for gs in grads]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for gs in on_card:
            for p, g in zip(params, gs):
                p.grad = g
            opt.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert opt.launches == 4 * ADAFACTOR_STEPS


@pytest.mark.parametrize("leaf", ["bfloat16", "3-d", "strided grad"])
def test_adafactor_kernel_raises_on_a_leaf_it_does_not_take(card, leaf):
    from music2midi_tpu_torch.train import Adafactor

    x = torch.randn(8, 16, device=card)
    if leaf == "bfloat16":
        x = x.bfloat16()
    elif leaf == "3-d":
        x = x.view(2, 4, 16)
    p = torch.nn.Parameter(x)
    g = torch.randn_like(p)
    if leaf == "strided grad":
        g = torch.randn(16, 8, device=card).t()
    p.grad = g
    with pytest.raises(ValueError, match="Adafactor kernel"):
        Adafactor([p]).step()


def test_adafactor_kernel_launches_per_chunk_past_max_leaves(card,
                                                             monkeypatch):
    """Leaves are cut into launches of at most MAX_LEAVES (here lowered to
    64) and where the step scalars change (a leaf stepped once more than
    the rest): 300 leaves of ragged shapes, two steps, against the plain
    version on the CPU at the bars above; 4 launches a step for each
    chunk."""
    from music2midi_tpu_torch.train import Adafactor
    from music2midi_tpu_torch.train import adafactor as ad

    monkeypatch.setattr(ad, "MAX_LEAVES", 64)
    rng = np.random.default_rng(5)
    shapes = [tuple(int(d) for d in rng.integers(1, 300, rng.integers(1, 3)))
              for _ in range(300)]
    leaves = [rng.normal(size=s).astype(np.float32) for s in shapes]
    sides = []
    for dev in (card, torch.device("cpu")):
        params = [torch.nn.Parameter(torch.from_numpy(x.copy()).to(dev))
                  for x in leaves]
        sides.append((params, Adafactor(params)))
    for k in range(3):
        gs = [(rng.normal(size=s) * 10.0 ** rng.uniform(-3, 0)).astype(
            np.float32) for s in shapes]
        for params, opt in sides:
            for i, (p, g) in enumerate(zip(params, gs)):
                # leaf 100 alone in the first step: a step ahead after it
                p.grad = torch.from_numpy(g).to(p.device) \
                    if k > 0 or i == 100 else None
            opt.step()
    (kp, kopt), (cp, copt) = sides
    torch.cuda.synchronize()
    # steps 2 and 3: chunks [0, 64), [64, 100), [100], [101, 165), ...
    assert kopt.launches == 4 + 2 * 4 * 7
    for i, (a, b) in enumerate(zip(kp, cp)):
        got, want = a.detach().cpu().numpy(), b.detach().numpy()
        excess = np.abs(got - want) - (
            1e-5 * np.abs(want - leaves[i])
            + 3 * np.spacing(np.maximum(np.abs(leaves[i]), np.abs(want))))
        assert excess.max() <= 0, (i, excess.max())
        for key, m in copt.state[b].items():
            if key != "step":
                np.testing.assert_allclose(
                    kopt.state[a][key].cpu().numpy(), m.numpy(), rtol=1e-6,
                    atol=0, err_msg=f"leaf {i}: moment {key}")


# --------------------------------------------------------------------- #
# the hybrid decoder (models/granite_hybrid.py) and kernel 6             #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
def test_ssm_state_update_kernel_matches_plain_at_published_widths(
        card, state_dtype):
    """Kernel 6 against its plain version on the card at granite-4.0-h's
    widths (H 128, P 64, N 128, G 1) and 128 rows, 3 steps in place, each
    from the same state: y and the state within 1e-5 relative of the
    largest (float32: the two sum h * C in other orders and the kernel
    fuses the update's multiply and add), a bfloat16 state within one of
    its ulps (the two round float32 values an ulp of float32 apart), both
    above a floor of float32 round-off where the update cancels."""
    from music2midi_tpu_torch.ops import ssm_state_update as su

    g = torch.Generator(device=card).manual_seed(3)
    B, H, P, N = 128, 128, 64, 128

    def normal(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=card) * scale

    h0 = normal(B, H, P, N, scale=0.1).to(state_dtype)
    A = -torch.exp(torch.rand(H, generator=g, device=card) * 2.7)
    D = torch.ones(H, device=card)
    hk, hp = h0.clone(), h0.clone()
    before = su.ssm_state_update.launches
    for _ in range(3):
        hp.copy_(hk)
        x, Bm, Cm = normal(B, H, P), normal(B, 1, N), normal(B, 1, N)
        dt = torch.rand(B, H, generator=g, device=card) * 0.1
        yk = su.ssm_state_update(hk, x, dt, A, Bm, Cm, D)
        yp = su.ssm_state_update_plain(hp, x, dt, A, Bm, Cm, D)
        torch.cuda.synchronize()
        assert float((yk - yp).abs().max()) <= 1e-5 * float(yp.abs().max())
    assert su.ssm_state_update.launches == before + 3
    err = (hk.float() - hp.float()).abs()
    floor = 1e-6 * float(hp.float().abs().max())  # float32 round-off
    if state_dtype == torch.float32:
        assert float(err.max()) <= 10 * floor
    else:
        ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(
            hk.float().abs(), hp.float().abs())
        assert bool((err <= ulp + floor).all())


def _hybrid_published(card):
    """granite4h-small-p1's decoder (configs/granite4h_small_p1.yaml) at
    its published widths, random from seed 7, bf16 on the card."""
    from music2midi_tpu_torch.config import load_config
    from music2midi_tpu_torch.models import granite_hybrid as gh

    root = Path(__file__).resolve().parent.parent
    cfg = gh.hybrid_config_from(
        load_config(root / "configs" / "granite4h_small_p1.yaml"),
        dtype=torch.bfloat16)
    return gh.GraniteHybrid.from_seed(cfg, 7, card), cfg


def test_hybrid_captured_step_matches_eager_at_published_widths(card):
    """The hybrid's decode loop captured (two phases of its KV: 256 and
    290 positions) against the same loop stepped eagerly from a fresh
    program, at 128 rows behind a random 190-position prefix: tokens
    equal; every routed token counted (rows x top-k a layer step); kernel
    6 launched once a Mamba layer a step under replay; the T5 step's
    kernels 7-10 never."""
    from music2midi_tpu_torch.infer.decode import (
        DecodeConfig, generate_tokens, generate_tokens_eager, program_for)
    from music2midi_tpu_torch.ops import decode_fused as df
    from music2midi_tpu_torch.ops import ssm_state_update as su

    model, cfg = _hybrid_published(card)
    g = torch.Generator(device=card).manual_seed(11)
    prefix = torch.randn(128, 190, 384, generator=g, device=card).bfloat16()
    dcfg = DecodeConfig(max_length=100)
    fused = [w.launches for w in df.wrappers()]
    eager, eager_len = generate_tokens_eager(model, prefix, cfg, dcfg)
    generate_tokens(model, prefix, cfg, dcfg)  # eager first bodies, capture
    prog = program_for(model, prefix, cfg, dcfg)
    assert sorted(prog.graphs) == [256, 290]
    before = su.ssm_state_update.launches
    got, got_len = generate_tokens(model, prefix, cfg, dcfg)
    torch.cuda.synchronize()
    assert torch.equal(got, eager) and torch.equal(got_len, eager_len)
    assert su.ssm_state_update.launches - before == 9 * 99
    assert [w.launches for w in df.wrappers()] == fused
    per_layer = prog.counters[0].sum(1)
    assert per_layer.tolist() == [128 * 10 * 99] * 10
    assert bool((prog.counters[1] >= -(-128 * 10 // 72) * 99).all())


def test_hybrid_replayed_steps_make_no_host_sync(card):
    """Replays of the captured hybrid step under
    ``torch.cuda.set_sync_debug_mode("error")``: no host synchronisation
    inside the steps (the loop's one read-back a step is outside them)."""
    from music2midi_tpu_torch.infer.decode import (
        DecodeConfig, generate_tokens, program_for)

    model, cfg = _hybrid_published(card)
    prefix = torch.zeros(64, 190, 384, device=card, dtype=torch.bfloat16)
    dcfg = DecodeConfig(max_length=40)
    generate_tokens(model, prefix, cfg, dcfg)
    prog = program_for(model, prefix, cfg, dcfg)
    (phase,) = prog.graphs
    prog.step.zero_()  # the generation left it at the cache's end
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(5):
            prog._iterate(phase, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# --------------------------------------------------------------------- #
# kernels 7-10: the decode step's fused glue (csrc/decode_fused.cu)      #
# --------------------------------------------------------------------- #

# the serving shapes: 128 rows of the model of record
_B, _DM, _H, _DK, _L, _FF, _V = 128, 384, 8, 64, 1024, 1152, 400
_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _randn(card, seed, *shape, dtype=torch.bfloat16, scale=1.0):
    g = torch.Generator(device=card).manual_seed(seed)
    return (torch.randn(*shape, generator=g, device=card) * scale).to(dtype)


def _ulps(a, b):
    """Each pair's distance in ulps of their dtype (bf16 or f32), read off
    the bit patterns; a pair of opposite signs counts its two distances
    from zero."""
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[a.dtype]
    ia = a.contiguous().view(ints).long()
    ib = b.contiguous().view(ints).long()
    sign = 1 << (8 * a.element_size() - 1)
    mag_a = torch.where(ia < 0, ia + sign, ia)
    mag_b = torch.where(ib < 0, ib + sign, ib)
    same = (ia < 0) == (ib < 0)
    return torch.where(same, (mag_a - mag_b).abs(), mag_a + mag_b)


@pytest.mark.parametrize("dtype,w_dtype", [("bfloat16", "float32"),
                                           ("bfloat16", "bfloat16"),
                                           ("float32", "float32")])
@pytest.mark.parametrize("rows,d", [(128, 384), (8, 384), (1, 384),
                                    (128, 64), (4, 16)])
def test_add_rms_norm_kernel_matches_plain_on_card(card, rows, d, dtype,
                                                   w_dtype):
    """Kernel 7 against its twin (ATen's chain) on the card: the new x
    bit for bit; the norm bit-equal on at least 99.9 % of its values and
    never more than one ulp of its dtype off (the two may sum the squares
    in another order); the same through the embedding gather."""
    from music2midi_tpu_torch.ops import decode_fused as df

    dt = _DT[dtype]
    x = _randn(card, 1, rows, 1, d, dtype=dt, scale=3.0)
    delta = _randn(card, 2, rows, 1, d, dtype=dt)
    w = (_randn(card, 3, d, dtype=torch.float32) * 0.2 + 1.0).to(_DT[w_dtype])
    xk, xp = x.clone(), x.clone()
    before = df.add_rms_norm.launches
    hk = df.add_rms_norm(xk, delta, w, 1e-6)
    hp = df.add_rms_norm_plain(xp, delta, w, 1e-6)
    table = _randn(card, 4, _V, d, dtype=dt, scale=2.0)
    token = torch.randint(0, _V, (rows,), device=card, dtype=torch.int32)
    ek, gk = df.embed_rms_norm(table, token, w, 1e-6)
    ep, gp = df.embed_rms_norm_plain(table, token.long(), w, 1e-6)
    torch.cuda.synchronize()
    assert df.add_rms_norm.launches == before + 2
    assert torch.equal(xk, xp) and torch.equal(ek, ep)
    for got, want in ((hk, hp), (gk, gp)):
        ulps = _ulps(got, want)
        assert int(ulps.max()) <= 1, int(ulps.max())
        assert float((ulps == 0).float().mean()) >= 0.999


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gelu_mul_kernel_equals_plain_on_card(card, dtype):
    """Kernel 9 against ATen's ``gelu_new(gate) * lin`` chain on the card,
    bit for bit, over values from 1e-6 to 40 in size."""
    from music2midi_tpu_torch.ops import decode_fused as df

    gl = _randn(card, 5, _B, 1, 2 * _FF, dtype=_DT[dtype], scale=3.0)
    gl[:4] *= 1e-5
    gl[4:8] *= 12.0
    before = df.gelu_mul.launches
    got = df.gelu_mul(gl)
    want = df.gelu_mul_plain(gl)
    torch.cuda.synchronize()
    assert df.gelu_mul.launches == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("step", [0, 517, 1023])
@pytest.mark.parametrize("levels", [127.0, 7.0])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantize_write_kv_kernel_equals_plain_on_card(card, dtype, levels,
                                                       step):
    """Kernel 8 against the twin's quantize and ``index_copy_`` on the
    card: the fresh rows, their scales and both whole cache entries bit
    for bit (a zero row keeps the 1e-8 floor); a step off the cache
    writes nothing."""
    from music2midi_tpu_torch.ops import decode_fused as df

    dt = _DT[dtype]
    qkv = _randn(card, 6, _B, 1, 3 * _H * _DK, dtype=dt, scale=4.0)
    qkv[3, 0, _H * _DK:_H * _DK + _DK] = 0.0

    def entries():
        g = torch.Generator(device=card).manual_seed(7)
        return [(torch.randint(-127, 128, (_B, _H, _L, _DK), generator=g,
                               device=card, dtype=torch.int8),
                 torch.rand(_B, _H, 1, _L, generator=g, device=card))
                for _ in range(2)]

    ours, theirs = entries(), entries()
    s = torch.tensor(step, dtype=torch.int32, device=card)
    before = df.quantize_write_kv.launches
    got = df.quantize_write_kv(qkv, *ours, s, levels)
    want = df.quantize_write_kv_plain(qkv, *theirs, s, levels)
    torch.cuda.synchronize()
    assert df.quantize_write_kv.launches == before + 1
    for (q8, sc), (wq8, wsc) in zip(got, want):
        assert torch.equal(q8, wq8) and torch.equal(sc, wsc)
    for a, b in zip(ours, theirs):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    df.quantize_write_kv(qkv, *ours, torch.tensor(
        _L, dtype=torch.int32, device=card), levels)
    torch.cuda.synchronize()
    for a, b in zip(ours, theirs):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("suppress", [(), (2, 17, 399)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_greedy_commit_kernel_equals_plain_on_card(card, dtype, suppress):
    """Kernel 10 against the twin's selection chain over five steps at 128
    rows and 400 ids: ties (the first wins), a NaN (it wins), EOS, rows
    already done, the suppressed ids; the logits, done, tokens, token and
    step bit for bit."""
    from music2midi_tpu_torch.ops import decode_fused as df

    dt = _DT[dtype]
    sup = torch.tensor(suppress, dtype=torch.long, device=card) \
        if suppress else None

    def state():
        done = torch.zeros(_B, dtype=torch.bool, device=card)
        done[::7] = True
        return [done, torch.zeros(_B, 1 + _L, dtype=torch.int32, device=card),
                torch.zeros(_B, dtype=torch.int32, device=card),
                torch.tensor(40, dtype=torch.int32, device=card)]

    ours, theirs = state(), state()
    before = df.greedy_commit.launches
    for k in range(5):
        logits = _randn(card, 10 + k, _B, _V, dtype=dt, scale=4.0)
        logits[1, 5] = logits[1, 300] = 99.0  # a tie
        logits[2] = 1.0  # all tied
        logits[3, 77] = float("nan")
        logits[4 + k, 2] = 50.0  # EOS, unless suppressed
        logits[9, 17] = 60.0  # suppressed when 17 is
        mine = logits.clone()
        df.greedy_commit(mine, sup, *ours, 0, 2)
        df.greedy_commit_plain(logits, sup, *theirs, 0, 2)
        torch.cuda.synchronize()
        assert torch.equal(mine.isnan(), logits.isnan())
        assert torch.equal(mine.nan_to_num(), logits.nan_to_num())
        for a, b in zip(ours, theirs):
            assert torch.equal(a, b)
    assert df.greedy_commit.launches == before + 5
    assert int(ours[3]) == 45
    assert int(ours[2][3]) == 77 and int(ours[2][2]) == 0


def test_fused_wrappers_raise_on_what_the_kernels_do_not_take(card):
    """A CUDA tensor the kernels do not take raises; nothing falls back."""
    from music2midi_tpu_torch.ops import decode_fused as df

    for d in (130, 386, 1028):  # above 128 not a multiple of 4, or > 1024
        x = torch.zeros(4, 1, d, device=card, dtype=torch.bfloat16)
        w = torch.ones(d, device=card)
        with pytest.raises(ValueError):
            df.add_rms_norm(x, x.clone(), w, 1e-6)
    with pytest.raises(ValueError):
        df.gelu_mul(torch.zeros(8, 4, device=card).t())
    logits = torch.zeros(4, _V, device=card)
    tokens = torch.zeros(4, 9, dtype=torch.int64, device=card)
    with pytest.raises(ValueError):
        df.greedy_commit(logits, None, torch.zeros(4, dtype=torch.bool,
                                                   device=card), tokens,
                         tokens[:, 0], torch.zeros((), dtype=torch.int32,
                                                   device=card), 0, 2)


def test_captured_fused_loop_equals_eager_at_128_rows(card):
    """The song's encoder output twice over (128 rows) decoded by the
    captured loop (a capture, then a replay) and by its eager twin: tokens
    and lengths equal; under replay the four wrappers count what the graph
    holds, 6 x 5 + 2 a step (19 norms, 6 quantize-writes, 6 gelu_mul, 1
    greedy_commit), and the ``decode`` span's ``fused_launches`` says the
    same."""
    import sys

    from music2midi_tpu_torch import profiling
    from music2midi_tpu_torch.infer import Music2MIDI
    from music2midi_tpu_torch.infer.decode import (
        generate_tokens,
        generate_tokens_eager,
        program_for,
    )
    from music2midi_tpu_torch.ops import decode_fused as df

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from chip_smoke import synthetic_song

    engine = Music2MIDI.from_npz(RECORD, dtype=torch.bfloat16)
    chunks = engine._chunk_waveform(synthetic_song(180.0, 16000, seed=7))
    batch, cond = engine._pad_batch(chunks)
    enc = engine._encoder(engine._log_mel(engine._device_wave(batch)), cond)
    enc = torch.cat([enc, enc])[:128]
    assert enc.shape[0] == 128
    cfg, dcfg = engine.t5_config, engine._dcfg()._replace(max_length=300)
    want_t, want_l = generate_tokens_eager(engine.model, enc, cfg, dcfg)
    generate_tokens(engine.model, enc, cfg, dcfg)  # capture
    graph = program_for(engine.model, enc, cfg, dcfg).graphs
    (g,) = graph.values()
    per_step = dict(zip(("add_rms_norm", "quantize_write_kv", "gelu_mul",
                         "greedy_commit"), g.launches[-4:]))
    assert per_step == {"add_rms_norm": 19, "quantize_write_kv": 6,
                        "gelu_mul": 6, "greedy_commit": 1}
    before = [w.launches for w in df.wrappers()]
    profiling.clear_spans()
    with profiling.recording():
        got_t, got_l = generate_tokens(engine.model, enc, cfg, dcfg)
    torch.cuda.synchronize()
    assert torch.equal(got_t, want_t) and torch.equal(got_l, want_l)
    steps = int(want_l.max()) - 1
    counted = [w.launches - b for w, b in zip(df.wrappers(), before)]
    assert counted == [n * steps for n in per_step.values()]
    (sp,) = [s for s in profiling.spans() if s["name"] == "decode"]
    assert sp["attrs"]["fused_launches"] == 32 * steps
    assert sp["attrs"]["steps"] == steps
