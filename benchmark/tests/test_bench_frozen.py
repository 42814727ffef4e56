"""The frozen yardstick: FLOP and byte counts against hand counts, the
trace reading on hand-made events, and the frozen tokenizer against the
port's."""

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.frozen import flops, tokenizer, trace

TINY = SimpleNamespace(d_model=4, d_kv=2, num_heads=2, d_ff=3, num_layers=1,
                       num_decoder_layers=1, vocab_size=5)


def test_encoder_flops_by_hand():
    # one layer, L = 3: q k v o 4*2*3*4*4 = 384; scores and values
    # 2*2*3*3*4 = 144; ffn 3*2*3*4*3 = 216
    assert flops.encoder_fwd_flops(TINY, 1, 3) == 384 + 144 + 216
    assert flops.encoder_fwd_flops(TINY, 2, 3) == 2 * 744


def test_decoder_and_train_flops_by_hand():
    # T = 2, L = 3: proj 4*2*2*4*4 = 256; causal pairs 3 -> 2*2*3*4 = 48;
    # cross q,o 2*2*2*4*4 = 128; cross k,v 2*2*3*4*4 = 192; cross
    # scores+values 2*2*2*3*4 = 96; ffn 3*2*2*4*3 = 144; lm_head 2*2*4*5
    dec = 256 + 48 + 128 + 192 + 96 + 144 + 80
    assert flops.decoder_fwd_flops(TINY, 1, 3, 2) == dec
    assert flops.train_step_flops(TINY, 1, 3, 2) == 3 * (744 + dec)


def test_decode_flops_by_hand():
    # 2 steps over L = 3: cross k,v once 2*2*3*4*4 = 192; per layer proj
    # 256, causal 48, cross q,o 128, cross attention 96, ffn 144;
    # lm_head 80; plus the encoder
    want = 744 + 192 + 256 + 48 + 128 + 96 + 144 + 80
    assert flops.decode_flops(TINY, 1, 3, 2) == want


def test_attention_bound_by_hand():
    # B 1, H 2, D 4, n 3: K and V rows 2*1*2*3*(4+4) = 96 bytes, q and out
    # 2*1*2*4*2 = 32, causal bias 2*3*4 = 24
    b = flops.attention_bound_s(1, 2, 4, 3, True)
    assert b == pytest.approx(max(152 / flops.HBM_BYTES_PER_S,
                                  4 * 2 * 3 * 4 / flops.FP32_FLOPS_PER_S))
    b = flops.attention_bound_s(1, 2, 4, 3, False)
    assert b == pytest.approx(128 / flops.HBM_BYTES_PER_S)


def test_decode_attention_bound_sums_each_step_and_layer():
    cfg = SimpleNamespace(num_heads=2, d_kv=4, num_decoder_layers=3)
    want = 3 * sum(flops.attention_bound_s(5, 2, 4, s + 1, True)
                   + flops.attention_bound_s(5, 2, 4, 7, False)
                   for s in range(4))
    assert flops.decode_attention_bound_s(cfg, 5, 4, 7) == pytest.approx(want)


def _ev(name, cat, ts, dur, corr=0):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "corr": corr}


EVENTS = [
    _ev("bench.traced_slice", "host", 0.0, 100.0),
    _ev("cudaGraphLaunch", "runtime", 1.0, 2.0, corr=1),
    _ev("k_a", "device", 5.0, 10.0, corr=1),
    _ev("k_b", "device", 12.0, 8.0, corr=1),  # overlaps k_a
    _ev("cudaStreamSynchronize", "runtime", 20.0, 30.0, corr=2),
    _ev("k_a", "device", 40.0, 10.0, corr=3),
    _ev("cudaLaunchKernel", "runtime", 150.0, 1.0, corr=3),  # outside
]
WINDOW = (0.0, 100.0)


def test_busy_and_idle_by_hand():
    assert trace.busy_intervals(EVENTS, WINDOW) == [(5.0, 20.0),
                                                    (40.0, 50.0)]
    assert trace.busy_us(EVENTS, WINDOW) == 25.0
    assert trace.idle_share(EVENTS, WINDOW) == pytest.approx(0.75)


def test_kernel_time_counts_launches_in_the_window_by_correlation():
    assert trace.kernel_us(EVENTS, "k_a", WINDOW) == (10.0, 1)
    assert trace.kernel_us(EVENTS, "k_a") == (20.0, 2)


def test_top_device_ops_and_named_idle_gaps():
    assert trace.top_device_ops(EVENTS, WINDOW) == [["k_a", 20e-6],
                                                    ["k_b", 8e-6]]
    gaps = dict(trace.idle_gaps(EVENTS, WINDOW))
    # 0-5 under the graph launch's span? no: its mid 2.5 is in the launch
    assert gaps["cudaGraphLaunch"] == pytest.approx(5e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(20e-6)
    assert gaps["bench.traced_slice"] == pytest.approx(50e-6)
    assert sum(gaps.values()) == pytest.approx(75e-6)


def test_frozen_tokenizer_is_the_ports():
    from music2midi_tpu_torch.tokenizer import MidiTokenizer

    tok = MidiTokenizer()
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(0, 12))
        on = rng.uniform(0, 3, n)
        notes = np.stack([on, on + rng.uniform(0.01, 2, n),
                          rng.integers(21, 109, n), np.full(n, 80)], 1)
        want = tok.encode(notes)
        got = tokenizer.encode(notes)
        assert np.array_equal(got, want)
        # decode: random token soup, as a model may emit
        toks = np.concatenate([[1], rng.integers(3, 400, 40), [2]])
        steps = tokenizer.decode_steps(toks, 60)
        ref = tok._decode(toks, 60)
        assert sorted(steps) == sorted(
            (int(round(a / 0.05)), int(round(b / 0.05)), int(p))
            for a, b, p, _ in ref)
