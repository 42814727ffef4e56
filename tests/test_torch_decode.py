"""Port decode loop and detokenizer against the JAX package.

Bars: greedy tokens and lengths exactly equal to JAX ``generate_tokens``
in fp32; in the int8-KV serving mode (bf16) teacher-forced logits within
one bf16 ulp and the argmax equal wherever it is not a near-tie, with the
free-running token agreement recorded; the device detokenizer exactly
equal to the JAX ``detokenize`` and to the host tokenizer on fuzzed and
grammatical streams.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music2midi_tpu.infer.decode import DecodeConfig as JaxDecodeConfig
from music2midi_tpu.infer.decode import generate_tokens as jax_generate
from music2midi_tpu.models import t5 as jt5
from music2midi_tpu.ops.detokenize import detokenize as jax_detokenize
from music2midi_tpu_torch.infer.decode import DecodeConfig, generate_tokens
from music2midi_tpu_torch.models import t5 as pt5
from music2midi_tpu_torch.ops.detokenize import detokenize, detokenize_to_host
from music2midi_tpu_torch.tokenizer import EOS, OFFSET, ONSET, MidiTokenizer
from music2midi_tpu_torch.weights import params_from_jax

SHAPE = dict(d_model=64, d_kv=16, num_heads=4, d_ff=96, num_layers=2,
             num_decoder_layers=2)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads per parallel test worker (see
    test_torch_pipeline.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup():
    tree = jt5.init_params(11, jt5.T5Config(**SHAPE))
    pcfg = pt5.T5Config(**SHAPE)
    model = pt5.T5Model.from_state_dict(params_from_jax(tree), pcfg)
    rng = np.random.default_rng(3)
    enc = rng.normal(size=(4, 25, 64)).astype(np.float32)
    return tree, model, pcfg, enc


@pytest.mark.parametrize("suppress", [(), (2,)])
def test_greedy_tokens_and_lengths_equal_jax_fp32(setup, suppress):
    """suppress=(EOS,) forces every row to the full length; the default
    exits early once every row has emitted EOS."""
    tree, model, pcfg, enc = setup
    jt, jl = jax_generate(
        tree, jnp.asarray(enc), jt5.T5Config(**SHAPE),
        JaxDecodeConfig(max_length=40, suppress_tokens=suppress))
    pt, pl = generate_tokens(model, torch.from_numpy(enc), pcfg,
                             DecodeConfig(max_length=40,
                                          suppress_tokens=suppress))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))


def test_int8_kv_serving_mode_token_agreement(setup):
    """bf16 + int8 self/cross KV.  Teacher-forced on the JAX tokens, every
    step's logits agree within 0.0625 (one bf16 ulp at |logit| in [8, 16):
    the two frameworks round bf16 at different places) and the argmax
    agrees wherever JAX's top-2 gap exceeds twice that.  The free-running
    token agreement, where one flipped near-tie changes the rest of the
    row, is recorded."""
    tree, model, pcfg, enc = setup
    B, max_len, tol = enc.shape[0], 40, 0.0625
    jcfg = jt5.T5Config(**SHAPE, dtype=jnp.bfloat16)
    pcfg = pcfg._replace(dtype=torch.bfloat16)
    enc_bf = torch.from_numpy(enc).to(torch.bfloat16)
    jenc = jnp.asarray(enc).astype(jnp.bfloat16)
    jcross = jt5.precompute_cross_kv(tree, jenc, jcfg, quantize=True)
    jcache = jt5.init_kv_cache(B, max_len, jcfg, quantize=True)
    jdp = jt5.prepare_decode_params(tree, jcfg)
    dp = pt5.prepare_decode_params(model, pcfg)
    rows = pt5.decoder_bias_rows(dp["rel_bias"], max_len, pcfg)
    pcross = pt5.precompute_cross_kv(model, enc_bf, pcfg, quantize=True)
    pcache = pt5.init_kv_cache(B, max_len, pcfg, quantize=True)
    tok = np.ones(B, np.int32)
    jax_greedy = []
    for step in range(30):
        lj, jcache = jt5.decode_step(jdp, jnp.asarray(tok), jnp.int32(step),
                                     jcache, jcross, jcfg, max_len)
        lp = pt5.decode_step(dp, torch.from_numpy(tok).long(), step, pcache,
                             pcross, pcfg, rows).float().numpy()
        lj = np.asarray(lj).astype(np.float32)
        lj[:, 2] = lp[:, 2] = -np.inf  # EOS suppressed: full-length rows
        np.testing.assert_allclose(lp, lj, atol=tol)
        top2 = np.sort(lj, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * tol
        np.testing.assert_array_equal(lp.argmax(-1)[clear],
                                      lj.argmax(-1)[clear])
        tok = lj.argmax(-1).astype(np.int32)
        jax_greedy.append(tok)

    pt, _ = generate_tokens(model, enc_bf, pcfg, DecodeConfig(
        max_length=31, suppress_tokens=(2,), quantize_kv=True))
    agree = float((pt.numpy()[:, 1:] == np.stack(jax_greedy, 1)).mean())
    print(f"int8-KV bf16 free-running token agreement vs JAX: {agree:.4f}")


def _pad_batch(seqs):
    L = max(len(s) for s in seqs)
    out = np.zeros((len(seqs), L), np.int32)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return out


def _assert_matches(seqs, start_idx=None):
    tok = MidiTokenizer()
    batch = _pad_batch(seqs)
    start = (np.zeros(len(seqs), np.int32) if start_idx is None
             else np.asarray(start_idx, np.int32))
    pn, pv = detokenize(torch.from_numpy(batch), torch.from_numpy(start))
    jn, jv = jax_detokenize(jnp.asarray(batch), jnp.asarray(start))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pn.numpy()[pv.numpy()],
                                  np.asarray(jn)[np.asarray(jv)])
    dev = detokenize_to_host(torch.from_numpy(batch), torch.from_numpy(start),
                             tok.time_step)
    for i, s in enumerate(seqs):
        host = tok._decode(np.asarray(s), int(start[i]))
        np.testing.assert_allclose(dev[i], host, atol=1e-9)
    return dev


def T(i):
    return 133 + i


def P(p):
    return 5 + p


def test_detokenize_fuzzed_streams():
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 400, size=rng.integers(5, 120)).astype(np.int32)
            for _ in range(64)]
    _assert_matches(seqs)


def test_detokenize_grammatical_streams_and_offsets():
    rng = np.random.default_rng(1)
    seqs = []
    for _ in range(32):
        toks, t = [], 0
        while t < 190 and len(toks) < 200:
            toks.append(T(min(t, 199)))
            for marker in (ONSET, OFFSET):
                if rng.random() < 0.8:
                    toks.append(marker)
                    toks += [P(int(p)) for p in
                             rng.integers(40, 90, size=rng.integers(1, 4))]
            t += int(rng.integers(1, 8))
        toks.append(EOS)
        seqs.append(toks)
    dev = _assert_matches(seqs, start_idx=np.arange(32) * 60)
    assert sum(len(d) for d in dev) > 100
