"""Port decode options against the JAX package: int8 weights, 4-bit KV,
unroll, suppressed tokens and sampling (CPU, small widths).

Bars: ``_quantize_w`` values equal to JAX's and scales within 1 ulp; the
folded int8 ``_proj`` within 1e-5 of JAX's in fp32 and within one bf16
step in bf16; ``_quantize_kv(bits=4)`` values equal to JAX's int4 values,
the round trip within amax / 14; the plain int8 attention on +-7 entries
within 1e-6 of JAX ``_attention_int8`` on int4 entries (f32 query), and
equal to it in bf16 (``round_pv``); fp32 greedy tokens and lengths equal
to JAX ``generate_tokens`` with ``quantize_weights``, with 4-bit KV, with
``unroll`` 2, 3 and 8 (also equal to ``unroll=1``) and with EOS
suppressed; sampling reproducible per seed, different across seeds, every
draw in the top-k, and 20 000 draws within total-variation distance 0.02
of softmax(logits / T).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music2midi_tpu.infer.decode import DecodeConfig as JaxDecodeConfig
from music2midi_tpu.infer.decode import generate_tokens as jax_generate
from music2midi_tpu.models import t5 as jt5
from music2midi_tpu_torch.infer.decode import (
    DecodeConfig,
    _select_next,
    generate_tokens,
)
from music2midi_tpu_torch.models import t5 as pt5
from music2midi_tpu_torch.ops.decode_attention import (
    decode_attention_int8_plain,
)
from music2midi_tpu_torch.weights import params_from_jax

SHAPE = dict(d_model=64, d_kv=16, num_heads=4, d_ff=96, num_layers=2,
             num_decoder_layers=2)
MAX_LEN = 40


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


def _bf16_steps(a, b):
    """Distance in bf16 steps between two float32 arrays of bf16 values
    (sign and magnitude as one ordered integer)."""
    def ordered(x):
        u = (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(np.int64)
        return np.where(u & 0x8000, -(u & 0x7FFF), u)
    return np.abs(ordered(a) - ordered(b))


def test_quantize_w_equals_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 96)).astype(np.float32)
    w[:, 5] = 0.0  # the all-zero column guard
    jq, js = jt5._quantize_w(jnp.asarray(w))
    pq, ps = pt5._quantize_w(torch.from_numpy(w))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_max_ulp(ps.numpy(), np.asarray(js), maxulp=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_folded_int8_proj_matches_jax(dtype):
    """The f32 product scaled before its one rounding to the compute
    dtype, as JAX scales its f32 accumulator."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64, 96)).astype(np.float32)
    jd, pd = getattr(jnp, dtype), getattr(torch, dtype)
    jw = jt5._quantize_w(jnp.asarray(w))
    pw = pt5._quantize_w(torch.from_numpy(w))
    want = np.asarray(jt5._proj(jnp.asarray(x).astype(jd), jw, jd),
                      dtype=np.float32)
    got = pt5._proj(torch.from_numpy(x).to(pd), pw, pd)
    assert got.dtype == pd
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _bf16_steps(got, want).max() <= 1


def test_quantize_kv_4bit_equals_jax_int4():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, 9, 16)).astype(np.float32)
    x[0, 0, 3] = 0.0  # the all-zero position guard
    jq, js = jt5._quantize_kv(jnp.asarray(x), 4)
    assert jq.dtype == jnp.int4
    pq, ps = pt5._quantize_kv(torch.from_numpy(x), 4)
    assert pq.dtype == torch.int8 and int(pq.abs().max()) == 7
    np.testing.assert_array_equal(pq.numpy(),
                                  np.asarray(jq).astype(np.int8))
    np.testing.assert_array_max_ulp(ps.numpy(), np.asarray(js), maxulp=1)
    amax = np.abs(x).max(-1, keepdims=True)
    back = pq.numpy() * ps.numpy().swapaxes(-1, -2)
    assert (np.abs(back - x) <= amax / 14 * (1 + 1e-6) + 1e-12).all()
    with pytest.raises(ValueError):
        pt5._quantize_kv(torch.from_numpy(x), 6)


def _int4_cases(dtype):
    """(port plain-version arguments, JAX _attention_int8 arguments) over
    4-bit entries: causal (the post-write cache, key ``step`` also as the
    fresh rows) and cross (a pad mask)."""
    rng = np.random.default_rng(4)
    B, H, L, D = 3, 4, 12, 16
    jd, pd = getattr(jnp, dtype), getattr(torch, dtype)
    q = rng.normal(size=(B, H, 1, D)).astype(np.float32)
    jqv, pqv = jnp.asarray(q).astype(jd), torch.from_numpy(q).to(pd)

    def entry(shape):
        x = rng.normal(size=shape).astype(np.float32)
        j = jt5._quantize_kv(jnp.asarray(x), 4)
        p = pt5._quantize_kv(torch.from_numpy(x), 4)
        return j, p

    (jk, pk), (jv, pv) = entry((B, H, L, D)), entry((B, H, L, D))
    bias = rng.normal(size=(1, H, 1, L)).astype(np.float32)
    cases = []
    for step in (0, 7, L - 1):
        fresh = [(e[0][:, :, step:step + 1], e[1][..., step:step + 1])
                 for e in (pk, pv)]
        vis = (jnp.arange(L) <= step)[None, None, None, :]
        cases.append(((pqv, pk, pv, torch.from_numpy(bias), step, *fresh,
                       True, 0),
                      (jqv, jk, jv, jnp.asarray(bias), vis)))
    for enc_len in (L, 9):
        mask = (jnp.arange(L) < enc_len)[None, None, None, :]
        cases.append(((pqv, pk, pv, None, None, None, None, False, enc_len),
                      (jqv, jk, jv, None, mask)))
    return cases


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_on_4bit_entries_equals_jax(dtype):
    """The plain version of kernel 3 on +-7 entries stored in int8 against
    JAX ``_attention_int8`` on the same int4 entries: f32 (the f32
    instance) within 1e-6, bf16 (``round_pv``, the serving route) equal."""
    for port, jax_args in _int4_cases(dtype):
        want = np.asarray(
            jt5._attention_int8(*jax_args, getattr(jnp, dtype)), np.float32)
        got = decode_attention_int8_plain(*port, round_pv=True)
        assert got.dtype == getattr(torch, dtype)
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            assert _bf16_steps(got, want).max() == 0


def _both(setup, jax_kw, port_kw, max_len=MAX_LEN):
    tree, model, pcfg, enc = setup
    jt, jl = jax_generate(tree, jnp.asarray(enc), jt5.T5Config(**SHAPE),
                          JaxDecodeConfig(max_length=max_len, **jax_kw))
    pt, pl = generate_tokens(model, torch.from_numpy(enc), pcfg,
                             DecodeConfig(max_length=max_len, **port_kw))
    return (np.asarray(jt), np.asarray(jl)), (pt.numpy(), pl.numpy())


OPTIONS = {
    "int8_weights": ({"quantize_weights": True}, {"quantize_weights": True}),
    # the port's engine sends a quantized cache through kernel 3's plain
    # version (pallas_attention); JAX serves it with _attention_int8
    "kv_bits=4": ({"quantize_cross_kv": True, "quantize_self_kv": True,
                   "kv_bits": 4},
                  {"quantize_kv": True, "kv_bits": 4,
                   "pallas_attention": True}),
    "int8_weights, EOS suppressed": (
        {"quantize_weights": True, "suppress_tokens": (2,)},
        {"quantize_weights": True, "suppress_tokens": (2,)}),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_fp32_greedy_tokens_equal_jax_with_options(setup, option):
    (jt, jl), (pt, pl) = _both(setup, *OPTIONS[option])
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pl, jl)
    if "suppressed" in option:
        assert (pl == MAX_LEN).all()


@pytest.mark.parametrize("unroll", [2, 3, 8])
def test_fp32_unroll_tokens_equal_jax_and_unroll_1(setup, unroll):
    """unroll 3 and 8 do not divide the 39 generated steps: the loop
    stops at max_length all the same, and rows done keep emitting PAD."""
    (jt, jl), (pt, pl) = _both(setup, {"unroll": unroll}, {"unroll": unroll})
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pl, jl)
    tree, model, pcfg, enc = setup
    one, one_l = generate_tokens(model, torch.from_numpy(enc), pcfg,
                                 DecodeConfig(max_length=MAX_LEN))
    np.testing.assert_array_equal(pt, one.numpy())
    np.testing.assert_array_equal(pl, one_l.numpy())


def _sample(setup, seed, top_k=5):
    tree, model, pcfg, enc = setup
    g = torch.Generator().manual_seed(seed)
    t, _ = generate_tokens(model, torch.from_numpy(enc), pcfg,
                           DecodeConfig(max_length=24, temperature=1.0,
                                        top_k=top_k), g)
    return t.numpy()


def test_sampling_reproducible_per_seed(setup):
    a, b, c = _sample(setup, 7), _sample(setup, 7), _sample(setup, 8)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    # greedy ignores the generator
    tree, model, pcfg, enc = setup
    greedy = [generate_tokens(model, torch.from_numpy(enc), pcfg,
                              DecodeConfig(max_length=24),
                              torch.Generator().manual_seed(s))[0].numpy()
              for s in (1, 2)]
    np.testing.assert_array_equal(*greedy)


def test_every_draw_lies_in_the_top_k():
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.normal(size=(512, 40)).astype(np.float32))
    top = torch.topk(logits, 5, dim=-1).indices
    g = torch.Generator().manual_seed(0)
    for temperature in (0.5, 1.0, 3.0):
        dcfg = DecodeConfig(temperature=temperature, top_k=5)
        got = _select_next(logits.clone(), dcfg, g).long()
        assert (top == got[:, None]).any(dim=1).all()
    # suppressed ids are never drawn
    dcfg = DecodeConfig(temperature=1.0, suppress_tokens=tuple(range(20)))
    assert (_select_next(logits.clone(), dcfg, g) >= 20).all()


def test_sampling_distribution_within_tv_002():
    """20 000 draws on fixed logits, temperature 0.7: the empirical
    frequencies within total-variation distance 0.02 of
    softmax(logits / 0.7)."""
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.25])
    n = 20_000
    dcfg = DecodeConfig(temperature=0.7)
    g = torch.Generator().manual_seed(1)
    draws = _select_next(logits.repeat(n, 1), dcfg, g).long()
    freq = torch.bincount(draws, minlength=len(logits)).double() / n
    want = torch.softmax(logits.double() / 0.7, dim=0)
    tv = 0.5 * float((freq - want).abs().sum())
    assert tv <= 0.02, tv
