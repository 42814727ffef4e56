"""Port T5 against the JAX T5 on the same weights and inputs (fp32, CPU).

Bars: encoder output and logits within 2e-3 (the JAX package's own HF
parity bar, COMPONENTS.md / test_t5_parity.py), greedy tokens exactly
equal; the int8 KV pieces within 1e-5 of their JAX twins (same fp32
arithmetic, summation order apart).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music2midi_tpu.models import t5 as jt5
from music2midi_tpu.train.checkpoint import load_params_npz
from music2midi_tpu_torch.models import t5 as pt5
from music2midi_tpu_torch.weights import params_from_jax

RECORD = Path(__file__).resolve().parent.parent / "checkpoints" \
    / "model_of_record.npz"
SMALL = dict(d_model=64, d_kv=16, num_heads=4, d_ff=96, num_layers=2,
             num_decoder_layers=2)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads per parallel test worker (see
    test_torch_pipeline.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _pair(tree, **shape):
    jcfg = jt5.T5Config(**shape)
    pcfg = pt5.T5Config(**shape)
    model = pt5.T5Model.from_state_dict(params_from_jax(tree), pcfg)
    return jcfg, pcfg, model


@pytest.fixture(scope="module")
def small():
    tree = jt5.init_params(3, jt5.T5Config(**SMALL))
    return (tree,) + _pair(tree, **SMALL)


@pytest.fixture(scope="module")
def record():
    tree, _ = load_params_npz(RECORD)
    return (tree,) + _pair(tree)


def _embeds(rng, b, l, d):
    return rng.normal(size=(b, l, d)).astype(np.float32)


@pytest.mark.parametrize("which", ["small", "record"])
def test_encoder_and_decoder_logits_match_jax(which, request):
    tree, jcfg, pcfg, model = request.getfixturevalue(which)
    rng = np.random.default_rng(0)
    L = 40 if which == "small" else 96
    emb = _embeds(rng, 2, L, jcfg.d_model)
    cond = rng.integers(0, 3, size=(2, 2)).astype(np.int32)
    emb_j = jt5.conditioning_prepend(tree, jnp.asarray(emb), jnp.asarray(cond))
    emb_p = pt5.conditioning_prepend(model, torch.from_numpy(emb),
                                     torch.from_numpy(cond).long())
    np.testing.assert_array_equal(emb_p.numpy(), np.asarray(emb_j))
    enc_j = np.asarray(jt5.encode(tree, emb_j, jcfg))
    enc_p = pt5.encode(model, emb_p, pcfg).numpy()
    np.testing.assert_allclose(enc_p, enc_j, atol=2e-3)
    ids = rng.integers(3, 400, size=(2, 12)).astype(np.int32)
    ids[:, 0] = 1
    lj = np.asarray(jt5.decoder_forward(tree, jnp.asarray(ids),
                                        jnp.asarray(enc_j), jcfg))
    lp = pt5.decoder_forward(model, torch.from_numpy(ids).long(),
                             torch.from_numpy(np.array(enc_j)), pcfg).numpy()
    np.testing.assert_allclose(lp, lj, atol=2e-3)


@pytest.mark.parametrize("which", ["small", "record"])
def test_decode_steps_match_jax_greedy(which, request):
    """Step the JAX decode_step and the port's decode_step side by side
    from the same encoder output: logits within 2e-3 and the same argmax
    at every step (fp32, plain KV)."""
    tree, jcfg, pcfg, model = request.getfixturevalue(which)
    rng = np.random.default_rng(1)
    enc = _embeds(rng, 2, 30, jcfg.d_model)
    steps = 12 if which == "small" else 6
    max_len = 16
    jcross = jt5.precompute_cross_kv(tree, jnp.asarray(enc), jcfg)
    jcache = jt5.init_kv_cache(2, max_len, jcfg)
    dparams = pt5.prepare_decode_params(model, pcfg)
    rows = pt5.decoder_bias_rows(dparams["rel_bias"], max_len, pcfg)
    pcross = pt5.precompute_cross_kv(model, torch.from_numpy(enc), pcfg)
    pcache = pt5.init_kv_cache(2, max_len, pcfg)
    tok = np.full((2,), 1, np.int32)
    for step in range(steps):
        lj, jcache = jt5.decode_step(tree, jnp.asarray(tok), jnp.int32(step),
                                     jcache, jcross, jcfg, max_len)
        lp = pt5.decode_step(dparams, torch.from_numpy(tok).long(), step,
                             pcache, pcross, pcfg, rows)
        lj = np.asarray(lj)
        np.testing.assert_allclose(lp.numpy(), lj, atol=2e-3)
        nxt = lj.argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(lp.numpy().argmax(-1), nxt)
        tok = nxt


def test_quantize_kv_matches_jax():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 4, 9, 16)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0  # the amax guard
    x[1, 2, 3, :2] = [127 * 0.5, -127 * 0.5]  # exact halves: round to even
    qj, sj = jt5._quantize_kv(jnp.asarray(x))
    qp, sp = pt5._quantize_kv(torch.from_numpy(x))
    assert qp.dtype == torch.int8 and sp.shape == (2, 4, 1, 9)
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_int8_matches_jax(dtype):
    """fp32 within 1e-5; bf16 within 2e-2 (one bf16 rounding of the
    output, ~2^-8 relative, on values of order 1)."""
    rng = np.random.default_rng(4)
    B, H, L, D = 2, 4, 11, 16
    q = rng.normal(size=(B, H, 1, D)).astype(np.float32)
    k = rng.normal(size=(B, H, L, D)).astype(np.float32)
    v = rng.normal(size=(B, H, L, D)).astype(np.float32)
    bias = rng.normal(size=(1, H, 1, L)).astype(np.float32)
    mask = np.arange(L)[None, None, None, :] < 7
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    pd = torch.float32 if dtype == "float32" else torch.bfloat16
    kj, vj = jt5._quantize_kv(jnp.asarray(k)), jt5._quantize_kv(jnp.asarray(v))
    kp = pt5._quantize_kv(torch.from_numpy(k))
    vp = pt5._quantize_kv(torch.from_numpy(v))
    oj = jt5._attention_int8(jnp.asarray(q).astype(jd), kj, vj,
                             jnp.asarray(bias), jnp.asarray(mask), jd)
    op = pt5._attention_int8(torch.from_numpy(q).to(pd), kp, vp,
                             torch.from_numpy(bias), torch.from_numpy(mask), pd)
    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(op.float().numpy(),
                               np.asarray(oj).astype(np.float32), atol=atol)


def test_layer_primitives_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        pt5.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy(),
        np.asarray(jt5.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        atol=1e-6)
    np.testing.assert_allclose(
        pt5.gelu_new(torch.from_numpy(x)).numpy(),
        np.asarray(jt5.gelu_new(jnp.asarray(x))), atol=1e-6)
    rel = np.arange(-300, 300, dtype=np.int32)
    for bidir in (True, False):
        np.testing.assert_array_equal(
            pt5.relative_position_bucket(torch.from_numpy(rel), bidir, 32,
                                         128).numpy(),
            np.asarray(jt5.relative_position_bucket(jnp.asarray(rel), bidir,
                                                    32, 128)))
