"""Port decode-attention functions and routes against the JAX package (CPU).

On the CPU the wrappers of ``ops/decode_attention.py`` run their plain
versions, which spell out the TPU kernels' arithmetic; the CUDA kernels
are held against the same plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).  Here the JAX Pallas
kernels run in interpret mode (``da.INTERPRET``), as the JAX package's own
tests run them; the transposed-cross kernel, alone, in a process of its
own with ``--xla_allow_excess_precision=false``, so that its bf16 products
round as its source reads.  Bars:

  * the plain versions against the JAX kernels on the same seeded int8
    inputs: rtol = atol = 1e-2 (bf16 outputs, one rounding apart);
  * the JAX package's bars against JAX ``_attention_int8`` (0.05 for the
    int8 kernel, 0.08 for the transposed-cross kernel) hold for the plain
    versions too;
  * ``decode_step`` through each kernel route (an int8 launch plan, a
    transposed cross-KV), teacher-forced in bf16: logits
    within 0.0625 of JAX ``decode_step(use_pallas=True)``, argmax equal
    wherever JAX's top-2 gap exceeds 0.125 (as ``test_torch_decode.py``);
  * ``generate_tokens`` with ``pallas_cross`` against JAX
    ``generate_tokens(pallas_cross=True)``: the same bar on the logits
    along JAX's tokens, the free-running agreement recorded;
  * the serving route (``round_pv=True``, ``p * vs`` rounded to bf16)
    against JAX ``_attention_int8``, the JAX engine's serving arithmetic:
    equal bit for bit on every bf16 output.  That holds per draw, not by
    construction: XLA's CPU ``exp`` and torch's differ in the last f32 bit
    on some inputs and XLA's dot products sum in another order, so an
    output can land on the other side of a bf16 rounding boundary.  The
    TPU kernel's arithmetic (``round_pv=False``) misses on more than 10 %
    of them;
  * ``decode_step`` through the engine's route against JAX
    ``decode_step(use_pallas=False)``, and ``generate_tokens`` against
    JAX's serving ``generate_tokens``: the logit bar above.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import music2midi_tpu.ops.decode_attention as da
from music2midi_tpu.infer.decode import DecodeConfig as JaxDecodeConfig
from music2midi_tpu.infer.decode import generate_tokens as jax_generate
from music2midi_tpu.models import t5 as jt5
from music2midi_tpu_torch.infer.decode import DecodeConfig, generate_tokens
from music2midi_tpu_torch.models import t5 as pt5
from music2midi_tpu_torch.ops import decode_attention as pda
from music2midi_tpu_torch.weights import params_from_jax

SHAPE = dict(d_model=64, d_kv=16, num_heads=4, d_ff=96, num_layers=2,
             num_decoder_layers=2)
TOL = 0.0625  # one bf16 ulp at |logit| in [8, 16)
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads per parallel test worker (see
    test_torch_pipeline.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def _interpret():
    da.INTERPRET = True
    yield
    da.INTERPRET = False


def _normals(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _quantized(x):
    """One f32 array -> (JAX int8 entry, port int8 entry), each side's own
    ``_quantize_kv`` (the same rounding)."""
    jq = jt5._quantize_kv(jnp.asarray(x))
    pq = pt5._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jq[0]), pq[0].numpy())
    return jq, pq


def _to_np(out):
    return np.asarray(out, dtype=np.float32)


def _bf16_steps(a, b):
    """Distance in bf16 steps between two float32 arrays of bf16 values
    (sign and magnitude as one ordered integer)."""
    def ordered(x):
        u = (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(np.int64)
        return np.where(u & 0x8000, -(u & 0x7FFF), u)
    return np.abs(ordered(a) - ordered(b))


B, H, L, D = 8, 8, 64, 64


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    q = _normals(rng, B, H, 1, D)
    k, v = _normals(rng, B, H, L, D), _normals(rng, B, H, L, D)
    k_new, v_new = _normals(rng, B, H, 1, D), _normals(rng, B, H, 1, D)
    bias = _normals(rng, 1, H, 1, L)
    return q, k, v, k_new, v_new, bias


def _bf16_q(q):
    return (jnp.asarray(q).astype(jnp.bfloat16),
            torch.from_numpy(q).to(torch.bfloat16))


@pytest.mark.parametrize("step", [0, 5, L - 1])
def test_int8_causal_plain_matches_jax_kernel(_interpret, qkv, step):
    """Pre-write cache plus the fresh-row patch, as the TPU kernel gets it;
    the JAX package's bar against ``_attention_int8`` over the post-write
    cache holds as well."""
    q, k, v, k_new, v_new, bias = qkv
    jq, pq = _bf16_q(q)
    (jk, pk), (jv, pv) = _quantized(k), _quantized(v)
    (jkn, pkn), (jvn, pvn) = _quantized(k_new), _quantized(v_new)
    want = _to_np(da.decode_attention_int8(
        jq, jk, jv, jnp.asarray(bias), jnp.int32(step), jkn, jvn,
        causal=True))
    got = pda.decode_attention_int8(
        pq, pk, pv, torch.from_numpy(bias), step, pkn, pvn, causal=True)
    assert got.shape == (B, H, 1, D) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=1e-2)
    k_w, v_w = k.copy(), v.copy()
    k_w[:, :, step] = k_new[:, :, 0]
    v_w[:, :, step] = v_new[:, :, 0]
    vis = (jnp.arange(L) <= step)[None, None, None, :]
    ref = _to_np(jt5._attention_int8(
        jq, jt5._quantize_kv(jnp.asarray(k_w)),
        jt5._quantize_kv(jnp.asarray(v_w)), jnp.asarray(bias), vis,
        jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=0.05)


@pytest.mark.parametrize("enc_len", [50, L])
def test_int8_cross_plain_matches_jax_kernel(_interpret, qkv, enc_len):
    q, k, v = qkv[:3]
    jq, pq = _bf16_q(q)
    (jk, pk), (jv, pv) = _quantized(k), _quantized(v)
    want = _to_np(da.decode_attention_int8(
        jq, jk, jv, None, None, None, None, causal=False, enc_len=enc_len))
    got = pda.decode_attention_int8(pq, pk, pv, None, None, None, None,
                                    causal=False, enc_len=enc_len)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=1e-2)
    mask = (jnp.arange(L) < enc_len)[None, None, None, :]
    ref = _to_np(jt5._attention_int8(jq, jk, jv, None, mask, jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=0.05)


def _serving_cases():
    """(name, port kwargs, JAX _attention_int8 args) over one seeded draw:
    cross at enc_len = L and below, causal at steps 0, mid and last over
    the post-write cache (the port reads key ``step`` from the fresh
    row, JAX from the cache it was written to)."""
    rng = np.random.default_rng(0)
    cases = []
    Lc = 190
    q = _normals(rng, B, H, 1, D)
    (jk, pk), (jv, pv) = (_quantized(_normals(rng, B, H, Lc, D))
                          for _ in range(2))
    jq, pq = _bf16_q(q)
    for enc_len in (Lc, 150):
        mask = (jnp.arange(Lc) < enc_len)[None, None, None, :]
        cases.append((f"cross-{enc_len}",
                      (pq, pk, pv, None, None, None, None, False, enc_len),
                      (jq, jk, jv, None, mask)))
    q, k, v, k_new, v_new, bias = (_normals(rng, B, H, 1, D),
                                   _normals(rng, B, H, L, D),
                                   _normals(rng, B, H, L, D),
                                   _normals(rng, B, H, 1, D),
                                   _normals(rng, B, H, 1, D),
                                   _normals(rng, 1, H, 1, L))
    jq, pq = _bf16_q(q)
    (_, pkn), (_, pvn) = _quantized(k_new), _quantized(v_new)
    for step in (0, L // 2, L - 1):
        k_w, v_w = k.copy(), v.copy()
        k_w[:, :, step] = k_new[:, :, 0]
        v_w[:, :, step] = v_new[:, :, 0]
        (jk, pk), (jv, pv) = _quantized(k_w), _quantized(v_w)
        vis = (jnp.arange(L) <= step)[None, None, None, :]
        cases.append((f"causal-{step}",
                      (pq, pk, pv, torch.from_numpy(bias), step, pkn, pvn,
                       True),
                      (jq, jk, jv, jnp.asarray(bias), vis)))
    return cases


SERVING_CASES = ("cross-190", "cross-150", "causal-0", f"causal-{L // 2}",
                 f"causal-{L - 1}")


@pytest.fixture(scope="module")
def serving_cases():
    return {name: (port, jax_args) for name, port, jax_args
            in _serving_cases()}


@pytest.mark.parametrize("case", SERVING_CASES)
def test_serving_plain_matches_jax_attention_int8(serving_cases, case):
    """The serving route's plain attention (``round_pv=True``) against JAX
    ``_attention_int8``; the TPU kernel's arithmetic (the port's serving
    route before ``round_pv``) misses the same outputs on >10 %."""
    port, jax_args = serving_cases[case]
    want = _to_np(jt5._attention_int8(*jax_args, jnp.bfloat16))
    got = pda.decode_attention_int8(*port, round_pv=True).float().numpy()
    steps = _bf16_steps(got, want)
    print(f"{case}: {int((steps > 0).sum())} of {steps.size} outputs differ")
    assert steps.max() == 0
    old = pda.decode_attention_int8(*port, round_pv=False).float().numpy()
    assert (_bf16_steps(old, want) > 0).mean() > 0.1


CROSS_T_LEN, CROSS_T_ENC_LENS = 128, (100, 128)

_CROSS_T_JAX = """
import sys
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import music2midi_tpu.ops.decode_attention as da
from music2midi_tpu.models import t5 as jt5
da.INTERPRET = True
x = np.load(sys.argv[1])
q = jnp.asarray(x["q"]).astype(jnp.bfloat16)
kt = da.transpose_cross_entry(jt5._quantize_kv(jnp.asarray(x["k"])))
vt = da.transpose_cross_entry(jt5._quantize_kv(jnp.asarray(x["v"])))
np.savez(sys.argv[2], **{
    str(n): np.asarray(da.decode_attention_cross_t(q, kt, vt, enc_len=int(n)),
                       dtype=np.float32)
    for n in x["enc_lens"]})
"""


def _cross_t_inputs(length=CROSS_T_LEN):
    rng = np.random.default_rng(3)
    q = _normals(rng, B, H, 1, D)
    k = _normals(rng, B, H, length, D)
    v = _normals(rng, B, H, length, D)
    return q, k, v


def _run_cross_t_jax(d, length, enc_lens):
    """The JAX kernel on ``_cross_t_inputs(length)`` in its own process
    (see ``cross_t_jax``) -> {enc_len: output}."""
    q, k, v = _cross_t_inputs(length)
    np.savez(d / "in.npz", q=q, k=k, v=v, enc_lens=np.array(enc_lens))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _CROSS_T_JAX, str(d / "in.npz"),
                    str(d / "out.npz")], check=True, env=env, cwd=ROOT,
                   timeout=300)
    out = np.load(d / "out.npz")
    return {int(n): out[n] for n in out.files}


@pytest.fixture(scope="module")
def cross_t_jax(tmp_path_factory):
    """The JAX transposed-cross kernel in interpret mode, in a process of
    its own with ``--xla_allow_excess_precision=false``: without it XLA on
    the CPU keeps the kernel's bf16 products in f32, which is not what the
    kernel's source computes.  -> {enc_len: output}."""
    return _run_cross_t_jax(tmp_path_factory.mktemp("cross_t"), CROSS_T_LEN,
                            CROSS_T_ENC_LENS)


@pytest.mark.parametrize("enc_len", CROSS_T_ENC_LENS)
def test_cross_t_plain_matches_jax_kernel(cross_t_jax, enc_len):
    """Against the JAX kernel as its source reads (products rounded to
    bf16); the JAX package's bar against ``_attention_int8`` holds too."""
    Lx = CROSS_T_LEN
    q, k, v = _cross_t_inputs()
    jq, pq = _bf16_q(q)
    (jk, pk), (jv, pv) = _quantized(k), _quantized(v)
    want = cross_t_jax[enc_len]
    pkt, pvt = pda.transpose_cross_entry(pk), pda.transpose_cross_entry(pv)
    assert pkt[0].shape == (B, H, D, Lx) and pkt[0].is_contiguous()
    got = pda.decode_attention_cross_t(pq, pkt, pvt, enc_len=enc_len)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=1e-2)
    mask = (jnp.arange(Lx) < enc_len)[None, None, None, :]
    ref = _to_np(jt5._attention_int8(jq, jk, jv, None, mask, jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=0.08)


PADDED_LEN, PADDED_ENC_LENS = 120, (100, 120)


@pytest.fixture(scope="module")
def cross_t_jax_padded(tmp_path_factory):
    """``cross_t_jax`` at a length that is no multiple of 16."""
    return _run_cross_t_jax(tmp_path_factory.mktemp("cross_t_pad"),
                            PADDED_LEN, PADDED_ENC_LENS)


@pytest.mark.parametrize("length", [PADDED_LEN, 190])
def test_transpose_cross_entry_pads_rows_to_16_bytes(length):
    """JAX's shape and values, a row stride of the length rounded up to
    16 bytes, and zero pad bytes behind every row."""
    rng = np.random.default_rng(4)
    x = _normals(rng, 2, 3, length, D)
    (jk, pk) = _quantized(x)
    jt, js = da.transpose_cross_entry(jk)
    pt, ps = pda.transpose_cross_entry(pk)
    lp = -(-length // 16) * 16
    assert pt.shape == jt.shape == (2, 3, D, length)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert pt.stride() == (3 * D * lp, D * lp, lp, 1)
    full = torch.as_strided(pt, (2, 3, D, lp), pt.stride())
    assert not full[..., length:].any()


@pytest.mark.parametrize("enc_len", PADDED_ENC_LENS)
def test_cross_t_plain_matches_jax_kernel_on_padded_rows(cross_t_jax_padded,
                                                         enc_len):
    """``test_cross_t_plain_matches_jax_kernel`` on the padded layout of a
    length that is no multiple of 16."""
    q, k, v = _cross_t_inputs(PADDED_LEN)
    _, pq = _bf16_q(q)
    (_, pk), (_, pv) = _quantized(k), _quantized(v)
    pkt, pvt = pda.transpose_cross_entry(pk), pda.transpose_cross_entry(pv)
    assert pkt[0].stride(2) == 128
    got = pda.decode_attention_cross_t(pq, pkt, pvt, enc_len=enc_len)
    np.testing.assert_allclose(got.float().numpy(),
                               cross_t_jax_padded[enc_len], rtol=1e-2,
                               atol=1e-2)


def test_cross_t_guards_raise_on_unpadded_rows():
    """The transposed kernel's layout guard, without a card: rows 16-byte
    aligned, and storage behind each row for the keys rounded up to 16."""
    vals = torch.zeros(2, 2, 190, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="16-byte"):
        pda._check_padded_rows("kt", vals.transpose(2, 3).contiguous(), 190)
    padded = pda.transpose_cross_entry((vals, torch.ones(2, 2, 1, 190)))[0]
    pda._check_padded_rows("kt", padded, 190)
    short = torch.zeros(2 * 2 * 16 * 176 - 6, dtype=torch.int8)
    with pytest.raises(ValueError, match="padded"):
        pda._check_padded_rows("kt", torch.as_strided(
            short, (2, 2, 16, 170), (2 * 16 * 176, 16 * 176, 176, 1)), 170)
    narrow = torch.zeros(2 * 2 * 16 * 160, dtype=torch.int8)
    with pytest.raises(ValueError, match="padded"):
        pda._check_padded_rows("kt", torch.as_strided(
            narrow, (2, 2, 16, 150), (2 * 16 * 160, 16 * 160, 160, 1)), 170)


def test_keys_past_the_visible_ones_change_nothing():
    """Keys past ``step`` (causal) or ``enc_len`` (cross), and their scales
    and bias, do not change the output: the kernel never reads them, and
    a caller may pass a whole max_length buffer."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(_normals(rng, 2, 2, 1, 16)).to(torch.bfloat16)
    k8, ks = pt5._quantize_kv(torch.from_numpy(_normals(rng, 2, 2, 12, 16)))
    v8, vs = pt5._quantize_kv(torch.from_numpy(_normals(rng, 2, 2, 12, 16)))
    kn = pt5._quantize_kv(torch.from_numpy(_normals(rng, 2, 2, 1, 16)))
    vn = pt5._quantize_kv(torch.from_numpy(_normals(rng, 2, 2, 1, 16)))
    bias = torch.from_numpy(_normals(rng, 2, 12))

    def both():
        return (pda.decode_attention_int8(q, (k8, ks), (v8, vs), bias, 4,
                                          kn, vn, causal=True),
                pda.decode_attention_int8(q, (k8, ks), (v8, vs), None, None,
                                          None, None, causal=False,
                                          enc_len=5))

    before = both()
    for t in (k8, v8):
        t[:, :, 5:] = 99
    for t in (ks, vs):
        t[..., 5:] = 7.0
    bias[:, 5:] = 50.0
    for a, b in zip(before, both()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------------------- #
# decode_step routes and generate_tokens                                 #
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def model():
    tree = jt5.init_params(11, jt5.T5Config(**SHAPE))
    pcfg = pt5.T5Config(**SHAPE, dtype=torch.bfloat16)
    net = pt5.T5Model.from_state_dict(params_from_jax(tree), pcfg)
    rng = np.random.default_rng(3)
    enc = rng.normal(size=(8, 25, 64)).astype(np.float32)
    return tree, net, pcfg, enc


def _check_logits(lp, lj):
    np.testing.assert_allclose(lp, lj, atol=TOL)
    top2 = np.sort(lj, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * TOL
    np.testing.assert_array_equal(lp.argmax(-1)[clear], lj.argmax(-1)[clear])


def _teacher_forced(model, route, tokens, max_len, jax_pallas=True):
    """Step both engines' decode_step along `tokens` (B, T) in bf16 + int8
    KV through `route`, holding every step's logits to the bar; JAX's
    decode_step with ``use_pallas=jax_pallas``."""
    tree, net, pcfg, enc = model
    B = tokens.shape[0]
    jcfg = jt5.T5Config(**SHAPE, dtype=jnp.bfloat16)
    jenc = jnp.asarray(enc[:B]).astype(jnp.bfloat16)
    jcross = jt5.precompute_cross_kv(tree, jenc, jcfg, quantize=True)
    pcross = pt5.precompute_cross_kv(
        net, torch.from_numpy(enc[:B]).to(torch.bfloat16), pcfg,
        quantize=True)
    if route == "cross_t":
        jcross = jcross._replace(layers=[
            (da.transpose_cross_entry(k), da.transpose_cross_entry(v))
            for k, v in jcross.layers])
        pcross = pt5.transpose_cross_kv(pcross)
    jcache = jt5.init_kv_cache(B, max_len, jcfg, quantize=True)
    pcache = pt5.init_kv_cache(B, max_len, pcfg, quantize=True)
    jdp = jt5.prepare_decode_params(tree, jcfg)
    dp = pt5.prepare_decode_params(net, pcfg)
    rows = pt5.decoder_bias_rows(dp["rel_bias"], max_len, pcfg)
    plan = pt5.int8_attention_plan(pcache, pcross, rows)
    before = (pda.decode_attention_int8.launches,
              pda.decode_attention_cross_t.launches)
    for step in range(tokens.shape[1]):
        tok = tokens[:, step]
        lj, jcache = jt5.decode_step(jdp, jnp.asarray(tok), jnp.int32(step),
                                     jcache, jcross, jcfg, max_len,
                                     use_pallas=jax_pallas)
        lp = pt5.decode_step(dp, torch.from_numpy(tok).long(), step, pcache,
                             pcross, pcfg, rows, plan)
        _check_logits(lp.float().numpy(), np.asarray(lj).astype(np.float32))
    # the CPU route takes the plain versions and launches no kernel
    assert (pda.decode_attention_int8.launches,
            pda.decode_attention_cross_t.launches) == before


@pytest.mark.parametrize("route", ["int8", "cross_t"])
def test_decode_step_routes_match_jax_pallas(_interpret, model, route):
    """int8: self and cross blocks through decode_attention_int8;
    cross_t: the cross blocks through decode_attention_cross_t over the
    transposed cross-KV (B = 8, the JAX kernel's batch block)."""
    rng = np.random.default_rng(5)
    tokens = rng.integers(3, 400, size=(8, 12)).astype(np.int32)
    tokens[:, 0] = 1
    _teacher_forced(model, route, tokens, max_len=16)


@pytest.mark.parametrize("route", ["int8", "cross_t"])
def test_decode_step_serving_route_matches_jax_attention_int8(
        _interpret, model, route):
    """The engine's routes (the int8 kernel with ``round_pv`` in every
    int8 block, or the self blocks with the cross blocks on the transposed
    kernel) against JAX's serving decode_step, whose int8 blocks are
    ``_attention_int8`` (``use_pallas=False``; with ``pallas_cross`` its
    cross blocks take the transposed kernel, as the port's)."""
    rng = np.random.default_rng(6)
    tokens = rng.integers(3, 400, size=(8, 12)).astype(np.int32)
    tokens[:, 0] = 1
    _teacher_forced(model, route, tokens, max_len=16, jax_pallas=False)


def test_generate_tokens_serving_route_matches_jax(model):
    """The port's serving generate_tokens (int8 KV, the int8 kernel's
    route with ``round_pv``) against the JAX engine's (int8 KV through
    ``_attention_int8``): the logit bar along JAX's tokens, and the
    free-running agreement recorded."""
    tree, net, pcfg, enc = model
    max_len = 20
    jcfg = jt5.T5Config(**SHAPE, dtype=jnp.bfloat16)
    jt, _ = jax_generate(
        tree, jnp.asarray(enc).astype(jnp.bfloat16), jcfg,
        JaxDecodeConfig(max_length=max_len, suppress_tokens=(2,),
                        quantize_cross_kv=True, quantize_self_kv=True))
    jt = np.array(jt)
    _teacher_forced(model, "int8", jt[:, :-1], max_len, jax_pallas=False)
    pt, _ = generate_tokens(net, torch.from_numpy(enc).to(torch.bfloat16),
                            pcfg, DecodeConfig(
                                max_length=max_len, suppress_tokens=(2,),
                                quantize_kv=True, pallas_attention=True))
    agree = float((pt.numpy()[:, 1:] == jt[:, 1:]).mean())
    print(f"serving route bf16 free-running token agreement vs JAX: "
          f"{agree:.4f}")


def test_generate_tokens_pallas_cross_matches_jax(_interpret, model):
    tree, net, pcfg, enc = model
    max_len = 20
    jcfg = jt5.T5Config(**SHAPE, dtype=jnp.bfloat16)
    jt, _ = jax_generate(
        tree, jnp.asarray(enc).astype(jnp.bfloat16), jcfg,
        JaxDecodeConfig(max_length=max_len, suppress_tokens=(2,),
                        quantize_cross_kv=True, quantize_self_kv=True,
                        pallas_cross=True))
    jt = np.array(jt)
    _teacher_forced(model, "cross_t", jt[:, :-1], max_len)
    pt, pl = generate_tokens(net, torch.from_numpy(enc).to(torch.bfloat16),
                             pcfg, DecodeConfig(
                                 max_length=max_len, suppress_tokens=(2,),
                                 quantize_kv=True, pallas_cross=True))
    assert pt.shape == jt.shape and bool((pl == max_len).all())
    agree = float((pt.numpy()[:, 1:] == jt[:, 1:]).mean())
    print(f"pallas_cross bf16 free-running token agreement vs JAX: "
          f"{agree:.4f}")


def test_wrappers_reject_what_the_kernels_do_not_take():
    """Shape errors raise before any CUDA call; the checks of a CUDA
    tensor's layout are in ``_check_int8``."""
    q = torch.zeros(2, 2, 1, 16, dtype=torch.bfloat16)
    k = torch.zeros(2, 2, 8, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="16-byte"):
        pda._check_int8("k", k[:, :, :, 1:], 4)
    with pytest.raises(ValueError, match="int8"):
        pda._check_int8("k", k.float(), 4)
    with pytest.raises(ValueError, match="transposed"):
        pt5.transpose_cross_kv(pt5.CrossKV(layers=[(k, k)], enc_len=8))
    assert pda.decode_attention_int8(
        q, (k, torch.ones(2, 2, 1, 8)), (k, torch.ones(2, 2, 1, 8)), None,
        None, None, None, causal=False).shape == (2, 2, 1, 16)


# --------------------------------------------------------------------- #
# the int8 kernel's launch plan                                          #
# --------------------------------------------------------------------- #


def _plan_inputs(B=2, H=2, L=8, D=16):
    """An int8 self cache of one layer as ``init_kv_cache`` lays it out,
    (H, L) f32 bias rows, and one step's bf16 query and fresh rows."""
    rng = np.random.default_rng(8)
    entry = pt5._quantize_kv(torch.from_numpy(_normals(rng, B, H, L, D)))
    cache = [(entry, pt5._quantize_kv(torch.from_numpy(
        _normals(rng, B, H, L, D))))]
    rows = torch.from_numpy(_normals(rng, H, L))
    q = torch.from_numpy(_normals(rng, B, H, 1, D)).to(torch.bfloat16)
    kn = pt5._quantize_kv(torch.from_numpy(_normals(rng, B, H, 1, D)))
    vn = pt5._quantize_kv(torch.from_numpy(_normals(rng, B, H, 1, D)))
    return cache, rows, q, kn, vn


def test_plan_checks_what_it_packs():
    """Building a plan checks every buffer it packs, and a call its step,
    before any CUDA call: a row stride that is no multiple of 16 bytes, a
    base off 16-byte alignment, the wrong dtype of values, scales or bias
    rows, the wrong bias shape, an enc_len past the cross-KV, a layer
    whose cache differs from the first's, and a step outside the cache
    raise."""
    cache, rows, q, kn, vn = _plan_inputs()
    (k8, ks), v = cache[0]
    plan = pda.Int8AttentionPlan(cache, rows)
    assert plan.causal(0, q, kn, vn, 7).shape == (2, 2, 1, 16)
    wide = torch.zeros(2, 2, 8, 24, dtype=torch.int8)
    shifted = torch.zeros(2 * 2 * 8 * 16 + 1, dtype=torch.int8)[1:].view(
        2, 2, 8, 16)
    for bad, match in (
            ([((wide[..., :16], ks), v)], "16-byte"),
            ([((shifted, ks), v)], "16-byte"),
            ([((k8.float(), ks), v)], "int8"),
            ([((k8, ks.double()), v)], "float32"),
            ([((k8, ks[..., :7]), v)], "float32")):
        with pytest.raises(ValueError, match=match):
            pda.Int8AttentionPlan(bad, rows)
    with pytest.raises(ValueError, match="bias rows"):
        pda.Int8AttentionPlan(cache, rows.double())
    with pytest.raises(ValueError, match="bias rows"):
        pda.Int8AttentionPlan(cache, rows[:, :7])
    with pytest.raises(ValueError, match="enc_len"):
        pda.Int8AttentionPlan(cache, rows, cache, enc_len=9)
    with pytest.raises(ValueError, match="every layer"):
        pda.Int8AttentionPlan(cache + [((k8[:1], ks[:1]), (k8[:1], ks[:1]))],
                              rows)
    for step in (-1, 8):
        with pytest.raises(ValueError, match="outside the cache"):
            plan.causal(0, q, kn, vn, step)


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["int8", "cross_t"])
def test_plan_route_equals_public_route(model, route, bias_dtype):
    """``decode_step`` teacher-forced in bf16 + int8 KV through the launch
    plan, and after every step, 0, mid and last among them, each layer's
    plan calls against ``decode_attention_int8`` over views of the same
    caches (the written prefix, the bias window ``rows[:, L - n:]``, the
    step's rows as written): equal bit for bit (on the CPU both run the
    plain version), with f32 bias rows and the bf16 ones of a bf16
    checkpoint.  Over a transposed cross-KV the plan holds the self cache
    alone."""
    tree, net, pcfg, enc = model
    max_len = 16
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(3, 400, size=(8, max_len)))
    x = torch.from_numpy(enc).to(torch.bfloat16)
    cross = pt5.precompute_cross_kv(net, x, pcfg, quantize=True)
    if route == "cross_t":
        cross = pt5.transpose_cross_kv(cross)
    dp = pt5.prepare_decode_params(net, pcfg)
    rows = pt5.decoder_bias_rows(dp["rel_bias"], max_len, pcfg).to(bias_dtype)
    cache = pt5.init_kv_cache(8, max_len, pcfg, quantize=True)
    plan = pt5.int8_attention_plan(cache, cross, rows)
    q = torch.from_numpy(_normals(rng, 8, 4, 1, 16)).to(torch.bfloat16)
    for step in range(max_len):
        pt5.decode_step(dp, tokens[:, step], step, cache, cross, pcfg, rows,
                        plan)
        n = step + 1
        for i, entries in enumerate(cache):
            (k8, ks), (v8, vs) = entries
            public = pda.decode_attention_int8(
                q, (k8[:, :, :n], ks[..., :n]), (v8[:, :, :n], vs[..., :n]),
                rows[:, max_len - n:], step,
                (k8[:, :, step:n], ks[..., step:n]),
                (v8[:, :, step:n], vs[..., step:n]), causal=True,
                round_pv=True)
            planned = plan.causal(i, q, (k8[:, :, step:n], ks[..., step:n]),
                                  (v8[:, :, step:n], vs[..., step:n]), step)
            assert torch.equal(public, planned), (step, i)
    for i, (ck, cv) in enumerate(cross.layers if route == "int8" else ()):
        public = pda.decode_attention_int8(
            q, ck, cv, None, None, None, None, causal=False,
            enc_len=cross.enc_len, round_pv=True)
        assert torch.equal(public, plan.cross(i, q)), i
