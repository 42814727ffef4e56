"""The T5 decode step's fused glue (``ops/decode_fused.py``, kernels 7-10)
on the CPU, where each wrapper takes its plain twin.  Bars, all exact:

  * each plain twin equals, bit for bit, the chain ``decode_step`` and the
    decode loop ran before it (T5's ``rms_norm`` and ``gelu_new``, which
    ``models/t5.py`` imports from ``ops/decode_fused.py``, its
    ``_quantize_kv``, the residual adds, the cache's ``index_copy_``, the
    greedy selection), in float32 and bfloat16, at +-127 and +-7 levels;
    the selection on ties, suppressed ids and rows already done;
  * ``decode_step`` through the wrappers gives the logits and the cache
    contents of the previous step (reproduced below) in every route;
  * the decode loop's greedy step through ``greedy_commit`` gives the
    tokens of its previous chain; the hybrid loop keeps the chain;
  * ``_reduce_width`` gives ATen's reduce configuration; kernel 7 refuses
    the widths it was not built for.

The kernels themselves are held to these twins on the card
(``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest
import torch

from music2midi_tpu_torch.infer import decode as pdecode
from music2midi_tpu_torch.infer.decode import DecodeConfig, generate_tokens_eager
from music2midi_tpu_torch.models import t5 as pt5
from music2midi_tpu_torch.ops import decode_fused as df

SHAPE = dict(d_model=64, d_kv=16, num_heads=4, d_ff=96, num_layers=2,
             num_decoder_layers=2)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _normal(g, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=g) * scale).to(dtype)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b) or torch.equal(a.isnan(), b.isnan()) and \
        torch.equal(a.nan_to_num(), b.nan_to_num())


# --------------------------------------------------------------------- #
# the plain twins against the chains they replaced                       #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_rms_norm_plain_is_the_add_and_norm_chain(dtype, w_dtype):
    g = torch.Generator().manual_seed(1)
    dt = DTYPES[dtype]
    x = _normal(g, 8, 1, 384, dtype=dt, scale=3.0)
    delta = _normal(g, 8, 1, 384, dtype=dt)
    w = _normal(g, 384, dtype=DTYPES[w_dtype])
    want_x = x + delta
    want = pt5.rms_norm(want_x, w, 1e-6)
    got_x = x.clone()
    _same(df.add_rms_norm_plain(got_x, delta, w, 1e-6), want)
    _same(got_x, want_x)


@pytest.mark.parametrize("token_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_rms_norm_plain_is_the_gather_and_norm(dtype, token_dtype):
    g = torch.Generator().manual_seed(2)
    dt = DTYPES[dtype]
    table = _normal(g, 400, 384, dtype=dt)
    w = _normal(g, 384)
    token = torch.tensor([1, 0, 399, 7, 7], dtype=token_dtype)
    x, h = df.embed_rms_norm_plain(table, token, w, 1e-6)
    _same(x, table[token][:, None])
    _same(h, pt5.rms_norm(table[token][:, None], w, 1e-6))


def _parent_write_kv(entry, new, pos, bits):
    """The previous ``models/t5.py::_write_kv`` of an int8 entry."""
    vals, scales = entry
    q8, s = pt5._quantize_kv(new, bits)
    vals.index_copy_(2, pos, q8)
    scales.index_copy_(3, pos, s)
    return q8, s


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_write_kv_plain_is_the_parent_cache_write(dtype, bits):
    """The cache's values and scales after two writes, and the fresh rows
    and scales returned, equal the previous ``_write_kv`` on the
    ``_split_heads`` views of the fused projection; a zero row keeps the
    1e-8 floor."""
    g = torch.Generator().manual_seed(3)
    dt = DTYPES[dtype]
    B, H, L, D = 3, 4, 9, 16
    cfg = pt5.T5Config(**{**SHAPE, "num_heads": H, "d_kv": D}, dtype=dt)
    ours = pt5.init_kv_cache(B, L, cfg, quantize=True, bits=bits)
    theirs = pt5.init_kv_cache(B, L, cfg, quantize=True, bits=bits)
    levels = pt5._KV_LEVELS[bits]
    for s in (0, 5):
        qkv = _normal(g, B, 1, 3 * H * D, dtype=dt, scale=4.0)
        qkv[1, 0, H * D:H * D + D] = 0.0  # row 1, head 0 of K: all zero
        step = torch.tensor(s, dtype=torch.int32)
        got = df.quantize_write_kv_plain(qkv, *ours[0], step, levels)
        _, k_new, v_new = (pt5._split_heads(p, H, D)
                           for p in qkv.chunk(3, dim=-1))
        pos = step.view(1).long()
        want = (_parent_write_kv(theirs[0][0], k_new, pos, bits),
                _parent_write_kv(theirs[0][1], v_new, pos, bits))
        for (q8, sc), (wq8, wsc) in zip(got, want):
            _same(q8, wq8)
            _same(sc, wsc)
            assert q8.is_contiguous() and sc.shape == (B, H, 1, 1)
            assert int(q8.abs().max()) <= levels
    for (a, b) in zip(ours[0], theirs[0]):
        for t, u in zip(a, b):
            _same(t, u)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mul_plain_is_the_gelu_times_lin_chain(dtype):
    g = torch.Generator().manual_seed(4)
    dt = DTYPES[dtype]
    gate_lin = _normal(g, 16, 1, 2 * 96, dtype=dt, scale=3.0)
    gate, lin = gate_lin.chunk(2, dim=-1)
    _same(df.gelu_mul_plain(gate_lin), (pt5.gelu_new(gate) * lin).to(dt))


def _parent_commit(logits, suppress, done, tokens, token, step, cfg):
    """The previous greedy step of ``DecodeProgram._body``."""
    dcfg = DecodeConfig()
    nxt = pdecode._select_next(logits, dcfg, None, suppress)
    nxt = torch.where(done, cfg.pad_token_id, nxt)
    done |= nxt == cfg.eos_token_id
    tokens.index_copy_(1, (step + 1).view(1).long(), nxt[:, None])
    token.copy_(nxt)
    step += 1


@pytest.mark.parametrize("suppressed", [(), (2, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_greedy_commit_plain_is_the_parent_selection(dtype, suppressed):
    """Rows with tied maxima (the first wins), the maximum suppressed, an
    EOS, rows already done (PAD), over three steps: the logits, done,
    tokens, token and step equal the previous chain's, and the expected
    ids read off by hand."""
    cfg = pt5.T5Config(**SHAPE)
    B, V, N = 6, 12, 5
    g = torch.Generator().manual_seed(5)
    state = {k: [] for k in ("ours", "theirs")}
    for k in state:
        state[k] = [torch.zeros(B, dtype=torch.bool),
                    torch.zeros(B, N, dtype=torch.int32),
                    torch.zeros(B, dtype=torch.int32),
                    torch.zeros((), dtype=torch.int32)]
        state[k][0][4] = True  # row 4 done before the first step
    sup = torch.tensor(suppressed, dtype=torch.long) if suppressed else None
    for s in range(3):
        logits = _normal(g, B, V, dtype=DTYPES[dtype])
        logits[0, 3] = logits[0, 9] = 50.0  # a tie: 3 wins
        logits[1, 5] = 60.0  # suppressed when 5 is
        logits[2, 2] = 70.0  # EOS (id 2), unless suppressed
        logits[3, :] = 1.0  # all tied: 0 wins
        mine = logits.clone()
        df.greedy_commit_plain(mine, sup, *state["ours"], cfg.pad_token_id,
                               cfg.eos_token_id)
        _parent_commit(logits, sup, *state["theirs"], cfg)
        _same(mine, logits)
        for a, b in zip(state["ours"], state["theirs"]):
            _same(a, b)
        tok = state["ours"][2]
        assert int(state["ours"][3]) == s + 1
        assert int(tok[0]) == 3 and int(tok[3]) == 0
        assert int(tok[4]) == cfg.pad_token_id
        assert (int(tok[1]) == 5) == (5 not in suppressed)
        if s == 0:
            assert bool(state["ours"][0][2]) == (2 not in suppressed)
        if 2 not in suppressed and s:
            assert int(tok[2]) == cfg.pad_token_id  # done since step 0
        np.testing.assert_array_equal(state["ours"][1][:, s + 1].numpy(),
                                      tok.numpy())


def test_wrappers_take_the_plain_twins_on_cpu():
    """CPU tensors go to the twins and count no launch."""
    g = torch.Generator().manual_seed(6)
    before = [w.launches for w in df.wrappers()]
    x = _normal(g, 4, 1, 64)
    delta, w = _normal(g, 4, 1, 64), _normal(g, 64)
    x2 = x.clone()
    _same(df.add_rms_norm(x, delta, w, 1e-6),
          df.add_rms_norm_plain(x2, delta, w, 1e-6))
    _same(x, x2)
    gl = _normal(g, 4, 1, 32)
    _same(df.gelu_mul(gl), df.gelu_mul_plain(gl))
    assert [w.launches for w in df.wrappers()] == before


@pytest.mark.parametrize("rows,d,width", [
    (128, 384, 32), (16, 384, 32), (15, 384, 64), (1, 384, 64),
    (128, 16, 16), (1, 64, 64), (16, 64, 32), (128, 1024, 32),
    (1, 1024, 256), (4, 100, 64)])
def test_reduce_width_is_atens_block_width(rows, d, width):
    """ATen's mean over the last dim (``setReduceConfig``, 512 threads):
    block.x = min(pow2 <= items, 512 / block.y), block.y = min(pow2 <=
    rows, 512 / min(pow2 <= items, 32)), items being 4-value vectors when
    d > 128."""
    assert df._reduce_width(rows, d) == width


@pytest.mark.parametrize("d", [130, 386, 1028, 1040, 2048])
def test_norm_kernel_refuses_widths_it_was_not_built_for(d):
    """Kernel 7 takes d up to 1024, a multiple of 4 above 128 (the model
    of record's 384, and the 16 of a small test model the smoke decodes
    on the card); any other width raises before a launch."""
    x = torch.zeros(4, 1, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="add_rms_norm"):
        df._norm_launch(x, x.clone(), None, None, torch.ones(d),
                        torch.empty_like(x), 1e-6)


def test_t5_norm_and_gelu_are_defined_once():
    """``models/t5.py`` (training, the encoder, the cross-KV) and the
    decode step's twins share one definition of T5's norm and gelu."""
    assert pt5.rms_norm is df.rms_norm and pt5.gelu_new is df.gelu_new


# --------------------------------------------------------------------- #
# decode_step and the loop through the wrappers                          #
# --------------------------------------------------------------------- #


def _parent_decode_step(dparams, token, step, kv_cache, cross_kv, cfg,
                        bias_rows, plan=None):
    """The previous ``models/t5.py::decode_step``, op by op."""
    dt = cfg.dtype
    H, D = cfg.num_heads, cfg.d_kv
    step = torch.full((), int(step), dtype=torch.int32)
    pos = step.view(1).long()
    x = dparams["embedding"][token][:, None]
    int8_self = isinstance(kv_cache[0][0], tuple)
    c = pt5._cache_length(kv_cache)
    L = bias_rows.shape[1]
    keys = torch.arange(c)
    cols = (keys + (L - 1) - step).clamp_(max=L - 1)
    bias_row = bias_rows.index_select(1, cols)[None, :, None, :]
    mask = (keys <= step)[None, None, None, :]
    for i, layer in enumerate(dparams["layers"]):
        h = pt5.rms_norm(x, layer["ln1"], cfg.layer_norm_epsilon)
        qkv = pt5._proj(h, layer["sa_qkv"], dt)
        q, k_new, v_new = (pt5._split_heads(p, H, D)
                           for p in qkv.chunk(3, dim=-1))
        k_entry, v_entry = kv_cache[i]
        if int8_self:
            k_newq = _parent_write_kv(k_entry, k_new, pos, kv_cache.bits)
            v_newq = _parent_write_kv(v_entry, v_new, pos, kv_cache.bits)
        else:
            k_entry.index_copy_(2, pos, k_new)
            v_entry.index_copy_(2, pos, v_new)
        if int8_self and plan is not None:
            h = plan.causal(i, q, k_newq, v_newq, step)
        elif int8_self:
            h = pt5._attention_int8(q, pt5._prefix(k_entry, c),
                                    pt5._prefix(v_entry, c), bias_row, mask,
                                    dt)
        else:
            h = pt5.attention(q, pt5._prefix(k_entry, c),
                              pt5._prefix(v_entry, c), bias_row, mask, dt)
        x = x + pt5._proj_row(pt5._merge_heads(h), layer["sa_o"], dt, None)
        h = pt5.rms_norm(x, layer["ln2"], cfg.layer_norm_epsilon)
        q = pt5._split_heads(pt5._proj(h, layer["ca_q"], dt), H, D)
        ck, cv = cross_kv.layers[i]
        if cross_kv.transposed:
            a = pt5.decode_attention_cross_t(q, ck, cv,
                                             enc_len=cross_kv.enc_len)
        elif isinstance(ck, tuple) and plan is not None:
            a = plan.cross(i, q)
        elif isinstance(ck, tuple):
            a = pt5._attention_int8(q, ck, cv, None, None, dt)
        else:
            a = pt5.attention(q, ck, cv, None, None, dt)
        x = x + pt5._proj_row(pt5._merge_heads(a), layer["ca_o"], dt, None)
        h = pt5.rms_norm(x, layer["ln3"], cfg.layer_norm_epsilon)
        gate, lin = pt5._proj(h, layer["mlp_wi"], dt).chunk(2, dim=-1)
        x = x + pt5._proj_row(pt5.gelu_new(gate) * lin, layer["mlp_wo"], dt,
                              None)
    x = pt5.rms_norm(x, dparams["final_ln"], cfg.layer_norm_epsilon)
    return pt5._proj(x, dparams["lm_head"], dt)[:, 0, :]


ROUTES = {
    "fp32 plain KV": ("float32", dict(quant=False)),
    "fp32 int8 KV plan": ("float32", dict(quant=True, plan=True)),
    "bf16 int8 KV": ("bfloat16", dict(quant=True)),
    "bf16 int8 KV plan": ("bfloat16", dict(quant=True, plan=True)),
    "bf16 kv_bits=4 plan": ("bfloat16", dict(quant=True, plan=True, bits=4)),
    "bf16 int8 weights plan": ("bfloat16", dict(quant=True, plan=True,
                                                weights=True)),
    "bf16 transposed cross": ("bfloat16", dict(quant=True, plan=True,
                                               transposed=True)),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_decode_step_equals_parent_step(route):
    """Six teacher-forced steps from one encoder output: the logits and
    every cache entry equal the previous step's bit for bit."""
    dtype, opt = ROUTES[route]
    dt = DTYPES[dtype]
    cfg = pt5.T5Config(**SHAPE, dtype=dt)
    sd = {k: torch.from_numpy(v)
          for k, v in pt5.init_params(7, cfg).items()}
    model = pt5.T5Model.from_state_dict(sd, cfg)
    g = torch.Generator().manual_seed(8)
    B, Lenc, L = 3, 10, 16
    enc = _normal(g, B, Lenc, cfg.d_model, dtype=dt)
    bits = opt.get("bits", 8)
    quant = opt["quant"]
    dparams = pt5.prepare_decode_params(model, cfg,
                                        quantize_weights=opt.get("weights",
                                                                 False))
    rows = pt5.decoder_bias_rows(dparams["rel_bias"], L, cfg).float() \
        .contiguous()
    cross = pt5.precompute_cross_kv(model, enc, cfg, quantize=quant,
                                    bits=bits)
    if opt.get("transposed"):
        cross = pt5.transpose_cross_kv(cross)
    caches = [pt5.init_kv_cache(B, L, cfg, quantize=quant, bits=bits)
              for _ in range(2)]
    plans = [pt5.int8_attention_plan(c, cross, rows, dt)
             if opt.get("plan") else None for c in caches]
    tokens = torch.tensor([[1, 5, 9, 2, 30, 7], [1, 1, 399, 4, 4, 4],
                           [1, 17, 3, 0, 0, 0]], dtype=torch.int32)
    for s in range(tokens.shape[1]):
        got = pt5.decode_step(dparams, tokens[:, s],
                              torch.tensor(s, dtype=torch.int32), caches[0],
                              cross, cfg, rows, plans[0])
        want = _parent_decode_step(dparams, tokens[:, s], s, caches[1], cross,
                                   cfg, rows, plans[1])
        _same(got, want)
    for a, b in zip(caches[0], caches[1]):
        for ea, eb in zip(a, b):
            for t, u in zip(ea if quant else (ea,), eb if quant else (eb,)):
                _same(t, u)


@pytest.mark.parametrize("knobs", [
    {}, {"suppress_tokens": (3, 2)},
    {"quantize_kv": True, "pallas_attention": True, "unroll": 4}])
def test_greedy_loop_equals_parent_chain(knobs, monkeypatch):
    """The decode loop's greedy step through ``greedy_commit`` gives the
    tokens and lengths of the previous chain (``_commit_chain``), with and
    without suppression and across ``unroll``."""
    cfg = pt5.T5Config(**SHAPE, dtype=torch.bfloat16)
    sd = {k: torch.from_numpy(v)
          for k, v in pt5.init_params(9, cfg).items()}
    model = pt5.T5Model.from_state_dict(sd, cfg)
    enc = _normal(torch.Generator().manual_seed(10), 4, 12, cfg.d_model,
                  dtype=torch.bfloat16)
    dcfg = DecodeConfig(max_length=24, **knobs)
    got = generate_tokens_eager(model, enc, cfg, dcfg)
    monkeypatch.setattr(pdecode.DecodeProgram, "_commit",
                        pdecode.DecodeProgram._commit_chain)
    want = generate_tokens_eager(model, enc, cfg, dcfg)
    for a, b in zip(got, want):
        _same(a, b)


def test_loop_counts_the_fused_wrappers():
    """A replay adds the four wrappers' launches (``_counted``); the
    hybrid loop selects by the chain, never by kernel 10."""
    assert set(df.wrappers()) <= set(pdecode._counted())
    assert pdecode.HybridDecodeProgram._commit is \
        pdecode.DecodeProgram._commit_chain


@pytest.mark.parametrize("name", ["decode.fused_launches_per_step",
                                  "decode.fused_launches_per_step.upload"])
def test_fused_launches_metric_reads_the_decode_spans(monkeypatch, name):
    """``benchmark/metrics/decode.fused_launches_per_step.py`` (and its
    upload cell's name): the ``decode`` spans' ``fused_launches`` over
    their ``steps`` in the traced slice; nothing where the spans carry no
    count (a program before the counter), without spans or without a
    card."""
    from types import SimpleNamespace

    from benchmark import spec
    from music2midi_tpu_torch import profiling

    def span(sid, t0, t1, **attrs):
        return {"name": "decode", "id": sid, "parent": None, "thread": "t",
                "t0_ns": t0 * 1000, "t1_ns": t1 * 1000, "attrs": attrs}

    ctx = {"on_card": True, "trace": {"slice": SimpleNamespace(
        events=[], window=(0.0, 100.0))}}
    read = spec.metric_reader(name)
    spans = [span(1, 10, 40, steps=10, syncs=10, fused_launches=320),
             span(2, 50, 90, steps=4, syncs=4, fused_launches=128),
             span(3, 200, 300, steps=5, fused_launches=9)]  # outside
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert read(ctx) == 32.0
    assert read({**ctx, "on_card": False}) is None
    monkeypatch.setattr(profiling, "spans", lambda: [
        {**s, "attrs": {"steps": s["attrs"]["steps"]}} for s in spans])
    assert read(ctx) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(ctx) is None


@pytest.mark.parametrize("name", ["decode.kernels_per_step",
                                  "decode.kernels_per_step.upload"])
def test_kernels_metric_counts_what_decode_spans_launched(monkeypatch, name):
    """``benchmark/metrics/decode.kernels_per_step.py`` (and its upload
    cell's name): the device's kernels whose launching host call (by
    correlation id) starts inside a ``decode`` span of the slice, over
    those spans' ``steps``; a graph launch's kernels count, copies and
    sets do not, nor what a span outside the slice launched; nothing
    without decode steps, spans or a card."""
    from types import SimpleNamespace

    from benchmark import spec
    from music2midi_tpu_torch import profiling

    def span(sid, t0, t1, **attrs):
        return {"name": "decode", "id": sid, "parent": None, "thread": "t",
                "t0_ns": t0 * 1000, "t1_ns": t1 * 1000, "attrs": attrs}

    def ev(cat, name, ts, corr):
        return {"name": name, "cat": cat, "ts": ts, "dur": 1.0, "corr": corr}

    events = [
        ev("runtime", "cudaLaunchKernel", 5, 1),  # before any span
        ev("device", "encoder_gemm", 12, 1),  # runs inside: not counted
        ev("runtime", "cudaGraphLaunch", 12, 2),
        *[ev("device", f"k{i}", 30 + i, 2) for i in range(6)],
        ev("runtime", "cudaMemcpyAsync", 14, 3),
        ev("device", "Memcpy DtoH (Device -> Pinned)", 40, 3),
        ev("runtime", "cudaLaunchKernel", 60, 4),
        ev("device", "k_late", 95, 4),  # the card's clock: past the span
        ev("runtime", "cudaGraphLaunch", 210, 5),  # a span off the slice
        ev("device", "k_off", 211, 5),
    ]
    ctx = {"on_card": True, "trace": {"slice": SimpleNamespace(
        events=events, window=(0.0, 100.0))}}
    read = spec.metric_reader(name)
    spans = [span(1, 10, 40, steps=3), span(2, 50, 90, steps=1),
             span(3, 90, 300, steps=5)]  # past the slice's end
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert read(ctx) == 7 / 4
    assert read({**ctx, "on_card": False}) is None
    monkeypatch.setattr(profiling, "spans", lambda: [
        {**s, "attrs": {}} for s in spans])
    assert read(ctx) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(ctx) is None
