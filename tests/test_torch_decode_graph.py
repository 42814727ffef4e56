"""The decode loop as one program (``infer/decode.py::DecodeProgram``), its
device-step body (``models/t5.py::decode_step`` with a 0-d int32 step),
kernel 3's launch plan with a device step, and the trace helpers (CPU).

On the CPU the program runs its body eagerly over its static state: the
body a card captures.  Bars:
  * fp32 greedy tokens and lengths exactly JAX ``generate_tokens``' (with
    and without ``suppress_tokens``; past 64 steps, so that the plain
    route crosses a phase of its prefix as the JAX cache grows);
  * bf16 with int8 KV, teacher-forced on the JAX tokens through the
    device-step body (the plain route and the launch plan's): logits
    within 0.0625 of JAX's, the argmax equal wherever JAX's top-2 gap
    exceeds twice that (``test_torch_decode.py``'s bar);
  * tokens and lengths exactly those of the parent commit's host-step
    loop (reproduced below) for ``unroll`` 1 and 8, ``kv_bits`` 4,
    ``quantize_weights`` and ``pallas_cross``;
  * the eager twin (``generate_tokens_eager``) equal to the kept program,
    also when sampling from one seed, the caller's generator advanced
    alike; the program kept and reused per key, the suppression index
    built once per key;
  * ``Int8AttentionPlan.causal`` with a device step equal to the host-step
    call bit for bit;
  * the trace helpers summarize a ``torch.profiler`` trace of the CPU, and
    their interval arithmetic on a hand-made trace.
"""

import gc
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music2midi_tpu.infer.decode import DecodeConfig as JaxDecodeConfig
from music2midi_tpu.infer.decode import generate_tokens as jax_generate
from music2midi_tpu.models import t5 as jt5
from music2midi_tpu_torch import profiling
from music2midi_tpu_torch.infer import decode as pdecode
from music2midi_tpu_torch.infer.decode import (
    DecodeConfig,
    decode_programs,
    generate_tokens,
    generate_tokens_eager,
)
from music2midi_tpu_torch.models import t5 as pt5
from music2midi_tpu_torch.ops import decode_attention as pda
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
    rng = np.random.default_rng(3)
    enc = rng.normal(size=(4, 25, 64)).astype(np.float32)
    return tree, pcfg, enc


def _model(tree, pcfg):
    """A fresh port model of the JAX weights (its own kept programs)."""
    return pt5.T5Model.from_state_dict(params_from_jax(tree), pcfg)


@pytest.mark.parametrize("max_len,suppress", [(40, ()), (40, (2,)),
                                              (100, (2,))])
def test_device_step_body_greedy_equals_jax_fp32(setup, max_len, suppress):
    """suppress=(EOS,) runs every row to max_length; at 100 the plain
    route reads a 64-key prefix and then the whole cache, as the JAX loop
    runs a 64-long cache and then a 100-long one.  Exact."""
    tree, pcfg, enc = setup
    jt, jl = jax_generate(
        tree, jnp.asarray(enc), jt5.T5Config(**SHAPE),
        JaxDecodeConfig(max_length=max_len, suppress_tokens=suppress))
    dcfg = DecodeConfig(max_length=max_len, suppress_tokens=suppress)
    model = _model(tree, pcfg)
    for fn in (generate_tokens, generate_tokens_eager):
        pt, pl = fn(model, torch.from_numpy(enc), pcfg, dcfg)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    prog = decode_programs(model)[(4, 25, pcfg, dcfg, torch.device("cpu"))]
    assert prog.phases == ([64, max_len] if max_len > 64 else [max_len])


@pytest.mark.parametrize("route", ["plain", "plan"])
def test_device_step_body_int8_kv_teacher_forced_matches_jax(setup, route):
    """bf16 + int8 self/cross KV, the step a 0-d int32 tensor and the
    plain route's prefix the whole cache (keys after the step masked):
    logits within 0.0625 of JAX's serving ``decode_step`` and the argmax
    equal wherever JAX's top-2 gap exceeds twice that."""
    tree, pcfg, enc = setup
    B, max_len, tol = enc.shape[0], 40, 0.0625
    jcfg = jt5.T5Config(**SHAPE, dtype=jnp.bfloat16)
    pcfg = pcfg._replace(dtype=torch.bfloat16)
    model = _model(tree, pcfg)
    enc_bf = torch.from_numpy(enc).to(torch.bfloat16)
    jenc = jnp.asarray(enc).astype(jnp.bfloat16)
    jcross = jt5.precompute_cross_kv(tree, jenc, jcfg, quantize=True)
    jcache = jt5.init_kv_cache(B, max_len, jcfg, quantize=True)
    jdp = jt5.prepare_decode_params(tree, jcfg)
    dp = pt5.prepare_decode_params(model, pcfg)
    rows = pt5.decoder_bias_rows(dp["rel_bias"], max_len, pcfg)
    pcross = pt5.precompute_cross_kv(model, enc_bf, pcfg, quantize=True)
    pcache = pt5.init_kv_cache(B, max_len, pcfg, quantize=True)
    plan = pt5.int8_attention_plan(pcache, pcross, rows) \
        if route == "plan" else None
    tok = np.ones(B, np.int32)
    for step in range(30):
        lj, jcache = jt5.decode_step(jdp, jnp.asarray(tok), jnp.int32(step),
                                     jcache, jcross, jcfg, max_len)
        lp = pt5.decode_step(dp, torch.from_numpy(tok),
                             torch.tensor(step, dtype=torch.int32), pcache,
                             pcross, pcfg, rows, plan).float().numpy()
        lj = np.asarray(lj).astype(np.float32)
        lj[:, 2] = lp[:, 2] = -np.inf  # EOS suppressed: full-length rows
        np.testing.assert_allclose(lp, lj, atol=tol)
        top2 = np.sort(lj, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * tol
        np.testing.assert_array_equal(lp.argmax(-1)[clear],
                                      lj.argmax(-1)[clear])
        tok = lj.argmax(-1).astype(np.int32)


# --------------------------------------------------------------------- #
# the parent commit's host-step loop, reproduced as it was               #
# --------------------------------------------------------------------- #


def _parent_write_kv(entry, new, step, bits):
    if isinstance(entry, tuple):
        vals, scales = entry
        q8, s = pt5._quantize_kv(new, bits)
        vals[:, :, step:step + 1] = q8
        scales[:, :, :, step:step + 1] = s
        return q8, s
    entry[:, :, step:step + 1] = new
    return None


def _parent_decode_step(dparams, token, step, kv_cache, cross_kv, cfg,
                        bias_rows, plan):
    """The parent's ``decode_step``: a host step, the written prefix
    [0, step] read with no mask, the bias window a slice."""
    dt, H, D = cfg.dtype, cfg.num_heads, cfg.d_kv
    eps = cfg.layer_norm_epsilon
    x = dparams["embedding"][token][:, None]
    n = step + 1
    L = bias_rows.shape[1]
    bias_row = bias_rows[:, L - n:][None, :, None, :]
    for i, layer in enumerate(dparams["layers"]):
        h = pt5.rms_norm(x, layer["ln1"], eps)
        qkv = pt5._proj(h, layer["sa_qkv"], dt)
        q, k_new, v_new = (pt5._split_heads(p, H, D)
                           for p in qkv.chunk(3, dim=-1))
        k_entry, v_entry = kv_cache[i]
        k_newq = _parent_write_kv(k_entry, k_new, step, kv_cache.bits)
        v_newq = _parent_write_kv(v_entry, v_new, step, kv_cache.bits)
        k_seen, v_seen = pt5._prefix(k_entry, n), pt5._prefix(v_entry, n)
        if k_newq is not None and plan is not None:
            h = plan.causal(i, q, k_newq, v_newq, step)
        elif k_newq is not None:
            h = pt5._attention_int8(q, k_seen, v_seen, bias_row, None, dt)
        else:
            h = pt5.attention(q, k_seen, v_seen, bias_row, None, dt)
        x = x + pt5._proj(pt5._merge_heads(h), layer["sa_o"], dt)
        h = pt5.rms_norm(x, layer["ln2"], eps)
        q = pt5._split_heads(pt5._proj(h, layer["ca_q"], dt), H, D)
        ck, cv = cross_kv.layers[i]
        if cross_kv.transposed:
            a = pda.decode_attention_cross_t(q, ck, cv,
                                             enc_len=cross_kv.enc_len)
        elif isinstance(ck, tuple) and plan is not None:
            a = plan.cross(i, q)
        elif isinstance(ck, tuple):
            a = pt5._attention_int8(q, ck, cv, None, None, dt)
        else:
            a = pt5.attention(q, ck, cv, None, None, dt)
        x = x + pt5._proj(pt5._merge_heads(a), layer["ca_o"], dt)
        h = pt5.rms_norm(x, layer["ln3"], eps)
        gate, lin = pt5._proj(h, layer["mlp_wi"], dt).chunk(2, dim=-1)
        x = x + pt5._proj(pt5.gelu_new(gate) * lin, layer["mlp_wo"], dt)
    x = pt5.rms_norm(x, dparams["final_ln"], eps)
    return pt5._proj(x, dparams["lm_head"], dt)[:, 0, :]


def _parent_generate(model, enc, cfg, dcfg):
    """The parent's ``generate_tokens`` loop (greedy): every step issued
    from the host at a host step over a max_length cache."""
    B, max_len = enc.shape[0], dcfg.max_length
    unroll, quant = max(1, dcfg.unroll), dcfg.quantize_kv
    cross = pt5.precompute_cross_kv(model, enc, cfg, quantize=quant,
                                    bits=dcfg.kv_bits)
    if dcfg.pallas_cross and quant and dcfg.kv_bits == 8:
        cross = pt5.transpose_cross_kv(cross)
    dp = pt5.prepare_decode_params(model, cfg,
                                   quantize_weights=dcfg.quantize_weights)
    rows = pt5.decoder_bias_rows(dp["rel_bias"], max_len, cfg)
    cache = pt5.init_kv_cache(B, max_len, cfg, quantize=quant,
                              bits=dcfg.kv_bits)
    plan = pt5.int8_attention_plan(cache, cross, rows, cfg.dtype) \
        if dcfg.pallas_attention and quant else None
    tokens = torch.full((B, max_len), cfg.pad_token_id, dtype=torch.int32)
    tokens[:, 0] = cfg.decoder_start_token_id
    token = tokens[:, 0].clone()
    done = torch.zeros(B, dtype=torch.bool)
    for step in range(max_len - 1):
        logits = _parent_decode_step(dp, token, step, cache, cross, cfg, rows,
                                     plan)
        nxt = pdecode._select_next(logits, dcfg, None)
        nxt = torch.where(done, cfg.pad_token_id, nxt)
        done = done | (nxt == cfg.eos_token_id)
        tokens[:, step + 1] = nxt
        token = nxt
        if (step + 1) % unroll == 0 and bool(done.all()):
            break
    eos = tokens == cfg.eos_token_id
    first = eos.to(torch.int8).argmax(dim=1).to(torch.int32)
    return tokens, torch.where(eos.any(dim=1), first + 1,
                               max_len).to(torch.int32)


SERVING = dict(quantize_kv=True, pallas_attention=True)
PARENT_CASES = {
    "fp32 unroll=1": ("float32", {}),
    "fp32 unroll=8": ("float32", {"unroll": 8}),
    "fp32 quantize_weights": ("float32", {"quantize_weights": True}),
    "bf16 serving unroll=8": ("bfloat16", {**SERVING, "unroll": 8}),
    "bf16 kv_bits=4": ("bfloat16", {**SERVING, "kv_bits": 4}),
    "bf16 quantize_weights": ("bfloat16", {**SERVING,
                                           "quantize_weights": True}),
    "bf16 pallas_cross": ("bfloat16", {**SERVING, "pallas_cross": True}),
}


@pytest.mark.parametrize("case", list(PARENT_CASES))
def test_tokens_equal_parent_host_step_loop(setup, case):
    """The same greedy tokens and lengths as the parent commit's loop, the
    rows' EOS suppressed in half the batch so that rows run past 64 steps
    (max_length 80) beside rows that end early."""
    tree, pcfg, enc = setup
    dtype, knobs = PARENT_CASES[case]
    pcfg = pcfg._replace(dtype=getattr(torch, dtype))
    model = _model(tree, pcfg)
    x = torch.from_numpy(enc).to(pcfg.dtype)
    for suppress in ((), (2,)):
        dcfg = DecodeConfig(max_length=80, suppress_tokens=suppress, **knobs)
        want_t, want_l = _parent_generate(model, x, pcfg, dcfg)
        got_t, got_l = generate_tokens(model, x, pcfg, dcfg)
        np.testing.assert_array_equal(got_t.numpy(), want_t.numpy())
        np.testing.assert_array_equal(got_l.numpy(), want_l.numpy())


@pytest.mark.parametrize("knobs", [{}, {"temperature": 1.0, "top_k": 5},
                                   {"unroll": 3, "suppress_tokens": (2, 7)}])
def test_kept_program_equals_eager_twin(setup, knobs):
    """Two generations through the kept program (the second reusing its
    state) and one through the eager twin: equal tokens and lengths; when
    sampling, from generators of one seed, each advanced alike."""
    tree, pcfg, enc = setup
    model = _model(tree, pcfg)
    x = torch.from_numpy(enc)
    dcfg = DecodeConfig(max_length=48, **knobs)
    gens = [torch.Generator().manual_seed(13) for _ in range(3)]
    runs = [generate_tokens(model, x, pcfg, dcfg, gens[0]),
            generate_tokens(model, x, pcfg, dcfg, gens[1]),
            generate_tokens_eager(model, x, pcfg, dcfg, gens[2])]
    assert len(decode_programs(model)) == 1
    for t, ln in runs[1:]:
        assert torch.equal(t, runs[0][0]) and torch.equal(ln, runs[0][1])
    if "temperature" in knobs:
        assert torch.equal(gens[0].get_state(), gens[2].get_state())
        assert not torch.equal(gens[0].get_state(),
                               torch.Generator().manual_seed(13).get_state())
        # another generation on the advanced generator draws anew
        again = generate_tokens(model, x, pcfg, dcfg, gens[0])[0]
        assert not torch.equal(again, runs[0][0])


def test_programs_kept_per_key_and_suppression_built_once(setup,
                                                          monkeypatch):
    tree, pcfg, enc = setup
    built = []
    orig = pdecode.suppression_index

    def counting(dcfg, device):
        built.append(dcfg.suppress_tokens)
        return orig(dcfg, device)

    monkeypatch.setattr(pdecode, "suppression_index", counting)
    model = _model(tree, pcfg)
    x = torch.from_numpy(enc)
    dcfg = DecodeConfig(max_length=30, suppress_tokens=(5, 6))
    first = generate_tokens(model, x, pcfg, dcfg)
    second = generate_tokens(model, x, pcfg, dcfg)
    assert built == [(5, 6)]  # one key: built once, for 2 x 29 steps
    assert torch.equal(first[0], second[0])
    generate_tokens(model, x[:2], pcfg, dcfg)  # another width, another key
    assert built == [(5, 6)] * 2
    assert len(decode_programs(model)) == 2
    for width in range(1, 1 + pdecode._MAX_PROGRAMS):
        generate_tokens(model, x[:1].expand(width, -1, -1).contiguous(),
                        pcfg, dcfg._replace(max_length=4))
    assert len(decode_programs(model)) == pdecode._MAX_PROGRAMS
    del model
    gc.collect()  # the programs go with their model


def test_threads_on_one_key_take_turns(setup):
    """Two threads decode different encoder outputs of one key through
    the kept program, three times each, started together: each gets its
    own input's tokens and lengths (the eager twin's), exactly."""
    import threading

    tree, pcfg, enc = setup
    model = _model(tree, pcfg)
    dcfg = DecodeConfig(max_length=40)
    xs = [torch.from_numpy(enc), torch.from_numpy(enc[::-1].copy() * 1.5)]
    want = [generate_tokens_eager(model, x, pcfg, dcfg) for x in xs]
    assert not torch.equal(want[0][0], want[1][0])
    start = threading.Barrier(2)
    got = [[], []]

    def worker(i):
        start.wait()
        for _ in range(3):
            got[i].append(generate_tokens(model, xs[i], pcfg, dcfg))

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(decode_programs(model)) == 1
    for i in (0, 1):
        assert len(got[i]) == 3
        for t, ln in got[i]:
            assert torch.equal(t, want[i][0]) and torch.equal(ln, want[i][1])


def test_plan_device_step_equals_host_step_bit_for_bit():
    rng = np.random.default_rng(4)
    B, H, L, D = 2, 3, 24, 16

    def normals(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    cache = [(pt5._quantize_kv(normals(B, H, L, D)),
              pt5._quantize_kv(normals(B, H, L, D))) for _ in range(2)]
    rows = normals(H, L)
    for round_pv, dtype in ((True, torch.bfloat16), (False, torch.bfloat16),
                            (True, torch.float32)):
        plan = pda.Int8AttentionPlan(cache, rows, round_pv=round_pv,
                                     dtype=dtype)
        q = normals(B, H, 1, D).to(dtype)
        kn, vn = (pt5._quantize_kv(normals(B, H, 1, D)) for _ in range(2))
        for i, step in ((0, 0), (1, 5), (0, 16), (1, L - 1)):
            host = plan.causal(i, q, kn, vn, step)
            dev = plan.causal(i, q, kn, vn,
                              torch.tensor(step, dtype=torch.int32))
            assert torch.equal(host, dev), (round_pv, dtype, step)
    with pytest.raises(ValueError, match="outside the cache"):
        plan.causal(0, q, kn, vn, torch.tensor(L, dtype=torch.int32))


def test_trace_helpers_summarize_a_cpu_trace(tmp_path):
    a = torch.from_numpy(np.random.default_rng(0).normal(
        size=(32, 32)).astype(np.float32))
    with profiling.trace(tmp_path) as prof:
        with profiling.span("work"):
            b = torch.softmax(a @ a, dim=-1)
    assert prof is not None and b.shape == (32, 32)
    events = profiling.load_trace(tmp_path)
    rows = profiling.summarize_trace(tmp_path, top=50, device_only=False)
    names = [name for _, _, name in rows]
    assert "work" in names and "aten::softmax" in names
    assert all(ms >= 0 and n >= 1 for ms, n, _ in rows)
    assert [ms for ms, _, _ in rows] == sorted((ms for ms, _, _ in rows),
                                               reverse=True)
    assert profiling.summarize_trace(tmp_path) == []  # no device here
    window = profiling.annotation_window(events, "work")
    assert window[1] > window[0]
    assert profiling.host_launches(events, window) == {}
    assert profiling.device_idle_share(events, window) == 1.0
    with pytest.raises(KeyError):
        profiling.annotation_window(events, "absent")


def test_trace_interval_arithmetic(tmp_path):
    """A hand-made trace: kernels over [0, 10], [5, 15] and [20, 30], a
    copy over [38, 50], in a 40-us window: busy 27 us, idle 13 / 40; two
    kernel launches and one graph launch start inside it."""
    ev = [{"ph": "X", "cat": "kernel", "name": "k", "ts": t, "dur": d,
           "args": {"correlation": c}}
          for t, d, c in ((0, 10, 1), (5, 10, 2), (20, 10, 3))]
    ev.append({"ph": "X", "cat": "kernel", "name": "void ns::decode_k<float>"
               "(ns::Args)", "ts": 41, "dur": 1, "args": {"correlation": 4}})
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
               "ts": 38, "dur": 12, "args": {"correlation": 5}})
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": n, "ts": t, "dur": 1,
            "args": {"correlation": c}}
           for n, t, c in (("cudaLaunchKernel", 1, 1),
                           ("cudaLaunchKernel", 2, 2),
                           ("cudaGraphLaunch", 3, 3),
                           ("cudaLaunchKernel", 45, 4),
                           ("cudaMemcpyAsync", 4, 5))]
    ev.append({"ph": "X", "cat": "user_annotation", "name": "decode",
               "ts": 0, "dur": 40})
    (tmp_path / "a.trace.json").write_text(json.dumps({"traceEvents": ev}))
    events = profiling.load_trace(tmp_path)
    window = profiling.annotation_window(events, "decode")
    assert window == (0.0, 40.0)
    assert profiling.device_busy_us(events, window) == 27.0
    assert profiling.device_idle_share(events, window) == pytest.approx(
        13 / 40, abs=1e-12)
    assert profiling.host_launches(events, window) == {
        "cudaLaunchKernel": 2, "cudaGraphLaunch": 1}
    assert profiling.device_kernels(events, ("k", "decode_k", "absent"),
                                    window) == {"k": 3, "decode_k": 0,
                                                "absent": 0}
    assert profiling.device_kernels(events, ("decode_k",)) == {"decode_k": 1}
    assert profiling.device_clock_past(events, window) == 10.0  # the copy
    assert profiling.summarize_trace(tmp_path) == [
        (0.03, 3, "k"), (0.012, 1, "Memcpy DtoH"),
        (0.001, 1, "void ns::decode_k<float>(ns::Args)")]



def test_device_kernels_go_by_the_launching_call(tmp_path):
    """A kernel counts in a window when the host call that launched it
    (same correlation id) starts there, wherever the device's clock puts
    the kernel: a replay's kernels stamped past the window's end count,
    a kernel stamped inside it but launched after it does not, and one
    with no launch in the trace counts only without a window."""
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": n, "ts": t, "dur": 1,
           "args": {"correlation": c}}
          for n, t, c in (("cudaGraphLaunch", 2, 7),
                          ("cudaLaunchKernel", 60, 8))]
    ev.append({"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernelEx",
               "ts": 5, "dur": 1, "args": {"correlation": 9}})
    ev += [{"ph": "X", "cat": "kernel", "name": f"void {n}_kernel<1>()",
            "ts": t, "dur": 3, "args": {"correlation": c}}
           for n, t, c in (("attn", 10, 7), ("attn", 44, 7), ("attn", 47, 7),
                           ("attn", 30, 8), ("mel", 12, 9), ("mel", 20, 99))]
    ev.append({"ph": "X", "cat": "user_annotation", "name": "decode",
               "ts": 0, "dur": 40})
    (tmp_path / "b.trace.json").write_text(json.dumps({"traceEvents": ev}))
    events = profiling.load_trace(tmp_path)
    window = profiling.annotation_window(events, "decode")
    assert profiling.launch_ids(events, window) == {7, 9}
    assert profiling.device_kernels(events, ("attn", "mel"), window) == {
        "attn": 3, "mel": 1}
    assert profiling.device_kernels(events, ("attn", "mel")) == {
        "attn": 4, "mel": 2}
    assert profiling.device_clock_past(events, window) == 10.0  # 47 + 3
    assert profiling.host_launches(events, window) == {
        "cudaGraphLaunch": 1, "cuLaunchKernelEx": 1}

def _c_kind(decl: str):
    """The ctypes type a C parameter or field declaration is passed as."""
    import ctypes

    if "*" in decl:
        return ctypes.c_void_p
    if "long long" in decl or "int64_t" in decl:
        return ctypes.c_int64
    return ctypes.c_float if "float" in decl else ctypes.c_int


def test_launch_interfaces_match_the_cuda_sources():
    """Each exported launcher's ctypes argtypes and each argument block's
    ctypes fields, against the C declarations in ``csrc/*.cu``, read as
    text (the sources are compiled on the card only): the same count,
    order and kinds, and the same field names."""
    import re
    from pathlib import Path

    from music2midi_tpu_torch.ops import _build

    csrc = Path(pda.__file__).resolve().parent.parent / "csrc"
    text = "\n".join(re.sub(r"//[^\n]*", "", f.read_text())
                     for f in sorted(csrc.glob("*.cu")))
    protos = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text))
    assert set(protos) == set(_build._SIGNATURES)
    for name, params in protos.items():
        kinds = [_c_kind(p) for p in params.split(",")]
        assert kinds == _build._SIGNATURES[name], name
    for struct, cls in (("Int8AttnArgs", pda._Int8Args),
                        ("CrossTArgs", pda._CrossTArgs)):
        body = re.search(r"struct %s \{(.*?)\};" % struct, text, re.S)[1]
        fields = []
        for decl in filter(None, (d.strip() for d in body.split(";"))):
            words = decl.replace("*", " * ").split()
            kind = _c_kind(decl)
            names = " ".join(w for w in words if w not in (
                "const", "void", "int8_t", "float", "int64_t", "int",
                "__nv_bfloat16", "*")).split(",")
            fields += [(n.strip(), kind) for n in names]
        assert fields == [(n, t) for n, t in cls._fields_], struct
