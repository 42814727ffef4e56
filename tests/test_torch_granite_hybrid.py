"""The hybrid decoder (``models/granite_hybrid.py``) against its plain
float32 reference (``models/granite_hybrid_ref.py``), on the CPU at a tiny
configuration: hidden 64, 4 Mamba heads x 16, d_state 16, 8 experts top 2,
3 layers (mamba, attention, mamba).

Bars (everything float32 on both sides, so the two differ only by the
order of their float32 sums: the chunked scan against the sequential
recurrence, batched against per-expert matmuls):
  * prefill over the prefix, then decode through the SSM state, the conv
    tail and the KV cache: logits within 1e-5 of the largest logit of the
    reference's full forward (a bfloat16 rounding of the weights alone
    moves them ~1e-3), the final SSM states within 1e-6 of the largest;
  * the chunked scan against the sequential recurrence, at chunk sizes
    that split the sequence and that do not, for 1 and 2 groups, 1e-6;
  * kernel 6's plain twin against the reference's step, 1e-6; a bfloat16
    state is the float32 update rounded;
  * the MoE against the reference's per-expert loop, also with every
    token routed to one expert (nothing dropped: each layer step counts
    rows x top-k pairs), 1e-6;
  * the reference imports nothing of the port or of JAX;
  * ``serve_batch`` on the tiny hybrid behind the model of record's tower
    writes MIDI; the engine refuses the T5-only options and a mesh;
  * the T5 path's tokens and notes equal the JAX engine's (fp32), the
    hybrid's presence in the package changing nothing there;
  * ids >= 400 are no event in the device and host detokenizers, ids in
    [333, 400) still time tokens.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from music2midi_tpu.config import default_config as jax_default_config
from music2midi_tpu.infer import Music2MIDI as JaxMusic2MIDI
from music2midi_tpu.tokenizer import MidiTokenizer as JaxTokenizer
from music2midi_tpu_torch.audio import write_wav
from music2midi_tpu_torch.config import default_config, load_config
from music2midi_tpu_torch.infer import Music2MIDI
from music2midi_tpu_torch.infer.decode import (generate_tokens,
                                               generate_tokens_eager)
from music2midi_tpu_torch.models import granite_hybrid as gh
from music2midi_tpu_torch.models import granite_hybrid_ref as ref
from music2midi_tpu_torch.ops import ssm_state_update as su
from music2midi_tpu_torch.ops.detokenize import detokenize_to_host
from music2midi_tpu_torch.tokenizer import MidiTokenizer

ROOT = Path(__file__).resolve().parent.parent
RECORD = ROOT / "checkpoints" / "model_of_record.npz"
YAML = ROOT / "configs" / "granite4h_small_p1.yaml"

TINY = dict(hidden_size=64, num_hidden_layers=3,
            layer_types=("mamba", "attention", "mamba"), vocab_size=500,
            prefix_dim=24, mamba_n_heads=4, mamba_d_head=16,
            mamba_d_state=16, mamba_n_groups=1, mamba_chunk_size=8,
            num_attention_heads=4, num_key_value_heads=2,
            attention_multiplier=0.25, num_local_experts=8,
            num_experts_per_tok=2, intermediate_size=32,
            shared_intermediate_size=48)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _hf(cfg: gh.HybridConfig) -> dict:
    return {**cfg._asdict(), "layer_types": list(cfg.layer_types)}


@pytest.mark.parametrize("groups", [1, 2])
def test_prefill_then_decode_matches_reference_forward(groups):
    cfg = gh.HybridConfig(**{**TINY, "mamba_n_groups": groups})
    p = gh.init_params(cfg, 123)
    model = gh.GraniteHybrid(p, cfg)
    g = torch.Generator().manual_seed(0)
    B, Lp, T = 3, 13, 9  # the prefix crosses a chunk of 8
    prefix = torch.randn(B, Lp, cfg.prefix_dim, generator=g)
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=g)
    ref.strict_fp32()
    states = []
    want = ref.forward(p, _hf(cfg), prefix, ids, states)
    st = gh.init_state(model, B, Lp + T, "cpu")
    gh.prefill(model, prefix, st)
    got = torch.stack([gh.decode_step(
        model, ids[:, t].int(), torch.tensor(Lp + t, dtype=torch.int32), st,
        Lp + T) for t in range(T)], 1)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert len(st.ssm) == len(states) == 2
    for a, b in zip(st.ssm, states):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    # bf16 weights move the logits by far more than the bar
    lowp = gh.GraniteHybrid(
        gh.init_params(cfg, 123, weight_dtype=torch.bfloat16), cfg)
    st = gh.init_state(lowp, B, Lp + T, "cpu")
    gh.prefill(lowp, prefix, st)
    moved = gh.decode_step(lowp, ids[:, 0].int(),
                           torch.tensor(Lp, dtype=torch.int32), st, Lp + T)
    assert float((moved - want[:, 0]).abs().max()) > 1e-3 * scale


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("chunk", [1, 5, 8, 21, 64])
def test_chunked_scan_matches_sequential_recurrence(chunk, groups):
    g = torch.Generator().manual_seed(chunk)
    B, L, H, P, N = 2, 21, 4, 8, 16
    x = torch.randn(B, L, H, P, generator=g)
    dt = torch.rand(B, L, H, generator=g) * 0.3
    A = -torch.rand(H, generator=g) * 4 - 0.5
    Bm = torch.randn(B, L, groups, N, generator=g)
    Cm = torch.randn(B, L, groups, N, generator=g)
    y, final = gh.ssd_chunked(x, dt, A, Bm, Cm, chunk)
    h = torch.zeros(B, H, P, N)
    ys = []
    for t in range(L):
        h, yt = ref.state_update(h, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t],
                                 torch.zeros(H))
        ys.append(yt)
    want = torch.stack(ys, 1)
    assert float((y - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert float((final - h).abs().max()) <= 1e-6 * float(h.abs().max())


def test_kernel6_plain_twin_matches_reference_step():
    g = torch.Generator().manual_seed(4)
    B, H, P, N, G = 3, 4, 16, 16, 2
    h = torch.randn(B, H, P, N, generator=g)
    x = torch.randn(B, H, P, generator=g)
    dt = torch.rand(B, H, generator=g) * 0.1
    A = -torch.rand(H, generator=g) * 10
    Bm = torch.randn(B, G, N, generator=g)
    Cm = torch.randn(B, G, N, generator=g)
    D = torch.rand(H, generator=g)
    want_h, want_y = ref.state_update(h, x, dt, A, Bm, Cm, D)
    st = h.clone()
    before = su.ssm_state_update.launches
    y = su.ssm_state_update(st, x, dt, A, Bm, Cm, D)  # a CPU tensor: plain
    assert su.ssm_state_update.launches == before
    assert float((y - want_y).abs().max()) <= 1e-6 * float(want_y.abs().max())
    assert float((st - want_h).abs().max()) <= 1e-6 * float(want_h.abs().max())
    low = h.bfloat16()
    y_low = su.ssm_state_update(low, x, dt, A, Bm, Cm, D)
    fresh = ref.state_update(h.bfloat16().float(), x, dt, A, Bm, Cm, D)
    assert torch.equal(low, fresh[0].bfloat16())
    assert float((y_low - fresh[1]).abs().max()) <= \
        1e-6 * float(fresh[1].abs().max())


@pytest.mark.parametrize("one_expert", [False, True])
def test_moe_matches_per_expert_loop(one_expert):
    cfg = gh.HybridConfig(**TINY)
    lp = gh.GraniteHybrid(gh.init_params(cfg, 9), cfg).layers[0]
    h = torch.randn(37, cfg.hidden_size, generator=torch.Generator()
                    .manual_seed(1))
    if one_expert:  # every token's first choice is expert 3
        lp["router"] = lp["router"].clone()
        lp["router"][3] += 5.0
        h = h.abs()
    tokens = torch.zeros(cfg.num_local_experts, dtype=torch.int64)
    busiest = torch.zeros((), dtype=torch.int64)
    got = gh.moe(lp, h, cfg, (tokens, busiest))
    want = ref.moe(lp, _hf(cfg), h)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert int(tokens.sum()) == 37 * cfg.num_experts_per_tok
    if one_expert:
        assert int(tokens[3]) == int(busiest) == 37


def test_the_reference_imports_nothing_of_the_port():
    path = ROOT / "music2midi_tpu_torch" / "models" / "granite_hybrid_ref.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "a relative import"
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "math", "typing", "torch", "numpy"}, names


def _tiny_yaml(tmp_path, **decoder) -> Path:
    cfg = load_config(YAML).to_dict()
    cfg["model"]["decoder"].update(
        {**{k: list(v) if isinstance(v, tuple) else v
            for k, v in TINY.items() if k != "prefix_dim"},
         "vocab_size": 1000, "seed": 3, **decoder})
    cfg["inference"]["batch_size"] = 8
    path = tmp_path / "tiny_hybrid.json"
    path.write_text(json.dumps(cfg))
    return path


def test_serve_batch_on_the_tiny_hybrid_writes_midi(tmp_path, capsys):
    from music2midi_tpu_torch import serve_batch

    rng = np.random.default_rng(2)
    songs = []
    for i, seconds in enumerate((4.0, 7.5)):
        path = tmp_path / f"song{i}.wav"
        write_wav(path, (rng.normal(size=int(16000 * seconds)) * 0.1)
                  .astype(np.float32), 16000)
        songs.append(str(path))
    out = tmp_path / "out"
    res = serve_batch.main([str(out), *songs, "--ckpt", str(RECORD),
                            "--config", str(_tiny_yaml(tmp_path)),
                            "--device", "cpu", "--dtype", "float32"])
    assert res["songs"] == 2
    assert sorted(p.name for p in out.iterdir()) == ["song0.mid",
                                                     "song1.mid"]


def test_the_hybrid_engine_decodes_through_its_program(tmp_path):
    eng = Music2MIDI.from_npz(RECORD, config=_tiny_yaml(tmp_path),
                              device="cpu", decode_max_length=20)
    assert eng.decoder is not None and eng.hybrid_config.vocab_size == 1000
    hidden = torch.randn(8, eng.encoder_len, 384,
                         generator=torch.Generator().manual_seed(0))
    dcfg = eng._dcfg()
    assert not dcfg.quantize_kv and not dcfg.pallas_attention
    a = generate_tokens(eng.decoder, hidden, eng.hybrid_config, dcfg)
    b = generate_tokens_eager(eng.decoder, hidden, eng.hybrid_config, dcfg)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[0].shape == (8, 20) and bool((a[0][:, 0] == 1).all())
    eng.kv_bits = 4
    with pytest.raises(ValueError, match="hybrid"):
        eng._dcfg()


def test_hybrid_config_block_is_checked(tmp_path):
    cfg = load_config(_tiny_yaml(tmp_path, type="other"))
    with pytest.raises(ValueError, match="granitemoehybrid"):
        gh.hybrid_config_from(cfg)
    full = gh.hybrid_config_from(load_config(YAML), dtype=torch.bfloat16)
    assert full == gh.HybridConfig(dtype=torch.bfloat16)
    n = sum(int(np.prod(s)) for _, s, _ in gh.param_shapes(full))
    assert n == 8_361_695_872  # 7.95 B in the layers, 0.41 B embedding


def test_t5_path_tokens_equal_jax_fp32():
    """The T5 decoder's path through the refactored program: fp32 tokens
    and notes of a tiny random T5 exactly the JAX engine's."""
    small = {"num_layers": 1, "num_decoder_layers": 2, "d_model": 64,
             "d_ff": 96}
    cfg, jcfg = default_config(), jax_default_config()
    for c in (cfg, jcfg):
        for k, v in small.items():
            c.model.t5[k] = v
        c.inference.batch_size = 8
    wave = (np.random.default_rng(3).normal(size=5 * 48000) * 0.1
            ).astype(np.float32)
    mine = Music2MIDI.from_random(cfg, seed=4, device="cpu",
                                  decode_max_length=80)
    assert mine.decoder is None
    theirs = JaxMusic2MIDI.from_random(jcfg, seed=4, decode_max_length=80,
                                       use_compilation_cache=False)
    np.testing.assert_array_equal(
        mine.sample_tokens_batched(mine._chunk_waveform(wave)),
        theirs.sample_tokens_batched(theirs._chunk_waveform(wave)))
    np.testing.assert_array_equal(mine.sample_notes(wave),
                                  theirs.sample_notes(wave))


def _events(rng, n):
    """A token row of notes with times, pitches and markers."""
    out = []
    for t in sorted(rng.choice(60, n, replace=False)):
        out += [133 + int(t), int(rng.choice([3, 4])),
                5 + int(rng.integers(40, 60))]
    return out


def test_ids_past_the_vocabulary_are_no_event():
    rng = np.random.default_rng(7)
    tok = MidiTokenizer(default_config())
    for _ in range(20):
        row = _events(rng, 12) + [2]
        noisy = list(row[:-1])
        for at in sorted(rng.choice(len(noisy), 8), reverse=True):
            noisy.insert(int(at), int(rng.integers(400, 100352)))
        noisy.append(2)
        clean = [t if t < 400 else 0 for t in noisy]
        for seq in (noisy, clean):
            assert len(seq) == len(noisy)
        want = tok.decode([np.array(clean)])[0]
        assert np.array_equal(tok.decode([np.array(noisy)])[0], want)
        dev = detokenize_to_host(torch.tensor([noisy]), torch.zeros(1))
        np.testing.assert_array_equal(dev[0], want)
    # ids in [333, 400) keep the reference tokenizer's time reading
    row = np.array([140, 3, 60, 350, 4, 60, 2])
    jax_tok = JaxTokenizer(jax_default_config())
    np.testing.assert_array_equal(tok.decode([row])[0],
                                  jax_tok.decode([row])[0])
    np.testing.assert_allclose(tok.decode([row])[0],
                               [[0.35, 10.85, 55.0, 80.0]])
