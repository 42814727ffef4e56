"""The hybrid decoder's cell (``granite4h-small-p1.catalogue``) on the CPU:
its pieces are found by files alone; its configuration agrees with itself
and with the program's port config; the benchmark's copy of the
reference agrees with the program's reference on a tiny configuration
(weights drawn alike from one seed, the same logits and final states),
and its first Mamba layer's state alone is the whole pass's;
each new metric reads a synthetic run, worked by hand, and finds nothing
where the run gave it nothing; and the harness runs the cell end to end
at a tiny decoder size: correct, its control reading a larger state gap,
and not correct with the serving path broken, once for each fault.""" 

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.frozen import hybrid_counts as hc
from benchmark.reference import granite_hybrid as href
from benchmark.run import run_cell
from music2midi_tpu_torch import profiling

ROOT = Path(__file__).resolve().parents[2]
CELL = "granite4h-small-p1.catalogue"
NEW = ["kernel.ssm_state_update_roofline", "moe.expert_load_max_over_mean",
       "hybrid.prefill_share", "mfu.granite4h"]
TINY = dict(hidden_size=64, num_hidden_layers=3,
            layer_types=["mamba", "attention", "mamba"], vocab_size=500,
            mamba_n_heads=4, mamba_d_head=16, mamba_d_state=16,
            mamba_chunk_size=64, num_attention_heads=4, num_key_value_heads=2,
            num_local_experts=8, num_experts_per_tok=2, intermediate_size=32,
            shared_intermediate_size=48)


def test_the_cell_is_found_by_files_alone():
    cell = spec.find_cell(ROOT, CELL)
    assert [m.name for m in cell.end_to_end] == ["songs_per_min", "setup_s"]
    assert [m.name for m in cell.per_layer] == NEW
    assert cell.traffic["kind"] == "songs_closed_loop_hybrid"
    assert spec.load("kinds", cell.traffic["kind"]).run
    assert spec.load("profiles", cell.traffic["profile"]).render
    for name in NEW:
        assert callable(spec.metric_reader(name))


def test_the_configuration_agrees_with_itself():
    c = spec.find_cell(ROOT, CELL).config
    block = dict(c["port_config"]["model"]["decoder"])
    assert block.pop("type") == "granitemoehybrid"
    assert block.pop("state_dtype") == c["serving"]["state_dtype"]
    block.pop("seed")
    assert block == c["model"]
    for key, value in c["model"].items():  # the published numbers
        if key in c and key not in ("layer_types",):
            assert c[key] == value, key
    assert c["model"]["layer_types"] == c["layer_types"][:10]
    assert c["num_hidden_layers"] == 10 and len(c["layer_types"]) == 40
    assert c["parameters"] == sum(c["parameters_split"].values())
    assert c["control"]["serving"]["state_dtype"] == "bfloat16"


def _cfg(**extra):
    return {**TINY, "vocab_size": 500, "prefix_dim": 24,
            "attention_multiplier": 0.25, "embedding_multiplier": 12.0,
            "residual_multiplier": 0.22, "logits_scaling": 16.0,
            "rms_norm_eps": 1e-5, "mamba_n_groups": 1, "mamba_d_conv": 4,
            **extra}


@pytest.mark.parametrize("weight_dtype", [torch.float32, torch.bfloat16])
def test_the_two_reference_copies_agree(weight_dtype):
    from music2midi_tpu_torch.models import granite_hybrid as gh
    from music2midi_tpu_torch.models import granite_hybrid_ref as pref

    cfg = _cfg()
    hcfg = gh.HybridConfig(**{**cfg, "layer_types": tuple(cfg["layer_types"])})
    p = {k: v.float() for k, v in
         gh.init_params(hcfg, 77, weight_dtype=weight_dtype).items()}
    g = torch.Generator().manual_seed(2)
    prefix = torch.randn(2, 7, 24, generator=g)
    ids = torch.randint(0, 500, (2, 6), generator=g)
    served = [ids[0, 1:], ids[1, 1:4]]
    states = []
    want = pref.forward(p, cfg, prefix, ids, states)
    gaps, got_states = href.teacher_forced(cfg, 77, weight_dtype, prefix,
                                           ids, served)
    for r, nxt in enumerate(served):
        logits = want[r, :len(nxt)]
        wgap = logits.max(1).values - logits.gather(1, nxt[:, None])[:, 0]
        assert torch.allclose(gaps[r], wgap, atol=1e-6)
    for a, b in zip(got_states, states):
        assert torch.allclose(a, b, atol=1e-6 * float(b.abs().max()))


@pytest.mark.parametrize("layer_types", [["mamba", "attention", "mamba"],
                                         ["attention", "mamba", "mamba"]])
def test_the_first_mamba_state_is_the_teacher_forced_one(layer_types):
    """``first_mamba_state`` (the state gap's reference, over every row of a
    call) is ``teacher_forced``'s first Mamba state on the heads asked,
    whether or not a layer runs before that one."""
    cfg = _cfg(layer_types=layer_types)
    g = torch.Generator().manual_seed(4)
    prefix = torch.randn(3, 7, 24, generator=g)
    ids = torch.randint(0, 500, (3, 6), generator=g)
    _, states = href.teacher_forced(cfg, 91, torch.bfloat16, prefix, ids,
                                    [ids[0, 1:]])
    heads = torch.tensor([3, 1])
    got = href.first_mamba_state(cfg, 91, torch.bfloat16, prefix, ids, heads,
                                 rows_at_once=2)
    want = states[0][:, heads]
    assert torch.allclose(got, want, atol=1e-6 * float(want.abs().max()))


def _span(sid, name, t0, t1, parent=None, **attrs):
    return {"name": name, "id": sid, "parent": parent, "thread": "t",
            "t0_ns": int(t0 * 1000), "t1_ns": int(t1 * 1000),
            "attrs": attrs}


SPANS = [_span(1, "generate_batch", 0, 100),
         _span(2, "batch", 0, 80, 1, k=0),
         _span(3, "decode", 10, 78, 2, steps=100, syncs=100, replays=99,
               captures=0, ssm_layers=2, state_bytes_per_step=8,
               routed_per_layer_step=16, expert_tokens=[400, 0] + [200] * 6,
               expert_max_sum=1500, moe_layer_steps=300),
         _span(4, "prefill", 11, 31, 3, rows=8, positions=190)]
MODEL = {**_cfg(), "prefix_dim": 24}


def _ctx(on_card=True, events=(), calls=()):
    return {"on_card": on_card, "model": MODEL, "enc_len": 190,
            "window_s": 2.0, "peak_flops": 1e12,
            "calls": [{"stats": [{"batch_width": 8, "steps": 100,
                                  "row_steps": [100, 50]}]}],
            "trace": {"slice": SimpleNamespace(events=list(events),
                                               window=(0.0, 1e6)),
                      "calls": list(calls)}}


def test_each_new_metric_by_hand(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: SPANS)
    # 1500 busiest over 300 layer steps, against a mean of 16 / 8
    assert spec.metric_reader("moe.expert_load_max_over_mean")(_ctx()) \
        == pytest.approx(1500 / 300 / 2)
    assert spec.metric_reader("hybrid.prefill_share")(_ctx()) \
        == pytest.approx(100.0 * 20 / 80)
    flops = hc.row_flops(MODEL, 190, 100) + hc.row_flops(MODEL, 190, 50)
    assert spec.metric_reader("mfu.granite4h")(_ctx()) \
        == pytest.approx(100.0 * flops / 2.0 / 1e12)
    # two launches of kernel 6 in the window: 60 us of device time
    events = [{"name": "void ssm_state_update_kernel<float>", "cat": "device",
               "ts": 10.0 + 100 * i, "dur": 30.0, "corr": i}
              for i in range(2)] + \
        [{"name": "cudaLaunchKernel", "cat": "runtime", "ts": 5.0 + 100 * i,
          "dur": 1.0, "corr": i} for i in range(2)]
    calls = [{"stats": [{"batch_width": 8, "steps": 1}]}]
    want = 100.0 * hc.state_update_bound_s(MODEL, 8, 1) / 60e-6
    got = spec.metric_reader("kernel.ssm_state_update_roofline")(
        _ctx(events=events, calls=calls))
    assert got == pytest.approx(want)
    # the bound by hand: 2 Mamba layers, 8 rows of a 4 x 16 x 16 state
    assert hc.state_update_bytes(MODEL, 8) == 8 * (2 * 1024 * 4 + 2 * 64 * 4
                                                   + 16 + 2 * 16 * 4) + 32


@pytest.mark.parametrize("name", NEW)
def test_each_new_metric_finds_nothing_to_read(monkeypatch, name):
    read = spec.metric_reader(name)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(_ctx(on_card=False)) is None
    if name != "mfu.granite4h":
        assert read(_ctx()) is None
        assert read({**_ctx(), "trace": None}) is None
        monkeypatch.delattr(profiling, "spans")  # a program without spans
        assert read(_ctx()) is None


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The benchmark with the hybrid's decoder cut to TINY, two short
    songs and a 24-token cap (CPU time); everything else as it is."""
    tmp = tmp_path_factory.mktemp("bench")
    pkg = tmp / "benchmark"
    shutil.copytree(ROOT / "benchmark", pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    f = pkg / "traffic" / "catalogue2-fullmix.json"
    f.write_text(json.dumps({**json.loads(f.read_text()),
                             "seconds_min": 6.0, "seconds_max": 9.0}))
    f = pkg / "configs" / "granite4h-small-p1.json"
    cfg = json.loads(f.read_text())
    cfg["checkpoint"]["path"] = str(ROOT / cfg["checkpoint"]["path"])
    cfg["serving"]["decode_max_length"] = 24
    cfg["model"].update(TINY)
    cfg["port_config"]["model"]["decoder"].update(TINY)
    cfg["port_config"]["inference"]["batch_size"] = 8
    f.write_text(json.dumps(cfg))
    return tmp


def _run(tree, override=None):
    cell = spec.find_cell(tree, CELL, tree / "benchmark")
    return run_cell(tree, cell, 2 ** 31 + 5, 0.5, False,
                    torch.device("cpu"), override)


@pytest.fixture(scope="module")
def sound(tree):
    return _run(tree)


def test_the_harness_runs_the_cell_and_its_control(tree, sound):
    """A sound run is correct under the card's limits; the control (the
    state in bfloat16) reads a state gap many times the sound one's."""
    checks = sound["checks"]
    assert sound["correct"], checks
    assert sound["attempted"] >= 2 and sound["failed"] == 0
    assert set(sound["metrics"]) == {"songs_per_min", "setup_s"}
    control = _run(tree, {"state_dtype": "bfloat16"})
    assert control["checks"]["state_gap"]["value"] > \
        3 * checks["state_gap"]["value"]


def _alter_token(monkeypatch):
    from music2midi_tpu_torch.infer import pipeline

    real = pipeline.generate_tokens

    def altered(*a, **kw):
        tokens, lengths = real(*a, **kw)
        tokens = tokens.clone()
        tokens[:, 1] = torch.where(tokens[:, 1] == 2, 3, tokens[:, 1] + 1)
        return tokens, lengths

    monkeypatch.setattr(pipeline, "generate_tokens", altered)


def _alter_answer(monkeypatch):
    from music2midi_tpu_torch.infer import pipeline

    real = pipeline.detokenize_to_host

    def altered(*a, **kw):
        return [np.concatenate([r, [[0.0, 0.05, 60, 80]]])
                for r in real(*a, **kw)]

    monkeypatch.setattr(pipeline, "detokenize_to_host", altered)


def _drift_state(monkeypatch):
    from music2midi_tpu_torch.models import granite_hybrid as gh

    real = gh.ssm_state_update

    def drifted(state, x, dt, A, *rest):
        return real(state, x, dt, 2.0 * A, *rest)

    monkeypatch.setattr(gh, "ssm_state_update", drifted)


FAULTS = {"token_altered": _alter_token, "answer_altered": _alter_answer,
          "state_drifted": _drift_state}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_serving_path_is_not_correct(tree, sound, fault,
                                              monkeypatch):
    """Not correct, by a number the fault moves far past the sound run's:
    a served token changed (the reference sees it, the program's state
    did not), an answer given a note its tokens do not hold, the state
    decayed twice a step."""
    FAULTS[fault](monkeypatch)
    out = _run(tree)
    assert not out["correct"], out["checks"]
    assert any(c["value"] > max(c["limit"], 3 * sound["checks"][k]["value"])
               for k, c in out["checks"].items()), out["checks"]
