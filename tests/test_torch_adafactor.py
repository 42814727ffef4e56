"""The port's Adafactor against the JAX package's ``adafactor_hf``.

Fed the same parameters and gradients (numpy, seeded) for 5 steps, the
parameters must agree at ``tests/test_train.py``'s Adafactor bar (atol
2e-5, rtol 1e-4): factored leaves (ndim >= 2, the (32, 8) bias table
among them) and unfactored ones, under the relative step with and
without warm-up and under a fixed lr.  That bar is wider than what the
warm-up moves a parameter (1e-6 x step x RMS), so each step's update is
held too: the port's, read exactly off float64 parameters (a float32
update adds to them without rounding), against the update ``optax``
returns, within rtol 1e-4 and 1e-3 of the largest; and the second
moments, which only beta2_t and the gradients set, within rtol 1e-6.
The step's float32 scalars equal JAX's: the step size bit for bit,
beta2_t within one ulp (XLA's pow and libm's may round apart).  ``MultiSteps`` against ``optax.MultiSteps`` at the parameters'
bar; ``adafactor_lr_at`` equal; the moments float32 whatever the
parameter dtype, through a state_dict round trip too.

The phase form (``Adafactor.step`` over all leaves at once, its sums in
one statistics buffer): on the CPU it is the per-parameter loop it
replaced bit for bit (the loop is kept here as ``_LoopAdafactor``); a
``state_dict`` keeps each parameter's keys, shapes and float32 moments;
a state the loop saved loads and steps to the loop's parameters; a
loaded state lands in the moment buffer the state's views (and the
kernel's tables) already point at; and two gloo ranks step a row-split
and a column-split matrix as one device does, with one ``all_reduce`` a
phase.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from music2midi_tpu.train.adafactor import adafactor_hf
from music2midi_tpu.train.adafactor import adafactor_lr_at as jax_lr_at
from music2midi_tpu_torch.train.adafactor import (
    Adafactor,
    MultiSteps,
    adafactor_lr_at,
)

SHAPES = [(384, 512), (32, 8), (384,), (3, 16, 24)]
N_STEPS = 5


def _draws(seed):
    rng = np.random.default_rng(seed)
    init = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.uniform(-3, 1)).astype(
        np.float32) for s in SHAPES] for _ in range(N_STEPS)]
    return init, grads


def _jax(opt, init, grads):
    params = [jnp.asarray(x) for x in init]
    state = opt.init(params)
    for gs in grads:
        updates, state = opt.update([jnp.asarray(g) for g in gs], state,
                                    params)
        params = optax.apply_updates(params, updates)
    return [np.asarray(p) for p in params]


def _jax_steps(opt, init, grads):
    """Each step's (updates, moments) as optax gives them."""
    params = [jnp.asarray(x) for x in init]
    state = opt.init(params)
    out = []
    for gs in grads:
        updates, state = opt.update([jnp.asarray(g) for g in gs], state,
                                    params)
        params = optax.apply_updates(params, updates)
        moments = [[np.asarray(m.row), np.asarray(m.col)]
                   if hasattr(m, "row") else [np.asarray(m)]
                   for m in state.moments]
        out.append(([np.asarray(u) for u in updates], moments))
    return out


def _port_steps(opt_fn, init, grads):
    """Each step's (updates, moments) of the port: float64 parameters, so
    that the new value minus the old one is the float32 update exactly."""
    params = [torch.nn.Parameter(torch.from_numpy(x.astype(np.float64)))
              for x in init]
    opt = opt_fn(params)
    out = []
    for gs in grads:
        before = [p.detach().clone() for p in params]
        for p, g in zip(params, gs):
            p.grad = torch.from_numpy(g.astype(np.float64))
        opt.step()
        moments = [[opt.state[p][k].numpy().copy() for k in ("row", "col", "v")
                    if k in opt.state[p]] for p in params]
        out.append(([(p.detach() - b).numpy()
                     for p, b in zip(params, before)], moments))
    return out


def _port(opt_fn, init, grads):
    params = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in init]
    opt = opt_fn(params)
    for gs in grads:
        opt.zero_grad(set_to_none=True)
        for p, g in zip(params, gs):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
    return [p.detach().numpy() for p in params], opt


@pytest.mark.parametrize("lr, warmup_init", [(None, True), (None, False),
                                             (0.05, False)])
def test_updates_match_adafactor_hf(lr, warmup_init):
    init, grads = _draws(0)
    want = _jax(adafactor_hf(learning_rate=lr, warmup_init=warmup_init),
                init, grads)
    got, opt = _port(lambda ps: Adafactor(ps, lr=lr,
                                          warmup_init=warmup_init),
                     init, grads)
    for g, w, x in zip(got, want, init):
        assert not np.array_equal(w, x)  # the step moved it
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=1e-4)
    st = list(opt.state.values())
    assert [sorted(k for k in s if k != "step") for s in st] == [
        ["col", "row"], ["col", "row"], ["v"], ["col", "row"]]
    assert {s["step"] for s in st} == {N_STEPS}
    steps = zip(_port_steps(lambda ps: Adafactor(
        ps, lr=lr, warmup_init=warmup_init), init, grads),
        _jax_steps(adafactor_hf(learning_rate=lr, warmup_init=warmup_init),
                   init, grads))
    for k, ((upd, mom), (want_upd, want_mom)) in enumerate(steps, 1):
        for i, (u, w) in enumerate(zip(upd, want_upd)):
            assert np.abs(w).max() > 0
            np.testing.assert_allclose(
                u, w, rtol=1e-4, atol=1e-3 * np.abs(w).max(),
                err_msg=f"step {k}, leaf {i}: update")
        for i, (m, w) in enumerate(zip(mom, want_mom)):
            for a, b in zip(m, w):
                np.testing.assert_allclose(
                    a, b, rtol=1e-6, atol=0,
                    err_msg=f"step {k}, leaf {i}: second moment")


@pytest.mark.parametrize("lr, warmup_init", [(None, True), (None, False),
                                             (0.05, False)])
def test_step_scalars_match_jax(lr, warmup_init):
    """``Adafactor._scalars`` against the float32 arithmetic of
    ``adafactor_hf.update_fn`` (beta2_t = 1 - step^-0.8; the relative step
    min(1e-6 * step or 1e-2, rsqrt(step)), or the fixed lr): beta2_t
    within one float32 ulp, 1 - beta2_t its exact complement, the step
    size bit for bit, over steps 1-5 and far into the warm-up."""
    group = {"lr": lr, "warmup_init": warmup_init}

    @jax.jit
    def want(step):
        step_f = step.astype(jnp.float32)
        beta2t = 1.0 - jnp.power(step_f, -0.8)
        if lr is None:
            min_step = 1e-6 * step_f if warmup_init else jnp.float32(1e-2)
            rel = jnp.minimum(min_step, jax.lax.rsqrt(step_f))
        else:
            rel = jnp.float32(lr)
        return beta2t, 1 - beta2t, rel

    for step in (1, 2, 3, 4, 5, 3000, 10_000, 4_000_000):
        got = np.array(Adafactor._scalars(step, group), np.float32)
        ref = np.array([np.asarray(x) for x in want(jnp.int32(step))])
        # float32 values (their float64 view is exact); within one ulp,
        # as XLA's pow and libm's powf may round step^-0.8 apart
        assert np.array_equal(got.astype(np.float64),
                              np.array(Adafactor._scalars(step, group)))
        np.testing.assert_array_max_ulp(got[0], ref[0], maxulp=1)
        for b2, one_minus in (got[:2], ref[:2]):
            assert one_minus == np.float32(1) - b2  # exact in float32
        assert got[2] == ref[2], (step, got, ref)  # the step size exactly


def test_multisteps_matches_optax():
    init, grads = _draws(1)
    want = _jax(optax.MultiSteps(adafactor_hf(learning_rate=0.05,
                                              warmup_init=False),
                                 every_k_schedule=2), init, grads[:4])
    got, opt = _port(lambda ps: MultiSteps(
        Adafactor(ps, lr=0.05, warmup_init=False), 2), init, grads[:4])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=1e-4)
    assert opt.mini_step == 0
    assert {s["step"] for s in opt.inner.state.values()} == {2}


def test_lr_schedule_matches_jax():
    for step in (0, 1, 7, 10_000, 4_000_000):
        for warmup in (True, False):
            assert adafactor_lr_at(step, warmup) == jax_lr_at(step, warmup)


def test_moments_stay_float32_for_bf16_params():
    p = torch.nn.Parameter(torch.randn(16, 8).bfloat16())
    v = torch.nn.Parameter(torch.randn(8).bfloat16())
    opt = Adafactor([p, v])
    p.grad, v.grad = torch.randn_like(p), torch.randn_like(v)
    opt.step()
    assert p.dtype == torch.bfloat16
    moments = [t for s in opt.state.values() for k, t in s.items()
               if k != "step"]
    assert moments and all(t.dtype == torch.float32 for t in moments)
    saved = opt.state_dict()
    again = Adafactor([p, v])
    again.load_state_dict(saved)
    for a, b in zip(opt.state.values(), again.state.values()):
        assert a["step"] == b["step"]
        for k in ("row", "col", "v"):
            if k in a:
                assert b[k].dtype == torch.float32
                assert torch.equal(a[k], b[k])


# --------------------------------------------------------------------- #
# the phase form: state, checkpoints, tensor parallelism, the kernel's  #
# tables                                                                #
# --------------------------------------------------------------------- #


class _LoopAdafactor(torch.optim.Optimizer):
    """The per-parameter loop that ``Adafactor.step`` was before its phase
    form (no tensor parallelism), kept as the reference of the arithmetic
    and of the checkpoints it wrote: each moment its own tensor."""

    def __init__(self, params, lr=None, warmup_init=True):
        super().__init__(list(params), dict(lr=lr, warmup_init=warmup_init))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    if p.ndim >= 2:
                        st["row"] = torch.zeros(p.shape[:-1])
                        st["col"] = torch.zeros(p.shape[:-2] + p.shape[-1:])
                    else:
                        st["v"] = torch.zeros(p.shape)
                st["step"] += 1
                beta2t, one_minus, rel = Adafactor._scalars(st["step"], group)
                g = p.grad.float()
                lr = p.float().square().mean().sqrt().clamp(min=1e-3) * rel
                sq = g.square() + 1e-30
                if p.ndim >= 2:
                    row = st["row"].mul_(beta2t).add_(sq.mean(-1),
                                                      alpha=one_minus)
                    col = st["col"].mul_(beta2t).add_(sq.mean(-2),
                                                      alpha=one_minus)
                    r = torch.rsqrt(row / row.mean(-1, keepdim=True))[
                        ..., None]
                    upd = r * torch.rsqrt(col)[..., None, :] * g
                else:
                    v = st["v"].mul_(beta2t).add_(sq, alpha=one_minus)
                    upd = torch.rsqrt(v) * g
                upd = upd / (upd.square().mean().sqrt() / 1.0).clamp(min=1.0)
                p.add_((-(upd * lr)).to(p.dtype))


def _params(init):
    return [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in init]


def _step(opt, params, gs):
    for p, g in zip(params, gs):
        p.grad = torch.from_numpy(g.copy())
    opt.step()


def _saved(opt) -> dict:
    """``opt.state_dict()`` through ``torch.save`` and back, as a
    checkpoint holds it."""
    import io

    buf = io.BytesIO()
    torch.save(opt.state_dict(), buf)
    buf.seek(0)
    return torch.load(buf, weights_only=True)


@pytest.mark.parametrize("lr, warmup_init", [(None, True), (0.05, False)])
def test_phase_form_is_the_loop_bit_for_bit(lr, warmup_init):
    """On the CPU the phase form does the per-parameter loop's arithmetic
    op for op (a mean is PyTorch's sum over the count there), so five
    steps give the loop's parameters and moments bit for bit."""
    init, grads = _draws(2)
    a, b = _params(init), _params(init)
    loop = _LoopAdafactor(a, lr=lr, warmup_init=warmup_init)
    opt = Adafactor(b, lr=lr, warmup_init=warmup_init)
    for gs in grads:
        _step(loop, a, gs)
        _step(opt, b, gs)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
        for k in ("row", "col", "v"):
            if k in loop.state[x]:
                assert torch.equal(loop.state[x][k], opt.state[y][k])


def test_state_dict_round_trip_keeps_keys_shapes_and_fp32():
    init, grads = _draws(3)
    params = _params(init)
    opt = Adafactor(params)
    for gs in grads[:2]:
        _step(opt, params, gs)
    saved = _saved(opt)
    want = {0: {"row": (384,), "col": (512,)}, 1: {"row": (32,), "col": (8,)},
            2: {"v": (384,)}, 3: {"row": (3, 16), "col": (3, 24)}}
    for i, st in saved["state"].items():
        assert sorted(st) == sorted(["step", *want[i]])
        assert st["step"] == 2
        for k, shape in want[i].items():
            assert tuple(st[k].shape) == shape
            assert st[k].dtype == torch.float32
    again = Adafactor(_params(init))
    again.load_state_dict(saved)
    for i, (x, y) in enumerate(zip(params, again.param_groups[0]["params"])):
        for k in want[i]:
            got = again.state[y][k]
            assert got.dtype == torch.float32 and tuple(got.shape) == \
                want[i][k]
            assert torch.equal(got, opt.state[x][k])


def test_a_checkpoint_of_the_loop_loads_and_steps_alike():
    """A state the per-parameter loop saved (a tensor a moment) loads into
    the phase form, whose next steps give the loop's parameters."""
    init, grads = _draws(4)
    a = _params(init)
    loop = _LoopAdafactor(a)
    for gs in grads[:3]:
        _step(loop, a, gs)
    b = _params([x.detach().numpy() for x in a])
    opt = Adafactor(b)
    opt.load_state_dict(_saved(loop))
    for gs in grads[3:]:
        _step(loop, a, gs)
        _step(opt, b, gs)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert {s["step"] for s in opt.state.values()} == {N_STEPS}
    bad = _saved(loop)
    bad["state"][0]["row"] = torch.zeros(7)
    with pytest.raises(ValueError, match="moment 'row'"):
        Adafactor(_params(init)).load_state_dict(bad)


def test_the_next_step_reads_the_loaded_moments():
    """``load_state_dict`` copies into the moment buffer that the state's
    views (and so the kernel's table) point at: an optimizer that has
    stepped, then loads another's state, keeps its views' addresses, holds
    the loaded values there, and steps as the other does."""
    init, grads = _draws(5)
    a, b = _params(init), _params(init)
    opt_a, opt_b = Adafactor(a), Adafactor(b)
    _step(opt_b, b, grads[4])  # a plan and views of its own first
    def addresses(opt, params):
        return [t.data_ptr() for p in params
                for k, t in sorted(opt.state[p].items()) if k != "step"]

    views = addresses(opt_b, b)
    for gs in grads[:3]:
        _step(opt_a, a, gs)
    with torch.no_grad():
        for x, y in zip(a, b):
            y.copy_(x)
    opt_b.load_state_dict(_saved(opt_a))
    assert addresses(opt_b, b) == views
    for x, y in zip(a, b):
        for k, t in opt_b.state[y].items():
            if k != "step":
                assert torch.equal(t, opt_a.state[x][k])
    _step(opt_a, a, grads[3])
    _step(opt_b, b, grads[3])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_tensor_parallel_step_updates_each_slice_as_one_device(tmp_path):
    """Two gloo ranks (``tests/_adafactor_tp_child.py``) step a
    row-split, a column-split and two replicated leaves three times: each
    rank's slices of the parameters' changes within rtol 1e-5 of the
    one-device step's, its moments within rtol 1e-6 (the all-reduced sums
    add the ranks' halves in another order), and each step makes exactly
    three ``all_reduce`` calls, one a phase."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    import _adafactor_tp_child as child

    root = Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": str(root), "OMP_NUM_THREADS": "1"}
    init_file, world = tmp_path / "init", 2
    procs = [subprocess.Popen(
        [sys.executable, str(Path(child.__file__)), str(r), str(world),
         str(init_file), str(tmp_path / f"rank{r}.pt")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
    init, grads = child.draws()
    full = _params(init)
    opt = Adafactor(full, lr=child.LR, warmup_init=False)
    for gs in grads:
        _step(opt, full, gs)
    for r in range(world):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
        assert got["calls"] == [3] * child.N_STEPS
        for i, d in enumerate(child.SPLITS):
            def mine(x):
                return child.local(np.asarray(x), d, r, world)
            np.testing.assert_allclose(
                got["params"][i].numpy() - mine(init[i]),
                mine(full[i].detach().numpy()) - mine(init[i]),
                rtol=1e-5, atol=1e-6 * np.abs(init[i]).max())
            for k, m in got["moments"][i].items():
                want = opt.state[full[i]][k].numpy()
                if (d, k) in ((0, "row"), (1, "col")):
                    want = child.local(want, 0, r, world)
                np.testing.assert_allclose(m.numpy(), want, rtol=1e-6,
                                           atol=0)
