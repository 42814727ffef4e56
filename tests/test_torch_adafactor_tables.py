"""The multi-tensor Adafactor kernel's tables (``csrc/adafactor.cu``),
checked on the CPU, where the kernel cannot run.

``kernel_tables`` cuts each leaf into the kernel's tiles and places its
partial sums in scratch and its statistics in ``_Layout``'s buffer.  A
numpy model of the kernel's four phases, reading nothing but those
tables (a tile's leaf, its rows and columns, the offsets), steps leaves
of ragged shapes three times: every element lies in exactly one tile,
every scratch slot is written once a pass, and the parameters and moments
agree with the plain version's at every step (moments within rtol 1e-6;
each step's parameter change, from the plain version's parameters,
within rtol 1e-5 beside an ulp of the parameter, where the two round
p + step apart: the model sums in the kernel's order, the plain version
in PyTorch's).  The ctypes
structures are held against the C declarations, field for field."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from music2midi_tpu_torch.train import adafactor as ad

SHAPES = [(130, 260), (32, 8), (3, 384), (384,), (200,), (1, 5), (65, 129)]
N_STEPS = 3
F32 = np.float32


def _model_step(table, tile_leaf, n_scratch, stats_size, p, g, mom,
                scalars):
    """One step of the kernel's phases in numpy float32, through the
    tables alone; ``p`` and ``mom`` (each leaf's "row" and "col", or "v",
    flat) are updated in place."""
    b2, om, rel = (F32(x) for x in scalars)
    stats = np.zeros(stats_size, F32)
    n_tiles = len(tile_leaf)
    seen = [np.zeros(e.rows * e.cols, int) for e in table]

    def tiles():
        for t in range(n_tiles):
            li = int(tile_leaf[t])
            e = table[li]
            lt = t - e.first_tile
            rt, ct = divmod(lt, e.col_tiles)
            r = np.arange(rt * ad.TILE_ROWS, min((rt + 1) * ad.TILE_ROWS,
                                                  e.rows))
            c = np.arange(ct * ad.TILE_COLS, min((ct + 1) * ad.TILE_COLS,
                                                  e.cols))
            yield li, e, lt, rt, ct, r, c, (r[:, None] * e.cols + c).ravel()

    def fold(scratch, written):
        for li, e in enumerate(table):
            assert (written[e.part:e.part + e.n_tiles] == 1).all()
            yield li, e, F32(scratch[e.part:e.part + e.n_tiles].sum(
                dtype=F32))

    def update(li, e, idx):
        gv = g[li][idx]
        if e.col is None:
            return F32(1) / np.sqrt(mom[li]["v"][idx]) * gv
        rows, cols = idx // e.cols, idx % e.cols
        rmean = stats[e.rfac] / F32(e.rows_all)
        rf = F32(1) / np.sqrt(mom[li]["row"][rows] / rmean)
        return rf * (F32(1) / np.sqrt(mom[li]["col"][cols])) * gv

    # phase 0: sums of p^2, row and column partials of g^2 + eps1; v
    scratch, written = np.zeros(n_scratch, F32), np.zeros(n_scratch, int)
    for li, e, lt, rt, ct, r, c, idx in tiles():
        seen[li][idx] += 1
        scratch[e.part + lt] = (p[li][idx] * p[li][idx]).sum(dtype=F32)
        written[e.part + lt] += 1
        sq = (g[li][idx] * g[li][idx] + F32(1e-30)).reshape(len(r), len(c))
        if e.col is None:
            mom[li]["v"][idx] = om * sq.ravel() + mom[li]["v"][idx] * b2
            continue
        at = e.row_part + ct * e.rows + r
        scratch[at], written[at] = sq.sum(1, dtype=F32), written[at] + 1
        at = e.col_part + rt * e.cols + c
        scratch[at], written[at] = sq.sum(0, dtype=F32), written[at] + 1
    assert (written == 1).all()  # every slot once: no two tiles collide
    for li, e, total in fold(scratch, written):
        stats[e.psq] = total
        if e.col is not None:
            rt_n = e.n_tiles // e.col_tiles
            stats[e.row_sum:e.row_sum + e.rows] = scratch[
                e.row_part:e.row_part + e.rows * e.col_tiles].reshape(
                e.col_tiles, e.rows).sum(0, dtype=F32)
            stats[e.col_sum:e.col_sum + e.cols] = scratch[
                e.col_part:e.col_part + e.cols * rt_n].reshape(
                rt_n, e.cols).sum(0, dtype=F32)
    for s in seen:
        assert (s == 1).all()  # every element in exactly one tile
    # phase 1: the factored moments, the row factor's sum
    for li, e in enumerate(table):
        if e.col is not None:
            row, col = mom[li]["row"], mom[li]["col"]
            row[:] = om * (stats[e.row_sum:e.row_sum + e.rows]
                           / F32(e.cols_all)) + row * b2
            col[:] = om * (stats[e.col_sum:e.col_sum + e.cols]
                           / F32(e.rows_all)) + col * b2
            stats[e.rfac] = row.sum(dtype=F32)
    # phase 2: sum upd^2
    scratch, written = np.zeros(n_scratch, F32), np.zeros(n_scratch, int)
    for li, e, lt, rt, ct, r, c, idx in tiles():
        u = update(li, e, idx)
        scratch[e.part + lt] = (u * u).sum(dtype=F32)
        written[e.part + lt] += 1
    for li, e, total in fold(scratch, written):
        stats[e.usq] = total
    # phase 3: the step
    for li, e, lt, rt, ct, r, c, idx in tiles():
        lr = np.maximum(np.sqrt(stats[e.psq] / F32(e.n_all)), F32(1e-3)) * rel
        scale = np.maximum(np.sqrt(stats[e.usq] / F32(e.n_all)) / F32(1.0),
                           F32(1.0))
        p[li][idx] = p[li][idx] - (update(li, e, idx) / scale) * lr


@pytest.mark.parametrize("lr, warmup_init", [(None, True), (0.05, False)])
def test_the_kernels_tables_step_as_the_plain_version(lr, warmup_init):
    rng = np.random.default_rng(0)
    init = [rng.normal(size=s).astype(F32) for s in SHAPES]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.uniform(-3, 1)).astype(F32)
              for s in SHAPES] for _ in range(N_STEPS)]
    params = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in init]
    opt = ad.Adafactor(params, lr=lr, warmup_init=warmup_init)
    layout = ad._Layout([p.shape for p in params], [None] * len(params), 1)
    moments = [{k: torch.zeros(s) for k, s in ad._moment_shapes(p.shape)
                .items()} for p in params]
    table, tile_leaf, n_scratch = ad.kernel_tables(params, moments, layout)
    assert len(tile_leaf) == sum(
        -(-(s[0] if len(s) == 2 else 1) // ad.TILE_ROWS)
        * -(-s[-1] // ad.TILE_COLS) for s in SHAPES)
    mom = [{k: np.zeros(int(np.prod(s)), F32) for k, s in
            ad._moment_shapes(torch.Size(x.shape)).items()} for x in init]
    for k, gs in enumerate(grads, 1):
        before = [x.detach().numpy().ravel().copy() for x in params]
        p = [b.copy() for b in before]
        for x, g in zip(params, gs):
            x.grad = torch.from_numpy(g.copy())
        opt.step()
        _model_step(table, tile_leaf, n_scratch, layout.size, p,
                    [g.ravel() for g in gs], mom,
                    ad.Adafactor._scalars(k, opt.param_groups[0]))
        for i, x in enumerate(params):
            after = x.detach().numpy().ravel()
            excess = np.abs(p[i] - after) - (
                1e-5 * np.abs(after - before[i])
                + np.spacing(np.maximum(np.abs(before[i]), np.abs(after))))
            assert excess.max() <= 0, (f"step {k}, leaf {i}: change off "
                                       f"by {excess.max()}")
            for key, m in mom[i].items():
                np.testing.assert_allclose(
                    m, opt.state[x][key].numpy().ravel(), rtol=1e-6, atol=0,
                    err_msg=f"step {k}, leaf {i}: {key}")


def _fields(text: str, struct: str) -> list:
    body = re.search(r"struct %s \{(.*?)\};" % struct, text, re.S)[1]
    out = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        kind = ("ptr" if "*" in decl else "i64" if "int64_t" in decl
                else "f32" if "float" in decl else "i32")
        names = re.sub(r"\b(const|unsigned|float|int64_t|int|AdafactorLeaf)\b"
                       r"|\*", " ", decl)
        for name in names.split(","):
            name = name.strip()
            array = re.fullmatch(r"(\w+)\[kMaxLeaves\]", name)
            out.append((array[1] if array else name,
                        kind + ("[]" if array else "")))
    return out


def test_ctypes_structures_match_the_cuda_source():
    import ctypes

    src = (Path(ad.__file__).resolve().parent.parent / "csrc"
           / "adafactor.cu").read_text()
    src = re.sub(r"//[^\n]*", "", src)
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int64: "i64",
             ctypes.c_float: "f32", ctypes.c_int: "i32"}
    for struct, cls in (("AdafactorLeaf", ad._LeafRow),
                        ("AdafactorArgs", ad._Args)):
        want = []
        for name, t in cls._fields_:
            if issubclass(t, ctypes.Array):
                assert t._length_ == ad.MAX_LEAVES
                want.append((name, kinds[t._type_] + "[]"))
            else:
                want.append((name, kinds[t]))
        assert _fields(src, struct) == want, struct
    assert re.search(r"kMaxLeaves = (\d+);", src)[1] == str(ad.MAX_LEAVES)
    assert re.search(r"kTileRows = (\d+);", src)[1] == str(ad.TILE_ROWS)
    assert re.search(r"kTileCols = (\d+);", src)[1] == str(ad.TILE_COLS)
    assert ctypes.sizeof(ad._Args) <= 4096  # a kernel's parameter space


def test_a_plan_cuts_launches_at_max_leaves_and_where_the_step_changes(
        monkeypatch):
    """The kernel's launches take at most MAX_LEAVES leaves (here 2) of
    one step's scalars: leaf 2, stepped once more than the rest, gets a
    launch of its own; the plan is kept while the leaves stay."""
    monkeypatch.setattr(ad, "MAX_LEAVES", 2)
    params = [torch.nn.Parameter(torch.ones(4, 3)) for _ in range(5)]
    opt = ad.Adafactor(params)
    params[2].grad = torch.ones(4, 3)
    opt.step()
    for p in params:
        p.grad = torch.ones(4, 3)
    opt.step()
    (key, plan), = opt._plans.values()
    assert key[1] == (0, 2, 3)
    opt.step()
    assert opt._plans[torch.device("cpu")] == (key, plan)
