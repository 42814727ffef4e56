"""The port imports nothing the card's machine lacks.

That machine has PyTorch with CUDA, numpy, scipy and einops, and no JAX,
no ml_dtypes, no yaml, no pandas, no sklearn and no matplotlib; and the
JAX package itself needs yaml at import (``music2midi_tpu/config.py``).
Checks:

  * an AST scan of every module of ``music2midi_tpu_torch`` and of
    ``chip_smoke.py`` finds no import of those packages or of
    ``music2midi_tpu``, and imports matplotlib, yt-dlp and FluidSynth only
    inside the functions that use them;
  * a subprocess in which importing any of them raises imports every port
    module (``bench``, ``profiling``, ``models.convert``, the training
    modules, the train CLI, and the serving entry points ``evaluate``,
    ``serve_batch``, ``webui`` and ``serve``) and ``chip_smoke``, runs the
    calibration fixture through ``Music2MIDI.from_npz(model_of_record,
    device="cpu")`` in fp32 through ``generate`` and through
    ``generate_batch`` (the pinned ``check_midi`` gate must pass, and the
    two must give the same notes), then runs ``python3 -m
    music2midi_tpu_torch.serve_batch --device cpu`` and ``... evaluate
    --device cpu`` (through ``runpy``, as ``-m`` runs them) on a corpus of
    two short songs, the data-prep chain (``data.synthesize_corpus``,
    ``align_audio_midi``, ``midi_to_numpy``, ``compute_metrics``,
    ``generate_split``) on 4 songs of 12 s, and ``tools.calibration_check
    --device cpu`` on the model of record; and loads the training recipe
    ``configs/synth16k_aug_r5.yaml`` through ``config.load_config`` (the
    tree the JAX package reads with yaml);
  * serving (the engine, the bench, ``serve``, ``webui``, ``serve_batch``
    and ``evaluate``'s ``load_engine``) imports no training module.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import yaml

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "music2midi_tpu_torch"
RECORD = ROOT / "checkpoints" / "model_of_record.npz"
RECIPE = ROOT / "configs" / "synth16k_aug_r5.yaml"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
           "zstandard", "ml_dtypes", "yaml", "omegaconf", "transformers",
           "pandas", "sklearn", "music2midi_tpu")
# the data-prep chain and the checkpoint tools
PREP = ("native.py", "data/metadata.py", "data/align.py",
        "data/midi_tools.py", "data/synthesize_corpus.py",
        "data/align_audio_midi.py", "data/midi_to_numpy.py",
        "data/compute_metrics.py", "data/generate_split.py",
        "tools/calibration_check.py", "tools/export_npz.py",
        "tools/average_checkpoints.py", "tools/make_timbre_eval.py",
        "tools/realmix_check.py", "yaml_subset.py", "config.py")
# optional tools the card's machine lacks: imported inside functions only
LAZY = ("matplotlib", "yt_dlp", "fluidsynth", "pygame")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    """-> (package, line, inside a function) for every absolute import."""
    tree = ast.parse(path.read_text(), filename=str(path))
    in_function = {
        id(node)
        for fn in ast.walk(tree)
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
        for node in ast.walk(fn)
    }
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield (alias.name.split(".")[0], node.lineno,
                       id(node) in in_function)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module.split(".")[0], node.lineno,
                   id(node) in in_function)


def test_port_sources_import_no_blocked_package():
    files = _port_files()
    assert len(files) > 10, files
    for name in ("bench.py", "profiling.py", "models/convert.py",
                 "train/loop.py", "train/adafactor.py", "train/checkpoint.py",
                 "train/__main__.py", "data/dataset.py", "evaluation.py",
                 "dsp.py", "evaluate.py", "serve_batch.py", "webui.py",
                 "serve/batcher.py", "serve/webui_utils.py",
                 "plot_midi.py", "plot_interactive.py",
                 "parallel/__init__.py", "parallel/distributed.py",
                 "parallel/mesh.py", "orbax.py", "zstd.py", *PREP):
        assert PKG / name in files
    bad = [
        f"{p.relative_to(ROOT)}:{line} imports {root}"
        for p in files for root, line, in_fn in _imported_roots(p)
        if root in BLOCKED or (root in LAZY and not in_fn)
    ]
    assert not bad, bad
    lazy = {(p.name, root) for p in files
            for root, _, in_fn in _imported_roots(p) if root in LAZY}
    assert {("plot_midi.py", "matplotlib"), ("webui_utils.py", "yt_dlp"),
            ("webui_utils.py", "fluidsynth"),
            ("realmix_check.py", "pygame")} <= lazy


_REHEARSAL = r"""
import importlib, json, pkgutil, sys, tempfile
BLOCKED = set(json.loads(sys.argv[1]))
RECIPE = sys.argv[3]

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked on the card's machine: {name}")
        return None

sys.meta_path.insert(0, _Blocker())
import music2midi_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(
    music2midi_tpu_torch.__path__, "music2midi_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
importlib.import_module("chip_smoke")

from music2midi_tpu_torch.audio import write_wav
from music2midi_tpu_torch.calibration import check_midi, render_fixture
from music2midi_tpu_torch.infer import Music2MIDI

wav, sr = render_fixture()
with tempfile.TemporaryDirectory() as td:
    write_wav(td + "/a4.wav", wav, sr)
    engine = Music2MIDI.from_npz(sys.argv[2], device="cpu")
    midi = engine.generate(audio_path=td + "/a4.wav")
    ok, detail = check_midi(midi)
    (batch,) = engine.generate_batch(audio_paths=[td + "/a4.wav"])

def notes(m):
    return [(n.start, n.end, n.pitch) for n in m.instruments[0].notes]

# the CLIs, as `python3 -m` runs them, on two short songs of the fixture
import contextlib, io, os, runpy
import numpy as np
from music2midi_tpu_torch.audio import resample
cli, record = {}, sys.argv[2]
with tempfile.TemporaryDirectory() as td:
    os.chdir(td)
    for d in ("audio", "midi_numpy", "metadata"):
        os.mkdir(d)
    y = resample(wav, sr, 16000)
    for i in range(2):
        write_wav(f"audio/s{i}.wav", y[i * 48000:(i + 1) * 48000], 16000)
        np.save(f"midi_numpy/s{i}.npy", np.array([[0.0, 1.5, 69, 90]]))
        with open(f"metadata/s{i}.yaml", "w") as f:
            f.write("piano:\n  difficulty: beginner\n  genre: electronic\n")
    np.savez("dataset_split.npz", test_id=np.array(["s0", "s1"]))
    for mod, argv in (
            ("serve_batch", ["out", "audio/s0.wav", "audio/s1.wav",
                             "--dtype", "float32"]),
            ("evaluate", ["."])):
        sys.argv = [mod] + argv + ["--ckpt", record, "--device", "cpu"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            runpy.run_module(f"music2midi_tpu_torch.{mod}",
                             run_name="__main__")
        cli[mod] = buf.getvalue().strip().splitlines()
    cli["csv"] = open("scores/score-music2midi.csv").read().splitlines()

    # the data-prep chain and the gate's CLI, as `python3 -m` runs them
    def run_module(name, argv):
        sys.argv = [name] + argv
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                runpy.run_module(f"music2midi_tpu_torch.{name}",
                                 run_name="__main__")
            code = 0
        except SystemExit as e:
            code = e.code
        return code, buf.getvalue().strip().splitlines()

    os.mkdir("prep")
    prep = [run_module("data.synthesize_corpus",
                       ["prep", "--songs", "4", "--duration", "12"])]
    for stage in ("align_audio_midi", "midi_to_numpy", "compute_metrics",
                  "generate_split"):
        prep.append(run_module(f"data.{stage}", ["prep"]))
    cli["prep"] = prep
    cli["split"] = {k: [str(x) for x in v] for k, v in np.load(
        "prep/dataset_split.npz", allow_pickle=True).items()}
    cli["gate"] = run_module("tools.calibration_check",
                             [record, "--device", "cpu"])

from music2midi_tpu_torch.config import load_config
recipe = load_config(RECIPE).to_dict()

leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps({"modules": mods, "ok": ok, "detail": detail,
                  "batch_same": notes(batch) == notes(midi),
                  "cli": cli, "recipe": recipe, "leaked": leaked}))
"""


def test_port_runs_with_the_card_machines_packages_only():
    proc = subprocess.run(
        [sys.executable, "-c", _REHEARSAL, json.dumps(BLOCKED + LAZY),
         str(RECORD), str(RECIPE)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"},
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "music2midi_tpu_torch.ops.mel_cuda" in res["modules"]
    assert "music2midi_tpu_torch.infer.pipeline" in res["modules"]
    assert "music2midi_tpu_torch.ops.decode_attention" in res["modules"]
    for name in ("bench", "profiling", "models.convert", "train.loop",
                 "train.adafactor", "train.checkpoint", "train.__main__",
                 "data.dataset", "evaluation", "dsp", "evaluate",
                 "serve_batch", "webui", "serve.batcher", "serve.webui_utils",
                 "plot_midi", "plot_interactive",
                 *(p[:-3].replace("/", ".") for p in PREP)):
        assert f"music2midi_tpu_torch.{name}" in res["modules"]
    assert res["leaked"] == []
    assert res["ok"], res["detail"]
    assert res["batch_same"]
    served = res["cli"]["serve_batch"]
    assert served[-3].startswith("out/s0.mid (")
    summary = json.loads(served[-1])
    assert set(summary) == {"songs", "seconds", "songs_per_min", "notes"}
    assert summary["songs"] == 2 and summary["notes"] > 0
    assert res["cli"]["evaluate"][-2].startswith("mean score: ")
    assert res["cli"]["evaluate"][-1].startswith("chunks at the token cap")
    assert res["cli"]["csv"][0] == "piano_id,model,genre,difficulty,score"
    assert [r.split(",")[:4] for r in res["cli"]["csv"][1:]] == [
        ["s0", "music2midi", "electronic", "beginner"],
        ["s1", "music2midi", "electronic", "beginner"]]
    assert [code for code, _ in res["cli"]["prep"]] == [0] * 5
    assert res["cli"]["prep"][-1][1][-1].startswith("split 4 songs -> ")
    assert sum(len(v) for k, v in res["cli"]["split"].items()
               if k != "val_id") == 4
    code, lines = res["cli"]["gate"]
    assert code == 0 and lines[-1].startswith(f"PASS {RECORD}: notes=")
    assert res["recipe"] == yaml.safe_load(RECIPE.read_text())
    assert res["recipe"]["dataset"]["sample_rate"] == 16000


def test_serving_imports_no_training_module():
    """Serving (the engine, its bench, the batcher, the web UI, the bulk
    CLI and ``evaluate.load_engine``) loads checkpoints through
    ``weights.py`` and imports nothing of the training package."""
    code = ("import json, sys\n"
            "import music2midi_tpu_torch.infer, music2midi_tpu_torch.bench\n"
            "import music2midi_tpu_torch.serve, music2midi_tpu_torch.webui\n"
            "import music2midi_tpu_torch.serve_batch\n"
            "from music2midi_tpu_torch.evaluate import load_engine\n"
            "print(json.dumps(sorted(sys.modules)))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    mods = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("infer.pipeline", "serve.batcher", "webui", "serve_batch"):
        assert f"music2midi_tpu_torch.{name}" in mods
    training = [m for m in mods if m.split(".")[:2] in (
        ["music2midi_tpu_torch", "train"], ["music2midi_tpu_torch", "data"])]
    assert training == []
