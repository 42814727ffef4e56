"""The port imports nothing the card's machine lacks.

That machine has PyTorch with CUDA, numpy, scipy and einops, and no JAX,
no ml_dtypes and no yaml; and the JAX package itself needs yaml at import
(``music2midi_tpu/config.py``).  Two checks:

  * an AST scan of every module of ``music2midi_tpu_torch`` and of
    ``chip_smoke.py`` finds no import of those packages or of
    ``music2midi_tpu``;
  * a subprocess in which importing any of them raises imports every port
    module (``bench``, ``profiling``, ``models.convert`` and the training
    modules, the train CLI among them)
    and ``chip_smoke``, then runs the calibration fixture through
    ``Music2MIDI.from_npz(model_of_record, device="cpu")`` in fp32 through
    ``generate`` and through ``generate_batch``: the pinned ``check_midi``
    gate must pass, and the two must give the same notes.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "music2midi_tpu_torch"
RECORD = ROOT / "checkpoints" / "model_of_record.npz"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "yaml",
           "omegaconf", "transformers", "music2midi_tpu")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_port_sources_import_no_blocked_package():
    files = _port_files()
    assert len(files) > 10, files
    for name in ("bench.py", "profiling.py", "models/convert.py",
                 "train/loop.py", "train/adafactor.py", "train/checkpoint.py",
                 "train/__main__.py", "data/dataset.py", "evaluation.py",
                 "dsp.py"):
        assert PKG / name in files
    bad = [
        f"{p.relative_to(ROOT)}:{line} imports {root}"
        for p in files for root, line in _imported_roots(p)
        if root in BLOCKED
    ]
    assert not bad, bad


_REHEARSAL = r"""
import importlib, json, pkgutil, sys, tempfile
BLOCKED = set(json.loads(sys.argv[1]))

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

leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps({"modules": mods, "ok": ok, "detail": detail,
                  "batch_same": notes(batch) == notes(midi),
                  "leaked": leaked}))
"""


def test_port_runs_with_the_card_machines_packages_only():
    proc = subprocess.run(
        [sys.executable, "-c", _REHEARSAL, json.dumps(BLOCKED), str(RECORD)],
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
                 "data.dataset", "evaluation", "dsp"):
        assert f"music2midi_tpu_torch.{name}" in res["modules"]
    assert res["leaked"] == []
    assert res["ok"], res["detail"]
    assert res["batch_same"]


def test_serving_imports_no_training_module():
    """Serving (the engine, its bench) loads checkpoints through
    ``weights.py`` and imports nothing of the training package."""
    code = ("import json, sys\n"
            "import music2midi_tpu_torch.infer, music2midi_tpu_torch.bench\n"
            "print(json.dumps(sorted(sys.modules)))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    mods = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "music2midi_tpu_torch.infer.pipeline" in mods
    training = [m for m in mods if m.split(".")[:2] in (
        ["music2midi_tpu_torch", "train"], ["music2midi_tpu_torch", "data"])]
    assert training == []
