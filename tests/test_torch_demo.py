"""``demo_torch.ipynb`` runs: the port's walkthrough cannot rot.

Its code cells run in order in one namespace, in a scratch directory that
holds the 3-s two-tone ``song.wav`` of ``tests/test_demo_notebook.py``,
once with a link to ``checkpoints/`` (the notebook loads the model of
record, as it does at the repository's root) and once without (its
untrained smoke model, seed 0).  Two adaptations, as that test makes
them: the ``DEVICE = "cuda"`` assignment becomes ``"cpu"``, and the
engine's decode length is capped at 64 tokens.  Bars: the MIDI the notebook writes is byte-equal to
a direct ``generate`` of the same file with the same weights and
conditioning, and ``roll.html`` and ``output.wav`` exist.
"""

import functools
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from music2midi_tpu_torch.audio import write_wav
from music2midi_tpu_torch.infer import Music2MIDI

REPO = Path(__file__).resolve().parent.parent
CAP = 64


@pytest.fixture(params=["model_of_record", "random"])
def demo_dir(request, tmp_path, monkeypatch):
    sr = 16000
    t = np.arange(3 * sr) / sr
    y = (
        0.4 * np.sin(2 * np.pi * 330 * t)
        + 0.2 * np.sin(2 * np.pi * 415 * t)
    ).astype(np.float32)
    write_wav(tmp_path / "song.wav", y, sr)
    if request.param == "model_of_record":
        os.symlink(REPO / "checkpoints", tmp_path / "checkpoints")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MPLBACKEND", "Agg")
    return tmp_path


def _code_cells() -> list:
    nb = json.loads((REPO / "demo_torch.ipynb").read_text())
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


def test_demo_notebook_runs_on_the_cpu(demo_dir, monkeypatch):
    cells = _code_cells()
    assert sum('DEVICE = "cuda"' in c for c in cells) == 1
    for name in ("from_npz", "from_random"):
        monkeypatch.setattr(Music2MIDI, name, classmethod(functools.partial(
            getattr(Music2MIDI, name).__func__, decode_max_length=CAP)))
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        namespace = {}
        for cell in cells:
            exec(compile(cell.replace('DEVICE = "cuda"', 'DEVICE = "cpu"'),
                         "demo_torch.ipynb", "exec"), namespace)
        model = namespace["model"]
        assert str(model.device) == "cpu"
        assert model.decode_max_length == CAP
        if namespace["CKPT"] is None:
            direct = Music2MIDI.from_random(seed=0, device="cpu")
        else:
            assert namespace["CKPT"] == "checkpoints/model_of_record.npz"
            direct = Music2MIDI.from_npz(namespace["CKPT"], device="cpu")
        direct.generate(audio_path="song.wav", cond_index=[1, 1]).write(
            "direct.mid")
    finally:
        torch.set_num_threads(before)
    assert (demo_dir / "output.mid").read_bytes() == \
        (demo_dir / "direct.mid").read_bytes()
    assert (demo_dir / "roll.html").stat().st_size > 0
    assert (demo_dir / "output.wav").stat().st_size > 44
