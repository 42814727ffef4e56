"""The port's web UI (``music2midi_tpu_torch/webui.py``) on a real
``ThreadingHTTPServer``, wired as ``tests/test_serve_plot.py`` wires the
JAX one: the port's batcher over a CPU engine (the model of record in fp32),
in a ``tmp_path`` working directory.

Bars: the index page; a WAV upload gives the result page, a fetchable
``output.wav`` (RIFF), ``roll.html`` and an ``output.mid`` byte-identical
to the JAX engine's ``generate`` on the same upload with the same weights
written by the JAX writer (so its notes are equal); the empty-form error;
a ``../`` path is not served and a crafted upload filename stays inside
the upload root, also when its generation fails.
"""

import http.client
import os
import re
import threading
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

from music2midi_tpu.infer import Music2MIDI as JaxMusic2MIDI
from music2midi_tpu_torch import webui
from music2midi_tpu_torch.audio import write_wav
from music2midi_tpu_torch.calibration import render_fixture
from music2midi_tpu_torch.infer import Music2MIDI
from music2midi_tpu_torch.midi import MidiFile
from music2midi_tpu_torch.serve.batcher import DynamicBatcher

RECORD = Path(__file__).resolve().parent.parent / "checkpoints" \
    / "model_of_record.npz"
MAX_LEN = 64  # the fixture's rows end by step 43 (test_torch_pipeline.py)
BOUNDARY = "bndry123"


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    webui.engine = Music2MIDI.from_npz(RECORD, device="cpu",
                                       decode_max_length=MAX_LEN)
    webui.batcher = DynamicBatcher(webui.engine)
    root = tmp_path_factory.mktemp("webui")
    cwd = root / "site"
    (cwd / "static" / "uploads").mkdir(parents=True)
    (root / "secret.txt").write_text("not for the web")
    old = os.getcwd()
    os.chdir(cwd)
    webui.UPLOAD_DIR = Path("static/uploads")
    srv = ThreadingHTTPServer(("127.0.0.1", 0), webui.Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", cwd
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        webui.batcher.close()
        webui.batcher = webui.engine = None
        os.chdir(old)
        torch.set_num_threads(before)


def _post(url, filename=None, payload=b""):
    parts = (f"--{BOUNDARY}\r\n"
             'Content-Disposition: form-data; name="url"\r\n\r\n\r\n')
    if filename is not None:
        parts += (f"--{BOUNDARY}\r\n"
                  'Content-Disposition: form-data; name="file"; '
                  f'filename="{filename}"\r\n'
                  "Content-Type: audio/wav\r\n\r\n")
    body = parts.encode() + payload + (b"\r\n" if filename else b"") \
        + f"--{BOUNDARY}--\r\n".encode()
    req = urllib.request.Request(
        url + "/generate", data=body,
        headers={"Content-Type": f"multipart/form-data; boundary={BOUNDARY}"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read().decode()


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return r.read()


def test_index(server):
    body = _get(server[0], "/").decode()
    assert "Music2MIDI" in body and "form" in body


def test_wav_upload_equals_jax_generate(server, tmp_path):
    url, _ = server
    wav, sr = render_fixture()
    write_wav(tmp_path / "song.wav", wav, sr)
    page = _post(url, "song.wav", (tmp_path / "song.wav").read_bytes())
    assert "piano cover" in page
    links = {k: re.search(rf'(?:src|href)="([^"]*{re.escape(k)})"', page)
             for k in ("output.wav", "output.mid", "roll.html")}
    assert all(links.values()), page
    assert _get(url, links["output.wav"].group(1))[:4] == b"RIFF"
    roll = _get(url, links["roll.html"].group(1)).decode()
    assert "<canvas" in roll and "NOTES" in roll
    mid = _get(url, links["output.mid"].group(1))

    ref = JaxMusic2MIDI.from_npz(RECORD, use_compilation_cache=False,
                                 decode_max_length=MAX_LEN)
    ref.generate(audio_path=tmp_path / "song.wav").write(tmp_path / "jax.mid")
    assert mid == (tmp_path / "jax.mid").read_bytes()
    (tmp_path / "port.mid").write_bytes(mid)
    notes = MidiFile(tmp_path / "port.mid").instruments[0].notes
    assert len(notes) > 0


def test_empty_form(server):
    assert "Please provide a URL or upload a file." in _post(server[0])


def test_paths_stay_inside_the_roots(server, tmp_path):
    url, cwd = server
    host = url.split("//")[1]
    for path in ("/../secret.txt", "/static/../../secret.txt",
                 "/static/uploads/../../../secret.txt"):
        conn = http.client.HTTPConnection(host, timeout=60)
        conn.request("GET", path)
        resp = conn.getresponse()
        assert resp.status == 404 and b"not for" not in resp.read()
        conn.close()
    write_wav(tmp_path / "x.wav", np.zeros(16000, np.float32), 16000)
    page = _post(url, "../../../evil.wav", (tmp_path / "x.wav").read_bytes())
    assert "piano cover" in page
    uploads = (cwd / "static" / "uploads").resolve()
    made = sorted(p for p in cwd.parent.rglob("*")
                  if p.is_file() and "evil" in p.name)
    assert made and all(p.resolve().is_relative_to(uploads) for p in made)
    # a failed generation wipes only its own result dir
    page = _post(url, "../broken.wav", b"not a wav")
    assert "RIFF" in page
    assert not (uploads / "local" / "broken.wav").exists()
    assert (cwd.parent / "secret.txt").exists()
