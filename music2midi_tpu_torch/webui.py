"""Web UI of the port: ``python3 -m music2midi_tpu_torch.webui [--ckpt
CKPT] [--config CFG.yaml] [--port 5736] [--device cuda] [--warmup]``.

The port of the repository's root ``webui.py`` (standard-library HTTP):
GET / serves the submission form; POST /generate accepts a YouTube URL or
an uploaded audio/video file, runs the song -> MIDI pipeline through a
``DynamicBatcher`` (concurrent requests coalesce into one engine batch),
synthesizes a piano preview, writes an interactive piano roll, and renders
a dual-player result page with a crossfade slider.  Results are cached per
video id / filename; a failed generation wipes its result dir.  Pages come
from the repository's ``templates/`` and ``static/``, read in place.

External tools degrade gracefully: without yt-dlp/ffmpeg only direct WAV
uploads work (clearly reported to the user); the preview synth is built in.
"""

from __future__ import annotations

import argparse
import html
import re
import shutil
from email.parser import BytesParser
from email.policy import HTTP
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

from .evaluate import CONFIG_HELP, DTYPES, load_engine
from .midi import MidiFile
from .plot_interactive import plot_midi_sequence_html
from .serve.batcher import DynamicBatcher
from .serve.webui_utils import (
    download_video,
    ffmpeg_available,
    post_process,
    render_preview,
    video_stream_present,
)

UPLOAD_DIR = Path("static/uploads")
TEMPLATE_DIR = Path(__file__).resolve().parent.parent / "templates"
STATIC_DIR = Path(__file__).resolve().parent.parent / "static"

engine = None  # set in main()
batcher = None  # DynamicBatcher when serving (main()); concurrent
# /generate requests coalesce into one device batch


def render(template: str, **ctx) -> bytes:
    text = (TEMPLATE_DIR / template).read_text()
    for key, value in ctx.items():
        text = text.replace("{{" + key + "}}", str(value))
    return text.encode()


def _sanitize_name(name: str) -> str:
    """Keep only filename-safe characters; no separators, no dot-runs."""
    name = re.sub(r"[^A-Za-z0-9._-]", "_", name)
    return name.replace("..", "_").strip("._")


def parse_multipart(headers, body: bytes):
    """-> (fields: dict, files: dict name -> (filename, bytes))."""
    msg = BytesParser(policy=HTTP).parsebytes(
        b"Content-Type: " + headers.get("Content-Type", "").encode()
        + b"\r\n\r\n" + body
    )
    fields, files = {}, {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        filename = part.get_filename()
        payload = part.get_payload(decode=True) or b""
        if filename:
            files[name] = (filename, payload)
        else:
            fields[name] = payload.decode(errors="replace").strip()
    return fields, files


def _write_roll(midi_data, result_dir: Path) -> None:
    """Interactive piano-roll page next to the result (hover/zoom viewer).
    Optional extra: a rendering failure must not fail the request — the
    MIDI itself was already produced."""
    try:
        plot_midi_sequence_html(
            midi_data, path=result_dir / "roll.html", title="piano cover roll"
        )
    except Exception as e:
        print(f"roll.html render failed (non-fatal): {e!r}")


def generate_result(url: str, upload):
    """-> (result_dir, video_path, audio_path, display_video)."""
    if upload is not None:
        # sanitize: strip any directory components and dangerous chars so an
        # attacker-controlled filename cannot escape the upload dir (the
        # failure path rmtree's result_dir — containment is load-bearing)
        filename = _sanitize_name(Path(upload[0]).name) or "upload"
        result_dir = UPLOAD_DIR / "local" / filename
        input_name = filename
    else:
        parsed = urlparse(url)
        try:
            song_id = parse_qs(parsed.query)["v"][0]
        except KeyError:
            song_id = url.rstrip("/").split("/")[-1] or "song"
        song_id = _sanitize_name(song_id) or "song"
        result_dir = UPLOAD_DIR / "youtube" / song_id
        input_name = "input.mp4"

    result_dir.mkdir(parents=True, exist_ok=True)
    video_path = result_dir / input_name
    audio_path = result_dir / "output.wav"
    midi_path = result_dir / "output.mid"
    if audio_path.exists() and video_path.exists():
        print("Using existing result at", result_dir)
        if midi_path.exists() and not (result_dir / "roll.html").exists():
            _write_roll(MidiFile(midi_path), result_dir)
        return (result_dir, video_path, audio_path,
                video_stream_present(video_path))
    try:
        if upload is not None:
            video_path.write_bytes(upload[1])
        else:
            print("Downloading video from", url)
            download_video(url, video_path)
        print("Generating result")
        if batcher is not None:
            midi_data = batcher.submit(audio_path=video_path).result()
        else:
            midi_data = engine.generate(audio_path=video_path)
        midi_data.write(midi_path)
        print("MIDI written to", midi_path)
        _write_roll(midi_data, result_dir)
        render_preview(midi_data, audio_path)
        if ffmpeg_available() and video_stream_present(video_path):
            print("Post-processing A/V sync")
            post_process(video_path, audio_path)
        return (result_dir, video_path, audio_path,
                video_stream_present(video_path))
    except Exception:
        shutil.rmtree(result_dir, ignore_errors=True)
        raise


class Handler(BaseHTTPRequestHandler):
    def _send(self, body: bytes, status=200, ctype="text/html"):
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        path = self.path.split("?")[0]
        if path == "/":
            self._send(render("index.html", error=""))
            return
        # static files + generated results — containment-checked: only
        # files under the serving roots are reachable (no path traversal)
        rel = path.lstrip("/")
        allowed_roots = (
            (Path.cwd() / "static").resolve(),
            (STATIC_DIR.parent / "static").resolve(),
        )
        for base in (Path("."), STATIC_DIR.parent):
            f = (base / rel).resolve()
            if not any(
                f.is_relative_to(root) for root in allowed_roots
            ):
                continue
            if f.is_file():
                ctype = {
                    ".css": "text/css", ".js": "text/javascript",
                    ".wav": "audio/wav", ".mp4": "video/mp4",
                    ".mid": "audio/midi", ".mp3": "audio/mpeg",
                    ".html": "text/html",
                }.get(f.suffix, "application/octet-stream")
                self._send(f.read_bytes(), ctype=ctype)
                return
        self._send(b"not found", status=404, ctype="text/plain")

    def do_POST(self):
        if self.path != "/generate":
            self._send(b"not found", status=404, ctype="text/plain")
            return
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        fields, files = parse_multipart(self.headers, body)
        url = fields.get("url", "")
        upload = files.get("file")
        if upload and not upload[0]:
            upload = None
        if not url and upload is None:
            self._send(render(
                "index.html",
                error="Please provide a URL or upload a file.",
            ))
            return
        try:
            result_dir, video_path, audio_path, display_video = (
                generate_result(url, upload)
            )
        except Exception as e:  # surface tool gaps / decode errors
            self._send(render("index.html", error=html.escape(str(e))))
            return
        self._send(render(
            "result.html",
            video_path="/" + str(video_path),
            audio_path="/" + str(audio_path),
            midi_path="/" + str(result_dir / "output.mid"),
            roll_path="/" + str(result_dir / "roll.html"),
            display_video="block" if display_video else "none",
        ))

    def log_message(self, fmt, *args):
        print("[webui]", fmt % args)


def main(argv=None):
    global engine, batcher
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt", type=str, default=None,
                        help="model checkpoint (npz export, training dir of "
                             "the port, or torch .ckpt; default: the "
                             "committed checkpoints/model_of_record.npz when "
                             "present AND --config is not given, else random "
                             "weights)")
    parser.add_argument("--config", type=str, default=None, help=CONFIG_HELP)
    parser.add_argument("--port", type=int, default=5736)
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=list(DTYPES))
    parser.add_argument(
        "--warmup", action="store_true",
        help="run every batch width once on silence before accepting "
             "requests (builds the CUDA kernels and warms the allocator)")
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device (default cuda; no fallback to the CPU)")
    args = parser.parse_args(argv)

    engine = load_engine(args.ckpt, args.config, args.dtype, args.device)
    if args.warmup:
        print("Warming every batch width (builds the kernels)")
        engine.warmup()
    batcher = DynamicBatcher(engine)
    print("Model loaded successfully")
    server = ThreadingHTTPServer(("0.0.0.0", args.port), Handler)
    print(f"Serving on http://localhost:{args.port}")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        batcher.close()


if __name__ == "__main__":
    main()
