"""Headline benchmark of the port: 3-minute songs per minute on one card.

    python3 -m music2midi_tpu_torch.bench [--ckpt PATH] [--device cuda] ...

A port of the repository's root ``bench.py`` (the JAX package's): the same
flags, workload, trials and JSON line, on ``music2midi_tpu_torch``.  It
runs the whole song -> MIDI pipeline (chunking -> log-mel -> T5 encoder ->
decode -> device detokenizer -> host stitch) through
``Music2MIDI.generate_batch`` and prints ONE JSON line with the keys of
``bench.py``'s (``value`` = songs/min, p10/p50/p90, ``window_stable``,
``p50_song_latency_s``, ``n_notes``, ``decoded_tokens``, ``mfu``,
``mfu_executed``, ...), plus ``card`` (the ``nvidia-smi`` name and power
limit of the card it ran on), ``decode_steps`` (the steps each batch of a
timed call ran) and ``rows_at_cap`` (its chunks that reached the token
cap).

Workload: the model of record (``checkpoints/model_of_record.npz``, or
``--ckpt``) in bf16, trained EOS early exit, over ``_songs``: 8 synthetic
180-s songs (a sine of 200 + 40 k Hz plus gaussian noise, numpy seed 0),
or the first 8 WAVs of ``--audio_dir``.  One warm-up of the exact
workload, then 3 groups of 3 timed ``generate_batch`` calls 10 s apart
(throughput: the median, and nearest-rank p10 / p90), then 5 single-song
``generate`` calls on the first song (latency).  A secondary
``random_forced256`` run (random weights from seed 0, EOS suppressed, 256
tokens a chunk; 1 group of 3, 3 latency trials) follows; ``--random``
makes it the headline.

Time is the host's wall clock around calls that end in
``torch.cuda.synchronize()``.  ``mfu`` is the model-required FLOPs of one
``generate_batch`` call (``profiling.decode_flops``, each real row at its
own generated length) over the median call time over the card's dense
bf16 peak; ``mfu_executed`` counts the padded batch width at the lockstep
step count instead (what the loop ran).  Both are null where the peak is
unknown (a CPU, or a card outside ``profiling.PEAK_FLOPS_BF16``).

``--device cpu`` runs the same code on the CPU (the tests do, at a tiny
size); a CPU number is no card metric.  ``--config`` takes the JSON of an
npz ``__config__`` (the card's machine has no yaml).  An orbax
checkpoint directory raises: the port does not read them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

DECODE_TOKENS = 256  # forced tokens per 3-s chunk in the random mode
N_SONGS = 8
SONG_SECONDS = 180
RECORD_CKPT = (Path(__file__).resolve().parent.parent / "checkpoints"
               / "model_of_record.npz")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="3-minute songs per minute of the PyTorch port")
    p.add_argument(
        "--ckpt", type=str, default=os.environ.get("M2M_BENCH_CKPT"),
        help="trained checkpoint (.npz export or Lightning .ckpt).  "
             "Default: checkpoints/model_of_record.npz when it exists")
    p.add_argument(
        "--random", action="store_true",
        help="make the random-weights forced-256 run the headline (no "
             "trained-mode run)")
    p.add_argument(
        "--no_secondary", action="store_true",
        help="skip the secondary random_forced256 run in trained mode")
    p.add_argument(
        "--max_decode", type=int, default=None,
        help="decode token cap per chunk in trained mode (default 1024); "
             "the random mode always forces DECODE_TOKENS=256")
    p.add_argument(
        "--config", type=str, default=None,
        help="JSON config for --ckpt (an npz embeds its own; a .ckpt "
             "embeds none, so the packaged default is used)")
    p.add_argument(
        "--int8_weights", action="store_true",
        help="int8 weight-only quantization of the decode projections")
    p.add_argument(
        "--kv_bits", type=int, default=8, choices=[8, 4],
        help="quantized-KV width (4: +-7 levels, stored in int8)")
    p.add_argument(
        "--pallas_cross", action="store_true",
        help="the transposed-cross decode-attention kernel for the cross "
             "blocks (8-bit KV only)")
    p.add_argument(
        "--unroll", type=int, default=1,
        help="decode steps between two EOS read-backs (greedy tokens "
             "unchanged)")
    p.add_argument(
        "--audio_dir", type=str, default=os.environ.get("M2M_BENCH_AUDIO"),
        help="directory of .wav songs for the trained-mode workload "
             "(default: synthetic sines); throughput is normalized to "
             "3-min-song equivalents by total audio seconds")
    p.add_argument(
        "--device", type=str, default="cuda",
        help="torch device to run on (default cuda; cpu for tests)")
    return p.parse_args(argv)


def _load_config(path):
    if path is None:
        return None
    if Path(path).suffix in (".yaml", ".yml"):
        raise SystemExit(f"--config {path}: pass the config as JSON (the "
                         "port reads no yaml)")
    return json.loads(Path(path).read_text())


def _load_engine(args, trained: bool):
    from .infer import Music2MIDI

    kw = {"dtype": torch.bfloat16, "device": args.device}
    if trained:
        if args.max_decode:
            kw["decode_max_length"] = args.max_decode
        p = Path(args.ckpt)
        config = _load_config(args.config)
        if p.suffix in (".ckpt", ".pt"):
            engine = Music2MIDI.from_torch_checkpoint(p, config, **kw)
        elif p.suffix == ".npz":
            engine = Music2MIDI.from_npz(p, config, **kw)
        else:
            engine = Music2MIDI.from_orbax(p, config, **kw)
    else:
        engine = Music2MIDI.from_random(
            seed=0, decode_max_length=args.max_decode or DECODE_TOKENS, **kw)
        # EOS suppressed in the decode loop: every chunk decodes the full
        # DECODE_TOKENS
        engine.suppress_tokens = (engine.t5_config.eos_token_id,)
    engine.int8_weights = bool(args.int8_weights)
    engine.pallas_cross = bool(args.pallas_cross)
    engine.kv_bits = args.kv_bits  # != 8 implies quantized KV (_dcfg)
    # clamped on args too, so that the result line records what ran
    args.unroll = max(1, int(args.unroll))
    engine.unroll = args.unroll
    return engine


def _songs(args, sr: int):
    if args.audio_dir:
        from .audio import load as load_audio

        paths = sorted(Path(args.audio_dir).glob("*.wav"))[:N_SONGS]
        if not paths:
            raise SystemExit(f"no .wav files in {args.audio_dir}")
        return [load_audio(p, sr=sr)[0].astype(np.float32) for p in paths]
    rng = np.random.default_rng(0)
    t = np.arange(SONG_SECONDS * sr) / sr
    return [
        (0.3 * np.sin(2 * np.pi * (200 + 40 * k) * t)
         + 0.05 * rng.normal(size=len(t))).astype(np.float32)
        for k in range(N_SONGS)
    ]


def _decode_flops_from_stats(engine) -> tuple:
    """(model-required, executed) FLOPs of one generate_batch call, from
    the engine's per-batch ``last_decode_stats``.

    model-required (the standard MFU numerator): each REAL row at its own
    generated length, so padding and lockstep overwork count against
    utilization.  executed: the padded batch width at the lockstep step
    count, what the loop ran; the ratio is the batching overhead."""
    from .profiling import decode_flops

    enc_len = engine.encoder_len
    cfg = engine.t5_config
    required = sum(
        decode_flops(cfg, 1, enc_len, max(1, int(s_row)))
        for s in engine.last_decode_stats
        for s_row in s["row_steps"]
    )
    executed = sum(
        decode_flops(cfg, s["batch_width"], enc_len, max(1, s["steps"]))
        for s in engine.last_decode_stats
    )
    return required, executed


def _timed(engine, fn):
    """(fn's result, host seconds around it), the device's work included."""
    sync = engine.device.type == "cuda"
    if sync:
        torch.cuda.synchronize(engine.device)
    t0 = time.perf_counter()
    out = fn()
    if sync:
        torch.cuda.synchronize(engine.device)
    return out, time.perf_counter() - t0


def _run_workload(engine, songs, groups: int, per_group: int,
                  lat_trials: int = 5):
    """Warmed throughput trials + single-song latency -> a dict."""
    # warm-up: the EXACT workload once, so that every batch width the
    # timed trials reach is warm (kernels built, allocator and libraries
    # warmed)
    engine.generate_batch(songs)
    engine.generate(audio_y=songs[0])
    sr = int(engine.config.model.sample_rate)
    song_equivalents = sum(len(s) for s in songs) / sr / SONG_SECONDS

    # groups 10 s apart: a spread across minutes, not only back to back
    trials = []
    midis = []
    for g in range(groups):
        if g:
            time.sleep(10.0)
        for _ in range(per_group):
            midis, dt = _timed(engine, lambda: engine.generate_batch(songs))
            trials.append(dt)
    elapsed = sorted(trials)[len(trials) // 2]
    # greedy: the same stats in every trial
    flops, flops_exec = _decode_flops_from_stats(engine)
    decode_stats = list(engine.last_decode_stats)
    tokens_real = sum(s["tokens_real"] for s in decode_stats)
    cap = engine.decode_max_length - 1
    rows_at_cap = sum(r >= cap for s in decode_stats for r in s["row_steps"])
    n_notes = sum(len(i.notes) for m in midis for i in m.instruments)
    tput = sorted(song_equivalents / (t / 60.0) for t in trials)

    lat = sorted(_timed(engine, lambda: engine.generate(audio_y=songs[0]))[1]
                 for _ in range(lat_trials))

    return {
        "songs_per_min": song_equivalents / (elapsed / 60.0),
        "elapsed_median_s": elapsed,
        "flops_per_call": flops,
        "flops_executed_per_call": flops_exec,
        "tokens_real": tokens_real,
        "decode_stats": decode_stats,
        "rows_at_cap": rows_at_cap,
        "n_notes": n_notes,
        "tput_sorted": tput,
        "lat_sorted": lat,
        "songs": songs,
        "sr": sr,
    }


def _mfu(r, peak, key="flops_per_call"):
    if not peak:
        return None
    return round(r[key] / r["elapsed_median_s"] / peak, 4)


def build_result(args, trained: bool, head: dict, peak, device_kind: str,
                 card=None, sec=None) -> dict:
    """The JSON line: ``bench.py``'s keys from the headline run ``head``
    and, when given, the secondary run ``sec``; ``card`` is the
    ``nvidia-smi`` name and power limit."""
    songs_per_min = head["songs_per_min"]
    tput, lat = head["tput_sorted"], head["lat_sorted"]
    # nearest rank on (n-1) q: 9 trials -> indices 1, 4, 7
    p10 = tput[round((len(tput) - 1) * 0.1)]
    p90 = tput[round((len(tput) - 1) * 0.9)]
    window_stable = bool(p10 > 0 and p90 / p10 < 1.5)
    result = {
        "metric": "songs_per_min_per_chip",
        "value": round(songs_per_min, 2),
        "unit": "3min_songs/min/chip",
        "vs_baseline": round(songs_per_min / 6.25, 3),
        "p10": round(p10, 2),
        "p50": round(songs_per_min, 2),
        "p90": round(p90, 2),
        "window_stable": window_stable,
        "spread_ratio_p90_p10": round(p90 / p10, 3) if p10 else None,
        "mode": "trained_eos" if trained else "random_forced256",
        "ckpt": args.ckpt,
        "int8_weights": bool(args.int8_weights),
        "kv_bits": int(args.kv_bits),
        "unroll": int(args.unroll),
        "pallas_cross": bool(args.pallas_cross),
        "n_notes": head["n_notes"],
        "decoded_tokens": head["tokens_real"],
        # per batch of a timed call: decode steps run, and the chunks
        # that reached the token cap
        "decode_steps": [s["steps"] for s in head["decode_stats"]],
        "rows_at_cap": head["rows_at_cap"],
        "mfu": _mfu(head, peak),
        "mfu_executed": _mfu(head, peak, "flops_executed_per_call"),
        "model_tflops_per_call": round(head["flops_per_call"] / 1e12, 4),
        "device_kind": device_kind,
        "card": card,
        "peak_tflops_bf16": peak / 1e12 if peak else None,
        "p50_song_latency_s": round(lat[len(lat) // 2], 3),
        "spread": {
            "n_trials": len(tput),
            "min": round(tput[0], 2),
            "p10": round(p10, 2),
            "p90": round(p90, 2),
            "max": round(tput[-1], 2),
        },
        "latency_spread_s": {
            "min": round(lat[0], 3), "max": round(lat[-1], 3),
        },
        # latency is of songs[0] as it is
        "latency_song_seconds": round(len(head["songs"][0]) / head["sr"], 1),
    }
    if sec is not None:
        result["secondary_random_forced256"] = {
            "songs_per_min": round(sec["songs_per_min"], 2),
            "mfu": _mfu(sec, peak),
            "p50_song_latency_s": round(
                sec["lat_sorted"][len(sec["lat_sorted"]) // 2], 3),
        }
    return result


def card_name_and_power_limit():
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.random:
        args.ckpt = None
    elif not args.ckpt and RECORD_CKPT.exists():
        args.ckpt = str(RECORD_CKPT)
    trained = bool(args.ckpt)

    from .profiling import device_peak_flops

    engine = _load_engine(args, trained)
    on_card = engine.device.type == "cuda"
    peak = device_peak_flops(engine.device)
    device_kind = (torch.cuda.get_device_name(engine.device) if on_card
                   else "cpu")
    card = card_name_and_power_limit() if on_card else None
    songs = _songs(args, int(engine.config.model.sample_rate))
    head = _run_workload(engine, songs, groups=3, per_group=3)

    sec = None
    if trained and not args.no_secondary:
        # random weights, forced 256 tokens: ALWAYS 256, whatever
        # --max_decode shaped the headline
        sec_args = argparse.Namespace(**{**vars(args), "max_decode": None})
        sec_engine = _load_engine(sec_args, trained=False)
        sec = _run_workload(sec_engine, songs, groups=1, per_group=3,
                            lat_trials=3)
    print(json.dumps(build_result(args, trained, head, peak, device_kind,
                                  card, sec)))


if __name__ == "__main__":
    main()
