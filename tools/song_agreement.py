"""The song's greedy-token agreement of the int8 kernel route with plain
``_attention_int8``, as ``chip_smoke.py``'s song_timing phase reads it,
on the encoder output of a chosen log-mel: the serving kernel's, the plain
PyTorch version's on the card, or one saved by an earlier run.

The song is ``chip_smoke.py``'s (``synthetic_song(180, 16000, seed=7)``)
and the model the model of record in bf16 with int8 KV.  Both decode
routes run on the same encoder output, so a change in the agreement
between two mels is the decoder's answer to the input, not to the
attention kernel.  ``--root`` imports the port from another checkout
(its kernels are built there), so that the mel of another version of the
kernel can be saved and fed to this checkout's decode loop; the hashes of
each route's tokens show whether two runs decoded the same tokens.  Needs
a CUDA card; from the repo root:

    python3 tools/song_agreement.py --mel kernel --save-mel kernel.npy
    python3 tools/song_agreement.py --mel plain
    python3 tools/song_agreement.py --root OTHER --mel kernel --save-mel o.npy
    python3 tools/song_agreement.py --mel o.npy
    python3 tools/song_agreement.py --save-encoder chiprun_out/enc.npz

``--save-encoder`` writes the encoder output of the song's real chunks
(bf16, stored as its uint16 bits), the conditioning and each route's
tokens and lengths to an npz, so that the same encoder output can be
decoded elsewhere (``tools/c1_distance.py`` decodes it through the JAX
engine on the CPU).

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose music2midi_tpu_torch is imported")
    ap.add_argument("--mel", default="kernel",
                    help="'kernel', 'plain' or a .npy file of a saved mel")
    ap.add_argument("--save-mel", help="write the mel used to this .npy")
    ap.add_argument("--save-encoder",
                    help="write the encoder output and both routes' "
                         "tokens to this .npz")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    from music2midi_tpu_torch.infer import Music2MIDI
    from music2midi_tpu_torch.infer.decode import generate_tokens
    from music2midi_tpu_torch.ops.mel import log_mel_spectrogram

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)

    engine = Music2MIDI.from_npz(ROOT / "checkpoints" / "model_of_record.npz",
                                 dtype=torch.bfloat16)
    chunks = engine._chunk_waveform(smoke.synthetic_song(180.0, 16000,
                                                         seed=7))
    batch, cond = engine._pad_batch(chunks)
    wave = engine._device_wave(batch)
    plain = log_mel_spectrogram(wave, engine.mel_config)
    if args.mel == "kernel":
        mel = engine._log_mel(wave)
    elif args.mel == "plain":
        mel = plain
    else:
        mel = torch.from_numpy(np.load(args.mel)).to(wave.device)
    if args.save_mel:
        np.save(args.save_mel, mel.cpu().numpy())
    enc = engine._encoder(mel, cond)
    runs = {}
    for on in (False, True):
        toks, lens = generate_tokens(
            engine.model, enc, engine.t5_config,
            engine._dcfg()._replace(pallas_attention=on))
        runs[on] = (toks.cpu().numpy(), lens.cpu().numpy())
    (t_off, l_off), (t_on, l_on) = runs[False], runs[True]
    if args.save_encoder:
        real = len(chunks)
        Path(args.save_encoder).parent.mkdir(parents=True, exist_ok=True)
        np.savez(args.save_encoder,
                 encoder_bf16_bits=enc[:real].contiguous().view(
                     torch.int16).cpu().numpy().view(np.uint16),
                 cond=cond[:real], tokens_kernel=t_on[:real],
                 lengths_kernel=l_on[:real], tokens_plain=t_off[:real],
                 lengths_plain=l_off[:real])
    agree = total = 0
    for r in range(len(chunks)):
        m = int(max(l_off[r], l_on[r]))
        agree += int((t_off[r, :m] == t_on[r, :m]).sum())
        total += m
    print(json.dumps({
        "root": str(args.root), "mel": args.mel,
        "mel_vs_plain_max_abs": float((mel - plain).abs().max()),
        "mel_values_unequal_to_plain": int((mel != plain).sum()),
        "chunks": len(chunks),
        "steps_off": int(l_off[:len(chunks)].max()) - 1,
        "steps_on": int(l_on[:len(chunks)].max()) - 1,
        "rows_at_cap_on": [r for r in range(len(chunks))
                           if l_on[r] >= engine.decode_max_length],
        "greedy_token_agreement_kernel_route_vs_attention_int8":
            agree / total,
        "agree": agree, "tokens": total,
        # the real rows' tokens of each route, to compare runs
        "sha256_kernel_route": hashlib.sha256(
            t_on[:len(chunks)].tobytes()).hexdigest(),
        "sha256_attention_int8_route": hashlib.sha256(
            t_off[:len(chunks)].tobytes()).hexdigest()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
