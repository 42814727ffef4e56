"""How far each bf16 decode route of the port is from the JAX engine's, on
one saved encoder output.

Reads the npz that ``tools/song_agreement.py --save-encoder`` writes on a
CUDA card (the song's encoder output in bf16 and the greedy tokens of the
port's two int8-KV routes there: kernel 3 with ``round_pv``, and plain
``_attention_int8``), decodes the same encoder output on the CPU through

  * the JAX engine's serving decode (``music2midi_tpu`` ``generate_tokens``
    in bf16 with int8 self- and cross-KV: ``_attention_int8``, the
    reference's arithmetic), and
  * the port's two routes (``pallas_attention`` off: ``_attention_int8``;
    on: the launch plan, whose CPU path is the kernel's plain version),

and prints one JSON line: the greedy-token agreement of every route with
the JAX decode, over all rows and over the rows where the card's two
routes differ; for each of those rows, the position where each route
first leaves the JAX tokens (its matching prefix) and its length; the
rows each route decodes exactly as JAX does; and the agreement of the
card's two routes.  ``--save-jax`` keeps the JAX decode in an npz, and a
second run with ``--jax`` reads it back instead of decoding again.  Like
the tests, it imports both packages; it runs on the CPU only:

    JAX_PLATFORMS=cpu python3 tools/c1_distance.py chiprun_out/c1/enc.npz
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RECORD = ROOT / "checkpoints" / "model_of_record.npz"


def agreement(a_tok, a_len, b_tok, b_len, rows) -> tuple:
    """(equal tokens, tokens) over `rows`, each row compared up to the
    longer of its two lengths (``chip_smoke.py``'s song_timing measure)."""
    same = total = 0
    for r in rows:
        m = int(max(a_len[r], b_len[r]))
        same += int((a_tok[r, :m] == b_tok[r, :m]).sum())
        total += m
    return same, total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("npz", help="the file song_agreement.py --save-encoder "
                                "wrote")
    ap.add_argument("--max-length", type=int, default=1024)
    ap.add_argument("--save-jax", help="write the JAX decode to this .npz")
    ap.add_argument("--jax", help="read the JAX decode from this .npz")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import jax.numpy as jnp
    import numpy as np
    import torch

    from music2midi_tpu.infer.decode import DecodeConfig as JaxDecodeConfig
    from music2midi_tpu.infer.decode import generate_tokens as jax_generate
    from music2midi_tpu.models import t5 as jt5
    from music2midi_tpu.train.checkpoint import load_params_npz
    from music2midi_tpu_torch.infer import Music2MIDI
    from music2midi_tpu_torch.infer.decode import generate_tokens

    saved = np.load(args.npz)
    bits = saved["encoder_bf16_bits"]
    enc = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    rows = range(enc.shape[0])
    routes = {"card_kernel": (saved["tokens_kernel"], saved["lengths_kernel"]),
              "card_plain": (saved["tokens_plain"], saved["lengths_plain"])}

    if args.jax:
        kept = np.load(args.jax)
        jax_tl = (kept["tokens"], kept["lengths"])
    else:
        params, config = load_params_npz(RECORD)
        jcfg = jt5.t5_config_from(config, dtype=jnp.bfloat16)
        jt, jl = jax_generate(
            params, jnp.asarray(enc.float().numpy()).astype(jnp.bfloat16),
            jcfg, JaxDecodeConfig(max_length=args.max_length,
                                  quantize_cross_kv=True,
                                  quantize_self_kv=True))
        jax_tl = (np.asarray(jt), np.asarray(jl))
    if args.save_jax:
        np.savez(args.save_jax, tokens=jax_tl[0], lengths=jax_tl[1])

    engine = Music2MIDI.from_npz(RECORD, dtype=torch.bfloat16, device="cpu")
    engine.decode_max_length = args.max_length
    for name, on in (("cpu_plain", False), ("cpu_kernel_plain_version", True)):
        t, n = generate_tokens(engine.model, enc, engine.t5_config,
                               engine._dcfg()._replace(pallas_attention=on))
        routes[name] = (t.numpy(), n.numpy())

    ka, kl = routes["card_kernel"]
    pa, pl = routes["card_plain"]
    diverging = [r for r in rows
                 if not np.array_equal(ka[r, :max(kl[r], pl[r])],
                                       pa[r, :max(kl[r], pl[r])])]
    out = {"rows": len(rows), "rows_where_card_routes_differ": diverging}
    for name, (t, n) in routes.items():
        for label, which in (("all", rows), ("diverging", diverging)):
            same, total = agreement(t, n, *jax_tl, which)
            out[f"{name}_vs_jax_{label}"] = [same / max(total, 1), same,
                                             total]
    jt, jl = jax_tl
    for name, (t, n) in routes.items():
        out[f"{name}_rows_equal_to_jax"] = sum(
            int(np.array_equal(t[r, :jl[r]], jt[r, :jl[r]]) and n[r] == jl[r])
            for r in rows)
        # per diverging row: (first position off the JAX tokens, length)
        out[f"{name}_first_off_jax"] = {
            r: [int(np.argmax(t[r, :max(n[r], jl[r])]
                              != jt[r, :max(n[r], jl[r])])), int(n[r])]
            for r in diverging}
    out["jax_lengths_diverging"] = {r: int(jl[r]) for r in diverging}
    same, total = agreement(ka, kl, pa, pl, rows)
    out["card_kernel_vs_card_plain_all"] = [same / total, same, total]
    out["jax_steps"] = int(jax_tl[1].max()) - 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
