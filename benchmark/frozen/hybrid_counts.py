"""The hybrid decoder's yardstick: the FLOPs its served tokens need and the
bytes kernel 6 moves, from the configuration's sizes alone (HF key
names, as ``configs/<config>.json``'s ``model`` holds them).

FLOPs are the model's, counted as 2 a multiply-add: per position the
projections of every layer (Mamba ``in_proj`` and ``out_proj``, attention
q, k, v and o), the router, the top-k experts' gate, up and down
matrices and the shared MLP; the depthwise conv; the SSM recurrence
(update and readout, 4 H P N); attention's scores and weighted sum over
the positions up to the query (4 Hq D n); the projector at prefix
positions and the tied head at decoded ones.
"""

from __future__ import annotations

#: the H100 SXM's memory bandwidth (data sheet)
HBM_BYTES_PER_S = 3.35e12


def kinds(m: dict) -> list:
    return list(m["layer_types"][:int(m["num_hidden_layers"])])


def _ssm(m: dict):
    H, P = int(m["mamba_n_heads"]), int(m["mamba_d_head"])
    G, N = int(m["mamba_n_groups"]), int(m["mamba_d_state"])
    return H, P, G, N


def _per_position(m: dict):
    """(FLOPs of every layer at one position without attention's reads,
    FLOPs per position attention reads) (head and projector excluded)."""
    d = int(m["hidden_size"])
    H, P, G, N = _ssm(m)
    inner = H * P
    conv = inner + 2 * G * N
    Hq, Hk = int(m["num_attention_heads"]), int(m["num_key_value_heads"])
    D = d // Hq
    k, E = int(m["num_experts_per_tok"]), int(m["num_local_experts"])
    I, S = int(m["intermediate_size"]), int(m["shared_intermediate_size"])
    ffn = 2 * d * E + k * 2 * 3 * d * I + 2 * 3 * d * S
    fixed, per_key = 0.0, 0.0
    for kind in kinds(m):
        if kind == "mamba":
            fixed += 2 * d * (inner + conv + H) + 2 * inner * d \
                + 2 * int(m["mamba_d_conv"]) * conv + 4 * H * P * N
        else:
            fixed += 2 * d * (2 * Hq * D + 2 * Hk * D)
            per_key += 4 * Hq * D
        fixed += ffn
    return fixed, per_key


def position_flops(m: dict, keys: int) -> float:
    """FLOPs of every layer at one position that attends over ``keys``
    positions (head and projector excluded)."""
    fixed, per_key = _per_position(m)
    return fixed + per_key * keys


def _positions(m: dict, first: int, count: int, extra: float) -> float:
    """Positions first .. first + count - 1 (reading 1 + their index
    keys), each with ``extra`` FLOPs more."""
    fixed, per_key = _per_position(m)
    keys = count * first + count * (count + 1) / 2  # sum of index + 1
    return count * (fixed + extra) + per_key * keys


def prefill_flops(m: dict, positions: int) -> float:
    """A row's prefill over ``positions`` prefix positions."""
    return _positions(m, 0, positions,
                      2 * int(m["prefix_dim"]) * int(m["hidden_size"]))


def decode_flops(m: dict, prefix: int, steps: int) -> float:
    """A row's ``steps`` decode steps after a prefix of ``prefix``
    positions: step s reads prefix + s + 1 positions and ends in the
    head."""
    return _positions(m, prefix, steps,
                      2 * int(m["hidden_size"]) * int(m["vocab_size"]))


def row_flops(m: dict, prefix: int, steps: int) -> float:
    return prefill_flops(m, prefix) + decode_flops(m, prefix, steps)


def state_update_bytes(m: dict, rows: int, state_bytes: int = 4) -> float:
    """Kernel 6's bytes in one launch over ``rows`` rows: the state read
    and written once, x and y, dt, B and C, A and D."""
    H, P, G, N = _ssm(m)
    return rows * (2 * H * P * N * state_bytes + 2 * H * P * 4 + H * 4
                   + 2 * G * N * 4) + 2 * H * 4


def state_update_bound_s(m: dict, rows: int, steps: int,
                         state_bytes: int = 4) -> float:
    """The least time of a batch's kernel 6 launches: one a Mamba layer a
    step, each bound by its bytes."""
    layers = kinds(m).count("mamba")
    return steps * layers * state_update_bytes(m, rows, state_bytes) \
        / HBM_BYTES_PER_S
