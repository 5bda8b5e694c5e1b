"""A published Zamba2 decode step and its attention calls, counted from
the configuration's keys (``bench/configs/zamba2-7b-instruct.json``):
parameters, the bytes a step must move, its model flops, and the least
time the card could take for one ``decode_attention`` or
``flash_attention`` call (bytes counted once; a causal prefill counts
only the (query, key) pairs it sees)."""
from __future__ import annotations

from typing import Dict

from bench.counts.peaks import HBM_BYTES_S, TF32_FLOP_S

F32 = 4


def dims(c: Dict) -> Dict[str, int]:
    d = int(c["hidden_size"])
    di = int(c["mamba_expand"]) * d
    G, N = int(c["mamba_ngroups"]), int(c["mamba_d_state"])
    P = int(c["mamba_headdim"])
    return {"d": d, "di": di, "H": di // P, "P": P, "G": G, "N": N,
            "K": int(c["mamba_d_conv"]), "L": int(c["num_hidden_layers"]),
            "J": len(c["hybrid_layer_ids"]),
            "blocks": int(c["num_mem_blocks"]),
            "Hq": int(c["num_attention_heads"]),
            "Hkv": int(c["num_key_value_heads"]),
            "hd": int(c["attention_head_dim"]),
            "ff": int(c["intermediate_size"]), "r": int(c["adapter_rank"]),
            "V": int(c["vocab_size"])}


def mamba_layer_params(c: Dict) -> int:
    """A Mamba layer with its input norm: z, x, B, C, dt projections,
    the convs' taps and biases, A_log, D, dt_bias, the gated norm,
    out_proj."""
    m = dims(c)
    d, di, H, gn = m["d"], m["di"], m["H"], m["G"] * m["N"]
    conv = di + 2 * gn
    return (d * (2 * di + 2 * gn + H) + conv * (m["K"] + 1) + 3 * H + di
            + di * d + d)


def shared_block_params(c: Dict) -> int:
    """One shared block: its two norms, q, k, v from the concatenated
    input, the output projection, the MLP's gate-up and down."""
    m = dims(c)
    d, a = m["d"], m["Hq"] * m["hd"]
    kv = m["Hkv"] * m["hd"]
    return 2 * d + 2 * d * (a + 2 * kv) + a * d + d + 3 * d * m["ff"]


def invocation_params(c: Dict) -> int:
    """One invocation's own adapter (A, B) and linear."""
    m = dims(c)
    return m["d"] * m["r"] + m["r"] * 2 * m["ff"] + m["d"] * m["d"]


def param_count(c: Dict) -> int:
    m = dims(c)
    return (m["V"] * m["d"] + m["d"] + m["L"] * mamba_layer_params(c)
            + m["blocks"] * shared_block_params(c)
            + m["J"] * invocation_params(c))


def weights_read(c: Dict) -> int:
    """Weights a decode step reads, counting each shared block once per
    invocation and the tied table once for the logits."""
    m = dims(c)
    return (m["V"] * m["d"] + m["d"] + m["L"] * mamba_layer_params(c)
            + m["J"] * (shared_block_params(c) + invocation_params(c)))


def step_bytes(c: Dict, batch: int, kv_positions: float) -> float:
    """Bytes one decode step of ``batch`` sessions must move: every
    weight once (``weights_read``), the K/V rows it attends
    (``kv_positions``: positions summed over sessions and invocations)
    and the row each invocation writes, the SSM and conv states read and
    written, the embeddings gathered and the logits written."""
    m = dims(c)
    kv_row = m["Hkv"] * 2 * m["hd"] * F32
    state = m["H"] * m["P"] * m["N"] + (m["K"] - 1) * (m["di"] + 2 * m["G"]
                                                        * m["N"])
    return (weights_read(c) * F32 + kv_positions * kv_row
            + batch * m["J"] * kv_row
            + 2 * m["L"] * batch * state * F32
            + batch * m["d"] * F32 + batch * m["V"] * F32)


def step_flops(c: Dict, batch: int, kv_positions: float) -> float:
    """Model flops of one decode step: 2 a weight a session (the table
    as the head), the score and value products over the attended
    positions, and the SSM's state update and readout (6 a state
    element a session)."""
    m = dims(c)
    return (2.0 * batch * weights_read(c)
            + 2.0 * 2 * m["hd"] * (m["Hq"] // m["Hkv"]) * m["Hkv"]
            * kv_positions
            + 6.0 * m["L"] * batch * m["H"] * m["P"] * m["N"])


def decode_attention_bound_s(batch: int, Hq: int, Hkv: int, D: int, Dv: int,
                             keys: float) -> float:
    """One ``decode_attention`` call: each session's ``keys`` K and V
    rows read once, q read and the output written (bytes over HBM)."""
    by = F32 * (batch * Hkv * keys * (D + Dv) + batch * Hq * (D + Dv))
    return by / HBM_BYTES_S


def flash_attention_bound_s(batch: int, S: int, Hq: int, Hkv: int, D: int,
                            Dv: int, causal: bool = True) -> float:
    """One ``flash_attention`` prefill call over S positions: three TF32
    products (3xTF32) of 2 (D + Dv) flops for each visible (query, key)
    pair and head, over the TF32 peak, or q, k, v read and the output
    written once, over HBM; the larger."""
    pairs = S * (S + 1) / 2 if causal else S * S
    ops = 3 * 2 * (D + Dv) * pairs * Hq * batch / TF32_FLOP_S
    by = F32 * batch * S * (Hq * D + Hkv * (D + Dv) + Hq * Dv) / HBM_BYTES_S
    return max(ops, by)
