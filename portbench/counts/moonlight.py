"""Model FLOPs of one ``octo_moonlight`` tick, and the operations and bytes
of each call of the grouped expert kernels, from the numbers of its
configuration alone (a ``configs/*.json`` file's ``model``).

Counted, at 2 FLOPs per multiply-add: the image tower and the diffusion
head as ``counts.octo`` counts them; in the stack, at the token count of
each block's stage, the latent attention's four projections, its two
products over the (query, key) pairs the mask lets attend (qk at nope +
rope, values at v), the dense block's SwiGLU, and in every routed block
the router, the ``num_experts_per_tok`` chosen experts' SwiGLUs and the
shared experts' (the experts a token did not choose are not work); the
ToMe similarity products between stages.  Not counted: T5 and the text
projection (a served tick reads the cached instruction), norms, RoPE,
activations, softmax, sorting and the merges' averages.

A grouped kernel call's bytes (each read once, each write once): the
weights of every expert that some pair reaches (all of them, at these
token counts: ``min(E, pairs)`` experts), the rows it reads and writes,
and its index and weight tables.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

from ..reference import layout as L
from . import octo

__all__ = ["request_flops", "expert_calls", "expert_bytes_flops"]

_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _stages(m: Mapping) -> List[Tuple[int, int, int]]:
    """(stage, first block, blocks) of each stage of the stack."""
    tr = m["transformer"]
    k = tr["tome_merge_every"]
    n = -(-tr["num_blocks"] // k)
    return [(i, i * k, min(k, tr["num_blocks"] - i * k)) for i in range(n)]


def _stack_flops_per_row(m: Mapping) -> Dict[str, int]:
    tr = m["transformer"]
    d = m["token_embedding_dim"]
    h = tr["attention"]["num_heads"]
    nope, rope, dv = (tr["qk_nope_head_dim"], tr["qk_rope_head_dim"],
                      tr["v_head_dim"])
    rank = tr["kv_lora_rank"]
    f = tr["moe_intermediate_size"]
    sets = L.parse(m["input_sequence"], m["compression_sequence"])
    proj = d * h * (nope + rope) + d * (rank + rope) \
        + rank * h * (nope + dv) + h * dv * d
    out = {"mla": 0, "attention": 0, "dense": 0, "moe": 0, "merge": 0}
    stages = _stages(m)
    for stage, first, blocks in stages:
        s = L.tokens(sets, stage)
        pairs = L.live_pairs(sets, stage)
        out["mla"] += blocks * 2 * s * proj
        out["attention"] += blocks * 2 * pairs * h * (nope + rope + dv)
        for layer in range(first, first + blocks):
            if layer < tr["first_k_dense_replace"]:
                out["dense"] += 2 * s * 3 * d * tr["mlp_dim"]
            else:
                width = (tr["num_experts_per_tok"]
                         + tr["n_shared_experts"]) * f
                out["moe"] += 2 * s * (d * tr["n_routed_experts"]
                                       + 3 * d * width)
        if stage < len(stages) - 1:
            for t in sets:
                if t.at(stage) > t.at(stage + 1):
                    n = t.at(stage)
                    out["merge"] += 2 * ((n + 1) // 2) * (n // 2) * d
    return out


def request_flops(m: Mapping, batch: int) -> Dict[str, int]:
    """FLOPs of one served tick of ``batch`` rows, by part, and their
    'total'."""
    parts = {"image_tower": batch * octo._tower_flops_per_row(m)}
    parts.update({k: batch * v for k, v in _stack_flops_per_row(m).items()})
    parts["head"] = octo._head_flops(m, batch)
    parts["total"] = sum(parts.values())
    return parts


def expert_calls(m: Mapping, batch: int) -> List[Tuple[int, int, int, int,
                                                        int]]:
    """(tokens, experts a token, experts, hidden, expert width) of every
    routed layer's call of the grouped kernels in a tick, in launch
    order."""
    tr = m["transformer"]
    sets = L.parse(m["input_sequence"], m["compression_sequence"])
    calls = []
    for stage, first, blocks in _stages(m):
        for layer in range(first, first + blocks):
            if layer >= tr["first_k_dense_replace"]:
                calls.append((batch * L.tokens(sets, stage),
                              tr["num_experts_per_tok"],
                              tr["n_routed_experts"], m["token_embedding_dim"],
                              tr["moe_intermediate_size"]))
    return calls


def expert_bytes_flops(call: Tuple[int, int, int, int, int],
                       dtype: str) -> Dict[str, Tuple[int, int]]:
    """(bytes, FLOPs) of the gate|up kernel ('gate_up': x rows gathered,
    the SwiGLU rows written) and of the down kernel ('down': SwiGLU rows in,
    weighted rows out) of one call."""
    t, k, e, d, f = call
    b = _BYTES[dtype]
    pairs = t * k
    held = min(e, pairs)
    gate_up = (held * 2 * f * d * b + t * d * b + pairs * f * b
               + pairs * 4 + (e + 1) * 4, 2 * pairs * d * 2 * f)
    down = (held * d * f * b + pairs * f * b + pairs * d * b + pairs * 4
            + (e + 1) * 4, 2 * pairs * f * d)
    return {"gate_up": gate_up, "down": down}
