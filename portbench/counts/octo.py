"""Model FLOPs of one Octo diffusion-policy request, from the numbers of
its configuration alone (the nested dict of a ``configs/*.json`` file's
``model``).

Counted, at 2 FLOPs per multiply-add: the image tower's convolutions (every
output position times the whole kernel, SAME padding included) and dense
layer; in the transformer, every block's projections and MLP at the token
count of its stage, attention's two products over the (query, key) pairs
its mask lets attend, and the ToMe similarity products between stages;
the diffusion head's time encoder, context projections and, at every
step, both denoiser products.  The T5 tower is not counted: a served
request reads the cached instruction and does not run it.  Norms,
activations, softmax and the merges' averages are not counted.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

from ..reference import layout as L

__all__ = ["request_flops", "flash_fwd_calls", "sampler_call"]


def _tower_flops_per_row(m: Mapping) -> int:
    img = m["images"]
    r = img["resnet"]
    p = img["patch_size"]
    frames = m["num_observation_blocks"]
    patches = frames * (img["image_size"][0] // p) ** 2
    k, s = r["input_kernel"][0], r["input_stride"][0]
    side = (p - k) // s + 1
    flops = 2 * side * side * r["features"] * img["image_size"][2] * k * k
    side = (side - r["pool_window"][0]) // r["pool_stride"][0] + 1
    bk = r["block_kernel"][0]
    flops += r["num_blocks"] * 2 * side * side * r["features"] ** 2 * bk * bk
    flops += 2 * side * side * r["features"] * r["output_features"]
    return patches * flops


def _stages(m: Mapping) -> List[Tuple[int, int]]:
    """(compression event, blocks) of each stage of the transformer."""
    tr = m["transformer"]
    sets = L.parse(m["input_sequence"], m["compression_sequence"])
    staged = tr["compression_mode"] == "merge" and any(s.shed for s in sets)
    if not staged:
        return [(0, tr["num_blocks"])]
    k = tr["tome_merge_every"]
    n = -(-tr["num_blocks"] // k)
    return [(i, min(k, tr["num_blocks"] - i * k)) for i in range(n)]


def _transformer_flops_per_row(m: Mapping) -> Dict[str, int]:
    tr = m["transformer"]
    e = m["token_embedding_dim"]
    qkv = tr["attention"]["qkv_features"]
    sets = L.parse(m["input_sequence"], m["compression_sequence"])
    dense = attention = merge = 0
    stages = _stages(m)
    for event, blocks in stages:
        s = L.tokens(sets, event)
        dense += blocks * (2 * s * e * 3 * qkv + 2 * s * qkv * e
                           + 2 * 2 * s * e * tr["mlp_dim"])
        attention += blocks * 2 * 2 * L.live_pairs(sets, event) * qkv
        if event < len(stages) - 1:
            for t in sets:
                if t.at(event) > t.at(event + 1):
                    n = t.at(event)
                    merge += 2 * ((n + 1) // 2) * (n // 2) * e
    return {"transformer": dense + merge, "attention": attention}


def _head_flops(m: Mapping, batch: int) -> int:
    c = m["heads"]["diffusion"]
    e = m["token_embedding_dim"]
    steps, h, a, td = (c["diffusion_steps"], c["mlp_dim"],
                       c["action_space_dim"], c["time_dim"])
    per_request = steps * (2 * (td // 2) + 2 * td * h + 2 * h * td
                           + 2 * td * h)
    per_row = 2 * e * h + steps * 2 * 2 * a * h
    return per_request + batch * per_row


def request_flops(m: Mapping, batch: int) -> Dict[str, int]:
    """FLOPs of one served request of ``batch`` rows, by part, and their
    'total'."""
    parts = {"image_tower": batch * _tower_flops_per_row(m)}
    parts.update({k: batch * v
                  for k, v in _transformer_flops_per_row(m).items()})
    parts["head"] = _head_flops(m, batch)
    parts["total"] = sum(parts.values())
    return parts


def flash_fwd_calls(m: Mapping, batch: int) -> List[Tuple[int, ...]]:
    """(b, s, h, d, nnz) of every flash forward launch of one request, in
    launch order: one a block, at its stage's token count and mask."""
    tr = m["transformer"]
    h = tr["attention"]["num_heads"]
    d = tr["attention"]["qkv_features"] // h
    sets = L.parse(m["input_sequence"], m["compression_sequence"])
    calls = []
    for event, blocks in _stages(m):
        call = (batch, L.tokens(sets, event), h, d,
                L.live_pairs(sets, event))
        calls.extend([call] * blocks)
    return calls


def sampler_call(m: Mapping, batch: int) -> Tuple[int, int, int, int]:
    """(batch, steps, hidden, action dim) of the fused reverse loop."""
    c = m["heads"]["diffusion"]
    return batch, c["diffusion_steps"], c["mlp_dim"], c["action_space_dim"]
