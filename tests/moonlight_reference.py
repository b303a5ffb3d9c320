"""Plain float32 reference of the Moonlight-16B-A3B decoder stack as the
Octo policy's transformer, for the CPU tests of the port's
``modules/latent_moe.py``.

Written from DeepSeek-V3's modelling code (Moonlight's ``model_type`` is
``deepseek_v3``) and imports nothing of the port and no JAX: plain
``torch`` in float32 with TF32 off (:func:`exact_float32`), no kernels, no
graphs, no batching tricks; each routed expert is a loop over the tokens
that chose it.

The block, for hidden x:

* ``h = x + mla(rms(x))``, then ``h + ffn(rms(h))``; pre-RMSNorm, eps from
  the configuration; a final RMSNorm after the last block;
* latent attention with no query compression: ``q = W_q x`` ->
  H x (nope + rope); ``[c_kv; k_pe] = W_kva x`` (kv_lora_rank + rope, k_pe
  shared by the heads); ``c_kv <- rms(c_kv)``; ``[k_nope; v] = W_kvb c_kv``
  -> H x (nope + v); RoPE on q_pe and k_pe; softmax of ``q.k *
  (nope + rope)^-1/2`` under the stage's mask; ``W_o`` of the values;
* blocks before ``first_k_dense_replace``: ``W_down(silu(W_gate x) * W_up
  x)`` of width ``mlp_dim``; the others: scores ``sigmoid(W_r x)`` in
  float32; the top ``k`` experts by ``score + bias`` (the bias only
  chooses); weights the chosen scores over their sum, times
  ``routed_scaling_factor``; output ``shared(x) + sum_i w_i expert_i(x)``,
  the shared experts one SwiGLU of ``n_shared * moe_intermediate_size``.

Departures from the published model, each the Octo policy's:

* no token embedding and no LM head: the tokens come from Octo's towers and
  the readouts feed the action head;
* Octo's block-causal stage masks, not a causal mask;
* ToMe merges between stages of ``tome_merge_every`` blocks (Bolya et al.,
  arXiv:2210.09461, per token set, cosine similarity of the hidden state,
  alternate tokens as sources and destinations, the best-matched sources
  averaged into their partners by size); each token's RoPE position starts
  at its index in the sequence and is averaged like the hidden state, so
  positions become fractional;
* RoPE turns interleaved pairs (2i, 2i + 1) in place; DeepSeek-V3's code
  turns the same pairs and writes them de-interleaved, a permutation shared
  by q and k that leaves every logit as it is;
* ties among equal routing scores go to the lower expert index.

Weights are a mapping from the port's parameter names (``stage_{i}.{j}.``
prefixes) to tensors; the configuration is a dict of the transformer
group's numbers.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Mapping, Sequence

import torch
import torch.nn.functional as F

__all__ = ["exact_float32", "rms", "rope", "latent_attention", "swiglu",
           "route", "routed_layer", "merge", "stack"]


@contextlib.contextmanager
def exact_float32():
    """Float32 products without TF32, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]


def rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, positions, theta):
    """x (B, S, H, d) turned by (B, S) positions in pairs (2i, 2i + 1) by
    ``position * theta^(-2i / d)``."""
    d = x.shape[-1]
    freq = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64) / d)
    angle = (positions.double()[..., None] * freq).float()[:, :, None]
    cos, sin = torch.cos(angle), torch.sin(angle)
    a, b = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = a * cos - b * sin
    out[..., 1::2] = a * sin + b * cos
    return out


def latent_attention(x, w: Mapping, pre: str, c: Mapping, positions, mask):
    b, s, _ = x.shape
    h = c["attention"]["num_heads"]
    nope, rp, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], \
        c["v_head_dim"]
    q = (x @ w[pre + "q_proj.weight"].T).reshape(b, s, h, nope + rp)
    kva = x @ w[pre + "kv_a_proj.weight"].T
    c_kv, k_pe = kva[..., :c["kv_lora_rank"]], kva[..., c["kv_lora_rank"]:]
    c_kv = rms(c_kv, w[pre + "kv_a_norm.weight"], c["rms_norm_eps"])
    kv = (c_kv @ w[pre + "kv_b_proj.weight"].T).reshape(b, s, h, nope + dv)
    q_pe = rope(q[..., nope:], positions, c["rope_theta"])
    k_pe = rope(k_pe[:, :, None], positions, c["rope_theta"])
    qf = torch.cat([q[..., :nope], q_pe], -1)
    kf = torch.cat([kv[..., :nope], k_pe.expand(b, s, h, rp)], -1)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) / math.sqrt(nope + rp)
    logits = logits.masked_fill(~mask, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1),
                     kv[..., nope:])
    return o.reshape(b, s, h * dv) @ w[pre + "out.weight"].T


def swiglu(x, gate_up, down):
    g, u = (x @ gate_up.T).chunk(2, dim=-1)
    return (F.silu(g) * u) @ down.T


def route(x, weight, bias, k: int, scale: float):
    """(T, D) -> (T, k) weights and experts: top k of sigmoid score + bias,
    the lower index first among equals."""
    scores = torch.sigmoid(x @ weight.T)
    choice = scores + bias
    experts = []
    for row in choice:
        # the k largest, the lower index first among equals
        experts.append(sorted(range(row.numel()),
                              key=lambda e: (-row[e].item(), e))[:k])
    experts = torch.tensor(experts, dtype=torch.long)
    top = torch.gather(scores, 1, experts)
    return top / top.sum(-1, keepdim=True) * scale, experts


def routed_layer(x, w: Mapping, pre: str, c: Mapping, routing=None):
    """The dropless layer on (T, D) rows: each expert a loop over the
    tokens that chose it.  ``routing`` (weights, experts) replaces the
    router's choice where given."""
    if routing is None:
        routing = route(x, w[pre + "router.weight"], w[pre + "router.bias"],
                        c["num_experts_per_tok"], c["routed_scaling_factor"])
    weights, experts = routing
    out = swiglu(x, w[pre + "shared.gate_up.weight"],
                 w[pre + "shared.down.weight"])
    for e in range(w[pre + "w_gate_up"].shape[0]):
        for t, slot in (experts == e).nonzero().tolist():
            out[t] = out[t] + weights[t, slot] * swiglu(
                x[t], w[pre + "w_gate_up"][e], w[pre + "w_down"][e])
    return out


def merge(x, size, positions, r: int):
    """ToMe merge of one token set: r sources of the even half join their
    most similar odd token (cosine of x), averaged by size; (B, n, E),
    (B, n, 1), (B, n) -> (B, n - r, ...), the kept sources first."""
    unit = x / x.norm(dim=-1, keepdim=True)
    scores = unit[:, ::2] @ unit[:, 1::2].transpose(1, 2)
    best, partner = scores.max(dim=-1)
    order = torch.sort(best, dim=-1, descending=True, stable=True).indices
    src, kept = order[:, :r], order[:, r:].sort(dim=-1).values
    dst = torch.gather(partner, 1, src)
    out = []
    for t in (x * size, size, positions[..., None] * size):
        width = t.shape[-1]
        even, odd = t[:, ::2], t[:, 1::2].clone()
        moved = torch.gather(even, 1, src[..., None].expand(-1, -1, width))
        odd.scatter_add_(1, dst[..., None].expand(-1, -1, width), moved)
        keep = torch.gather(even, 1, kept[..., None].expand(-1, -1, width))
        out.append(torch.cat([keep, odd], dim=1))
    return out[0] / out[1], out[1], (out[2] / out[1])[..., 0]


def stack(x, w: Mapping, c: Mapping, masks: Sequence[torch.Tensor],
          sets: Sequence[Sequence[int]]):
    """The stack on the assembled (B, S, D) tokens.  ``masks``: each
    stage's (S_i, S_i) bool mask; ``sets``: each token set's count at each
    stage, in sequence order."""
    b, s, _ = x.shape
    k = c["tome_merge_every"]
    stages = -(-c["num_blocks"] // k)
    size = torch.ones(b, s, 1)
    positions = torch.arange(s, dtype=torch.float32).expand(b, s)
    eps = c["rms_norm_eps"]
    for st in range(stages):
        for layer in range(st * k, min(c["num_blocks"], (st + 1) * k)):
            pre = f"transformer.stage_{st}.{layer - st * k}."
            x = x + latent_attention(rms(x, w[pre + "ln_attention.weight"],
                                         eps), w, pre + "attention.", c,
                                     positions, masks[st])
            y = rms(x, w[pre + "ln_mlp.weight"], eps)
            if layer < c["first_k_dense_replace"]:
                x = x + swiglu(y, w[pre + "mlp.gate_up.weight"],
                               w[pre + "mlp.down.weight"])
            else:
                x = x + routed_layer(y.reshape(b * y.shape[1], -1), w,
                                     pre + "moe.", c).reshape(y.shape)
        if st < stages - 1:
            parts: List = [[], [], []]
            cur = 0
            for counts in sets:
                n, r = counts[st], counts[st] - counts[st + 1]
                piece = (x[:, cur:cur + n], size[:, cur:cur + n],
                         positions[:, cur:cur + n])
                if r > 0:
                    piece = merge(*piece, r)
                for part, p in zip(parts, piece):
                    part.append(p)
                cur += n
            x, size, positions = (torch.cat(p, dim=1) for p in parts)
    if c["final_norm"]:
        x = rms(x, w["transformer.final_norm.weight"], eps)
    return x


def float32_weights(model) -> Dict[str, torch.Tensor]:
    """The parameters of a module as float32 CPU tensors, by name."""
    return {n: p.detach().float().cpu() for n, p in model.named_parameters()}
