"""Plain float32 PyTorch reference of the Octo policy on Moonlight-16B-A3B's
decoder layers (configuration ``octo_moonlight``): observation and
instruction in, actions out.

It imports nothing of the program under test.  T5, the image tower, the
readouts, the merges' plan and the diffusion head are those of
:class:`reference.octo.OctoReference`; T5-base's 768-wide output is
projected to the tokens' width by a dense layer (``text_projection``).
The stack is written from DeepSeek-V3's modelling code (Moonlight's
``model_type``):

* ``h = x + mla(rms(x))``, then ``h + ffn(rms(h))``; a final RMSNorm;
* latent attention with no query compression: ``q = W_q x`` -> H x (nope
  + rope); ``[c_kv; k_pe] = W_kva x`` (k_pe shared by the heads);
  ``c_kv <- rms(c_kv)``; ``[k_nope; v] = W_kvb c_kv``; RoPE (theta from the
  configuration) on q_pe and k_pe; softmax of ``q.k * (nope + rope)^-1/2``
  under the stage's block-causal mask; ``W_o`` of the values; no biases;
* the first ``first_k_dense_replace`` blocks a SwiGLU MLP; the others the
  float32 router (``sigmoid(W_r x)``, top k by score + bias, the lower
  index first among equals, the chosen scores normalised and scaled by
  ``routed_scaling_factor``), each expert a SwiGLU over the tokens that
  chose it, plus the shared experts, unweighted; no capacity.

Departures from the published model, each the Octo policy's: no token
table and no LM head; Octo's block-causal masks; ToMe merges between
stages of ``tome_merge_every`` blocks, each token's RoPE position starting
at its index in the sequence and averaged by size through every merge
like the hidden state; RoPE turns interleaved pairs in place (the
published code's de-interleaved layout is a permutation shared by q and k).

The weights are handed in as drawn, in bfloat16 (the stack alone is 28.5
GiB); every product upcasts its weight to float32 where it is used, one
layer's tensors at a time, and runs with TF32 off
(``reference.octo.exact_float32``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import layout as L
from .octo import OctoReference

__all__ = ["MoonlightReference"]


class MoonlightReference(OctoReference):
    """The ``octo_moonlight`` policy (``model``: its configuration as a
    nested dict) over ``weights`` (name -> tensor)."""

    def __init__(self, model, weights, device, operands=None):
        self.operands = operands
        self.m = model
        self.w = weights
        self.device = torch.device(device)
        tr = model["transformer"]
        unsupported = {
            "compression_mode": tr["compression_mode"] != "merge",
            "text.kind": model["text"]["kind"] != "t5",
            "images.resnet.norm_stats_scope":
                model["images"]["resnet"]["norm_stats_scope"] != "image",
            "heads.diffusion.num_blocks":
                model["heads"]["diffusion"]["num_blocks"] != 1,
            "heads.diffusion.sampler_rng_mode":
                model["heads"]["diffusion"]["sampler_rng_mode"] != "folded",
            "heads.diffusion.ddim_steps":
                model["heads"]["diffusion"]["ddim_steps"] is not None,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(f"the reference does not model {bad}")
        self.sets = L.parse(model["input_sequence"],
                            model["compression_sequence"])
        self.staged = True

    def q(self, x):
        """A product's operand as the reference multiplies it: bfloat16
        operands (the configuration's precision, for the calibration's
        witness) by a plain cast; float8 scaled, as ``OctoReference``."""
        if self.operands == torch.bfloat16:
            return x.to(torch.bfloat16).float()
        return super().q(x)

    def encode_text(self, ids):
        return self._linear(super().encode_text(ids), "text_projection")

    # -- the stack ----------------------------------------------------------

    def _rms(self, x, name):
        eps = self.m["transformer"]["rms_norm_eps"]
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
            * self.p(name)

    def _rope(self, x, positions):
        """x (B, S, H, d) turned by (B, S) positions in pairs (2i, 2i+1)."""
        d = x.shape[-1]
        theta = self.m["transformer"]["rope_theta"]
        freq = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                            device=self.device) / d)
        angle = (positions.double()[..., None] * freq).float()[:, :, None]
        cos, sin = torch.cos(angle), torch.sin(angle)
        a, b = x[..., 0::2], x[..., 1::2]
        return torch.stack((a * cos - b * sin, a * sin + b * cos),
                           dim=-1).flatten(-2)

    def _attention(self, x, pre, positions, mask):
        tr = self.m["transformer"]
        b, s, _ = x.shape
        h = tr["attention"]["num_heads"]
        nope, rp, dv = (tr["qk_nope_head_dim"], tr["qk_rope_head_dim"],
                        tr["v_head_dim"])
        rank = tr["kv_lora_rank"]
        q = self._linear(x, pre + "q_proj", bias=False).reshape(
            b, s, h, nope + rp)
        kva = self._linear(x, pre + "kv_a_proj", bias=False)
        c_kv = self._rms(kva[..., :rank], pre + "kv_a_norm.weight")
        kv = self._linear(c_kv, pre + "kv_b_proj", bias=False).reshape(
            b, s, h, nope + dv)
        q_pe = self._rope(q[..., nope:], positions)
        k_pe = self._rope(kva[..., None, rank:], positions)
        qf = torch.cat([q[..., :nope], q_pe], -1)
        kf = torch.cat([kv[..., :nope], k_pe.expand(b, s, h, rp)], -1)
        logits = self.einsum("bqhd,bkhd->bhqk", qf, kf) / math.sqrt(nope + rp)
        logits = logits.masked_fill(~mask, float("-inf"))
        o = self.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1),
                        kv[..., nope:])
        return self._linear(o.reshape(b, s, h * dv), pre + "out", bias=False)

    def _swiglu(self, x, gate_up, down):
        g, u = self.linear(x, gate_up).chunk(2, dim=-1)
        return self.linear(F.silu(g) * u, down)

    def _routed(self, x, pre):
        """The dropless layer on (T, D) rows."""
        tr = self.m["transformer"]
        k = tr["num_experts_per_tok"]
        scores = torch.sigmoid(self.linear(x, self.p(pre + "router.weight")))
        order = torch.sort(scores + self.p(pre + "router.bias"), dim=-1,
                           descending=True, stable=True).indices
        experts = order[:, :k]
        weights = torch.gather(scores, 1, experts)
        weights = weights / weights.sum(-1, keepdim=True) \
            * tr["routed_scaling_factor"]
        out = self._swiglu(x, self.p(pre + "shared.gate_up.weight"),
                           self.p(pre + "shared.down.weight"))
        gate_up, down = self.p(pre + "w_gate_up"), self.p(pre + "w_down")
        for e in range(gate_up.shape[0]):
            tok, slot = (experts == e).nonzero(as_tuple=True)
            if tok.numel():
                y = self._swiglu(x[tok], gate_up[e], down[e])
                out.index_add_(0, tok, weights[tok, slot, None] * y)
        del gate_up, down
        return out

    def _merge_positions(self, x, size, positions, st):
        parts, sizes, places, cur = [], [], [], 0
        for s in self.sets:
            n, r = s.at(st), s.at(st) - s.at(st + 1)
            xi, si = x[:, cur:cur + n], size[:, cur:cur + n]
            pi = positions[:, cur:cur + n, None]
            if r > 0:
                # the merge of the hidden state with the positions beside it
                # as one more channel: averaged by the same plan and sizes
                e = xi.shape[-1]
                merged, si = self._merge_with(xi, si, pi, r)
                xi, pi = merged[..., :e], merged[..., e:]
            parts.append(xi)
            sizes.append(si)
            places.append(pi)
            cur += n
        return (torch.cat(parts, 1), torch.cat(sizes, 1),
                torch.cat(places, 1)[..., 0])

    def _merge_with(self, x, size, extra, r):
        """:meth:`OctoReference._merge`'s plan, chosen on x alone, applied
        to x and ``extra`` together."""
        unit = x / x.norm(dim=-1, keepdim=True)
        scores = unit[:, ::2] @ unit[:, 1::2].transpose(1, 2)
        best, partner = scores.max(dim=-1)
        order = torch.sort(best, dim=-1, descending=True, stable=True).indices
        src, kept = order[:, :r], order[:, r:].sort(dim=-1).values
        dst = torch.gather(partner, 1, src)
        out = []
        for t in (torch.cat([x, extra], -1) * size, size):
            width = t.shape[-1]
            even, odd = t[:, ::2], t[:, 1::2].clone()
            moved = torch.gather(even, 1, src[..., None].expand(-1, -1, width))
            odd.scatter_add_(1, dst[..., None].expand(-1, -1, width), moved)
            keep = torch.gather(even, 1, kept[..., None].expand(-1, -1, width))
            out.append(torch.cat([keep, odd], dim=1))
        return out[0] / out[1], out[1]

    def transformer(self, x):
        tr = self.m["transformer"]
        k = tr["tome_merge_every"]
        stages = -(-tr["num_blocks"] // k)
        b, s, _ = x.shape
        size = torch.ones_like(x[..., :1])
        positions = torch.arange(s, dtype=torch.float32,
                                 device=self.device).expand(b, s)
        for st in range(stages):
            mask = torch.as_tensor(L.attention_mask(self.sets, st),
                                   device=self.device)
            for layer in range(st * k, min(tr["num_blocks"], (st + 1) * k)):
                pre = f"transformer.stage_{st}.{layer - st * k}."
                x = x + self._attention(
                    self._rms(x, pre + "ln_attention.weight"),
                    pre + "attention.", positions, mask)
                y = self._rms(x, pre + "ln_mlp.weight")
                if layer < tr["first_k_dense_replace"]:
                    x = x + self._swiglu(y, self.p(pre + "mlp.gate_up.weight"),
                                         self.p(pre + "mlp.down.weight"))
                else:
                    x = x + self._routed(y.reshape(-1, y.shape[-1]),
                                         pre + "moe.").reshape(y.shape)
            if st < stages - 1:
                x, size, positions = self._merge_positions(x, size, positions,
                                                           st)
        if tr["final_norm"]:
            x = self._rms(x, "transformer.final_norm.weight")
        return x, stages - 1
