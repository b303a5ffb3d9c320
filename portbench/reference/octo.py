"""Plain float32 PyTorch reference of an Octo diffusion policy: observation
and instruction in, actions out.

It is written from the published architecture and imports nothing of the
program under test: a frozen T5 encoder (unscaled embeddings, bucketed
relative-position bias shared by all layers, pre-RMSNorm blocks, unscaled
attention, a ReLU MLP, a final RMSNorm); the Gato-style image tokenizer
(patches normalised to [-1, 1], each through a ResNetV2 stem: a strided
convolution, a max pool, GroupNorm -> GELU -> convolution blocks whose
statistics pool over every patch of an observation, the residual, a dense
layer over the (channel, row, column) flattened map, plus learned row and
column position embeddings at interval midpoints); learned readout tokens;
the block-causal pre-LN transformer, optionally as stages of blocks with a
ToMe bipartite merge of the hidden state between stages (Bolya et al.,
arXiv:2210.09461: cosine similarity, alternate tokens split into sources
and destinations, the r best-matched sources averaged into their partners
by the number of tokens each stands for); and the DDPM diffusion head with
a cosine schedule whose reverse loop clips every sample.

Weights are handed in as a mapping from parameter name to tensor, the
names of the program's state dict, so that the benchmark can hand the same
drawn tensors to both sides.  Every product runs in float32 with TF32 off
(:func:`exact_float32`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import layout as L

__all__ = ["OctoReference", "exact_float32", "cosine_schedule"]


@contextlib.contextmanager
def exact_float32():
    """Float32 products without TF32, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def cosine_schedule(steps: int, s: float = 0.008):
    """(betas, alphas, alpha_hats) of the cosine schedule (Nichol and
    Dhariwal, arXiv:2102.09672), float64."""
    t = np.linspace(0, steps, steps + 1) / steps
    f = np.cos((t + s) / (1 + s) * np.pi / 2) ** 2
    betas = np.clip(1 - f[1:] / f[:-1], 0, 0.999)
    alphas = 1 - betas
    return betas, alphas, np.cumprod(alphas)


def t5_buckets(t: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """Bidirectional T5 relative-position buckets, (query, key)."""
    rel = np.arange(t)[None, :] - np.arange(t)[:, None]
    n = num_buckets // 2
    out = (rel > 0).astype(np.int64) * n
    rel = np.abs(rel)
    exact = n // 2
    large = exact + (np.log(np.maximum(rel, 1) / exact)
                     / np.log(max_distance / exact)
                     * (n - exact)).astype(np.int64)
    return out + np.where(rel < exact, rel, np.minimum(large, n - 1))


def _rms(x, w, eps=1e-6):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _ln(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


class OctoReference:
    """The policy of one configuration (``model``: the configuration as a
    nested dict of its numbers) over ``weights`` (name -> tensor)."""

    def __init__(self, model: Mapping, weights: Mapping[str, torch.Tensor],
                 device, operands: Optional[torch.dtype] = None):
        """``operands``: a dtype (``torch.float8_e4m3fn``) to which every
        product's operands are rounded, each tensor scaled by its own
        absolute maximum first; None keeps float32.  The benchmark's
        control runs the reference so."""
        self.operands = operands
        self.m = model
        self.w = weights
        self.device = torch.device(device)
        tr = model["transformer"]
        unsupported = {
            "mlp_activation": tr["mlp_activation"] != "relu",
            "mlp_type": tr["mlp_type"] != "dense",
            "layer_norm_reduction": tr["layer_norm_reduction"] != "features",
            "prestack_merge": tr["prestack_merge"],
            "proportional_attention": tr["proportional_attention"],
            "compression_mode": tr["compression_mode"] not in ("none",
                                                               "merge"),
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
        self.staged = (tr["compression_mode"] == "merge"
                       and any(s.shed for s in self.sets))
        if self.staged and tr["tome_merge_every"] <= 1:
            raise ValueError("the reference models staged merging only")

    def p(self, name: str) -> torch.Tensor:
        return self.w[name].to(self.device, torch.float32)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """A product's operand as the reference multiplies it."""
        if self.operands is None:
            return x
        top = torch.finfo(self.operands).max
        scale = x.abs().amax().clamp_min(1e-30) / top
        return (x / scale).to(self.operands).float() * scale

    def einsum(self, spec, a, b):
        return torch.einsum(spec, self.q(a), self.q(b))

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def _linear(self, x, name, bias=True):
        return self.linear(x, self.p(name + ".weight"),
                           self.p(name + ".bias") if bias else None)

    # -- text ---------------------------------------------------------------

    def encode_text(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, T) ids -> (B, T, E)."""
        c = self.m["text"]
        pre = "text_encoder.t5_encoder."
        h, d = c["t5_num_heads"], c["t5_d_kv"]
        b, t = ids.shape
        x = self.p(pre + "token_embedding.weight")[ids.to(self.device)]
        buckets = torch.as_tensor(
            t5_buckets(t, c["t5_rel_pos_buckets"],
                       c["t5_rel_pos_max_distance"]), device=self.device)
        bias = self.p(pre + "relative_attention_bias.weight")[buckets]
        bias = bias.permute(2, 0, 1)                       # (H, T, T)
        for i in range(c["t5_num_layers"]):
            blk = f"{pre}blocks.{i}."
            y = _rms(x, self.p(blk + "attn_norm.weight"))
            q, k, v = self.linear(y, self.p(blk + "attn.qkv.weight")).reshape(
                b, t, 3, h, d).unbind(2)
            a = torch.softmax(self.einsum("bqhd,bkhd->bhqk", q, k) + bias,
                              dim=-1)
            x = x + self.linear(self.einsum("bhqk,bkhd->bqhd", a, v).reshape(
                b, t, h * d), self.p(blk + "attn.o.weight"))
            y = _rms(x, self.p(blk + "mlp_norm.weight"))
            x = x + self.linear(torch.relu(self.linear(
                y, self.p(blk + "wi.weight"))), self.p(blk + "wo.weight"))
        return _rms(x, self.p(pre + "final_norm.weight"))

    # -- images -------------------------------------------------------------

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """(B, F, H, W, C) uint8 -> (B, F*P, E)."""
        c = self.m["images"]
        r = c["resnet"]
        pre = "image_encoder.resnet."
        x = images.to(self.device, torch.float32)
        b, f, hh, ww, ch = x.shape
        p = c["patch_size"]
        n = hh // p
        x = x.reshape(b, f, n, p, n, p, ch).permute(0, 1, 2, 4, 6, 3, 5)
        x = x.reshape(b * f * n * n, ch, p, p)
        if c["normalize"]:
            x = 2.0 * (x / 255.0) - 1.0
        y = F.conv2d(self.q(x), self.q(self.p(pre + "input_conv.weight")),
                     self.p(pre + "input_conv.bias"),
                     stride=tuple(r["input_stride"]))
        y = F.max_pool2d(y, tuple(r["pool_window"]), tuple(r["pool_stride"]))
        res = y
        g = r["group_norm_groups"]
        per_obs = f * n * n
        for i in range(r["num_blocks"]):
            nb, cc, sh, sw = y.shape
            z = y.reshape(nb // per_obs, per_obs, g, cc // g, sh, sw)
            mu = z.mean(dim=(1, 3, 4, 5), keepdim=True)
            var = z.var(dim=(1, 3, 4, 5), unbiased=False, keepdim=True)
            z = ((z - mu) / torch.sqrt(var + r["group_norm_epsilon"]))
            z = z.reshape(nb, cc, sh, sw)
            z = (z * self.p(f"{pre}block{i}_norm.weight")[:, None, None]
                 + self.p(f"{pre}block{i}_norm.bias")[:, None, None])
            z = F.gelu(z, approximate="tanh")
            y = F.conv2d(self.q(z), self.q(self.p(f"{pre}block{i}_conv.weight")),
                         self.p(f"{pre}block{i}_conv.bias"), padding="same")
        y = y + res
        emb = self._linear(y.reshape(y.shape[0], -1), pre + "output_dense")
        emb = emb.reshape(b, f * n * n, -1)
        edges = np.arange(0, hh + p, p, dtype=np.float64)
        q = np.floor(edges / hh * (c["position_interval"] - 1)).astype(
            np.int64)
        mid = (q[:-1] + q[1:]) // 2
        rows = torch.as_tensor(np.tile(np.tile(mid, n), f), device=self.device)
        cols = torch.as_tensor(np.tile(np.repeat(mid, n), f),
                               device=self.device)
        return (emb + self.p("image_encoder.row_position_embedding.weight")[rows]
                + self.p("image_encoder.col_position_embedding.weight")[cols])

    # -- transformer --------------------------------------------------------

    def _block(self, x, mask, name):
        tr = self.m["transformer"]
        h = tr["attention"]["num_heads"]
        eps = tr["layer_norm_epsilon"]
        b, s, _ = x.shape
        y = _ln(x, self.p(name + "ln_attention.weight"),
                self.p(name + "ln_attention.bias"), eps)
        q, k, v = (self._linear(y, name + "attention." + part).reshape(
            b, s, h, -1) for part in ("query", "key", "value"))
        logits = self.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
        logits = logits.masked_fill(~mask, float("-inf"))
        a = self.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)
        x = x + self._linear(a.reshape(b, s, -1), name + "attention.out")
        y = _ln(x, self.p(name + "ln_mlp.weight"), self.p(name + "ln_mlp.bias"),
                eps)
        return x + self._linear(torch.relu(self._linear(
            y, name + "mlp.dense_in")), name + "mlp.dense_out")

    @staticmethod
    def _merge(x, size, r):
        """ToMe merge of one token set: r sources of the even half join
        their most similar odd token; (B, n, E), (B, n, 1) ->
        (B, n - r, E), (B, n - r, 1), kept sources first."""
        unit = x / x.norm(dim=-1, keepdim=True)
        scores = unit[:, ::2] @ unit[:, 1::2].transpose(1, 2)
        best, partner = scores.max(dim=-1)
        # the r highest-scoring sources, the lower index first among equals
        order = torch.sort(best, dim=-1, descending=True, stable=True).indices
        src, kept = order[:, :r], order[:, r:].sort(dim=-1).values
        dst = torch.gather(partner, 1, src)
        e = x.shape[-1]
        xs, ss = x * size, size
        out = []
        for t, width in ((xs, e), (ss, 1)):
            even, odd = t[:, ::2], t[:, 1::2].clone()
            moved = torch.gather(even, 1, src[..., None].expand(-1, -1, width))
            odd.scatter_add_(1, dst[..., None].expand(-1, -1, width), moved)
            keep = torch.gather(even, 1, kept[..., None].expand(-1, -1, width))
            out.append(torch.cat([keep, odd], dim=1))
        return out[0] / out[1], out[1]

    def transformer(self, x):
        tr = self.m["transformer"]
        x = x + self.p("transformer.posembed_input.pos_embedding")
        masks = {}

        def mask(event):
            if event not in masks:
                masks[event] = torch.as_tensor(
                    L.attention_mask(self.sets, event), device=self.device)
            return masks[event]

        if not self.staged:
            for i in range(tr["num_blocks"]):
                x = self._block(x, mask(0), f"transformer.blocks.{i}.")
            event = 0
        else:
            k = tr["tome_merge_every"]
            stages = -(-tr["num_blocks"] // k)
            size = torch.ones_like(x[..., :1])
            for st in range(stages):
                for j in range(min(k, tr["num_blocks"] - st * k)):
                    x = self._block(x, mask(st), f"transformer.stage_{st}.{j}.")
                if st < stages - 1:
                    parts, sizes, cur = [], [], 0
                    for s in self.sets:
                        n, r = s.at(st), s.at(st) - s.at(st + 1)
                        xi, si = x[:, cur:cur + n], size[:, cur:cur + n]
                        if r > 0:
                            xi, si = self._merge(xi, si, r)
                        parts.append(xi)
                        sizes.append(si)
                        cur += n
                    x, size = torch.cat(parts, 1), torch.cat(sizes, 1)
            event = stages - 1
        if tr["final_norm"]:
            x = _ln(x, self.p("transformer.final_norm.weight"),
                    self.p("transformer.final_norm.bias"),
                    tr["layer_norm_epsilon"])
        return x, event

    def readouts(self, text_embeddings, images):
        """(B, T, E) text embeddings, (B, F, H, W, C) images -> (B, R, E)."""
        img = self.encode_images(images)
        b = img.shape[0]
        ro = self.p("readout_encoder.pos_embedding").expand(b, -1, -1)
        seq = torch.cat([text_embeddings.to(self.device, torch.float32),
                         img, ro], dim=1)
        seq = seq[:, torch.as_tensor(L.stream_order(self.sets),
                                     device=self.device)]
        x, event = self.transformer(seq)
        idx = torch.as_tensor(L.positions(self.sets, "Readout", event),
                              device=self.device)
        return x[:, idx]

    # -- diffusion head -----------------------------------------------------

    def actions(self, readouts, noisy, noise):
        """(B, R, E) readouts, (B, A) initial sample, (T, B, A) per-step
        noise -> (B, A) actions by the full DDPM reverse loop."""
        c = self.m["heads"]["diffusion"]
        pre = "diffusion_action_head.denoiser."
        steps = c["diffusion_steps"]
        betas, alphas, alpha_hats = cosine_schedule(steps)
        times = torch.arange(steps - 1, -1, -1, device=self.device)
        fourier = self.p(pre + "time_encoder.fourier_kernel")
        z = self.linear(2 * math.pi * times[:, None].float(), fourier)
        t_emb = torch.cat([torch.cos(z), torch.sin(z)], dim=-1)
        t_emb = self._linear(torch.relu(self._linear(
            t_emb, pre + "time_encoder.mlp.dense_in")),
            pre + "time_encoder.mlp.dense_out")
        ctx = (self._linear(t_emb, pre + "time_proj", bias=False)[:, None]
               + self._linear(readouts.mean(dim=1), pre + "readout_proj",
                              bias=False)[None])
        x = noisy.to(self.device, torch.float32)
        noise = noise.to(self.device, torch.float32)
        clip = c["clip_value"]
        for i, t in enumerate(range(steps - 1, -1, -1)):
            h = torch.relu(self._linear(x, pre + "noisy_proj") + ctx[i])
            eps = self._linear(h, pre + "first_out")
            x = (x - (1 - alphas[t]) / math.sqrt(1 - alpha_hats[t]) * eps) \
                / math.sqrt(alphas[t])
            if t > 0:
                x = x + math.sqrt(betas[t]) * noise[i]
            x = x.clamp(-clip, clip)
        return x

    def policy(self, text_embeddings, images, noisy, noise):
        return self.actions(self.readouts(text_embeddings, images), noisy,
                            noise)
