"""Post-training int8 quantization of the frozen serving towers: the T5
text tower and the image tower's patch embedder.

Counterpart of the JAX package's ``serve/quantize.py``, over the port's own
modules:

* weights: symmetric per-output-channel int8 (scale = amax / 127 over the
  contraction axis, clamped at 1e-8), made once from the model;
* ``'int8'`` mode: activations quantized too, dynamically and
  symmetrically (per row of a matrix product; per patch, over C, H and W,
  in the convolutions), and int8 x int8 products accumulated in int32 by
  ``torch._int_mm``; the convolutions as an int8 im2col and one such
  product (no float convolution of the int8 values: cuDNN may pick
  Winograd or FFT, and at the output dense's 28224-long contraction only an
  int32 accumulator is exact);
* ``'w8'`` mode: weights stored int8 and converted to the compute dtype at
  every call, activations float; the matrix products return float32
  unrounded, as JAX's ``preferred_element_type=float32`` (see
  :func:`float32_product`), and the per-channel scale applies to that
  output;
* everything else (norms, softmax, pool, GELU, residuals, embeddings, the
  relative-position bias) stays float as in the float towers.

Rounding is half to even in both frameworks and every scale is a correctly
rounded quotient, so the quantized weights, the activation scales and the
int32 accumulators equal the JAX package's on the same float inputs, and
the card's equal the CPU's bit for bit.

Layouts: a quantized matrix is (K, N) as in JAX (the port's ``Dense``
weight transposed), a quantized convolution kernel is the port's OIHW with
its scales on O.  The ``*_hwcn`` functions take (H, W, C, N) operands as
the JAX ones do; the tower hands them permuted views of its NCHW maps.
The output dense's rows are in the port's (c, h, w) order
(``convert.from_flax`` permutes them); per-column scales do not change
under that permutation, so its int8 values are JAX's with rows permuted.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..modules.image_tokenizer import group_norm_stats
from ..modules.t5 import relative_position_bucket
from ..ops.image_ops import patchify
from ..ops.pool import max_pool_hwcn

__all__ = ["QTensor", "quantize_matrix", "int8_matmul", "matmul_w8",
           "quantize_t5_params", "t5_encode_int8", "make_int8_text_encoder",
           "quantize_conv_kernel", "int8_conv_hwcn", "int8_matmul_tn",
           "dequant", "conv_w8_hwcn", "matmul_w8_tn",
           "quantize_image_tower", "image_embed_int8", "image_embed_w8",
           "make_int8_image_embedder", "make_w8_image_embedder", "int_mm",
           "card_operands", "float32_product", "W8_PRODUCT_ROUTE"]

# whether this torch has a CUDA kernel for ``torch.mm(..., out_dtype=)``
# (``aten::mm.dtype``: 16-bit operands, a float32 result from the float32
# accumulator).  Read once here: every w8 product on the card takes the
# same route, and none falls back after an error.
_MM_OUT_DTYPE_ON_CUDA = torch._C._dispatch_has_kernel_for_dispatch_key(
    "aten::mm.dtype", "CUDA")
W8_PRODUCT_ROUTE = "mm_out_dtype" if _MM_OUT_DTYPE_ON_CUDA else "upcast"

@dataclass
class QTensor:
    """Symmetric per-output-channel int8 tensor, ``w ~ q * scale``: a (K, N)
    matrix with (N,) scales, or an OIHW kernel with (O,) scales."""

    q: torch.Tensor       # int8
    scale: torch.Tensor   # float32


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127``, correctly rounded on every device: a CUDA
    tensor divided by a Python number is multiplied by its reciprocal,
    one ulp off the quotient in some elements, so the divisor is a tensor
    on ``amax``'s device."""
    return amax.clamp_min(1e-8) / torch.full((), 127.0, dtype=amax.dtype,
                                             device=amax.device)


def _quantize(w: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 values and scales of ``w`` with amax over ``dims``."""
    w = w.detach().float()
    scale = _scale(w.abs().amax(dim=dims, keepdim=True))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_matrix(w: torch.Tensor) -> QTensor:
    """(K, N) float matrix -> int8 with per-column scales."""
    q, scale = _quantize(w, 0)
    return QTensor(q=q, scale=scale.reshape(-1))


def quantize_conv_kernel(kernel: torch.Tensor) -> QTensor:
    """OIHW conv kernel -> int8 with per-output-channel scales."""
    q, scale = _quantize(kernel, (1, 2, 3))
    return QTensor(q=q, scale=scale.reshape(-1))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact (``torch._int_mm``;
    on the card through :func:`card_operands`)."""
    if a.device.type != "cuda":
        return torch._int_mm(a, b)
    m, n = a.shape[0], b.shape[1]
    return torch._int_mm(*card_operands(a, b))[:m, :n]


def card_operands(a: torch.Tensor, b: torch.Tensor):
    """``a`` and ``b`` as ``torch._int_mm`` takes them on the card: ``a``
    row-major (cuBLASLt's int8 product refuses a column-major ``a`` beside
    a column-major ``b``), more than 16 rows, K and N multiples of 8.  The
    zero padding adds nothing to the sums; the caller slices the (M, N)
    block off."""
    a = a.contiguous()
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    return a, b


def _quant_rows(a: torch.Tensor):
    """Per-row (last-axis) dynamic int8 quantization: (..., K) -> int8 and
    (..., 1) scales."""
    a32 = a.float()
    a_scale = _scale(a32.abs().amax(dim=-1, keepdim=True))
    qa = torch.clamp(torch.round(a32 / a_scale), -127, 127).to(torch.int8)
    return qa, a_scale


def int8_matmul(a: torch.Tensor, w: QTensor) -> torch.Tensor:
    """``a @ w`` with per-row dynamic int8 activations: (..., K) float ->
    (..., N) float32."""
    qa, a_scale = _quant_rows(a)
    acc = int_mm(qa.reshape(-1, qa.shape[-1]), w.q)
    acc = acc.reshape(*a.shape[:-1], acc.shape[-1])
    return acc.float() * a_scale * w.scale


def float32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two operands of one dtype, (..., K) x (K, N), as an
    unrounded float32 result: JAX's ``dot_general(...,
    preferred_element_type=float32)``.  On the card 16-bit operands go to
    ``torch.mm(..., out_dtype=torch.float32)`` where this torch registers
    it for CUDA (:data:`W8_PRODUCT_ROUTE`), and are upcast to float32
    otherwise; on the CPU they are upcast, which is exact (an int8 value
    or a 16-bit activation is a float32 value, their product too)."""
    if (a.dtype == torch.float32 or a.device.type != "cuda"
            or not _MM_OUT_DTYPE_ON_CUDA):
        return torch.matmul(a.float(), b.float())
    out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
    return out.reshape(*a.shape[:-1], b.shape[-1])


def matmul_w8(a: torch.Tensor, w: QTensor,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``a @ w`` with the int8-stored kernel converted to ``compute_dtype``
    at the call (int8 values are exact there), the product in float32
    (:func:`float32_product`); the scale applies to that output."""
    acc = float32_product(a.to(compute_dtype), w.q.to(compute_dtype))
    return acc * w.scale


def _quant_act_lanes(x: torch.Tensor):
    """Per-lane (last axis: one patch) dynamic int8 quantization of a
    (..., N) operand: int8 values and (N,) scales."""
    x32 = x.float()
    scale = _scale(x32.abs().amax(dim=tuple(range(x.ndim - 1))))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _pad(x: torch.Tensor, kh: int, kw: int, strides,
         padding: str) -> torch.Tensor:
    """An NCHW map padded as the JAX convolution pads it: not at all for
    'VALID', for 'SAME' by the total the output size needs, the odd unit
    after."""
    if padding == "VALID":
        return x
    if padding != "SAME":
        raise ValueError(f"unknown padding {padding!r}")
    pads = []
    for size, k, s in ((x.shape[3], kw, strides[1]),
                       (x.shape[2], kh, strides[0])):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _im2col(x: torch.Tensor, kh: int, kw: int, strides, padding: str):
    """(N, C, H, W) of any dtype -> ((N*Ho*Wo, C*kh*kw) columns, Ho, Wo),
    columns in the (c, i, j) order of an OIHW kernel's rows."""
    x = _pad(x, kh, kw, strides, padding)
    patches = x.unfold(2, kh, strides[0]).unfold(3, kw, strides[1])
    n, c, ho, wo = patches.shape[:4]                  # (..., kh, kw)
    cols = patches.permute(0, 2, 3, 1, 4, 5).reshape(n * ho * wo, c * kh * kw)
    return cols, ho, wo


def int8_conv_hwcn(x: torch.Tensor, w: QTensor, strides,
                   padding: str) -> torch.Tensor:
    """(H, W, C, N) float conv with int8 inputs (per-patch activation
    scales) and int32 accumulation -> (H', W', O, N) float32."""
    qx, x_scale = _quant_act_lanes(x)
    o, c, kh, kw = w.q.shape
    n = x.shape[3]
    cols, ho, wo = _im2col(qx.permute(3, 2, 0, 1), kh, kw, strides, padding)
    acc = int_mm(cols, w.q.reshape(o, -1).t()).reshape(n, ho, wo, o)
    acc = acc.permute(1, 2, 3, 0)                       # (Ho, Wo, O, N)
    return acc.float() * (w.scale[:, None] * x_scale[None, :])


def int8_matmul_tn(a: torch.Tensor, w: QTensor) -> torch.Tensor:
    """(K, N) activations x (K, M) int8 kernel -> (N, M) float32, per-lane
    (per N) activation scales."""
    qa, a_scale = _quant_act_lanes(a)
    acc = int_mm(qa.t(), w.q)
    return acc.float() * a_scale[:, None] * w.scale[None, :]


def dequant(w: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """int8-stored tensor -> float, per-output-channel scales."""
    scale = w.scale.reshape(-1, *([1] * (w.q.ndim - 1))) if w.q.ndim == 4 \
        else w.scale
    return (w.q.float() * scale).to(dtype)


def conv_w8_hwcn(x: torch.Tensor, w: QTensor, strides, padding: str,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(H, W, C, N) conv with the int8-stored kernel dequantized at the
    call, computed in ``compute_dtype`` like the float tower -> float32."""
    k = dequant(w, compute_dtype)
    xn = _pad(x.permute(3, 2, 0, 1).to(compute_dtype), k.shape[2],
              k.shape[3], strides, padding)
    y = F.conv2d(xn, k, stride=tuple(strides))
    return y.permute(2, 3, 1, 0).float()


def matmul_w8_tn(a: torch.Tensor, w: QTensor,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(K, N) float activations x int8-stored (K, M) kernel -> (N, M)
    float32, the product unrounded (:func:`float32_product`); the
    per-channel scale applies to the output."""
    acc = float32_product(a.t().to(compute_dtype), w.q.to(compute_dtype))
    return acc * w.scale[None, :]


# -- the T5 text tower -------------------------------------------------------

def quantize_t5_params(t5) -> dict:
    """A ``modules.t5.T5EncoderStack`` -> the quantized serving tree of
    :func:`t5_encode_int8`: the fused qkv, o, wi and wo kernels of each
    layer as :class:`QTensor` (per fused column: each projection's numbers
    are those of quantizing it alone); embeddings, norm scales and the
    relative-position bias table stay float.  ``buckets`` caches each
    length's device bucket table (made at the first call of a length, so
    that a CUDA-graph capture after it copies nothing from the host)."""
    def mat(dense):
        return quantize_matrix(dense.weight.t())

    layers = [{
        "attn_norm": blk.attn_norm.weight.detach(),
        "mlp_norm": blk.mlp_norm.weight.detach(),
        "qkv": mat(blk.attn.qkv), "o": mat(blk.attn.o),
        "wi": mat(blk.wi), "wo": mat(blk.wo),
    } for blk in t5.blocks]
    return {
        "token_embedding": t5.token_embedding.weight.detach(),
        "relative_attention_bias":
            t5.relative_attention_bias.weight.detach(),
        "final_norm": t5.final_norm.weight.detach(),
        "layers": layers,
        "buckets": {},
    }


def _rmsnorm(x, scale, epsilon=1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return x32 * torch.rsqrt(var + epsilon) * scale.float()


def _position_bias(qparams, t: int, device, num_buckets: int,
                   max_distance: int) -> torch.Tensor:
    key = (t, num_buckets, max_distance, str(device))
    table = qparams["buckets"].get(key)
    if table is None:
        pos = np.arange(t)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None], num_buckets=num_buckets,
            max_distance=max_distance)
        with torch.inference_mode(False):
            table = torch.as_tensor(buckets, device=device)
        qparams["buckets"][key] = table
    bias = qparams["relative_attention_bias"][table]        # (T, T, H)
    return bias.permute(2, 0, 1)[None].float()               # (1, H, T, T)


def t5_encode_int8(qparams, token_ids: torch.Tensor, *,
                   rel_pos_buckets: int = 32, rel_pos_max_distance: int = 128,
                   dtype=torch.bfloat16, mode: str = "int8") -> torch.Tensor:
    """Quantized mirror of ``T5EncoderStack.forward``: (B, T) ids ->
    (B, T, D) embeddings in ``dtype``.  Head geometry comes from the
    shapes (heads from the bias table, d_kv from the fused qkv width).
    ``mode='int8'`` quantizes activations too; ``'w8'`` is weight-only."""
    if mode == "int8":
        mm = int8_matmul
    elif mode == "w8":
        def mm(a, w):
            return matmul_w8(a, w, compute_dtype=dtype)
    else:
        raise ValueError(f"unknown mode {mode!r}; 'int8' or 'w8'")
    h = qparams["relative_attention_bias"].shape[-1]
    dkv = qparams["layers"][0]["qkv"].q.shape[-1] // (3 * h)
    b, t = token_ids.shape
    x = qparams["token_embedding"][token_ids].to(dtype)
    position_bias = _position_bias(qparams, t, token_ids.device,
                                   rel_pos_buckets, rel_pos_max_distance)
    for layer in qparams["layers"]:
        y = _rmsnorm(x, layer["attn_norm"]).to(dtype)
        qkv = mm(y, layer["qkv"]).reshape(b, t, 3, h, dkv)
        q, k, v = qkv.unbind(2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        weights = torch.softmax(logits + position_bias, dim=-1).to(dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v.to(dtype))
        out = mm(out.reshape(b, t, h * dkv), layer["o"])
        x = x + out.to(dtype)
        y = _rmsnorm(x, layer["mlp_norm"]).to(dtype)
        y = torch.clamp_min(mm(y, layer["wi"]), 0.0).to(dtype)
        y = mm(y, layer["wo"])
        x = x + y.to(dtype)
    return _rmsnorm(x, qparams["final_norm"]).to(dtype)


def make_int8_text_encoder(model, dtype=torch.bfloat16):
    """``token_ids -> embeddings`` through the int8 T5 tower of an Octo
    model whose text encoder is T5 (others raise)."""
    cfg = model.config.text
    if cfg.kind != "t5":
        raise ValueError(
            f"int8 text tower needs a t5 text encoder, got {cfg.kind!r}")
    qp = quantize_t5_params(model.text_encoder.t5_encoder)

    def encode(token_ids):
        return t5_encode_int8(
            qp, token_ids, rel_pos_buckets=cfg.t5_rel_pos_buckets,
            rel_pos_max_distance=cfg.t5_rel_pos_max_distance, dtype=dtype)

    return encode


# -- the image tower ---------------------------------------------------------

def quantize_image_tower(model) -> dict:
    """An Octo model's ``ImageTokenizer`` -> the quantized tree of
    :func:`image_embed_int8` / :func:`image_embed_w8` (the convolutions and
    the output dense int8; norms, biases and position tables float)."""
    tok = model.image_encoder
    rn = tok.resnet
    blocks = []
    for i in range(tok.cfg.resnet.num_blocks):
        norm, conv = getattr(rn, f"block{i}_norm"), getattr(rn, f"block{i}_conv")
        blocks.append({
            "norm_scale": norm.weight.detach(),
            "norm_bias": norm.bias.detach(),
            "conv": quantize_conv_kernel(conv.weight),
            "conv_bias": conv.bias.detach(),
        })
    return {
        "input_conv": quantize_conv_kernel(rn.input_conv.weight),
        "input_bias": rn.input_conv.bias.detach(),
        "blocks": blocks,
        "dense": quantize_matrix(rn.output_dense.weight.t()),
        "dense_bias": rn.output_dense.bias.detach(),
        "row_emb": tok.row_position_embedding.weight.detach(),
        "col_emb": tok.col_position_embedding.weight.detach(),
        "eval_rows": tok.eval_rows, "eval_cols": tok.eval_cols,
    }


def image_embed_int8(qparams, images, cfg, dtype=torch.bfloat16):
    """Quantized eval-mode mirror of ``ImageTokenizer``: int8 convolutions
    and output dense (int8 activations too), float pool, GroupNorm and
    GELU, eval position tokens.  ``cfg`` is the model's
    ``ImageTokenizerConfig``; images (B, H, W, C) or (B, F, H, W, C)."""
    return _image_embed_q(qparams, images, cfg, dtype, int8_conv_hwcn,
                          int8_matmul_tn)


def image_embed_w8(qparams, images, cfg, dtype=torch.bfloat16):
    """Weight-only-int8 mirror of the image tower: the same tree as the
    int8 mode, dequantized at the call and computed in ``dtype``."""
    return _image_embed_q(
        qparams, images, cfg, dtype,
        lambda x, w, s, p: conv_w8_hwcn(x, w, s, p, compute_dtype=dtype),
        lambda a, w: matmul_w8_tn(a, w, compute_dtype=dtype))


def _image_embed_q(qparams, images, cfg, dtype, conv_fn, matmul_fn):
    rcfg = cfg.resnet
    if images.ndim == 4:
        images = images[:, None]
    b, f, hh, ww, ch = images.shape
    p = cfg.patch_size
    g = f * (hh // p) * (ww // p)
    patches = patchify(images, p, cfg.normalize, dtype=torch.float32)
    xt = patches.reshape(b * g, p, p, ch).permute(1, 2, 3, 0)   # HWCN

    y = conv_fn(xt, qparams["input_conv"], tuple(rcfg.input_stride), "VALID")
    y = y + qparams["input_bias"].float()[:, None]
    y = max_pool_hwcn(y, rcfg.pool_window, rcfg.pool_stride, vjp="xla")

    residual = y
    for blk in qparams["blocks"]:
        # the float tower's statistics (its 'image' scope and var clamp)
        yn = group_norm_stats(y.permute(3, 2, 0, 1), rcfg.group_norm_groups,
                              rcfg.group_norm_epsilon,
                              rcfg.norm_stats_scope, g)
        y = yn.permute(2, 3, 1, 0)
        y = (y * blk["norm_scale"].float()[:, None]
             + blk["norm_bias"].float()[:, None])
        y = F.gelu(y, approximate="tanh")
        y = conv_fn(y, blk["conv"], (1, 1), "SAME")
        y = y + blk["conv_bias"].float()[:, None]
    y = y + residual

    # the dense's rows in the port's (c, h, w) order: (K, B*G)
    a = y.permute(3, 2, 0, 1).reshape(b * g, -1).t()
    out = matmul_fn(a, qparams["dense"])
    out = out + qparams["dense_bias"].float()
    emb = out.reshape(b, g, rcfg.output_features)
    rows = qparams["eval_rows"].repeat(f)
    cols = qparams["eval_cols"].repeat(f)
    emb = (emb + qparams["row_emb"][rows].float()[None]
           + qparams["col_emb"][cols].float()[None])
    return emb.to(dtype)


def make_int8_image_embedder(model, dtype=torch.bfloat16):
    """``images -> (B, F*P, E)`` through the int8 image tower."""
    qp = quantize_image_tower(model)
    cfg = model.config.images
    return lambda images: image_embed_int8(qp, images, cfg, dtype=dtype)


def make_w8_image_embedder(model, dtype=torch.bfloat16):
    """``images -> (B, F*P, E)`` through the weight-only-int8 image tower."""
    qp = quantize_image_tower(model)
    cfg = model.config.images
    return lambda images: image_embed_w8(qp, images, cfg, dtype=dtype)
