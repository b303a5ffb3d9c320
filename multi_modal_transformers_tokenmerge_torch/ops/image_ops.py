"""Image preprocessing: patchify and the static patch-position tables.

Counterpart of the JAX package's ``ops/image_ops.py``.  Position-interval
bounds depend only on image geometry, so they are numpy constants; the
eval-mode position tokens are their midpoints, and the train-mode tokens
are uniform draws within each patch's interval, from a ``torch.Generator``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.global_batch import draw_global

__all__ = ["patchify", "position_interval_bounds", "eval_position_tokens",
           "sample_position_tokens"]


def patchify(images: torch.Tensor, patch_size: int, normalize: bool,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., H, W, C) uint8/float images -> (..., P, p, p, C) patches.

    ``P = (H/p)*(W/p)`` patches in raster order, optionally normalized to
    [-1, 1].  Any number of leading batch dims."""
    *batch, h, w, c = images.shape
    p = patch_size
    if h % p or w % p:
        raise ValueError(f"image ({h}x{w}) not divisible by patch size {p}")
    x = images.to(dtype)
    x = x.reshape(*batch, h // p, p, w // p, p, c)
    x = x.movedim(-4, -3)  # (..., h/p, w/p, p, p, c)
    x = x.reshape(*batch, (h // p) * (w // p), p, p, c)
    if normalize:
        x = 2.0 * (x / 255.0) - 1.0
    return x


@functools.lru_cache(maxsize=None)
def position_interval_bounds(
    image_dim: int, patch_size: int, position_interval: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Static quantized ``(row_start, row_stop, col_start, col_stop)``
    bucket bounds per patch, in raster order, each int32 of shape (P,).

    The "row" stream varies fastest along the raster, as in the reference;
    both streams are learned embeddings, so only agreement matters."""
    p = patch_size
    n = image_dim // p
    edges = np.arange(0, image_dim + p, p, dtype=np.float64)
    q = np.floor(edges / image_dim * (position_interval - 1)).astype(np.int32)
    start, stop = q[:-1], q[1:]
    return (np.tile(start, n), np.tile(stop, n),
            np.repeat(start, n), np.repeat(stop, n))


def eval_position_tokens(
    image_dim: int, patch_size: int, position_interval: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic (row, col) position tokens: interval midpoints."""
    rs, rp, cs, cp = position_interval_bounds(image_dim, patch_size,
                                              position_interval)
    return (rs + rp) // 2, (cs + cp) // 2


@functools.lru_cache(maxsize=64)
def _draw_tables(image_dim: int, patch_size: int, position_interval: int,
                 device: torch.device):
    """(row start, row span, col start, col span) int64 tensors on
    ``device``, made once: a draw then copies nothing from the host, which a
    CUDA graph could not capture."""
    rs, rp, cs, cp = position_interval_bounds(image_dim, patch_size,
                                              position_interval)
    rp = np.maximum(rp, rs + 1)
    cp = np.maximum(cp, cs + 1)
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                     for a in (rs, rp - rs, cs, cp - cs))


def sample_position_tokens(
    batch_shape: Tuple[int, ...], image_dim: int, patch_size: int,
    position_interval: int, generator: Optional[torch.Generator] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-mode (row, col) tokens, each uniform in its patch's
    ``[start, stop)`` interval: two int64 tensors of shape
    ``(*batch_shape, P)`` on ``device``.

    A degenerate interval (start == stop, possible when position_interval
    - 1 < patches per dim) is widened to ``[start, start + 1)``, so its
    patches emit their start bucket."""
    device = torch.device(device if device is not None else "cpu")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    row_lo, row_span, col_lo, col_span = _draw_tables(
        image_dim, patch_size, position_interval, device)
    shape = (*batch_shape, row_lo.shape[0])

    def draw(lo, span):
        # a data-parallel step draws the global batch's positions
        u = draw_global(lambda s: torch.rand(s, generator=generator,
                                             device=device), shape)
        off = torch.minimum((u * span).long(), span - 1)
        return lo + off

    return draw(row_lo, row_span), draw(col_lo, col_span)
