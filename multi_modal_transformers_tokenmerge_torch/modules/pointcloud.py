"""Point-cloud tokenizer: farthest-point sampling, kNN grouping and the
sample-and-group module.

Counterpart of the JAX package's ``modules/pointcloud.py``, batched over a
leading batch axis where the JAX functions take one cloud (the JAX model
maps them with ``jax.vmap``):

* :func:`farthest_point_sampling` is a loop on the device over a
  preallocated index buffer (no host round trip); its first index is an
  argument or a draw from an explicit ``torch.Generator``, where the JAX
  function draws it with ``jax.random.randint``;
* distances are one batched product (``|a|^2 + |b|^2 - 2 a.b``);
* :func:`knn` is exact whatever ``exact`` says: ``exact=False`` is JAX's
  ``approx_max_k``, which is exact on the CPU and approximate only on a
  TPU.  Ties go to the lower index (a stable sort), as ``lax.top_k``
  breaks them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import BatchNorm, Dense

__all__ = ["pairwise_sq_dist", "farthest_point_sampling", "knn",
           "ball_query", "SampleAndGroup"]


def pairwise_sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (..., N, M) between point sets
    (..., N, D) and (..., M, D): ``|a|^2 + |b|^2 - 2 a b^T``."""
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1, keepdim=True).transpose(-1, -2)
    return a2 + b2 - 2.0 * (a.float() @ b.float().transpose(-1, -2))


def farthest_point_sampling(points: torch.Tensor, num_samples: int,
                            start=None,
                            generator: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
    """Greedy max-min sampling: (N, D) or (B, N, D) points -> (num_samples,)
    or (B, num_samples) int64 indices.  ``start``: the first index (an int
    or one per cloud); else drawn uniformly from ``generator``."""
    single = points.dim() == 2
    pts = points[None] if single else points
    b, n, _ = pts.shape
    dev = pts.device
    if start is None:
        start = torch.randint(0, n, (b,), generator=generator, device=dev)
    start = torch.as_tensor(start, device=dev).long().expand(b).clone()
    rows = torch.arange(b, device=dev)
    sampled = torch.zeros((b, num_samples), dtype=torch.long, device=dev)
    sampled[:, 0] = start
    dists = torch.full((b, n), float("inf"), device=dev)
    dists[rows, start] = -float("inf")
    for i in range(1, num_samples):
        last = pts[rows, sampled[:, i - 1]]                  # (B, D)
        d = torch.square(pts - last[:, None]).sum(-1)
        dists = torch.minimum(dists, d)
        nxt = dists.argmax(-1)
        sampled[:, i] = nxt
        dists[rows, nxt] = -float("inf")
    return sampled[0] if single else sampled


def _top_k_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, ties to the lower
    index (``lax.top_k``'s order)."""
    return torch.sort(score, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def ball_query(points: torch.Tensor, centroids: torch.Tensor, k: int,
               radius: float) -> torch.Tensor:
    """Indices (..., M, k) of up to k points within ``radius`` of each
    centroid, nearest first; a ball with fewer is padded with the
    centroid's nearest neighbour."""
    d = pairwise_sq_dist(centroids, points)
    within = d <= radius * radius
    score = torch.where(within, -d, -d - 1e9)
    idx = _top_k_indices(score, k)
    nearest = d.argmin(-1, keepdim=True)
    return torch.where(within.gather(-1, idx), idx, nearest)


def knn(points: torch.Tensor, centroids: torch.Tensor, k: int,
        exact: bool = False) -> torch.Tensor:
    """Indices (..., M, k) of the k nearest points to each centroid; exact
    either way (see the module docstring)."""
    return _top_k_indices(-pairwise_sq_dist(centroids, points), k)


class SampleAndGroup(nn.Module):
    """FPS downsampling, kNN grouping and two Dense-BatchNorm-ReLU layers
    over each group: (B, N, F) points, xyz first -> (B, M, 3 + E) with
    ``pool_neighbours`` (max over the k neighbours, the centroids' xyz
    carried in front), else (B, M, k, E).  Train-mode batch statistics are
    taken per cloud, as the JAX module computes them under ``jax.vmap``."""

    def __init__(self, in_features: int, num_samples: int,
                 num_neighbours: int, embed_dim: int,
                 pool_neighbours: bool = True, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.num_samples = num_samples
        self.num_neighbours = num_neighbours
        self.pool_neighbours = pool_neighbours
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        dims = (in_features + 3, embed_dim)
        for i in range(2):
            setattr(self, f"lbr{i}_dense", Dense(
                dims[i], embed_dim, kernel_init="xavier", bias_init="zeros",
                **kw))
            setattr(self, f"lbr{i}_bn", BatchNorm(embed_dim, **kw))

    def forward(self, points: torch.Tensor, train: bool = False, start=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``start`` / ``generator``: the FPS start of each cloud."""
        b = points.shape[0]
        xyz = points[..., :3].float()
        idx = farthest_point_sampling(xyz, self.num_samples, start,
                                      generator)                 # (B, M)
        rows = torch.arange(b, device=points.device)[:, None]
        centroids = xyz[rows, idx]                               # (B, M, 3)
        groups = knn(xyz, centroids, self.num_neighbours)        # (B, M, k)
        feats = points[rows[..., None], groups]                  # (B, M, k, F)
        delta = feats[..., :3] - centroids[:, :, None, :]
        feats = torch.cat([delta.to(feats.dtype), feats], dim=-1)
        for i in range(2):
            feats = getattr(self, f"lbr{i}_dense")(feats)
            feats = getattr(self, f"lbr{i}_bn")(feats, train,
                                               per_example=True)
            feats = torch.relu(feats)
        if self.pool_neighbours:
            feats = feats.amax(dim=-2)
            feats = torch.cat([centroids.to(feats.dtype), feats], dim=-1)
        return feats
