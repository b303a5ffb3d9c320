"""Octo: the vision-language-action transformer policy.

Counterpart of the JAX package's ``models/octo.py``: ``encode_text``, the
``generate_readouts*`` backbone, ``assemble_embeddings``, and the diffusion
head's serving methods (``predict_diffusion_action`` with its cached-text
``_with_text`` and external-tower ``_with_modalities`` variants) and
training methods (``compute_diffusion_denoise_loss[_with_text]``,
``predict_diffusion_denoise_term``).  The sequence layout, the block-causal
mask and the assembly permutation are static tables built once; assembly
is one concat and one gather.  The continuous and categorical heads and
token merging come with later parts of the port.

``train=True`` runs the stochastic pieces from ``rngs``, a mapping of rng
collection name to ``torch.Generator`` (``dropout``, ``patch_encoding``,
``diffusion``); each draw may be passed in instead (``positions``,
``time``, ``noise``).  The transformer's attention core is chosen when the
model is built (``modules.attention.select_attention_fn``).

The model is built on ``device`` ('cuda' unless the caller says otherwise)
and initialized from an explicit seed.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import torch
from torch import nn

from ..core.config import OctoConfig
from ..heads.diffusion import DiffusionActionHead
from ..modules.attention import TransformerStack, select_attention_fn
from ..modules.image_tokenizer import ImageTokenizer
from ..modules.readout import ReadoutTokens
from ..modules.text import build_text_encoder
from ..sequence.layout import SequenceLayout

__all__ = ["Octo", "TokenEmbeddings"]


class TokenEmbeddings(NamedTuple):
    text: torch.Tensor
    images: torch.Tensor
    readouts: torch.Tensor


class Octo(nn.Module):
    def __init__(self, config: OctoConfig, *, device="cuda",
                 seed: Optional[int] = 0):
        """``seed=None`` leaves the parameters uninitialized (to be loaded
        from a state_dict)."""
        super().__init__()
        cfg = config
        self.config = cfg
        self.layout = SequenceLayout.from_strings(cfg.input_sequence,
                                                  cfg.compression_sequence)
        if self.layout.compressible and \
                cfg.transformer.compression_mode != "none":
            raise ValueError("token merging / pruning is not ported yet")
        kw = dict(dtype=cfg.compute_dtype, param_dtype=cfg.params_dtype,
                  device=device)
        e = cfg.token_embedding_dim
        self.text_encoder = build_text_encoder(cfg.text, **kw)
        self.image_encoder = ImageTokenizer(cfg.images, **kw)
        self.readout_encoder = ReadoutTokens(
            self.layout.modality_tokens("readouts"), e, **kw)
        self.transformer = TransformerStack(
            cfg.transformer, self.layout.total_tokens, e,
            select_attention_fn(cfg.transformer, self.layout.attention_mask(),
                                self.layout.total_tokens, device), **kw)
        if cfg.heads.diffusion is None:
            raise ValueError("the port serves the diffusion head; the "
                             "configuration has none")
        self.diffusion_action_head = DiffusionActionHead(
            cfg.heads.diffusion, e, **kw)

        self.register_buffer("attention_mask", torch.as_tensor(
            self.layout.attention_mask(), device=device), persistent=False)
        self.register_buffer("assembly_permutation", torch.as_tensor(
            self.layout.assembly_permutation, dtype=torch.long,
            device=device), persistent=False)
        self.register_buffer("readout_index", torch.as_tensor(
            self.layout.modality_index("readouts"), dtype=torch.long,
            device=device), persistent=False)
        if seed is not None:
            self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.attention_mask.device

    def reset_parameters(self, seed: int) -> None:
        """Draw every parameter from the flax initializers' distributions
        with one generator seeded by ``seed``, on the model's device."""
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(g)

    # -- backbone ----------------------------------------------------------

    def encode_text(self, text_tokens: torch.Tensor) -> torch.Tensor:
        """(B, T) ids -> (B, T, E) text embeddings."""
        return self.text_encoder(text_tokens)

    def generate_readouts(self, text_tokens, images, train: bool = False,
                          *, rngs: Optional[Mapping] = None,
                          positions=None):
        return self.generate_readouts_with_text(
            self.encode_text(text_tokens), images, train, rngs=rngs,
            positions=positions)

    def generate_readouts_with_text(self, text_embeddings, images,
                                    train: bool = False, *,
                                    rngs: Optional[Mapping] = None,
                                    positions=None):
        rngs = rngs or {}
        image_embeddings = self.image_encoder(
            images, train, positions,
            rngs.get(self.config.images.rng_collection))
        return self.generate_readouts_with_modalities(
            text_embeddings, image_embeddings, train, rngs=rngs)

    def generate_readouts_with_modalities(self, text_embeddings,
                                          image_embeddings,
                                          train: bool = False, *,
                                          rngs: Optional[Mapping] = None):
        """Both modality streams given -> (B, R, E) readout embeddings."""
        readouts = self.readout_encoder(image_embeddings.shape[0])
        x = self.assemble_embeddings(TokenEmbeddings(
            text=text_embeddings, images=image_embeddings, readouts=readouts))
        x = self.transformer(x, self.attention_mask, train,
                             (rngs or {}).get("dropout"))
        return x.index_select(1, self.readout_index)

    def assemble_embeddings(self, embeddings: TokenEmbeddings):
        """Interleave the modality streams: one concat, one gather."""
        streams = (("text", embeddings.text), ("images", embeddings.images),
                   ("readouts", embeddings.readouts))
        for name, stream in streams:
            expected = self.layout.modality_tokens(name)
            if stream.shape[1] != expected:
                raise ValueError(
                    f"{name} stream has {stream.shape[1]} tokens but the "
                    f"sequence layout {self.config.input_sequence!r} "
                    f"expects {expected}")
        dtype = self.config.compute_dtype
        combined = torch.cat([s.to(dtype) for _, s in streams], dim=1)
        return combined.index_select(1, self.assembly_permutation)

    # -- diffusion head ----------------------------------------------------

    def predict_diffusion_denoise_term(self, text_tokens, images, time,
                                       noisy_actions, train: bool = False,
                                       *, rngs: Optional[Mapping] = None,
                                       positions=None):
        readouts = self.generate_readouts(text_tokens, images, train,
                                          rngs=rngs, positions=positions)
        return self.diffusion_action_head.predict_denoise_term(
            readouts, time, noisy_actions, train, (rngs or {}).get("dropout"))

    def compute_diffusion_denoise_loss(self, text_tokens, images, actions,
                                       train: bool = True, *,
                                       rngs: Optional[Mapping] = None,
                                       positions=None, time=None,
                                       noise=None):
        """Scalar denoising loss; ``positions``, ``time`` and ``noise``
        replace the draws of the ``patch_encoding`` and ``diffusion``
        generators."""
        return self.compute_diffusion_denoise_loss_with_text(
            self.encode_text(text_tokens), images, actions, train, rngs=rngs,
            positions=positions, time=time, noise=noise)

    def compute_diffusion_denoise_loss_with_text(
            self, text_embeddings, images, actions, train: bool = True, *,
            rngs: Optional[Mapping] = None, positions=None, time=None,
            noise=None):
        """As :meth:`compute_diffusion_denoise_loss` with the frozen text
        tower's embeddings given (``utils.data.cache_text_embeddings``)."""
        readouts = self.generate_readouts_with_text(
            text_embeddings, images, train, rngs=rngs, positions=positions)
        return self.diffusion_action_head.denoise_loss(
            readouts, actions, train, time, noise, rngs=rngs)

    def predict_diffusion_action(self, text_tokens, images, **sample_kw):
        """``sample_kw``: ``noisy``, ``noise``, ``generator``,
        ``ddim_steps`` of ``DiffusionActionHead.predict_action``."""
        return self.diffusion_action_head.predict_action(
            self.generate_readouts(text_tokens, images), **sample_kw)

    def predict_diffusion_action_with_text(self, text_embeddings, images,
                                           **sample_kw):
        return self.diffusion_action_head.predict_action(
            self.generate_readouts_with_text(text_embeddings, images),
            **sample_kw)

    def predict_diffusion_action_with_modalities(
            self, text_embeddings, image_embeddings, **sample_kw):
        return self.diffusion_action_head.predict_action(
            self.generate_readouts_with_modalities(text_embeddings,
                                                   image_embeddings),
            **sample_kw)
