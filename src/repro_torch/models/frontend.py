"""Modality-frontend stubs, as in ``repro.models.frontend``.

For vision models the ViT tower is stubbed: patch embeddings of the right
shape and dtype, (B, num_prefix_tokens, embed_dim), unit-normalised. For
audio models the EnCodec codec is stubbed: the LM reads the (B, S,
num_codebooks) token grid directly. The projector and the codebook
embeddings that consume them are the LM's (``models.model``).

``repro`` draws from ``jax.random``; these draw from an explicit
``torch.Generator``, so the values differ between the packages (tests feed
both the same numpy arrays).
"""
from __future__ import annotations

import torch

from repro_torch.models.model import _DTYPES


def synth_image_embeds(gen: torch.Generator, cfg, batch: int
                       ) -> torch.Tensor:
    """Stubbed ViT output: unit-normalised patch embeddings in the
    model's param dtype, on the generator's device."""
    f = cfg.frontend
    x = torch.randn((batch, f.num_prefix_tokens, f.embed_dim),
                    generator=gen, dtype=torch.float32, device=gen.device)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x.to(_DTYPES[cfg.param_dtype])


def synth_audio_tokens(gen: torch.Generator, cfg, batch: int,
                       seq_len: int) -> torch.Tensor:
    """Stubbed EnCodec output: an int32 token grid (B, S, num_codebooks)
    on the generator's device."""
    return torch.randint(0, cfg.vocab_size,
                         (batch, seq_len, cfg.frontend.num_codebooks),
                         generator=gen, dtype=torch.int32, device=gen.device)


def _labels(tokens: torch.Tensor) -> torch.Tensor:
    """Next-token labels: tokens shifted left by one, -1 at the end."""
    return torch.cat([tokens[:, 1:],
                      torch.full_like(tokens[:, :1], -1)], dim=1)


def make_batch(gen: torch.Generator, cfg, batch: int, seq_len: int) -> dict:
    """A synthetic batch honouring the model's input contract, on the
    generator's device: tokens and labels, and for a vision model
    ``image_embeds`` with ``seq_len`` minus the prefix text tokens."""
    if cfg.frontend.kind == "audio":
        tokens = synth_audio_tokens(gen, cfg, batch, seq_len)
        return {"tokens": tokens, "labels": _labels(tokens)}
    n_txt = seq_len
    if cfg.frontend.kind == "vision":
        n_txt = seq_len - cfg.frontend.num_prefix_tokens
        if n_txt <= 0:
            raise ValueError("seq_len must exceed the vision prefix")
    tokens = torch.randint(0, cfg.vocab_size, (batch, n_txt), generator=gen,
                           dtype=torch.int32, device=gen.device)
    out = {"tokens": tokens, "labels": _labels(tokens)}
    if cfg.frontend.kind == "vision":
        out["image_embeds"] = synth_image_embeds(gen, cfg, batch)
    return out
