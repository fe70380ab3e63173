"""In-batch contrastive alignment (v7.01_with_contrastive_alignment).
Counterpart of ``visualrwkv_tpu/multimodal/contrastive.py``.

A symmetric InfoNCE between each sample's text-EOS and image-EOS hidden
features at temperature 0.07, added to the LM loss (reference
v7.01_with_contrastive_alignment/src/model.py:414-452). The features are
gathered at one text-EOS and one image-EOS position a sample. No path of
the JAX package calls :func:`contrastive_alignment_loss`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def gather_positions(features: Tensor, positions: Tensor) -> Tensor:
    """features ``[B, T, C]``, positions ``[B]`` -> ``[B, C]``."""
    idx = positions.long()[:, None, None].expand(-1, 1, features.shape[-1])
    return features.gather(1, idx)[:, 0]


def in_batch_contrastive_loss(text_feats: Tensor, image_feats: Tensor, temperature=0.07) -> Tensor:
    """Symmetric InfoNCE over the batch diagonal, in fp32. ``temperature``
    may be a tensor (the v4 adapter's is learnable)."""
    t = text_feats.float()
    v = image_feats.float()
    t = t / t.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    v = v / v.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    labels = torch.arange(t.shape[0], device=t.device)
    return (F.cross_entropy(t @ v.T / temperature, labels) + F.cross_entropy(v @ t.T / temperature, labels)) / 2


def contrastive_alignment_loss(hidden: Tensor, text_eos_positions: Tensor, image_eos_positions: Tensor,
                               temperature: float = 0.07) -> Tensor:
    """hidden ``[B, T, C]`` (pre-head features), each sample's EOS
    positions ``[B]``."""
    t = gather_positions(hidden, text_eos_positions)
    v = gather_positions(hidden, image_eos_positions)
    return in_batch_contrastive_loss(t, v, temperature)
