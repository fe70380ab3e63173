"""VisualRWKV-7: vision ensemble -> projector -> token scatter -> RWKV LM.

Counterpart of ``visualrwkv_tpu/models/visualrwkv.py`` (the unidirectional
v7.00 path) over a parameter dict ``{"rwkv", "vit", "proj"}``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from visualrwkv_torch.config import VLMConfig, resolve_device
from visualrwkv_torch.models import lm, rwkv7
from visualrwkv_torch.multimodal.projector import (
    adaptive_pool_tokens,
    apply_projector,
    init_projector_params,
    scatter_image_features,
)
from visualrwkv_torch.vision.backbone import backbone_features, init_backbone_params

Tensor = torch.Tensor
Params = Dict[str, Any]


def init_visualrwkv_params(cfg: VLMConfig, seed: int = 0, device="cuda",
                           dtype: Optional[torch.dtype] = None) -> Params:
    """Seeded random init of the whole assembly on ``device`` (CUDA unless
    the caller asks for the CPU); ``dtype`` is an optional storage dtype."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = {"rwkv": lm.init_lm_params(gen, cfg.rwkv, device, dtype)}
    if cfg.vision.towers:
        sdt = dtype or torch.float32
        params["vit"] = init_backbone_params(gen, cfg.vision, cfg.rwkv.compute_dtype, device, sdt)
        params["proj"] = init_projector_params(
            gen, cfg.proj_type, cfg.projector_in_dim, cfg.rwkv.n_embd, device, sdt
        )
    return params


@torch.no_grad()
def encode_images(params: Params, cfg: VLMConfig, images: Dict[str, Tensor],
                  normalized: bool = False) -> Tensor:
    """Per-tower pixel batches -> [N_img, num_token_per_image, n_embd]."""
    feats = backbone_features(params["vit"], cfg.vision, images, cfg.rwkv.compute_dtype, normalized)
    feats = adaptive_pool_tokens(feats, cfg.num_token_per_image)
    return apply_projector(params["proj"], cfg.proj_type, feats, cfg.rwkv.dtype)


def prepare_embeddings(params: Params, cfg: VLMConfig, input_ids: Tensor,
                       images: Optional[Dict[str, Tensor]] = None,
                       image_features: Optional[Tensor] = None,
                       normalized: bool = False) -> Tensor:
    """Token embeddings with image features scattered at image-token slots."""
    input_embeds = rwkv7.embed(params["rwkv"], input_ids.clamp(0, cfg.rwkv.vocab_size - 1))
    if image_features is None:
        if images is None:
            return input_embeds
        image_features = encode_images(params, cfg, images, normalized)
    return scatter_image_features(input_ids, input_embeds, image_features)


@torch.no_grad()
def vlm_forward(params: Params, cfg: VLMConfig, input_ids, images=None,
                return_hidden: bool = False, device="cuda") -> Tensor:
    """Logits [B, T, vocab] fp32 (or the final hidden states). ``input_ids``
    [B, T] and the per-tower uint8 images (arrays or tensors) are moved to
    ``device``, where ``params`` must already be."""
    device = resolve_device(device)
    ids = torch.as_tensor(input_ids, device=device).long()
    if images is not None:
        images = {t: torch.as_tensor(v, device=device) for t, v in images.items()}
    x = prepare_embeddings(params, cfg, ids, images)
    out, _ = lm.lm_forward(params["rwkv"], cfg.rwkv, x, return_hidden=return_hidden)
    return out
