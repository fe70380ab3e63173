"""Vision backbone ensemble: DINOv2-L + SigLIP-so400m + SAM-B features
concatenated on the channel dim (1024 + 1152 + 1024 = 3200 at full size), or
the single CLIP-L/336 tower of VisualRWKV-6. Counterpart of
``visualrwkv_tpu/vision/backbone.py``."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from visualrwkv_torch.config import VisionConfig
from visualrwkv_torch.data.transforms import normalize_uint8
from visualrwkv_torch.vision.sam import SAM_VIT_B, SAMConfig, init_sam_params, sam_features
from visualrwkv_torch.vision.vit import (
    CLIP_L_336,
    DINOV2_L_REG4,
    SIGLIP_SO400M,
    init_vit_params,
    vit_features,
)

Tensor = torch.Tensor
Params = Dict[str, Any]


def tower_configs(cfg: VisionConfig, compute_dtype: str = "bfloat16") -> Dict[str, Any]:
    """Per-tower architecture configs of the enabled towers."""
    overrides = cfg.tower_config_overrides or {}
    defaults = {
        "dino": dataclasses.replace(DINOV2_L_REG4, img_size=cfg.image_size),
        "siglip": dataclasses.replace(SIGLIP_SO400M, img_size=cfg.image_size),
        "sam": dataclasses.replace(SAM_VIT_B, img_size=cfg.sam_image_size),
        "clip": CLIP_L_336,
    }
    out: Dict[str, Any] = {}
    for t in cfg.towers:
        if t not in defaults:
            raise NotImplementedError(f"vision tower {t!r} is not ported yet")
        out[t] = dataclasses.replace(overrides.get(t, defaults[t]), compute_dtype=compute_dtype)
    return out


def init_backbone_params(gen: torch.Generator, cfg: VisionConfig, compute_dtype="bfloat16",
                         device="cuda", dtype=torch.float32) -> Params:
    params: Params = {}
    for name, tcfg in tower_configs(cfg, compute_dtype).items():
        init = init_sam_params if isinstance(tcfg, SAMConfig) else init_vit_params
        params[name] = init(gen, tcfg, device=device, dtype=dtype)
    return params


def backbone_tower_features(params: Params, cfg: VisionConfig, images: Dict[str, Tensor],
                            compute_dtype: str = "bfloat16", normalized: bool = False
                            ) -> Dict[str, Tensor]:
    """Each enabled tower's patch features on its pixel batch (uint8
    [N, H, W, 3], or normalised when ``normalized``), in the compute dtype,
    by tower name: the UHD fusion combines the towers spatially instead of
    concatenating them per patch."""
    dt = getattr(torch, compute_dtype)
    out: Dict[str, Tensor] = {}
    for name, tcfg in tower_configs(cfg, compute_dtype).items():
        x = images[name]
        if not normalized:
            x = normalize_uint8(x, name, dt)
        fn = sam_features if isinstance(tcfg, SAMConfig) else vit_features
        out[name] = fn(params[name], tcfg, x).to(dt)
    return out


def backbone_features(params: Params, cfg: VisionConfig, images: Dict[str, Tensor],
                      compute_dtype: str = "bfloat16", normalized: bool = False) -> Tensor:
    """Run the enabled towers on their pixel batches (uint8 [N, H, W, 3], or
    normalised when ``normalized``) and concatenate the patch features:
    [N, L, sum(dims)] in the compute dtype."""
    feats = list(backbone_tower_features(params, cfg, images, compute_dtype, normalized).values())
    lens = {f.shape[1] for f in feats}
    if len(lens) != 1:
        raise ValueError(f"towers disagree on token count: {lens}")
    return torch.cat(feats, dim=-1)
