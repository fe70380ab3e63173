"""Image normalisation per tower (the reference's transform statistics).

DINOv2 and SAM use the ImageNet statistics; SigLIP uses 0.5 / 0.5; CLIP its
own (OpenAI CLIP's).
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)

TOWER_STATS = {
    "dino": (IMAGENET_MEAN, IMAGENET_STD),
    "siglip": (SIGLIP_MEAN, SIGLIP_STD),
    "sam": (IMAGENET_MEAN, IMAGENET_STD),
    "clip": ((0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)),
}


def normalize_uint8(pixels: torch.Tensor, tower: str, dtype=torch.bfloat16) -> torch.Tensor:
    """[N, H, W, 3] uint8 -> normalised [N, H, W, 3] in ``dtype``."""
    mean, std = TOWER_STATS[tower]
    x = pixels.float() / 255.0
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)
