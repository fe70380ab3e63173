"""Image normalisation per tower (the reference's transform statistics).

DINOv2 and SAM use the ImageNet statistics; SigLIP uses 0.5 / 0.5; CLIP its
own (OpenAI CLIP's). Counterpart of ``visualrwkv_tpu/data/transforms.py``,
with its letterbox padding and antialiased resize.
"""

from __future__ import annotations

from typing import Dict

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


def normalize_tower_dict(images: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    return {t: normalize_uint8(v, t, dtype) for t, v in images.items()}


def letterbox_pad(img, fill=(127, 127, 127)):
    """Pad a PIL image to square with a neutral border (v6.11's LetterboxPad
    transform, v6.11/src/vision.py:39-198) instead of aspect-distorting resize."""
    from PIL import Image

    w, h = img.size
    if w == h:
        return img
    side = max(w, h)
    canvas = Image.new("RGB", (side, side), fill)
    canvas.paste(img, ((side - w) // 2, (side - h) // 2))
    return canvas


def resize_images(x: torch.Tensor, size: int, method: str = "bicubic") -> torch.Tensor:
    """Antialiased resize of ``[N, H, W, C]`` (uint8 or float) to float32
    ``[N, size, size, C]``, unclipped (for tiling paths); ``method`` is
    "bicubic" or "bilinear". ``torch.nn.functional.interpolate`` with
    ``antialias=True``: its cubic is Keys' with a = -0.5, as
    ``jax.image.resize``'s, and both renormalise the taps that fall outside
    the image. They differ in rounding only: torch computes and sums the
    taps' weights in its own order, so on uint8 inputs (0-255) the two differ
    by up to about 1.1e-4 (tests/test_torch_tooling.py), not bit for bit."""
    y = torch.nn.functional.interpolate(x.float().permute(0, 3, 1, 2), size=(size, size), mode=method,
                                        antialias=True, align_corners=False)
    return y.permute(0, 2, 3, 1).contiguous()
