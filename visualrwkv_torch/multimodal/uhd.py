"""UHD fusion of a global view with 2x2 tiles, and offline feature
extraction. Counterpart of ``visualrwkv_tpu/multimodal/uhd.py``.

Reference VisualRWKV-UHD/src/vision.py:179-224: an image gives the towers
five views, [global, tl, tr, bl, br]. The towers' global features are
concatenated on the channel dim; each tower's four tiles are average-pooled
to half their grid and put back together into one full grid; all of it is
concatenated on the channel dim -> ``[B, L, 2 * sum(D_tower)]``.

The offline extraction (vision.py:225-255, extract_feature.py) writes a
fp16 ``.npz`` feature file an image, for training from features on disk.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from visualrwkv_torch.data.tiling import split_into_tiles

Tensor = torch.Tensor


def _pool_half(tile: Tensor) -> Tensor:
    """``[B, L, D]`` on a sqrt(L) grid -> its 2x2 average pool, fp32,
    ``[B, h/2, w/2, D]``."""
    B, L, D = tile.shape
    out = int(round(L**0.5)) // 2
    return tile.float().reshape(B, out, 2, out, 2, D).mean(dim=(2, 4))


def fuse_image_features(per_tower_tiles: Sequence[Tensor]) -> Tensor:
    """A list over towers of ``[B, 5, L, D_tower]`` (the global view, then
    the tiles tl, tr, bl, br) -> ``[B, L, 2 * sum(D_tower)]`` in the first
    tower's dtype."""
    parts = [t[:, 0].float() for t in per_tower_tiles]
    for t in per_tower_tiles:
        tl, tr, bl, br = (_pool_half(t[:, i]) for i in range(1, 5))
        full = torch.cat([torch.cat([tl, tr], dim=2), torch.cat([bl, br], dim=2)], dim=1)
        B, H, W, D = full.shape
        parts.append(full.reshape(B, H * W, D))
    return torch.cat(parts, dim=-1).to(per_tower_tiles[0].dtype)


def uhd_image_to_tiles(image) -> List:
    """A PIL image -> [image, tl, tr, bl, br] (a 2x2 grid of crops)."""
    return [image] + split_into_tiles(image, 2, 2)


def extract_features_to_disk(encode_fn: Callable, image_files: Sequence[str], image_folder: str,
                             feature_folder: str, tower_sizes: Dict[str, int],
                             batch_size: int = 4) -> List[Path]:
    """Offline UHD extraction: ``encode_fn(images)`` (per-tower uint8 arrays
    ``[5 * n, size, size, 3]``, the five views of each image in turn) ->
    ``[n, L, D]`` fused features (a tensor or an array), written as one fp16
    ``.npz`` (key ``features``) an image under ``feature_folder``, at the
    image's relative path. Returns the paths written."""
    from PIL import Image

    out_paths = []
    folder = Path(feature_folder)
    for start in range(0, len(image_files), batch_size):
        chunk = image_files[start:start + batch_size]
        arrays: Dict[str, List[np.ndarray]] = {t: [] for t in tower_sizes}
        for name in chunk:
            img = Image.open(Path(image_folder) / name).convert("RGB")
            for tile in uhd_image_to_tiles(img):
                for t, size in tower_sizes.items():
                    arrays[t].append(np.asarray(tile.resize((size, size), Image.BICUBIC), np.uint8))
        feats = encode_fn({t: np.stack(v) for t, v in arrays.items()})
        if isinstance(feats, torch.Tensor):
            feats = feats.detach().float().cpu().numpy()
        feats = np.asarray(feats, np.float16)
        for i, name in enumerate(chunk):
            path = (folder / name).with_suffix(".npz")
            path.parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(path, features=feats[i])
            out_paths.append(path)
    return out_paths
