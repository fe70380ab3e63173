"""High-resolution image strategies: tiling, regions, video frame sampling.
Counterpart of ``visualrwkv_tpu/data/tiling.py`` (host code: PIL and numpy,
nothing on the device).

Reproduces the reference's input-construction protocols
(VisualRWKV-v7/v7.00/src/utils.py:11,44-118 and evaluate.py:93-137):

- ``select_best_resolution`` over the 5 aspect-ratio buckets;
- single image -> [full image] + N tiles ("single->multi" eval strategy);
- region splitting (v7.02: resize to best resolution, split into fixed-size
  regions, v7.02/src/utils.py:100-117);
- uniform video-frame sampling.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

POSSIBLE_RESOLUTIONS: List[Tuple[int, int]] = [
    (448, 896), (896, 448), (896, 896), (448, 1344), (1344, 448)
]

_GRID_FOR_RESOLUTION = {
    (448, 896): (2, 1),
    (896, 448): (1, 2),
    (896, 896): (2, 2),
    (448, 1344): (3, 1),
    (1344, 448): (1, 3),
}


def select_best_resolution(
    original_size: Tuple[int, int],
    possible_resolutions: Sequence[Tuple[int, int]] = POSSIBLE_RESOLUTIONS,
) -> Tuple[int, int]:
    """Pick the bucket minimizing wasted area after aspect-preserving fit."""
    ow, oh = original_size
    best, best_waste = None, float("inf")
    for w, h in possible_resolutions:
        scale = min(w / ow, h / oh)
        effective = int(ow * scale) * int(oh * scale)
        waste = abs(w * h - effective)
        if waste < best_waste:
            best_waste = waste
            best = (w, h)
    return best


def split_into_tiles(image, n_rows: int, n_cols: int) -> List:
    """Split a PIL image into an n_rows x n_cols grid of crops (row-major)."""
    w, h = image.size
    tw, th = w // n_cols, h // n_rows
    tiles = []
    for i in range(n_rows):
        for j in range(n_cols):
            tiles.append(image.crop((j * tw, i * th, (j + 1) * tw, (i + 1) * th)))
    return tiles


def n_tiles_for_size(size: Tuple[int, int]) -> int:
    """Images-per-sample the multi-tile strategy will produce for an original
    size (1 when it stays single; else 1 + rows*cols) — size-only, no pixels."""
    best = select_best_resolution(size)
    if best == (896, 896) and size[0] * size[1] <= 896 * 896:
        return 1
    n, m = _GRID_FOR_RESOLUTION[best]
    return 1 + n * m


def single_to_multi_images(image) -> List:
    """[full image] + aspect-matched tiles (reference utils.py:91-118; a small
    ~1:1 image stays single)."""
    best = select_best_resolution(image.size)
    if best == (896, 896) and image.size[0] * image.size[1] <= 896 * 896:
        return [image]
    n, m = _GRID_FOR_RESOLUTION[best]
    return [image] + split_into_tiles(image, n, m)


def image_to_regions(image, region_size: int = 448) -> List:
    """v7.02 region protocol: resize to the best bucket, split into fixed-size
    regions (row-major)."""
    from PIL import Image

    best = select_best_resolution(image.size)
    resized = image.resize(best, Image.BICUBIC)
    n, m = best[1] // region_size, best[0] // region_size
    return split_into_tiles(resized, n, m)


def gpt4v_crop(image, detail: str = "high", crop_size: int = 336) -> List:
    """GPT-4V-style detail crops (reference v6.0/src/utils.py, used by
    rank_answer.py:107-118): "low" = [image]; "high" = [full image] + up to
    2x3 grid of crop_size crops over the aspect-fit resized image."""
    from PIL import Image

    if detail == "low":
        return [image]
    w, h = image.size
    # aspect-preserving fit into a 2x3 / 3x2 crop grid
    if w >= h:
        n_cols, n_rows = 3, 2
    else:
        n_cols, n_rows = 2, 3
    resized = image.resize((n_cols * crop_size, n_rows * crop_size), Image.BICUBIC)
    return [image] + split_into_tiles(resized, n_rows, n_cols)


def sample_video_frames(frame_paths: Sequence, num_frames: int) -> List:
    """Uniform frame sampling (reference evaluate.py:117-126)."""
    frame_paths = list(frame_paths)
    if len(frame_paths) <= num_frames:
        return frame_paths
    idx = np.round(np.linspace(0, len(frame_paths) - 1, num_frames)).astype(int)
    return [frame_paths[i] for i in idx]


def load_video_frame_paths(video_dir: Path) -> List[Path]:
    return sorted(Path(video_dir).rglob("*.jpg"))
