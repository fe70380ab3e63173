"""Image patch scanning orders (v5.1) and the tiny attention layer (v5.2).
Counterpart of ``visualrwkv_tpu/multimodal/scanning.py``.

v5.1 reorders the square patch grid before the image tokens reach the
recurrent LM (v5.1/src/model.py:348-416): unidirection (raster),
bidirection (raster, then reversed), multidirection (the four rotations),
rotation (a quarter turn), spiral (outside in), snake (boustrophedon),
zigzag (anti-diagonals). Each is a permutation made on the host and applied
as one gather on the device.

v5.2's tiny attention: one small softmax-attention layer whose keys and
values come from the image-embedding residual (v5.2/src/model.py:212-283).
The JAX package defines it and calls it from no path; so does the port.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

from visualrwkv_torch.models.rwkv7 import layer_norm, linear

Tensor = torch.Tensor
Params = Dict[str, Any]


def raster_order(n: int) -> np.ndarray:
    return np.arange(n * n)


def snake_order(n: int) -> np.ndarray:
    grid = np.arange(n * n).reshape(n, n)
    return np.concatenate([grid[i] if i % 2 == 0 else grid[i][::-1] for i in range(n)])


def zigzag_order(n: int) -> np.ndarray:
    """Anti-diagonal traversal (JPEG's zigzag)."""
    order = []
    for s in range(2 * n - 1):
        diag = [(i, s - i) for i in range(max(0, s - n + 1), min(n, s + 1))]
        if s % 2 == 1:
            diag.reverse()
        order.extend(i * n + j for i, j in diag)
    return np.asarray(order)


def spiral_order(n: int) -> np.ndarray:
    """Outside-in clockwise spiral."""
    grid = np.arange(n * n).reshape(n, n)
    out: List[int] = []
    top, bottom, left, right = 0, n - 1, 0, n - 1
    while top <= bottom and left <= right:
        out.extend(grid[top, left:right + 1])
        out.extend(grid[i, right] for i in range(top + 1, bottom + 1))
        if top < bottom:
            out.extend(grid[bottom, left:right][::-1])
        if left < right:
            out.extend(grid[i, left] for i in range(bottom - 1, top, -1))
        top, bottom, left, right = top + 1, bottom - 1, left + 1, right - 1
    return np.asarray(out)


def rotation_order(n: int, quarter_turns: int = 1) -> np.ndarray:
    return np.rot90(np.arange(n * n).reshape(n, n), k=quarter_turns).reshape(-1)


def scan_orders(n: int, strategy: str) -> List[np.ndarray]:
    """A strategy's permutations of the n x n grid; with several, the image
    tokens are concatenated in each order."""
    if strategy == "unidirection":
        return [raster_order(n)]
    if strategy == "bidirection":
        return [raster_order(n), raster_order(n)[::-1]]
    if strategy == "multidirection":
        return [rotation_order(n, k) for k in range(4)]
    if strategy == "rotation":
        return [rotation_order(n, 1)]
    if strategy == "spiral":
        return [spiral_order(n)]
    if strategy == "snake":
        return [snake_order(n)]
    if strategy == "zigzag":
        return [zigzag_order(n)]
    raise ValueError(f"unknown scanning strategy {strategy}")


def apply_scanning(image_features: Tensor, strategy: str) -> Tensor:
    """``[N_img, L, D]`` -> ``[N_img, L * n_orders, D]``, reordered and
    concatenated."""
    L = image_features.shape[1]
    n = int(round(math.sqrt(L)))
    if n * n != L:
        raise ValueError(f"patch count {L} is not square")
    order = np.concatenate(scan_orders(n, strategy))
    return image_features[:, torch.from_numpy(order).to(image_features.device)]


# ---------------------------------------------------------------------------
# v5.2 tiny attention
# ---------------------------------------------------------------------------


def init_tiny_attention_params(gen: torch.Generator, n_embd: int, tiny_att_dim: int,
                               device="cuda") -> Params:
    """Uniform(-1/sqrt(C), 1/sqrt(C)) projections (``[out, in]``), a zero
    output projection: the layer starts as the identity."""
    std = n_embd**-0.5
    u = lambda *shape: torch.empty(shape, device=device).uniform_(-std, std, generator=gen)
    return {
        "ln": {"weight": torch.ones(n_embd, device=device), "bias": torch.zeros(n_embd, device=device)},
        "q": {"weight": u(tiny_att_dim, n_embd)},
        "k": {"weight": u(tiny_att_dim, n_embd)},
        "v": {"weight": u(n_embd, n_embd)},
        "out": {"weight": torch.zeros(n_embd, n_embd, device=device)},
    }


def tiny_attention(p: Params, x: Tensor, x_emb: Tensor, causal: bool = True,
                   dtype=torch.bfloat16) -> Tensor:
    """One head of softmax attention whose keys and values are the image
    embedding residual: ``x + out(softmax(q(ln(x)) k(x_emb)^T / sqrt(d)) v(x_emb))``,
    causal when ``x_emb`` is as long as ``x``."""
    dt = dtype
    T = x.shape[1]
    q = linear(p["q"], layer_norm(p["ln"], x), dt)
    k = linear(p["k"], x_emb, dt)
    v = linear(p["v"], x_emb, dt)
    scores = (q.to(dt) @ k.to(dt).transpose(1, 2)).float() / math.sqrt(q.shape[-1])
    if causal and x_emb.shape[1] == T:
        mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    attn = torch.softmax(scores, -1)
    out = (attn.to(dt) @ v.to(dt)).float()
    return x + linear(p["out"], out.to(dt), dt).to(x.dtype)
