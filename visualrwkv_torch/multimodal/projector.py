"""Vision -> language projector and token-space utilities.
Counterpart of ``visualrwkv_tpu/multimodal/projector.py``: linear / gated-MLP
projector, exact adaptive average pooling, CLIP grid pooling, and the scatter
of image features into ``IMAGE_TOKEN_INDEX`` positions."""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from visualrwkv_torch.config import IMAGE_TOKEN_INDEX

Tensor = torch.Tensor
Params = Dict[str, Any]


def init_projector_params(gen: torch.Generator, proj_type: str, in_dim: int, n_embd: int,
                          device="cuda", dtype=torch.float32) -> Params:
    """Normal(0, in_dim^-1/2) weights in ``[out, in]`` layout."""
    def w(dout, din):
        return (torch.randn(dout, din, generator=gen, device=device) * in_dim**-0.5).to(dtype)

    if proj_type == "linear":
        return {"weight": w(n_embd, in_dim)}
    if proj_type == "mlp":
        return {
            "gate": {"weight": w(in_dim, in_dim)},
            "o_proj": {"weight": w(n_embd, in_dim)},
            "ln_v": {"weight": torch.ones(n_embd, device=device, dtype=dtype),
                     "bias": torch.zeros(n_embd, device=device, dtype=dtype)},
        }
    raise ValueError(f"unknown proj_type {proj_type}")


def apply_projector(p: Params, proj_type: str, x: Tensor, dtype=torch.bfloat16) -> Tensor:
    dt = dtype
    if proj_type == "linear":
        return F.linear(x.to(dt), p["weight"].to(dt)).to(dt)
    gating = torch.sigmoid(F.linear(x.to(dt), p["gate"]["weight"].to(dt)).float())
    h = F.linear((x.float() * gating).to(dt), p["o_proj"]["weight"].to(dt)).float()
    out = F.layer_norm(h, h.shape[-1:], p["ln_v"]["weight"].float(), p["ln_v"]["bias"].float(), 1e-5)
    return out.to(dt)


def adaptive_pool_tokens(x: Tensor, num_tokens: int) -> Tensor:
    """[N, L, D] -> [N, num_tokens, D] by exact 2-D average pooling, where
    sqrt(num_tokens) divides sqrt(L)."""
    N, L, D = x.shape
    src, dst = int(round(L**0.5)), int(round(num_tokens**0.5))
    if src * src != L or dst * dst != num_tokens or src % dst:
        raise ValueError(f"adaptive pool needs square grids with {dst} | {src}: L={L}, tokens={num_tokens}")
    if src == dst:
        return x
    f = src // dst
    xf = x.float().reshape(N, dst, f, dst, f, D)
    return xf.mean(dim=(2, 4)).reshape(N, num_tokens, D).to(x.dtype)


def grid_pooling(image_features: Tensor, grid_size: int) -> Tensor:
    """CLIP-style pooling of ``[N, 1 + L, D]`` features with the CLS token at
    position 0 (the v5 / v6.0 grid pooling). ``grid_size``: -1 = no pooling
    (patches, then CLS: 1 + L tokens), 0 = CLS only, 1 = the patches' mean
    and CLS, g > 1 = g x g average pooling of the patch grid and CLS."""
    cls_features, patches = image_features[:, :1], image_features[:, 1:]
    if grid_size == -1:
        return torch.cat([patches, cls_features], dim=1)
    if grid_size == 0:
        return cls_features
    if grid_size == 1:
        return torch.cat([patches.mean(dim=1, keepdim=True), cls_features], dim=1)
    B, L, D = patches.shape
    hw = int(round(L**0.5))
    if grid_size < 0 or hw * hw != L or hw % grid_size:
        raise ValueError(f"grid pooling needs a square grid divisible by {grid_size}: L={L}")
    s = hw // grid_size
    pooled = patches.float().reshape(B, grid_size, s, grid_size, s, D).mean(dim=(2, 4))
    return torch.cat([pooled.reshape(B, grid_size * grid_size, D).to(image_features.dtype),
                      cls_features], dim=1)


def scatter_image_features(input_ids: Tensor, input_embeds: Tensor, image_features: Tensor) -> Tensor:
    """Place flattened image features at IMAGE_TOKEN_INDEX positions, in
    batch-major order; with more image tokens than rows the last row repeats."""
    B, T = input_ids.shape
    D = input_embeds.shape[-1]
    flat_ids = input_ids.reshape(B * T)
    flat_emb = input_embeds.reshape(B * T, D)
    feats = image_features.reshape(-1, D).to(flat_emb.dtype)
    mask = flat_ids == IMAGE_TOKEN_INDEX
    order = (torch.cumsum(mask.to(torch.int64), 0) - 1).clamp(0, feats.shape[0] - 1)
    out = torch.where(mask[:, None], feats[order], flat_emb)
    return out.reshape(B, T, D)
