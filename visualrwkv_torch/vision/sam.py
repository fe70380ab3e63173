"""SAM ViT-B image encoder: the third tower.

Counterpart of ``visualrwkv_tpu/vision/sam.py``: 1024px / patch 16 ViT-B
with windowed attention (window 14; global attention at blocks 2, 5, 8, 11),
decomposed relative positions, the conv neck to 256 channels and the
lossless space-to-depth downsampler 64x64x256 -> 32x32x1024. Activations
are NHWC at the public functions; parameters use PyTorch layouts (linears
``[out, in]``, convolutions OIHW).

Windowed blocks (N = 196) run plain PyTorch attention; blocks with more than
``MAX_DENSE_TOKENS`` tokens (the global blocks, N = 4096) run kernel K3
through :func:`visualrwkv_torch.vision.flash.sam_attention`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from visualrwkv_torch.vision.flash import sam_attention
from visualrwkv_torch.vision.vit import _linear_init, _ln_init, _normal, dense, layer_norm

Tensor = torch.Tensor
Params = Dict[str, Any]

MAX_DENSE_TOKENS = 2048  # above this, attention streams keys (kernel K3)


@dataclass(frozen=True)
class SAMConfig:
    img_size: int = 1024
    patch_size: int = 16
    width: int = 768
    depth: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    out_chans: int = 256
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    ln_eps: float = 1e-6
    downsample_factor: int = 2
    compute_dtype: str = "bfloat16"

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @property
    def output_dim(self) -> int:
        return self.out_chans * self.downsample_factor**2


SAM_VIT_B = SAMConfig()


def init_sam_params(gen: torch.Generator, cfg: SAMConfig, device="cuda",
                    dtype=torch.float32) -> Params:
    """Random init with the JAX package's distributions (zero rel-pos tables)."""
    C, hd, p, oc = cfg.width, cfg.head_dim, cfg.patch_size, cfg.out_chans
    params: Params = {
        "patch_embed": {"weight": _normal(gen, (C, 3, p, p), 0.02, device, dtype),
                        "bias": torch.zeros(C, device=device, dtype=dtype)},
        "pos_embed": _normal(gen, (cfg.grid, cfg.grid, C), 0.02, device, dtype),
        "blocks": [],
        "neck": {
            "conv1": {"weight": _normal(gen, (oc, C, 1, 1), 0.02, device, dtype)},
            "ln1": _ln_init(oc, device, dtype),
            "conv2": {"weight": _normal(gen, (oc, oc, 3, 3), 0.02, device, dtype)},
            "ln2": _ln_init(oc, device, dtype),
        },
    }
    for i in range(cfg.depth):
        size = cfg.grid if i in cfg.global_attn_indexes else cfg.window_size
        params["blocks"].append({
            "ln1": _ln_init(C, device, dtype),
            "ln2": _ln_init(C, device, dtype),
            "attn": {
                "qkv": _linear_init(gen, C, 3 * C, device, dtype),
                "proj": _linear_init(gen, C, C, device, dtype),
                "rel_pos_h": torch.zeros(2 * size - 1, hd, device=device, dtype=dtype),
                "rel_pos_w": torch.zeros(2 * size - 1, hd, device=device, dtype=dtype),
            },
            "mlp": {"fc1": _linear_init(gen, C, cfg.mlp_dim, device, dtype),
                    "fc2": _linear_init(gen, cfg.mlp_dim, C, device, dtype)},
        })
    return params


def window_partition(x: Tensor, window: int) -> Tuple[Tensor, Tuple[int, int]]:
    """[B, H, W, C] -> [B*nW, win, win, C], padding bottom/right to multiples."""
    B, H, W, C = x.shape
    pad_h, pad_w = (-H) % window, (-W) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window, window, Wp // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C), (Hp, Wp)


def window_unpartition(x: Tensor, window: int, pad_hw: Tuple[int, int],
                       hw: Tuple[int, int]) -> Tensor:
    Hp, Wp = pad_hw
    H, W = hw
    B = x.shape[0] // (Hp // window * Wp // window)
    x = x.reshape(B, Hp // window, Wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


def _rel_pos_table(size: int, rel_pos: Tensor) -> Tensor:
    """[2*size-1, hd] -> [size, size, hd] by relative-coordinate gather."""
    ar = torch.arange(size, device=rel_pos.device)
    return rel_pos[ar[:, None] - ar[None, :] + size - 1]


def attention_relpos(p: Params, x: Tensor, heads: int, dt: torch.dtype) -> Tensor:
    """Attention over [B, H, W, C] tokens with decomposed relative positions."""
    B, H, W, C = x.shape
    hd = C // heads
    N = H * W
    qkv = dense(p["qkv"], x.reshape(B, N, C), dt).reshape(B, N, 3, heads, hd)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))  # [B, h, N, hd] fp32
    scale = hd**-0.5

    rh = _rel_pos_table(H, p["rel_pos_h"]).float()  # [Hq, Hk, hd]
    rw = _rel_pos_table(W, p["rel_pos_w"]).float()
    qs = q.float().reshape(B, heads, H, W, hd)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", qs, rh).reshape(B, heads, N, H)
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", qs, rw).reshape(B, heads, N, W)

    if N <= MAX_DENSE_TOKENS:
        logits = ((q * scale).to(dt).float() @ k.to(dt).float().transpose(-1, -2))
        bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(B, heads, N, N)
        attn = torch.softmax(logits + bias, dim=-1)
        out = attn.to(dt).float() @ v.to(dt).float()
    else:
        G = B * heads
        out = sam_attention(
            q.reshape(G, N, hd).to(dt).contiguous(), k.reshape(G, N, hd).to(dt).contiguous(),
            v.reshape(G, N, hd).to(dt).contiguous(), rel_h.reshape(G, N, H).contiguous(),
            rel_w.reshape(G, N, W).contiguous(), scale,
        ).reshape(B, heads, N, hd).float()
    out = out.permute(0, 2, 1, 3).reshape(B, N, C)
    return dense(p["proj"], out, dt).reshape(B, H, W, C)


def sam_block(p: Params, cfg: SAMConfig, x: Tensor, layer_id: int, dt: torch.dtype) -> Tensor:
    shortcut = x
    x = layer_norm(p["ln1"], x, cfg.ln_eps)
    windowed = layer_id not in cfg.global_attn_indexes
    if windowed:
        hw = x.shape[1:3]
        x, pad_hw = window_partition(x, cfg.window_size)
    x = attention_relpos(p["attn"], x, cfg.heads, dt)
    if windowed:
        x = window_unpartition(x, cfg.window_size, pad_hw, hw)
    x = shortcut + x.to(shortcut.dtype)
    h = dense(p["mlp"]["fc1"], layer_norm(p["ln2"], x, cfg.ln_eps), dt)
    h = dense(p["mlp"]["fc2"], F.gelu(h).to(dt), dt)
    return x + h.to(x.dtype)


def _conv(p: Params, x: Tensor, dt: torch.dtype) -> Tensor:
    """'Same' convolution on NHWC with an OIHW weight; fp32 result."""
    kh = p["weight"].shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), p["weight"].to(dt), padding=kh // 2)
    return y.float().permute(0, 2, 3, 1)


def sam_features(params: Params, cfg: SAMConfig, pixels: Tensor) -> Tensor:
    """[B, S, S, 3] -> [B, (grid/2)^2, out_chans*4] token features."""
    dt = getattr(torch, cfg.compute_dtype)
    B = pixels.shape[0]
    g, f = cfg.grid, cfg.downsample_factor
    pe = params["patch_embed"]
    x = F.conv2d(pixels.permute(0, 3, 1, 2).to(dt), pe["weight"].to(dt), stride=cfg.patch_size)
    x = x.float().permute(0, 2, 3, 1) + pe["bias"].float()
    x = x + params["pos_embed"].to(x.dtype)
    for i, blk in enumerate(params["blocks"]):
        x = sam_block(blk, cfg, x, i, dt)
    neck = params["neck"]
    # channel LayerNorms on NHWC (the reference's LayerNorm2d), eps 1e-6
    x = layer_norm(neck["ln1"], _conv(neck["conv1"], x, dt), 1e-6)
    x = layer_norm(neck["ln2"], _conv(neck["conv2"], x, dt), 1e-6)  # [B, g, g, out_chans]
    # lossless space-to-depth, feature order c*f^2 + dh*f + dw
    gh = g // f
    x = x.reshape(B, gh, f, gh, f, cfg.out_chans).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, gh * gh, cfg.output_dim)


def global_blocks(cfg: SAMConfig) -> int:
    """Blocks that run kernel K3 (more than MAX_DENSE_TOKENS tokens)."""
    return len(cfg.global_attn_indexes) if cfg.grid**2 > MAX_DENSE_TOKENS else 0
