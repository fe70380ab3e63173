"""Hybrid RWKV <-> image-memory variants (v6.21 / v6.22 / v6.23).
Counterpart of ``visualrwkv_tpu/multimodal/hybrid.py``.

- v6.21 memory-read hybrid TimeMix: an attention-free lookup over the
  layer's image WKV state, out = wkv_out * relu(1 - mg) + (mr @ S_img) * mg,
  with mr / mg from a two-way data-dependent token-shift LoRA (reference
  v6.21/src/model.py:235-291). No path of the JAX package calls it.
- v6.22 / v6.23 softmax cross-attention: Q from the text stream, K / V from
  image features, written as plain products (matmul, fp32 softmax, matmul;
  operands in the compute dtype), as the JAX package writes it outside any
  kernel.
- v6.23 hybrid stack: RWKV blocks with cross-attention blocks (zero-init
  output projection, ReLU MLP with a zero-init projection) interleaved,
  counted from the end at ``cross_layer_interval`` (v6.23/src/model.py:
  232-367, 500-519; utils.py:256-270).

Linears are ``{"weight": [out, in]}``; the LoRA factors ``time_mem_w1
[C, 2 dm]`` and ``time_mem_w2 [2, dm, C]`` keep the JAX layout (``x @ w``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from visualrwkv_torch.config import STOP_TOKEN_INDEX, RWKVConfig, resolve_device
from visualrwkv_torch.models import lm
from visualrwkv_torch.models.rwkv7 import _lora, _ln_init, _token_shift, _uniform, embed, layer_norm, linear

Tensor = torch.Tensor
Params = Dict[str, Any]


def _d_mix_lora(cfg: RWKVConfig) -> int:
    return 64 if cfg.n_embd >= 4096 else 32


# ---------------------------------------------------------------------------
# v6.21: memory-read hybrid
# ---------------------------------------------------------------------------


def init_memory_read_params(gen: torch.Generator, cfg: RWKVConfig, layer_id: int, device="cuda") -> Params:
    device = resolve_device(device)
    C, A = cfg.n_embd, cfg.dim_att
    dm = _d_mix_lora(cfg)
    ratio_1_to_almost0 = 1.0 - layer_id / cfg.n_layer
    ddd = torch.arange(C, dtype=torch.float32, device=device) / C
    return {
        "mem_read": {"weight": _uniform(gen, (A, C), -0.5 / C**0.5, 0.5 / C**0.5, device)},
        "mem_gate": {"weight": _uniform(gen, (A, C), -1e-4, 1e-4, device)},
        "time_mem_w1": torch.zeros(C, dm * 2, device=device),
        "time_mem_w2": _uniform(gen, (2, dm, C), -0.01, 0.01, device),
        "time_mem_r": 1.0 - ddd ** (0.5 * ratio_1_to_almost0),
        "time_mem_g": 1.0 - ddd ** (0.5 * ratio_1_to_almost0),
    }


def memory_read_mix(p: Params, mem: Params, cfg: RWKVConfig, x: Tensor, wkv_out: Tensor,
                    s_img: Tensor) -> Tensor:
    """Blend a TimeMix's WKV output with a lookup over the image state. p:
    the x060 TimeMix's parameters (``time_maa_x``); x: the block input
    ``[B, T, C]`` (ln1'd); wkv_out ``[B, T, C]``: the WKV output before
    ``ln_x``; s_img ``[B, H, N, N]``: the layer's image state. Returns
    ``[B, T, C]`` in wkv_out's dtype."""
    B, T, C = x.shape
    H, N = cfg.n_head, cfg.head_size
    dt = cfg.dtype
    xf = x.float()
    xx = _token_shift(xf, None) - xf
    xxx = (xf + xx * p["time_maa_x"].float()).to(dt)
    mixed = torch.tanh(_lora(xxx, mem["time_mem_w1"], dt))
    D = mixed.shape[-1] // 2
    m = torch.einsum("btsd,sdc->btsc", mixed.reshape(B, T, 2, D).to(dt), mem["time_mem_w2"].to(dt)).float()
    er, eg = m[:, :, 0], m[:, :, 1]
    xr = (xf + xx * (mem["time_mem_r"].float() + er)).to(dt)
    xg = (xf + xx * (mem["time_mem_g"].float() + eg)).to(dt)
    mr = linear(mem["mem_read"], xr, dt).reshape(B, T, H, N)
    mg = torch.relu(linear(mem["mem_gate"], xg, dt)).reshape(B, T, H, N)
    read = torch.einsum("bthn,bhnm->bthm", mr, s_img.float())  # [B, T, H, N] x [B, H, N, N]
    out = wkv_out.float().reshape(B, T, H, N)
    mixed_out = out * torch.relu(1.0 - mg) + read * mg
    return mixed_out.reshape(B, T, C).to(wkv_out.dtype)


# ---------------------------------------------------------------------------
# v6.22 / v6.23: softmax cross-attention over image features
# ---------------------------------------------------------------------------


def init_cross_attention_params(gen: torch.Generator, cfg: RWKVConfig, device="cuda") -> Params:
    device = resolve_device(device)
    C, A = cfg.n_embd, cfg.dim_att
    return {
        "query": {"weight": _uniform(gen, (A, C), -0.5 / C**0.5, 0.5 / C**0.5, device)},
        "key": {"weight": _uniform(gen, (A, C), -0.05 / C**0.5, 0.05 / C**0.5, device)},
        "value": {"weight": _uniform(gen, (A, C), -0.5 / C**0.5, 0.5 / C**0.5, device)},
        "output": {"weight": torch.zeros(C, A, device=device)},
    }


def cross_attention(p: Params, cfg: RWKVConfig, query: Tensor, key_value: Tensor) -> Tensor:
    """Multi-head softmax cross-attention: query ``[B, T, C]``, key_value
    ``[B, S, C]``; the products take operands in the compute dtype, the
    softmax is fp32. Returns ``[B, T, C]`` fp32."""
    B, T, C = query.shape
    H, N = cfg.n_head, cfg.head_size
    dt = cfg.dtype
    heads = lambda t: t.reshape(B, t.shape[1], H, N).transpose(1, 2)
    q = heads(linear(p["query"], query, dt))
    k = heads(linear(p["key"], key_value, dt))
    v = heads(linear(p["value"], key_value, dt))
    scores = torch.matmul(q.to(dt), k.to(dt).transpose(-1, -2)).float() / math.sqrt(N)
    attn = torch.softmax(scores, dim=-1)
    out = torch.matmul(attn.to(dt), v.to(dt)).float()
    out = out.transpose(1, 2).reshape(B, T, H * N)
    return linear(p["output"], out.to(dt), dt)


def init_cross_block_params(gen: torch.Generator, cfg: RWKVConfig, device="cuda") -> Params:
    device = resolve_device(device)
    C = cfg.n_embd
    return {
        "ln1": _ln_init(C, device),
        "ln2": _ln_init(C, device),
        "att": init_cross_attention_params(gen, cfg, device),
        "ffn": {
            "c_fc": {"weight": _uniform(gen, (cfg.dim_ffn, C), -0.5 / C**0.5, 0.5 / C**0.5, device)},
            "c_proj": {"weight": torch.zeros(C, cfg.dim_ffn, device=device)},
        },
    }


def cross_attention_block(p: Params, cfg: RWKVConfig, x: Tensor, image_features: Tensor) -> Tensor:
    dt = cfg.dtype
    x = x + cross_attention(p["att"], cfg, layer_norm(p["ln1"], x), image_features)
    h = torch.relu(linear(p["ffn"]["c_fc"], layer_norm(p["ln2"], x), dt))
    return x + linear(p["ffn"]["c_proj"], h.to(dt), dt)


def get_cross_block_indices(n_layer: int, n_cross_layer: int, cross_layer_interval: int) -> List[int]:
    """Positions of the cross blocks in the interleaved stack, placed from
    the END at the given interval (utils.py:256-270)."""
    total = n_layer + n_cross_layer
    indices = []
    for i in range(n_cross_layer):
        idx = total - 1 - cross_layer_interval * i
        if idx < 0:
            raise ValueError("cross_layer_interval too large")
        indices.append(idx)
    return indices


def init_hybrid_rwkv_params(gen: torch.Generator, cfg: RWKVConfig, n_cross_layer: int, device="cuda",
                            dtype: Optional[torch.dtype] = None) -> Params:
    """An LM's parameters (any family) with ``n_cross_layer`` cross blocks
    (``"cross_blocks"``, fp32) beside its blocks: v6.23's HybridRWKV."""
    device = resolve_device(device)
    params = lm.init_lm_params(gen, cfg, device, dtype)
    params["cross_blocks"] = [init_cross_block_params(gen, cfg, device) for _ in range(n_cross_layer)]
    return params


def hybrid_rwkv_forward(params: Params, cfg: RWKVConfig, x: Tensor, image_features: Tensor,
                        cross_layer_interval: int = 1, grad_cp: bool = False) -> Tensor:
    """The interleaved forward (v6.23 ``forward_with_image_features``): x
    ``[B, T, C]`` left-padded with EOS embeddings to a multiple of
    ``chunk_len``, image_features ``[B, S, C]``. Each RWKV block takes its
    own index among the RWKV blocks as layer id, and x070's ``v_first``
    passes across the cross blocks unchanged. ``grad_cp``: every block under
    activation checkpointing. Returns logits ``[B, T, vocab]`` fp32."""
    B, T, C = x.shape
    pad = (-T) % cfg.chunk_len
    if pad:
        eos = embed(params, torch.full((B, pad), STOP_TOKEN_INDEX, dtype=torch.long, device=x.device))
        x = torch.cat([eos.to(x.dtype), x], dim=1)
    n_cross = len(params["cross_blocks"])
    cross_at = set(get_cross_block_indices(len(params["blocks"]), n_cross, cross_layer_interval))
    bi = ci = 0
    v_first = None
    for i in range(len(params["blocks"]) + n_cross):
        if i in cross_at:
            blk = params["cross_blocks"][ci]
            run = lambda xx, feats, blk=blk: cross_attention_block(blk, cfg, xx, feats)
            if grad_cp:
                x = checkpoint(run, x, image_features, use_reentrant=False, preserve_rng_state=False)
            else:
                x = run(x, image_features)
            ci += 1
        else:
            x, v_first, _ = lm.lm_block_forward(params["blocks"][bi], cfg, bi, x, v_first, grad_cp=grad_cp)
            bi += 1
    x = layer_norm(params["ln_out"], x)
    if pad:
        x = x[:, pad:]
    return linear(params["head"], x, cfg.dtype)
