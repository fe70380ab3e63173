"""Language-model facade: dispatch on ``cfg.version``. Counterpart of
``visualrwkv_tpu/models/lm.py``; the RWKV-7 ("x070") and RWKV-6 ("x060")
families are ported (the config rejects the others). Both carry the same
``[B, H, N, N]`` matrix state (:func:`visualrwkv_torch.models.rwkv7.init_state`)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from visualrwkv_torch.config import RWKVConfig
from visualrwkv_torch.models import rwkv6, rwkv7
from visualrwkv_torch.models.rwkv7 import LayerState

Tensor = torch.Tensor
Params = Dict[str, Any]


def init_lm_state(cfg: RWKVConfig, batch: int, device="cuda") -> List[LayerState]:
    return rwkv7.init_state(cfg, batch, device)


def init_lm_params(gen: torch.Generator, cfg: RWKVConfig, device="cuda",
                   dtype: Optional[torch.dtype] = None) -> Params:
    if cfg.version == "x060":
        return rwkv6.init_rwkv6_params(gen, cfg, device, dtype)
    return rwkv7.init_rwkv7_params(gen, cfg, device, dtype)


def lm_forward(params: Params, cfg: RWKVConfig, x: Tensor,
               states: Optional[List[LayerState]] = None, grad_cp=False,
               return_hidden: bool = False) -> Tuple[Tensor, List[LayerState]]:
    if cfg.version == "x060":
        return rwkv6.rwkv6_forward(params, cfg, x, states, grad_cp, return_hidden)
    return rwkv7.rwkv7_forward(params, cfg, x, states, grad_cp, return_hidden)


def lm_decode_step(params: Params, cfg: RWKVConfig, token: Tensor, states: List[LayerState]):
    if cfg.version == "x060":
        return rwkv6.rwkv6_decode_step(params, cfg, token, states)
    return rwkv7.rwkv7_decode_step(params, cfg, token, states)


def lm_decode_step_embed(params: Params, cfg: RWKVConfig, x_emb: Tensor, states: List[LayerState]):
    if cfg.version == "x060":
        return rwkv6.rwkv6_decode_step_embed(params, cfg, x_emb, states)
    return rwkv7.rwkv7_decode_step_embed(params, cfg, x_emb, states)
