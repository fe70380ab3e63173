"""Language-model facade: dispatch on ``cfg.version``. Counterpart of
``visualrwkv_tpu/models/lm.py``: "x070" (RWKV-7, the flagship), "x060"
(RWKV-6, the published VisualRWKV-6 backbone), "x052" (the legacy RWKV-5.2:
a static decay through the WKV6 kernels) and "x040" (the frozen RWKV-4 RNN:
the per-channel (aa, bb, pp) recurrence, ``ops.wkv4``). x070, x060 and x052
carry the ``[B, H, N, N]`` matrix state
(:func:`visualrwkv_torch.models.rwkv7.init_state`), x040 a ``[B, C, 3]``
triple."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from visualrwkv_torch.config import RWKVConfig
from visualrwkv_torch.models import rwkv4, rwkv5, rwkv6, rwkv7
from visualrwkv_torch.models.rwkv7 import LayerState

Tensor = torch.Tensor
Params = Dict[str, Any]

# version -> (init params, forward, decode step from a token, decode step from an embedding)
_FAMILIES = {
    "x070": (rwkv7.init_rwkv7_params, rwkv7.rwkv7_forward, rwkv7.rwkv7_decode_step,
             rwkv7.rwkv7_decode_step_embed),
    "x060": (rwkv6.init_rwkv6_params, rwkv6.rwkv6_forward, rwkv6.rwkv6_decode_step,
             rwkv6.rwkv6_decode_step_embed),
    "x052": (rwkv5.init_rwkv5_params, rwkv5.rwkv5_forward, rwkv5.rwkv5_decode_step,
             rwkv5.rwkv5_decode_step_embed),
    "x040": (rwkv4.init_rwkv4_params, rwkv4.rwkv4_forward, rwkv4.rwkv4_decode_step,
             rwkv4.rwkv4_decode_step_embed),
}


def init_lm_state(cfg: RWKVConfig, batch: int, device="cuda") -> List[LayerState]:
    if cfg.version == "x040":
        return rwkv4.init_state_x040(cfg, batch, device)
    return rwkv7.init_state(cfg, batch, device)


def init_lm_params(gen: torch.Generator, cfg: RWKVConfig, device="cuda",
                   dtype: Optional[torch.dtype] = None) -> Params:
    return _FAMILIES[cfg.version][0](gen, cfg, device, dtype)


def lm_forward(params: Params, cfg: RWKVConfig, x: Tensor,
               states: Optional[List[LayerState]] = None, grad_cp=False,
               return_hidden: bool = False) -> Tuple[Tensor, List[LayerState]]:
    return _FAMILIES[cfg.version][1](params, cfg, x, states, grad_cp, return_hidden)


def lm_decode_step(params: Params, cfg: RWKVConfig, token: Tensor, states: List[LayerState]):
    return _FAMILIES[cfg.version][2](params, cfg, token, states)


def lm_decode_step_embed(params: Params, cfg: RWKVConfig, x_emb: Tensor, states: List[LayerState]):
    return _FAMILIES[cfg.version][3](params, cfg, x_emb, states)


_BLOCKS = {"x060": rwkv6.block_x060, "x052": rwkv5.block_x052, "x040": rwkv4.block_x040}


def lm_block_forward(params: Params, cfg: RWKVConfig, layer_id: int, x: Tensor,
                     v_first: Optional[Tensor], state: Optional[LayerState] = None, grad_cp=False):
    """One block of any family, for the paths that drive the blocks
    themselves (the bidirectional image span, the visual token compressor).
    Returns (x, v_first, state); ``v_first`` passes through unchanged but
    for x070. ``grad_cp`` as in the family's forward: the block runs under
    its family's activation checkpoint."""
    if cfg.version == "x070":
        if grad_cp:
            return rwkv7._block_checkpointed(params, cfg, layer_id, x, v_first, state,
                                             rwkv7._remat_context(grad_cp))
        return rwkv7.block_x070(params, cfg, layer_id, x, v_first, state)
    block = _BLOCKS[cfg.version]
    if grad_cp:
        x, st = rwkv6._block_checkpointed(params, cfg, layer_id, x, state, block=block)
    else:
        x, st = block(params, cfg, layer_id, x, state)
    return x, v_first, st
