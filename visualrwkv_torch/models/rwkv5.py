"""RWKV-5.2 ("x052") language model in PyTorch: the legacy VisualRWKV-v5
backbone. Counterpart of ``visualrwkv_tpu/models/rwkv5.py``.

Static token-shift mixes (``x * mix + shift(x) * (1 - mix)``), a static
per-(head, channel) decay ``exp(-exp(time_decay))``, the per-head bonus
``time_faaaa``, a SiLU gate, GroupNorm over heads, and the receptance-gated
ChannelMix of x060 under ``time_mix_*`` names. Parameters are nested dicts
with the JAX package's leaf names; linears are ``{"weight": [out, in]}``.

The recurrence is the WKV6 recurrence with the decay held constant over
time, so the port's WKV6 dispatchers serve it with ``time_decay`` broadcast
over T, as the JAX package does: the prefill runs kernel K7 on CUDA (K8 /
K9 under autograd), with the WKV6 decay floor -80 / chunk_len of
:func:`visualrwkv_torch.ops.wkv6.wkv6`, and the decode step kernel K10 on
the head or the flat state (``wkv6_step_auto``). The GroupNorm's eps is
``1e-5 * head_size_divisor**2``: the reference's ``ln_x(x / divisor)`` with
eps 1e-5, written without the division.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from visualrwkv_torch.config import STOP_TOKEN_INDEX, RWKVConfig
from visualrwkv_torch.models.rwkv6 import _block_checkpointed, _tmix_output
from visualrwkv_torch.models.rwkv7 import (
    GRAD_CP,
    LayerState,
    _cast_tree,
    _ln_init,
    _ortho,
    _token_shift,
    _uniform,
    embed,
    layer_norm,
    linear,
)
from visualrwkv_torch.ops.wkv6 import wkv6, wkv6_step_auto

Tensor = torch.Tensor
Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Init (the reference's formulas, as in the JAX package)
# ---------------------------------------------------------------------------


def init_tmix_x052(gen: torch.Generator, cfg: RWKVConfig, layer_id: int, device) -> Params:
    C, H, N, A = cfg.n_embd, cfg.n_head, cfg.head_size, cfg.dim_att
    r01 = layer_id / max(1, cfg.n_layer - 1)
    r10 = 1.0 - layer_id / cfg.n_layer
    ddd = torch.arange(C, dtype=torch.float32, device=device) / C
    n = torch.arange(A, dtype=torch.float64, device=device)
    decay_speed = (-6 + 5 * (n / max(1, A - 1)) ** (0.7 + 1.3 * r01)).float()
    zigzag = (((n + 1) % 3 - 1) * 0.1).float()
    faaaa = (r01 * (1 - n / max(1, A - 1))).float() + zigzag
    u = lambda shape, s: _uniform(gen, shape, -s, s, device)
    return {
        "time_mix_k": ddd**r10,
        "time_mix_v": ddd**r10 + 0.3 * r01,
        "time_mix_r": ddd ** (0.5 * r10),
        "time_mix_g": ddd ** (0.5 * r10),
        "time_decay": decay_speed.reshape(H, N),
        "time_faaaa": faaaa.reshape(H, N),
        "receptance": {"weight": u((A, C), 0.5 / C**0.5)},
        "key": {"weight": u((A, C), 0.05 / C**0.5)},
        "value": {"weight": u((A, C), 0.5 / C**0.5)},
        "gate": {"weight": u((A, C), 0.5 / C**0.5)},
        "output": {"weight": torch.zeros(C, A, device=device)},
        "ln_x": _ln_init(A, device),
    }


def init_cmix_x052(gen: torch.Generator, cfg: RWKVConfig, layer_id: int, device) -> Params:
    """The ChannelMix of x052 and x040 (one init in the JAX package too)."""
    C = cfg.n_embd
    r10 = 1.0 - layer_id / cfg.n_layer
    ddd = torch.arange(C, dtype=torch.float32, device=device) / C
    s = 0.5 / C**0.5
    return {
        "time_mix_k": ddd**r10,
        "time_mix_r": ddd**r10,
        "key": {"weight": _uniform(gen, (cfg.dim_ffn, C), -s, s, device)},
        "receptance": {"weight": _uniform(gen, (C, C), -s, s, device)},
        "value": {"weight": torch.zeros(C, cfg.dim_ffn, device=device)},
    }


def init_legacy_params(gen: torch.Generator, cfg: RWKVConfig, init_tmix, device="cuda",
                       dtype: Optional[torch.dtype] = None) -> Params:
    """The x052 / x040 tree (``init_tmix`` makes a block's TimeMix); each
    leaf cast to ``dtype`` as it is made, as ``init_rwkv6_params`` does."""
    C = cfg.n_embd
    cast = (lambda t: _cast_tree(t, dtype)) if dtype is not None else (lambda t: t)
    blocks: List[Params] = []
    for i in range(cfg.n_layer):
        blk = {
            "ln1": _ln_init(C, device),
            "ln2": _ln_init(C, device),
            "att": init_tmix(gen, cfg, i, device),
            "ffn": init_cmix_x052(gen, cfg, i, device),
        }
        if i == 0:
            blk["ln0"] = _ln_init(C, device)
        blocks.append(cast(blk))
    emb = cast(_uniform(gen, (cfg.vocab_size, C), -1e-4, 1e-4, device))
    if C * cfg.vocab_size <= 16 * 2**20:
        head = _ortho(gen, C, cfg.vocab_size, 0.5, device).t().contiguous()
    else:
        head = torch.randn(cfg.vocab_size, C, generator=gen, device=device) * (0.5 * C**-0.5)
    return {"emb": {"weight": emb}, "blocks": blocks, "ln_out": cast(_ln_init(C, device)),
            "head": {"weight": cast(head)}}


def init_rwkv5_params(gen: torch.Generator, cfg: RWKVConfig, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> Params:
    return init_legacy_params(gen, cfg, init_tmix_x052, device, dtype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def static_mixes(p: Params, xf: Tensor, prev: Tensor, dt: torch.dtype, names) -> List[Tensor]:
    """The static token shift: ``x * mix + prev * (1 - mix)`` a branch, in ``dt``."""
    out = []
    for n in names:
        mix = p[f"time_mix_{n}"].float()
        out.append((xf * mix + prev * (1.0 - mix)).to(dt))
    return out


def _tmix_inputs(p: Params, cfg: RWKVConfig, xf: Tensor, prev: Tensor):
    """(r, k, v, g) fp32 and the decay ``w_raw`` in the compute dtype, [H, N]."""
    dt = cfg.dtype
    xk, xv, xr, xg = static_mixes(p, xf, prev, dt, ("k", "v", "r", "g"))
    r = linear(p["receptance"], xr, dt)
    k = linear(p["key"], xk, dt)
    v = linear(p["value"], xv, dt)
    g = F.silu(linear(p["gate"], xg, dt))
    return r, k, v, g, p["time_decay"].to(dt)


def tmix_x052(p: Params, cfg: RWKVConfig, x: Tensor, shift_state: Optional[Tensor] = None,
              wkv_state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns (out, new_shift_state, new_wkv_state)."""
    B, T, C = x.shape
    H, N = cfg.n_head, cfg.head_size
    dt = cfg.dtype
    xf = x.float()
    r, k, v, g, decay = _tmix_inputs(p, cfg, xf, _token_shift(xf, shift_state))
    shp = (B, T, H, N)
    # the static decay broadcast over time: the WKV6 recurrence with constant w
    w_raw = decay.reshape(1, 1, H, N).expand(shp)
    y, new_wkv = wkv6(r.to(dt).reshape(shp), w_raw, k.to(dt).reshape(shp), v.to(dt).reshape(shp),
                      p["time_faaaa"], initial_state=wkv_state, chunk=cfg.chunk_len)
    return _tmix_output(p, cfg, y.reshape(B, T, cfg.dim_att), g), xf[:, -1].clone(), new_wkv


def cmix_x052(p: Params, cfg: RWKVConfig, x: Tensor, shift_state: Optional[Tensor] = None
              ) -> Tuple[Tensor, Tensor]:
    """The ChannelMix of x052 and x040: squared ReLU, receptance gate."""
    dt = cfg.dtype
    xf = x.float()
    xk, xr = static_mixes(p, xf, _token_shift(xf, shift_state), dt, ("k", "r"))
    k = torch.relu(linear(p["key"], xk, dt)).square()  # relu^2 in fp32
    kv = linear(p["value"], k.to(dt), dt)
    return torch.sigmoid(linear(p["receptance"], xr, dt)) * kv, xf[:, -1].clone()


def block_x052(p: Params, cfg: RWKVConfig, layer_id: int, x: Tensor,
               state: Optional[LayerState] = None) -> Tuple[Tensor, LayerState]:
    if layer_id == 0:
        x = layer_norm(p["ln0"], x)
    att_shift, wkv_state, ffn_shift = state if state is not None else (None, None, None)
    xx, new_att_shift, new_wkv = tmix_x052(p["att"], cfg, layer_norm(p["ln1"], x), att_shift,
                                           wkv_state)
    x = x + xx
    ff, new_ffn_shift = cmix_x052(p["ffn"], cfg, layer_norm(p["ln2"], x), ffn_shift)
    return x + ff, LayerState(new_att_shift, new_wkv, new_ffn_shift)


def legacy_forward(params: Params, cfg: RWKVConfig, x: Tensor, states, grad_cp, return_hidden,
                   block, pad: int) -> Tuple[Tensor, List[LayerState]]:
    """The x052 / x040 block stack over embeddings ``x`` [B, T, C], after
    ``pad`` EOS embeddings on the left (cut from the output), with the
    per-block checkpoint under any ``grad_cp`` but False."""
    if grad_cp not in GRAD_CP:
        raise ValueError(f"grad_cp must be one of {GRAD_CP}; got {grad_cp!r}")
    if pad:
        if states is not None:
            raise ValueError("stateful forward requires T % chunk_len == 0")
        eos = embed(params, torch.full((x.shape[0], pad), STOP_TOKEN_INDEX, dtype=torch.long,
                                       device=x.device))
        x = torch.cat([eos.to(x.dtype), x], dim=1)
    new_states: List[LayerState] = []
    for i, blk in enumerate(params["blocks"]):
        st = states[i] if states is not None else None
        if grad_cp:
            x, ns = _block_checkpointed(blk, cfg, i, x, st, block=block)
        else:
            x, ns = block(blk, cfg, i, x, st)
        new_states.append(ns)
    x = layer_norm(params["ln_out"], x)
    if pad:
        x = x[:, pad:]
    if return_hidden:
        return x, new_states
    return linear(params["head"], x, cfg.dtype), new_states


def rwkv5_forward(params: Params, cfg: RWKVConfig, x: Tensor,
                  states: Optional[List[LayerState]] = None, grad_cp=False,
                  return_hidden: bool = False) -> Tuple[Tensor, List[LayerState]]:
    """Forward over input embeddings ``x`` [B, T, C], with the semantics of
    ``rwkv6_forward``: EOS left padding to a multiple of ``cfg.chunk_len``
    when stateless, ``grad_cp`` and ``return_hidden``."""
    pad = (-x.shape[1]) % cfg.chunk_len
    return legacy_forward(params, cfg, x, states, grad_cp, return_hidden, block_x052, pad)


# ---------------------------------------------------------------------------
# O(1) decode step
# ---------------------------------------------------------------------------


def rwkv5_decode_step(params: Params, cfg: RWKVConfig, token: Tensor,
                      states: List[LayerState]) -> Tuple[Tensor, List[LayerState]]:
    """One autoregressive step. token [B] -> (logits [B, vocab] fp32, states)."""
    return rwkv5_decode_step_embed(params, cfg, embed(params, token), states)


def rwkv5_decode_step_embed(params: Params, cfg: RWKVConfig, x_emb: Tensor,
                            states: List[LayerState]) -> Tuple[Tensor, List[LayerState]]:
    """One step from an input embedding [B, C]: the one-token WKV6 step on
    fp32 vectors with the static decay (kernel K10 on CUDA, on the head or
    the flat state). The carried WKV dtype is kept."""
    x = x_emb[:, None, :]
    B = x.shape[0]
    shp = (B, cfg.n_head, cfg.head_size)
    new_states: List[LayerState] = []
    for i, blk in enumerate(params["blocks"]):
        st = states[i]
        if i == 0:
            x = layer_norm(blk["ln0"], x)
        p = blk["att"]
        xf = layer_norm(blk["ln1"], x).float()
        r, k, v, g, decay = _tmix_inputs(p, cfg, xf, st.att_shift[:, None, :])
        new_wkv, y = wkv6_step_auto(st.wkv, r.reshape(shp), decay[None].expand(shp), k.reshape(shp),
                                    v.reshape(shp), p["time_faaaa"])
        x = x + _tmix_output(p, cfg, y.reshape(B, 1, -1), g)
        ff, new_ffn_shift = cmix_x052(blk["ffn"], cfg, layer_norm(blk["ln2"], x), st.ffn_shift)
        x = x + ff
        new_states.append(LayerState(xf[:, -1], new_wkv.to(st.wkv.dtype), new_ffn_shift))
    x = layer_norm(params["ln_out"], x)
    return linear(params["head"], x, cfg.dtype)[:, 0], new_states
