"""RWKV-7 ("x070") language model in PyTorch.

Counterpart of ``visualrwkv_tpu/models/rwkv7.py``. Parameters are nested
dicts with the JAX package's leaf names; linears are ``{"weight": [out, in]}``
(PyTorch's layout), the LoRA factors ``w1/w2, a1/a2, v1/v2, g1/g2`` are
``[in, out]`` and used as ``x @ w`` (the reference checkpoint's layout), and
the embedding and head are ``[vocab, C]``.

Compute policy: matmuls in ``cfg.compute_dtype`` with fp32 results;
token-shift deltas, LoRA nonlinearities, norms and the WKV state in fp32.
The WKV recurrence goes through :func:`visualrwkv_torch.ops.wkv7.wkv7`
(on CUDA kernel K1, or K5 / K6 under autograd; K11, K12 / K13 in the
"packed" mode) and the decode step through ``wkv7_step_auto`` (K2, or K4 on
the flat state layout). The forward makes no in-place write, so autograd
differentiates it as it stands.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from visualrwkv_torch.config import STOP_TOKEN_INDEX, RWKVConfig
from visualrwkv_torch.infer.quant import dequantize_weight
from visualrwkv_torch.ops.wkv7 import wkv7, wkv7_step_auto, wkv_seq_axis
from visualrwkv_torch.parallel.collectives import group_rank, ppermute
from visualrwkv_torch.parallel.zero import materialize

Tensor = torch.Tensor
Params = Dict[str, Any]

_MIX = ("x_r", "x_w", "x_k", "x_v", "x_a", "x_g")


# ---------------------------------------------------------------------------
# Init (the reference's formulas, as in the JAX package)
# ---------------------------------------------------------------------------


def _ortho(gen: torch.Generator, rows: int, cols: int, scale: float, device) -> Tensor:
    gain = math.sqrt(rows / cols) if rows > cols else 1.0
    w = torch.empty(rows, cols, device=device)
    return torch.nn.init.orthogonal_(w, gain=gain * scale, generator=gen)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float, device) -> Tensor:
    return torch.empty(shape, device=device).uniform_(lo, hi, generator=gen)


def init_tmix_x070(gen: torch.Generator, cfg: RWKVConfig, layer_id: int, device) -> Params:
    C, H, N, L = cfg.n_embd, cfg.n_head, cfg.head_size, cfg.n_layer
    r01 = layer_id / max(1, L - 1)
    r10 = 1.0 - layer_id / L
    ddd = torch.arange(C, dtype=torch.float32, device=device) / C
    n = torch.arange(C, dtype=torch.float64, device=device)
    decay_speed = (-7 + 5 * (n / max(1, C - 1)) ** (0.85 + 1.0 * r01**0.5)).float()
    zeros = lambda *s: torch.zeros(*s, device=device)
    p: Params = {
        "x_r": 1.0 - ddd ** (0.2 * r10),
        "x_w": 1.0 - ddd ** (0.9 * r10),
        "x_k": 1.0 - (ddd ** (0.9 * r10) + 0.4 * r01),
        "x_v": 1.0 - (ddd ** (0.4 * r10) + 0.6 * r01),
        "x_a": 1.0 - ddd ** (0.9 * r10),
        "x_g": 1.0 - ddd ** (0.2 * r10),
        "w0": decay_speed + 0.5,
        "w1": zeros(C, cfg.d_decay_lora),
        "w2": _ortho(gen, cfg.d_decay_lora, C, 0.1, device),
        "a0": zeros(C),
        "a1": zeros(C, cfg.d_aaa_lora),
        "a2": _ortho(gen, cfg.d_aaa_lora, C, 0.1, device),
        "g1": zeros(C, cfg.d_gate_lora),
        "g2": _ortho(gen, cfg.d_gate_lora, C, 0.1, device),
        "k_k": torch.full((C,), 0.85, device=device),
        "k_a": torch.ones(C, device=device),
        "r_k": zeros(H, N),
        "receptance": {"weight": _uniform(gen, (C, C), -0.5 / C**0.5, 0.5 / C**0.5, device)},
        "key": {"weight": _uniform(gen, (C, C), -0.05 / C**0.5, 0.05 / C**0.5, device)},
        "value": {"weight": _uniform(gen, (C, C), -0.5 / C**0.5, 0.5 / C**0.5, device)},
        "output": {"weight": zeros(C, C)},
        "ln_x": _ln_init(C, device),
    }
    if layer_id != 0:
        p["v0"] = torch.ones(C, device=device)
        p["v1"] = zeros(C, cfg.d_mv_lora)
        p["v2"] = _ortho(gen, cfg.d_mv_lora, C, 0.1, device)
    return p


def init_cmix_x070(gen: torch.Generator, cfg: RWKVConfig, layer_id: int, device) -> Params:
    C = cfg.n_embd
    ddd = torch.arange(C, dtype=torch.float32, device=device) / C
    return {
        "x_k": 1.0 - ddd ** ((1.0 - layer_id / cfg.n_layer) ** 4),
        "key": {"weight": _uniform(gen, (cfg.dim_ffn, C), -0.5 / C**0.5, 0.5 / C**0.5, device)},
        "value": {"weight": torch.zeros(C, cfg.dim_ffn, device=device)},
    }


def _ln_init(C: int, device) -> Params:
    return {"weight": torch.ones(C, device=device), "bias": torch.zeros(C, device=device)}


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype)


def init_rwkv7_params(gen: torch.Generator, cfg: RWKVConfig, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> Params:
    """Random init; ``dtype`` is an optional storage dtype for every leaf
    (bf16 for serving). Each leaf is cast as it is made, so the fp32 copy of
    the whole model never exists at once."""
    C = cfg.n_embd
    cast = (lambda t: _cast_tree(t, dtype)) if dtype is not None else (lambda t: t)
    blocks: List[Params] = []
    for i in range(cfg.n_layer):
        blk = {
            "ln1": _ln_init(C, device),
            "ln2": _ln_init(C, device),
            "att": init_tmix_x070(gen, cfg, i, device),
            "ffn": init_cmix_x070(gen, cfg, i, device),
        }
        if i == 0:
            blk["ln0"] = _ln_init(C, device)
        blocks.append(cast(blk))
    emb = cast(_uniform(gen, (cfg.vocab_size, C), -1e-4, 1e-4, device))
    # orthogonal head (gain 0.5); a scaled gaussian beyond the size where QR is slow
    if C * cfg.vocab_size <= 16 * 2**20:
        head = _ortho(gen, C, cfg.vocab_size, 0.5, device).t().contiguous()
    else:
        head = torch.randn(cfg.vocab_size, C, generator=gen, device=device) * (0.5 * C**-0.5)
    return {
        "emb": {"weight": emb},
        "blocks": blocks,
        "ln_out": cast(_ln_init(C, device)),
        "head": {"weight": cast(head)},
    }


# ---------------------------------------------------------------------------
# Layer state
# ---------------------------------------------------------------------------


class LayerState(NamedTuple):
    """Recurrent state of one block: token-shift carries + WKV matrix state."""

    att_shift: Tensor  # [B, C] fp32
    wkv: Tensor  # [B, H, N, N] fp32 (a decode carry may be bf16)
    ffn_shift: Tensor  # [B, C] fp32


def init_state(cfg: RWKVConfig, batch: int, device="cuda") -> List[LayerState]:
    C, H, N = cfg.n_embd, cfg.n_head, cfg.head_size
    return [
        LayerState(
            att_shift=torch.zeros(batch, C, device=device),
            wkv=torch.zeros(batch, H, N, N, device=device),
            ffn_shift=torch.zeros(batch, C, device=device),
        )
        for _ in range(cfg.n_layer)
    ]


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------


def layer_norm(p: Params, x: Tensor, eps: float = 1e-5) -> Tensor:
    return F.layer_norm(x.float(), x.shape[-1:], p["weight"].float(), p["bias"].float(), eps).to(x.dtype)


def group_norm(p: Params, x: Tensor, num_groups: int, eps: float) -> Tensor:
    """GroupNorm over the last dim split into ``num_groups`` (per-head ln_x)."""
    *lead, C = x.shape
    xf = x.float().reshape(*lead, num_groups, C // num_groups)
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf.reshape(*lead, C) * p["weight"].float() + p["bias"].float()).to(x.dtype)


def linear(p: Params, x: Tensor, dt: torch.dtype) -> Tensor:
    """x @ W^T with operands in ``dt``; fp32 result. An int8 linear
    (``infer.quant``: ``weight_q``, ``scale``) is dequantised to ``dt``
    first, as the JAX package's ``linear`` does."""
    w = dequantize_weight(p, dt) if "weight_q" in p else p["weight"].to(dt)
    return F.linear(x.to(dt), w).float()


def _lora(x: Tensor, w: Tensor, dt: torch.dtype) -> Tensor:
    """x @ w for an ``[in, out]`` LoRA factor; fp32 result."""
    return (x.to(dt) @ w.to(dt)).float()


def _token_shift(x: Tensor, shift_state: Optional[Tensor]) -> Tensor:
    """Previous-token stream: zeros (or the carried last token) at position 0."""
    if shift_state is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([shift_state[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def _l2norm_heads(x: Tensor, H: int) -> Tensor:
    B, T, C = x.shape
    xh = x.reshape(B, T, H, C // H).float()
    n2 = (xh * xh).sum(-1, keepdim=True)
    return (xh * torch.rsqrt(n2.clamp_min(1e-24))).reshape(B, T, C).to(x.dtype)


def _tmix_inputs(p: Params, cfg: RWKVConfig, layer_id: int, xf: Tensor, xx: Tensor,
                 v_first: Optional[Tensor]):
    """The projections of a TimeMix: (r, w_raw, k, v, a, g, kk, v_first), fp32."""
    dt = cfg.dtype
    xr, xw, xk, xv, xa, xg = ((xf + xx * p[n].float()).to(dt) for n in _MIX)
    r = linear(p["receptance"], xr, dt)
    w_lora = _lora(torch.tanh(_lora(xw, p["w1"], dt)), p["w2"], dt)
    # soft-clamp to (-inf, -0.5)
    w_raw = -F.softplus(-(p["w0"].float() + w_lora)) - 0.5
    k = linear(p["key"], xk, dt)
    v = linear(p["value"], xv, dt)
    if layer_id == 0:
        v_first = v
    else:
        v_lora = _lora(_lora(xv, p["v1"], dt), p["v2"], dt)
        v = v + (v_first - v) * torch.sigmoid(p["v0"].float() + v_lora)
    a = torch.sigmoid(p["a0"].float() + _lora(_lora(xa, p["a1"], dt), p["a2"], dt))
    g = _lora(torch.sigmoid(_lora(xg, p["g1"], dt)), p["g2"], dt)
    kk = _l2norm_heads(k * p["k_k"].float(), cfg.n_head)
    k = k * (1 + (a - 1) * p["k_a"].float())
    return r, w_raw, k, v, a, g, kk, v_first


def _tmix_output(p: Params, cfg: RWKVConfig, y: Tensor, r: Tensor, k: Tensor, v: Tensor,
                 g: Tensor) -> Tensor:
    """ln_x, the r_k bonus, the gate and the output projection; y [B, T, C]."""
    B, T, C = y.shape
    H = cfg.n_head
    y = group_norm(p["ln_x"], y, H, 1e-5 * cfg.head_size_divisor**2)
    rk = (r * k).float().reshape(B, T, H, -1) * p["r_k"].float()
    bonus = rk.sum(-1, keepdim=True) * v.float().reshape(B, T, H, -1)
    y = y.float() + bonus.reshape(B, T, C)
    return linear(p["output"], (y * g.float()).to(cfg.dtype), cfg.dtype)


# ---------------------------------------------------------------------------
# TimeMix / ChannelMix / Block (sequence mode, optional state)
# ---------------------------------------------------------------------------


def tmix_x070(p: Params, cfg: RWKVConfig, layer_id: int, x: Tensor, v_first: Optional[Tensor],
              shift_state: Optional[Tensor] = None, wkv_state: Optional[Tensor] = None,
              wkv_fn=None) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Returns (out, v_first, new_shift_state, new_wkv_state). ``wkv_fn``
    replaces the WKV op (:func:`visualrwkv_torch.ops.wkv7.wkv7`'s call
    signature): the speculative verify pass gives
    ``ops.wkv7.wkv7_scan_states``, and the returned WKV state is then the
    trail ``[B, T, H, N, N]``."""
    B, T, C = x.shape
    dt = cfg.dtype
    xf = x.float()
    xx = _token_shift(xf, shift_state) - xf
    r, w_raw, k, v, a, g, kk, v_first = _tmix_inputs(p, cfg, layer_id, xf, xx, v_first)
    shp = (B, T, cfg.n_head, C // cfg.n_head)
    y, new_wkv = (wkv_fn or wkv7)(
        r.to(dt).reshape(shp), w_raw.to(dt).reshape(shp), k.to(dt).reshape(shp),
        v.to(dt).reshape(shp), (-kk).to(dt).reshape(shp), (kk * a).to(dt).reshape(shp),
        initial_state=wkv_state, chunk=cfg.chunk_len,
    )
    out = _tmix_output(p, cfg, y.reshape(B, T, C), r, k, v, g)
    # a copy: a view of the last row would keep the whole fp32 [B, T, C] input alive
    return out, v_first, xf[:, -1].clone(), new_wkv


def cmix_x070(p: Params, cfg: RWKVConfig, x: Tensor, shift_state: Optional[Tensor] = None
              ) -> Tuple[Tensor, Tensor]:
    dt = cfg.dtype
    xf = x.float()
    xx = _token_shift(xf, shift_state) - xf
    kx = (xf + xx * p["x_k"].float()).to(dt)
    k = torch.relu(linear(p["key"], kx, dt).to(dt)).square()  # relu^2 in the compute dtype
    return linear(p["value"], k, dt), xf[:, -1].clone()


def block_x070(p: Params, cfg: RWKVConfig, layer_id: int, x: Tensor, v_first: Optional[Tensor],
               state: Optional[LayerState] = None) -> Tuple[Tensor, Tensor, LayerState]:
    p = materialize(p)  # ZeRO-3: the block's slices gathered (parallel.zero)
    if layer_id == 0:
        x = layer_norm(p["ln0"], x)
    att_shift, wkv_state, ffn_shift = state if state is not None else (None, None, None)
    xx, v_first, new_att_shift, new_wkv = tmix_x070(
        p["att"], cfg, layer_id, layer_norm(p["ln1"], x), v_first, att_shift, wkv_state
    )
    x = x + xx
    ff, new_ffn_shift = cmix_x070(p["ffn"], cfg, layer_norm(p["ln2"], x), ffn_shift)
    return x + ff, v_first, LayerState(new_att_shift, new_wkv, new_ffn_shift)


# ---------------------------------------------------------------------------
# Full LM forward
# ---------------------------------------------------------------------------


def embed(params: Params, tokens: Tensor) -> Tensor:
    return params["emb"]["weight"][tokens]


GRAD_CP = (False, True, "dots", "wkv")

# The operators whose outputs a selective checkpoint policy saves: "dots" the
# products of the projections and LoRA factors (``linear`` and ``_lora``
# lower to ``mm``), as ``dots_with_no_batch_dims_saveable`` saves XLA's dots
# without batch dimensions; "wkv" the WKV training forward's y, final state
# and chunk states, as ``save_only_these_names("wkv_y", "wkv_res")`` does.
_SAVED_OPS = {
    "dots": {torch.ops.aten.mm.default, torch.ops.aten.addmm.default},
    "wkv": {torch.ops.visualrwkv_torch.wkv7_fwd_res.default},  # registered by ops.wkv7
}


def _remat_context(grad_cp):
    """The ``context_fn`` of the checkpoint for a ``grad_cp`` policy (the
    JAX package's ``_remat_policy``): None for the full per-block
    checkpoint (True), else a selective checkpoint that saves the outputs
    of ``_SAVED_OPS[grad_cp]`` and recomputes everything else."""
    if grad_cp not in GRAD_CP:
        raise ValueError(f"grad_cp must be one of {GRAD_CP}; got {grad_cp!r}")
    if not isinstance(grad_cp, str):
        return None
    saved = _SAVED_OPS[grad_cp]

    def policy(ctx, func, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if func in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


def _block_checkpointed(blk: Params, cfg: RWKVConfig, layer_id: int, x: Tensor,
                        v_first: Optional[Tensor], state: Optional[LayerState], context_fn=None):
    """:func:`block_x070` under activation checkpointing: the block's inputs
    are kept (and, with a selective ``context_fn``, the outputs its policy
    saves) and the rest of the block runs again in the backward pass."""
    def run(x, v_first, *st):
        y, vf, ns = block_x070(blk, cfg, layer_id, x, v_first, LayerState(*st) if st else None)
        return (y, vf, *ns)

    kw = {} if context_fn is None else {"context_fn": context_fn}
    y, vf, *ns = checkpoint(run, x, v_first, *(state or ()), use_reentrant=False,
                            preserve_rng_state=False, **kw)
    return y, vf, LayerState(*ns)


def rwkv7_forward(params: Params, cfg: RWKVConfig, x: Tensor,
                  states: Optional[List[LayerState]] = None, grad_cp=False,
                  return_hidden: bool = False) -> Tuple[Tensor, List[LayerState]]:
    """Forward over input embeddings ``x`` [B, T, C].

    Without a state, pads LEFT with EOS-token embeddings to a multiple of
    ``cfg.chunk_len`` (the reference's training semantics); with a carried
    state T must be a multiple of ``chunk_len``. ``grad_cp``: False; True
    for per-block activation checkpointing; "dots" to keep the projections'
    products across it; "wkv" to keep the WKV forward's outputs, so that the
    WKV kernel runs once a layer (:func:`_remat_context`). Returns (logits
    [B, T, vocab] fp32, or hidden [B, T, C] after ``ln_out`` if
    ``return_hidden``, and the per-layer states).
    """
    context_fn = _remat_context(grad_cp)
    B, T, C = x.shape
    pad = (-T) % cfg.chunk_len
    if pad:
        if states is not None:
            raise ValueError("stateful forward requires T % chunk_len == 0")
        eos = embed(params, torch.full((B, pad), STOP_TOKEN_INDEX, dtype=torch.long, device=x.device))
        x = torch.cat([eos.to(x.dtype), x], dim=1)

    v_first = None
    new_states: List[LayerState] = []
    for i, blk in enumerate(params["blocks"]):
        st = states[i] if states is not None else None
        if grad_cp:
            x, v_first, ns = _block_checkpointed(blk, cfg, i, x, v_first, st, context_fn)
        else:
            x, v_first, ns = block_x070(blk, cfg, i, x, v_first, st)
        new_states.append(ns)

    x = layer_norm(params["ln_out"], x)
    if pad:
        x = x[:, pad:]
    if return_hidden:
        return x, new_states
    return linear(params["head"], x, cfg.dtype), new_states


def halo_shift(t: Tensor, group) -> Tensor:
    """The token-shift carry of a rank's part of a split token axis: the
    left neighbour's last position of ``t`` [B, T, C] (zeros on the first
    rank, as the unsplit shift's position 0 sees)."""
    recv = ppermute(t[:, -1].contiguous(), group, 1)
    first = recv.new_full((), group_rank(group) == 0, dtype=torch.bool)  # a fill: no host wait
    return torch.where(first, torch.zeros_like(recv), recv)  # recv stays in the graph


def rwkv7_forward_seq(params: Params, cfg: RWKVConfig, x: Tensor, group=None, grad_cp=False,
                      return_hidden: bool = False) -> Tensor:
    """Context-parallel forward over this rank's part ``x`` [B, T_local, C]
    of a token axis split over the process group ``group`` (the JAX
    package's ``rwkv7_forward_seq``, run there inside ``shard_map``).

    A block is per-token but for two couplings across the split, both made
    here: the 1-token shift (:func:`halo_shift` of each post-LN stream, in
    fp32) and the WKV recurrence (the ring of :mod:`visualrwkv_torch.ops.
    wkv_sp`, through ``ops.wkv7.wkv_seq_axis``). ``T_local`` must be a
    multiple of ``cfg.chunk_len``: no shard is padded. ``grad_cp`` as in
    :func:`rwkv7_forward`; the recomputed block exchanges its halos and runs
    its ring again. Returns this rank's logits (or hidden after ``ln_out``)."""
    context_fn = _remat_context(grad_cp)
    T = x.shape[1]
    if T % cfg.chunk_len:
        raise ValueError(f"seq-parallel shards must be chunk-aligned: T_local={T}, "
                         f"chunk_len={cfg.chunk_len}")

    def body(p, xx, vf, i):
        p = materialize(p)
        with wkv_seq_axis(group):  # inside the body, so that a recompute runs the ring too
            if i == 0:
                xx = layer_norm(p["ln0"], xx)
            xin = layer_norm(p["ln1"], xx)
            yy, vf, _, _ = tmix_x070(p["att"], cfg, i, xin, vf, halo_shift(xin.float(), group), None)
            xx = xx + yy
            xin2 = layer_norm(p["ln2"], xx)
            ff, _ = cmix_x070(p["ffn"], cfg, xin2, halo_shift(xin2.float(), group))
        return xx + ff, vf

    v_first = None
    kw = {} if context_fn is None else {"context_fn": context_fn}
    for i, blk in enumerate(params["blocks"]):
        if grad_cp:
            x, v_first = checkpoint(lambda xx, vf, blk=blk, i=i: body(blk, xx, vf, i), x, v_first,
                                    use_reentrant=False, preserve_rng_state=False, **kw)
        else:
            x, v_first = body(blk, x, v_first, i)

    x = layer_norm(params["ln_out"], x)
    if return_hidden:
        return x
    return linear(params["head"], x, cfg.dtype)


# ---------------------------------------------------------------------------
# O(1) decode step
# ---------------------------------------------------------------------------


def rwkv7_decode_step(params: Params, cfg: RWKVConfig, token: Tensor,
                      states: List[LayerState]) -> Tuple[Tensor, List[LayerState]]:
    """One autoregressive step. token [B] -> (logits [B, vocab] fp32, states)."""
    return rwkv7_decode_step_embed(params, cfg, embed(params, token), states)


def rwkv7_decode_step_embed(params: Params, cfg: RWKVConfig, x_emb: Tensor,
                            states: List[LayerState]) -> Tuple[Tensor, List[LayerState]]:
    """One step from an input embedding [B, C]; the WKV update is the
    one-token step (kernel K2 on CUDA). The carried WKV dtype is kept."""
    x = x_emb[:, None, :]
    B = x.shape[0]
    H, N = cfg.n_head, cfg.head_size
    v_first = None
    new_states: List[LayerState] = []
    for i, blk in enumerate(params["blocks"]):
        st = states[i]
        if i == 0:
            x = layer_norm(blk["ln0"], x)
        p = blk["att"]
        xf = layer_norm(blk["ln1"], x).float()
        xx = st.att_shift[:, None, :] - xf
        r, w_raw, k, v, a, g, kk, v_first = _tmix_inputs(p, cfg, i, xf, xx, v_first)
        shp = (B, H, N)
        new_wkv, y = wkv7_step_auto(
            st.wkv, r.reshape(shp), w_raw.reshape(shp), k.reshape(shp), v.reshape(shp),
            (-kk).reshape(shp), (kk * a).reshape(shp),
        )
        att_out = _tmix_output(p, cfg, y.reshape(B, 1, -1).to(cfg.dtype), r, k, v, g)
        x = x + att_out
        ff, new_ffn_shift = cmix_x070(blk["ffn"], cfg, layer_norm(blk["ln2"], x), st.ffn_shift)
        x = x + ff
        new_states.append(LayerState(xf[:, -1], new_wkv.to(st.wkv.dtype), new_ffn_shift))

    x = layer_norm(params["ln_out"], x)
    return linear(params["head"], x, cfg.dtype)[:, 0], new_states
