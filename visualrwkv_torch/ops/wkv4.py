"""RWKV-4 ("x040") WKV recurrence: the plain PyTorch version and the
dispatcher. Counterpart of ``visualrwkv_tpu/ops/wkv4.py``.

The state of a layer is three ``[C]`` vectors a row: a numerator ``aa``, a
denominator ``bb`` and a log-domain running max ``pp``, stacked on the last
axis as ``[B, C, 3]``, with ``pp`` starting at -1e30 so that the first token
enters with weight 1. A step (``w = -exp(time_decay) <= 0``, ``u`` the
current token's bonus)::

    ww = u + k_t;  p = max(pp, ww)
    y_t = (e^{pp-p} aa + e^{ww-p} v_t) / (e^{pp-p} bb + e^{ww-p})
    ww = w + pp;   p = max(ww, k_t)
    aa, bb, pp = e^{ww-p} aa + e^{k_t-p} v_t,  e^{ww-p} bb + e^{k_t-p},  p

All of it is fp32: every exponent is <= 0 (the max tracking), which bf16
would not keep.

* :func:`wkv4_init_state` — the zero state (pp = -1e30).
* :func:`wkv4_plain` — the sequence form as the reference's loop over T
  (the plain version of kernel K17); autograd differentiates it.
* :func:`wkv4_bwd_plain` — its VJP as one reverse walk written in torch
  (the plain version of kernel K18).
* :class:`WKV4Function` — the differentiable sequence form: K17 forward and
  K18 backward on CUDA tensors, their plain versions on CPU tensors.
* :func:`wkv4` — the sequence form's entry point, :class:`WKV4Function`.
* :func:`wkv4_step` — one token, elementwise on both devices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from visualrwkv_torch.ops import wkv4_cuda, wkv7_cuda

Tensor = torch.Tensor

PP_INIT = -1e30


def wkv4_init_state(B: int, C: int, device="cuda") -> Tensor:
    """Zero (aa, bb) and -1e30 (pp): ``[B, C, 3]`` fp32."""
    s = torch.zeros(B, C, 3, device=device)
    s[..., 2] = PP_INIT
    return s


def wkv4_step(state: Tensor, w: Tensor, u: Tensor, k: Tensor, v: Tensor) -> Tuple[Tensor, Tensor]:
    """One step: k, v ``[B, C]``, state ``[B, C, 3]``, w and u ``[C]``.
    Returns (new state fp32 ``[B, C, 3]``, y fp32 ``[B, C]``). The
    arithmetic is fp32, or float64 for float64 k (finite-difference
    checks)."""
    f32 = torch.float64 if k.dtype == torch.float64 else torch.float32
    aa, bb, pp = state.to(f32).unbind(-1)
    kt, vt, wf, uf = (x.to(f32) for x in (k, v, w, u))
    ww = uf + kt
    p = torch.maximum(pp, ww)
    e1, e2 = torch.exp(pp - p), torch.exp(ww - p)
    y = (e1 * aa + e2 * vt) / (e1 * bb + e2)
    ww = wf + pp
    p = torch.maximum(ww, kt)
    e1, e2 = torch.exp(ww - p), torch.exp(kt - p)
    return torch.stack([e1 * aa + e2 * vt, e1 * bb + e2, p], dim=-1), y


def wkv4_plain(w: Tensor, u: Tensor, k: Tensor, v: Tensor,
               initial_state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """The sequence form, the reference's loop over T: k, v ``[B, T, C]``,
    w and u ``[C]``, initial state ``[B, C, 3]`` or None. Returns (y fp32
    ``[B, T, C]``, final state fp32 ``[B, C, 3]``)."""
    B, T, C = k.shape
    state = wkv4_init_state(B, C, k.device) if initial_state is None else initial_state
    ys = []
    for t in range(T):
        state, y = wkv4_step(state, w, u, k[:, t], v[:, t])
        ys.append(y)
    y = torch.stack(ys, 1) if ys else k.new_zeros(B, 0, C, dtype=torch.float32)
    return y, state


def _split_max(g: Tensor, a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """The cotangent ``g`` of ``max(a, b)`` sent to its arguments as
    ``torch.maximum``'s backward does: all to the larger, half to each on a
    tie."""
    half = torch.where(a == b, 0.5 * g, g)
    return torch.where(a < b, 0.0, half), torch.where(a > b, 0.0, half)


def wkv4_bwd_plain(w: Tensor, u: Tensor, k: Tensor, v: Tensor, initial_state: Optional[Tensor],
                   dy: Tensor, ds: Optional[Tensor] = None
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Optional[Tensor]]:
    """The VJP of :func:`wkv4_plain` (the plain version of kernel K18), as
    the kernel computes it: one walk forward recomputing the state entering
    each step, then one walk back over T differentiating every operation of
    the step (the running max ``pp`` too: a cotangent of the final state's
    pp is honoured). dy ``[B, T, C]`` is the cotangent of y, ds ``[B, C, 3]``
    (or None: zero) that of the final state. Returns (dw, du ``[C]``, dk, dv
    ``[B, T, C]``, d initial state ``[B, C, 3]`` or None without an initial
    state), in fp32, or float64 for float64 k."""
    B, T, C = k.shape
    f32 = torch.float64 if k.dtype == torch.float64 else torch.float32
    wf, uf = w.to(f32), u.to(f32)
    kf, vf, gyf = k.to(f32), v.to(f32), dy.to(f32)
    state = wkv4_init_state(B, C, k.device) if initial_state is None else initial_state
    states = []
    for t in range(T):
        states.append(state.to(f32))
        state, _ = wkv4_step(state, w, u, k[:, t], v[:, t])
    g = torch.zeros(B, C, 3, dtype=f32, device=k.device) if ds is None else ds.to(f32)
    gaa, gbb, gpp = g.unbind(-1)
    gw = torch.zeros(B, C, dtype=f32, device=k.device)
    gu = torch.zeros_like(gw)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for t in range(T - 1, -1, -1):
        aa, bb, pp = states[t].unbind(-1)
        kt, vt, gy = kf[:, t], vf[:, t], gyf[:, t]
        ww = uf + kt
        p = torch.maximum(pp, ww)
        e1, e2 = torch.exp(pp - p), torch.exp(ww - p)
        num, den = e1 * aa + e2 * vt, e1 * bb + e2
        y = num / den
        ww2 = wf + pp
        p2 = torch.maximum(ww2, kt)
        f1, f2 = torch.exp(ww2 - p2), torch.exp(kt - p2)
        # the update aa' = f1 aa + f2 v, bb' = f1 bb + f2, pp' = p2
        gf1, gf2 = gaa * aa + gbb * bb, gaa * vt + gbb
        naa, nbb, gv = gaa * f1, gbb * f1, gaa * f2
        a1, a2 = gf1 * f1, gf2 * f2
        to_ww2, to_k = _split_max(gpp - a1 - a2, ww2, kt)
        gww2 = a1 + to_ww2
        gk = a2 + to_k
        gw = gw + gww2
        npp = gww2
        # the output y = num / den
        gnum, gden = gy / den, -gy * y / den
        ge1, ge2 = gnum * aa + gden * bb, gnum * vt + gden
        naa, nbb, gv = naa + gnum * e1, nbb + gden * e1, gv + gnum * e2
        b1, b2 = ge1 * e1, ge2 * e2
        to_pp, to_ww = _split_max(-b1 - b2, pp, ww)
        npp = npp + b1 + to_pp
        gww = b2 + to_ww
        gu = gu + gww
        dk[:, t], dv[:, t] = gk + gww, gv
        gaa, gbb, gpp = naa, nbb, npp
    ds0 = None if initial_state is None else torch.stack([gaa, gbb, gpp], -1)
    return gw.sum(0), gu.sum(0), dk, dv, ds0


def _cuda_operands(w: Tensor, u: Tensor, k: Tensor, v: Tensor, *rest: Optional[Tensor]):
    """K17 / K18's operands made from any float k, v (their common dtype,
    fp32 or bf16) and fp32 w, u and the rest (states, cotangents; None
    kept)."""
    dt = wkv7_cuda.stream_dtype((k, v))
    f32 = lambda x: None if x is None else wkv7_cuda.operand(x, torch.float32)
    return (f32(w), f32(u), wkv7_cuda.operand(k, dt), wkv7_cuda.operand(v, dt), *map(f32, rest))


class WKV4Function(torch.autograd.Function):
    """The differentiable sequence form: forward kernel K17, backward
    kernel K18 on CUDA tensors (K18 recomputes the states, so only the
    inputs are saved); :func:`wkv4_plain` and :func:`wkv4_bwd_plain` on CPU
    tensors. JAX differentiates its ``lax.scan`` with autodiff; this is the
    same derivative. On CUDA k and v run in their common dtype (fp32 or
    bf16, else fp32), w, u and the state in fp32, and each gradient returns
    in its input's dtype."""

    @staticmethod
    def forward(ctx, w, u, k, v, initial_state):
        ctx.save_for_backward(w, u, k, v, initial_state)
        if k.is_cuda:
            return wkv4_cuda.wkv4_fwd(*_cuda_operands(w, u, k, v, initial_state))
        return wkv4_plain(w, u, k, v, initial_state)

    @staticmethod
    def backward(ctx, dy, ds):
        w, u, k, v, s0 = ctx.saved_tensors
        if k.is_cuda:
            grads = wkv4_cuda.wkv4_bwd(*_cuda_operands(w, u, k, v, s0, dy, ds))
        else:
            grads = wkv4_bwd_plain(w, u, k, v, s0, dy, ds)
        dw, du, dk, dv, ds0 = grads
        return (dw.to(w.dtype), du.to(u.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None if ds0 is None else ds0.to(s0.dtype))


def wkv4(w: Tensor, u: Tensor, k: Tensor, v: Tensor,
         initial_state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Entry point of the model: k, v ``[B, T, C]`` (any float dtype), w
    the log decay and u the bonus ``[C]``, initial state ``[B, C, 3]`` or
    None, through :class:`WKV4Function`: CUDA tensors launch kernel K17
    forward (k and v in their dtype where it has it, fp32 or bf16; w, u and
    the state fp32) and K18 backward when a gradient is taken; CPU tensors
    take :func:`wkv4_plain` and :func:`wkv4_bwd_plain`. Returns (y fp32
    ``[B, T, C]``, final state fp32 ``[B, C, 3]``)."""
    return WKV4Function.apply(w, u, k, v, initial_state)
