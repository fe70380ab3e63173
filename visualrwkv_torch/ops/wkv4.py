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
* :func:`wkv4` — the sequence form's entry point: CUDA tensors launch K17
  (``csrc/wkv4.cu``), CPU tensors take :func:`wkv4_plain`.
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


def wkv4(w: Tensor, u: Tensor, k: Tensor, v: Tensor,
         initial_state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Entry point of the model: k, v ``[B, T, C]`` (any float dtype), w
    the log decay and u the bonus ``[C]``, initial state ``[B, C, 3]`` or
    None. CUDA tensors launch kernel K17 (k and v in their dtype where it
    has it, fp32 or bf16; w, u and the state fp32), which has no backward:
    a gradient through it raises. CPU tensors take :func:`wkv4_plain`,
    which autograd differentiates, as JAX differentiates its scan.
    Returns (y fp32 ``[B, T, C]``, final state fp32 ``[B, C, 3]``)."""
    if k.is_cuda:
        inputs = (w, u, k, v, initial_state)
        if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in inputs):
            raise NotImplementedError(
                "wkv4: kernel K17 has no backward yet (ROADMAP.md queue A, variants: x040's "
                "gradient, K17's VJP); run the x040 LM frozen on CUDA, or on the CPU for a gradient"
            )
        dt = wkv7_cuda.stream_dtype((k, v))
        f32 = lambda x: wkv7_cuda.operand(x, torch.float32)
        return wkv4_cuda.wkv4_fwd(f32(w), f32(u), wkv7_cuda.operand(k, dt), wkv7_cuda.operand(v, dt),
                                  None if initial_state is None else f32(initial_state))
    return wkv4_plain(w, u, k, v, initial_state)
