"""RWKV-6 ("x060") WKV recurrence: plain PyTorch versions and dispatchers.

The recurrence (per head, head size N; fp32 state ``S`` of shape ``[N_v, N_k]``,
bonus ``u`` per channel of the head)::

    y_t = S_{t-1} @ r_t + (sum_j u_j k_tj r_tj) * v_t
    S_t = S_{t-1} * w_t[None, :] + v_t[:, None] * k_t[None, :]

with ``w_t = exp(-exp(w_raw_t))``. Streams are ``[B, T, H, N]``, ``u`` is
``[H, N]``; the state is ``[B, H, N_v, N_k]`` fp32 (a decode carry may be
bf16).

The sequence forms take ``chunk`` (``cfg.chunk_len``) and floor the log decay
at ``-80 / chunk``, as the JAX package's ``wkv6_chunked`` and Pallas kernels
do (``visualrwkv_tpu/ops/wkv6.py:173-178``): the chunked form's
``exp(+-cumsum(log w))`` factors would overflow fp32 past about 88 a chunk.
The floor binds only where ``exp(w_raw) > 80 / chunk``, and its gradient
there is zero. The one-token step has no floor, as in the JAX package.

* :func:`wkv6_step` — one token (no floor); :func:`wkv6_step_flat` the
  same on the flat decode state ``[B, N_v, H*N_k]``.
* :func:`wkv6_scan_states` — a short window with the state after every
  position (speculative decoding's verify pass): K10 once a position on
  CUDA.
* :func:`wkv6_reference` — the sequential scan, fp32; with ``chunk`` it
  applies the decay floor (the plain version of kernel K7).
* :func:`wkv6_chunked` — the chunked matmul form of the JAX package.
* :func:`wkv6_fwd_res_plain` / :func:`wkv6_bwd_plain` — the training forward
  that also returns the state entering every 16-step chunk, and the
  vector-Jacobian product from those states (plain versions of K8 and K9).
* :func:`wkv6` / :func:`wkv6_step_auto` — dispatch on the tensors' device:
  the plain versions for CPU tensors, the CUDA kernels
  (:mod:`visualrwkv_torch.ops.wkv6_cuda`) for CUDA tensors. Under autograd,
  on both devices, :class:`WKV6Function` runs kernel K8 forward and K9
  backward (their plain versions on the CPU).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from visualrwkv_torch.ops import wkv6_cuda, wkv7_cuda
from visualrwkv_torch.ops.padding import pad_steps

Tensor = torch.Tensor

DEFAULT_CHUNK = 16
SAVE_EVERY = wkv6_cuda.CHUNK  # K8 saves, and K9 reads, the state entering every 16 steps


def _validate(r, w, k, v, u):
    shape = r.shape
    for x in (w, k, v):
        if x.shape != shape:
            raise ValueError(f"wkv6 inputs must share shape; got {tuple(x.shape)} vs {tuple(shape)}")
    if len(shape) != 4:
        raise ValueError(f"wkv6 inputs must be [B, T, H, N]; got {tuple(shape)}")
    if tuple(u.shape) != tuple(shape[2:]):
        raise ValueError(f"wkv6 bonus u must be [H, N] = {tuple(shape[2:])}; got {tuple(u.shape)}")


def log_decay(w_raw: Tensor, chunk: Optional[int]) -> Tensor:
    """``log w = -exp(w_raw)``, floored at ``-80 / chunk`` when ``chunk`` is given."""
    logw = -torch.exp(w_raw)
    return logw if chunk is None else torch.clamp_min(logw, -80.0 / chunk)


def wkv6_step(state: Tensor, r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, u: Tensor,
              chunk: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Single-token update. state ``[..., H, Nv, Nk]``; vectors ``[..., H, N]``;
    u ``[H, N]``. Returns (new state fp32, y in r's dtype). The arithmetic is
    fp32, or float64 when the state is float64. ``chunk`` applies the decay
    floor of the sequence forms (the decode step has none)."""
    f32 = torch.float64 if state.dtype == torch.float64 else torch.float32
    out_dtype = r.dtype
    state = state.to(f32)
    r, k, v, u = (x.to(f32) for x in (r, k, v, u))
    w = torch.exp(log_decay(w_raw.to(f32), chunk))
    bonus = (u * k * r).sum(-1, keepdim=True)
    y = torch.einsum("...ij,...j->...i", state, r) + bonus * v  # against the OLD state
    state = state * w[..., None, :] + v[..., :, None] * k[..., None, :]
    return state, y.to(out_dtype)


def wkv6_step_flat(state: Tensor, r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor,
                   u: Tensor) -> Tuple[Tensor, Tensor]:
    """:func:`wkv6_step` on the flat state ``[B, N_v, H*N_k]`` (element
    ``[b, i, h*N + j]`` is ``S[b, h, i, j]``); vectors ``[B, H, N]``, u
    ``[H, N]``; no decay floor. The JAX package's ``wkv6_step_flat``, sum
    for sum (the plain version of K10 on the flat layout). Returns (new
    state in the carried dtype and layout, y in r's dtype)."""
    B, N, HN = state.shape
    H = HN // N
    f32 = torch.float32
    out_dtype = r.dtype
    r, k, v, u = (x.to(f32) for x in (r, k, v, u))
    w = torch.exp(-torch.exp(w_raw.to(f32)))
    s4 = state.to(f32).reshape(B, N, H, N)  # [B, i, H, j]
    bonus = (u * k * r).sum(-1)  # [B, H]
    y = (s4 * r[:, None]).sum(-1).transpose(1, 2) + bonus[..., None] * v
    s4 = s4 * w[:, None] + v.transpose(1, 2)[..., None] * k[:, None]
    return s4.reshape(B, N, HN).to(state.dtype), y.to(out_dtype)


def wkv6_scan_states(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, u: Tensor,
                     initial_state: Optional[Tensor] = None,
                     chunk: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """WKV6 over a short window with the state after every position (the
    speculative verify pass; see ``ops.wkv7.wkv7_scan_states``): a loop of
    :func:`wkv6_step` on CPU tensors, kernel K10 once a position on CUDA
    tensors, each launch writing its state into the trail. No decay floor,
    as the decode step has none; ``chunk`` is accepted and ignored. Returns
    (y ``[B, T, H, N]`` in r's dtype, states fp32 ``[B, T, H, N, N]``)."""
    _validate(r, w_raw, k, v, u)
    if r.is_cuda:
        return wkv7_cuda.run_trail(wkv6_cuda.wkv6_step, (r, w_raw, k, v), initial_state, (u,))
    B, T, H, N = r.shape
    s = torch.zeros(B, H, N, N, device=r.device) if initial_state is None else initial_state.float()
    ys, states = [], []
    for t in range(T):
        s, y = wkv6_step(s, r[:, t], w_raw[:, t], k[:, t], v[:, t], u)
        ys.append(y)
        states.append(s)
    return torch.stack(ys, 1), torch.stack(states, 1)


def wkv6_reference(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, u: Tensor,
                   initial_state: Optional[Tensor] = None,
                   chunk: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Sequential fp32 scan (float64 for float64 streams). Without ``chunk``
    it is the JAX package's ``wkv6_reference``; with it, the decay floor of
    the chunked forms applies. Returns (y ``[B, T, H, N]`` in r's dtype,
    final state fp32)."""
    _validate(r, w_raw, k, v, u)
    B, T, H, N = r.shape
    sdt = torch.float64 if r.dtype == torch.float64 else torch.float32
    state = (torch.zeros(B, H, N, N, dtype=sdt, device=r.device)
             if initial_state is None else initial_state.to(sdt))
    ys = []
    for t in range(T):
        state, y = wkv6_step(state, r[:, t], w_raw[:, t], k[:, t], v[:, t], u, chunk)
        ys.append(y)
    y = torch.stack(ys, 1) if ys else r.new_zeros(r.shape)
    return y.to(r.dtype), state


def wkv6_chunked(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, u: Tensor,
                 initial_state: Optional[Tensor] = None,
                 chunk: int = DEFAULT_CHUNK) -> Tuple[Tensor, Tensor]:
    """Chunked matmul form (gated linear attention), all fp32, T % chunk == 0;
    the JAX package's ``wkv6_chunked``, decay floor included."""
    _validate(r, w_raw, k, v, u)
    B, T, H, N = r.shape
    if T % chunk:
        raise ValueError(f"T={T} must be a multiple of chunk={chunk}")
    L, nc = chunk, T // chunk
    f32 = torch.float32
    dev = r.device
    z0 = (torch.zeros(B, H, N, N, dtype=f32, device=dev) if initial_state is None
          else initial_state.to(f32).transpose(-1, -2))  # carry Z = S^T

    def chunked(x):
        return x.to(f32).permute(0, 2, 1, 3).reshape(B, H, nc, L, N)

    rc, wc, kc, vc = (chunked(x) for x in (r, w_raw, k, v))
    logw = log_decay(wc, L)
    g = torch.cumsum(logw, dim=-2)
    g_prev = g - logw
    g_last = g[..., -1:, :]

    r_t = rc * torch.exp(g_prev)  # the query sees the state BEFORE this step's decay
    k_h = kc * torch.exp(-g)
    k_bar = kc * torch.exp(g_last - g)
    tt = lambda x: x.transpose(-1, -2)
    strict = torch.tril(torch.ones(L, L, dtype=f32, device=dev), -1)

    sk = (r_t @ tt(k_h)) * strict
    bonus = (u.to(f32)[None, :, None, None, :] * kc * rc).sum(-1, keepdim=True)
    y_loc = sk @ vc + bonus * vc
    h_loc = tt(k_bar) @ vc
    p_last = torch.exp(g_last)  # [B, H, nc, 1, N]

    z = z0
    ys = []
    for c in range(nc):
        ys.append(r_t[:, :, c] @ z + y_loc[:, :, c])
        z = p_last[:, :, c].reshape(B, H, N, 1) * z + h_loc[:, :, c]
    y = torch.stack(ys, 2).reshape(B, H, T, N).permute(0, 2, 1, 3)
    return y.to(r.dtype), z.transpose(-1, -2)


def wkv6_plain(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, u: Tensor,
               initial_state: Optional[Tensor] = None,
               chunk: int = DEFAULT_CHUNK) -> Tuple[Tensor, Tensor]:
    """The plain path of :func:`wkv6`: chunked when T divides, else the
    sequential scan with the same decay floor."""
    if r.shape[1] % chunk == 0:
        return wkv6_chunked(r, w_raw, k, v, u, initial_state, chunk)
    return wkv6_reference(r, w_raw, k, v, u, initial_state, chunk)


def wkv6_fwd_res_plain(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, u: Tensor,
                       initial_state: Optional[Tensor] = None,
                       chunk: int = DEFAULT_CHUNK) -> Tuple[Tensor, Tensor, Tensor]:
    """The sequential scan (decay floor of ``chunk``) that also returns the
    state entering every 16-step chunk: (y, final state, ``zin`` fp32
    ``[B*H, T/16, N, N]``), where ``zin[bh, c]`` is the TRANSPOSE of the state
    before step ``16 c`` (the layout of the JAX package's
    ``wkv6_pallas_fwd_res`` at chunk 16, which kernel K8 writes and K9 reads)."""
    _validate(r, w_raw, k, v, u)
    B, T, H, N = r.shape
    if T == 0 or T % SAVE_EVERY:
        raise ValueError(f"T={T} must be a positive multiple of {SAVE_EVERY}")
    state = (torch.zeros(B, H, N, N, dtype=torch.float32, device=r.device)
             if initial_state is None else initial_state.to(torch.float32))
    ys, zs = [], []
    for t in range(T):
        if t % SAVE_EVERY == 0:
            zs.append(state.transpose(-1, -2).reshape(B * H, N, N))
        state, y = wkv6_step(state, r[:, t], w_raw[:, t], k[:, t], v[:, t], u, chunk)
        ys.append(y)
    return torch.stack(ys, 1).to(r.dtype), state, torch.stack(zs, 1)


def wkv6_bwd_plain(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, u: Tensor, zin: Tensor,
                   dy: Tensor, dsfinal: Tensor,
                   chunk: int = DEFAULT_CHUNK) -> Tuple[Tensor, ...]:
    """Vector-Jacobian product of the recurrence from the saved chunk states
    (the plain version of kernel K9): the 16-step chunks are walked in
    reverse, each differentiated by fp32 autograd through
    :func:`wkv6_reference` (decay floor of ``chunk``) from its saved entering
    state, with the state cotangent carried between chunks. Returns (dr,
    dw_raw, dk, dv) in the stream dtype, du fp32 ``[H, N]`` (summed over the
    batch) and the fp32 cotangent of the initial state."""
    _validate(r, w_raw, k, v, u)
    B, T, H, N = r.shape
    if T % SAVE_EVERY:
        raise ValueError(f"T={T} must be a multiple of {SAVE_EVERY}")
    f32 = torch.float32
    ds = dsfinal.to(f32)
    du = torch.zeros(H, N, dtype=f32, device=r.device)
    pieces = []
    for c in reversed(range(T // SAVE_EVERY)):
        sl = slice(c * SAVE_EVERY, (c + 1) * SAVE_EVERY)
        with torch.enable_grad():
            xs = [x[:, sl].detach().to(f32).requires_grad_(True) for x in (r, w_raw, k, v)]
            uu = u.detach().to(f32).requires_grad_(True)
            s_in = zin[:, c].reshape(B, H, N, N).transpose(-1, -2).detach().to(f32).requires_grad_(True)
            y, s_out = wkv6_reference(*xs, uu, s_in, chunk)
            grads = torch.autograd.grad((y, s_out), xs + [uu, s_in], (dy[:, sl].to(f32), ds))
        pieces.append(grads[:4])
        du = du + grads[4]
        ds = grads[5]
    out = [torch.cat([p[i] for p in reversed(pieces)], 1).to(r.dtype) for i in range(4)]
    return (*out, du, ds)


class WKV6Function(torch.autograd.Function):
    """The differentiable WKV6 from the saved chunk states: forward is kernel
    K8 (which saves the chunk states), backward is kernel K9, on CUDA
    tensors; their plain versions on CPU tensors. Counterpart of the JAX
    package's ``_wkv6_cv_pallas`` custom VJP. Any T: the 16-step chunks are
    filled with identity steps (:func:`visualrwkv_torch.ops.padding.pad_steps`)
    and the outputs and gradients cut back to T."""

    @staticmethod
    def forward(ctx, r, w_raw, k, v, u, initial_state, chunk):
        T = r.shape[1]
        xs = pad_steps((r, w_raw, k, v), 1, T + (-T) % SAVE_EVERY)
        fwd = wkv6_cuda.wkv6_fwd_res if r.is_cuda else wkv6_fwd_res_plain
        y, s, zin = fwd(*xs, u, initial_state, chunk=chunk)
        ctx.save_for_backward(*xs, u, zin)
        ctx.has_initial = initial_state is not None
        ctx.chunk, ctx.steps = chunk, T
        return (y if y.shape[1] == T else y[:, :T].contiguous()), s

    @staticmethod
    def backward(ctx, dy, ds):
        r, w_raw, k, v, u, zin = ctx.saved_tensors  # padded to a multiple of 16 steps
        B, Tp, H, N = r.shape
        T = ctx.steps
        # a cotangent that autograd did not materialise is zero, as is a padding step's
        dy = torch.zeros_like(r) if dy is None else pad_steps((dy.to(r.dtype),), -1, Tp)[0].contiguous()
        ds = (torch.zeros(B, H, N, N, dtype=torch.float32, device=r.device) if ds is None
              else ds.to(torch.float32).contiguous())
        bwd = wkv6_cuda.wkv6_bwd if r.is_cuda else wkv6_bwd_plain
        dr, dw, dk, dv, du, ds0 = bwd(r, w_raw, k, v, u, zin, dy, ds, chunk=ctx.chunk)
        cut = lambda g: g if Tp == T else g[:, :T]
        return cut(dr), cut(dw), cut(dk), cut(dv), du, ds0 if ctx.has_initial else None, None


def wkv6(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, u: Tensor,
         initial_state: Optional[Tensor] = None,
         chunk: int = DEFAULT_CHUNK) -> Tuple[Tensor, Tensor]:
    """Entry point of the models. With grad mode on and an input that needs
    a gradient, :class:`WKV6Function` on both devices (K8 forward, K9
    backward on CUDA, their plain versions on the CPU; any T). Otherwise
    CUDA tensors launch kernel K7 (``csrc/wkv6.cu``) and CPU tensors take
    the plain path (:func:`wkv6_plain`). Any ``chunk >= 1`` on both devices
    (the decay floor -80 / chunk; the kernels' 16-step chunks pick a factor
    form for it), and ``u`` is taken in fp32 on CUDA. Without a gradient the
    kernel takes streams of any float dtype and layout, as the plain path
    does: it runs in their common dtype (fp32 or bf16, else fp32), made
    contiguous, and y returns in r's dtype."""
    _validate(r, w_raw, k, v, u)
    inputs = (r, w_raw, k, v, u.float().contiguous() if r.is_cuda else u, initial_state)
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in inputs):
        return WKV6Function.apply(*inputs, chunk)
    if r.is_cuda:
        u32 = wkv7_cuda.operand(u, torch.float32)
        return wkv7_cuda.run_streams(lambda r, w, k, v, s0: wkv6_cuda.wkv6_fwd(r, w, k, v, u32, s0, chunk),
                                     inputs[:4], initial_state)
    return wkv6_plain(*inputs, chunk)


def wkv6_step_auto(state: Tensor, r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor,
                   u: Tensor) -> Tuple[Tensor, Tensor]:
    """Decode-step entry point on vectors ``[B, H, N]``. A state with one
    more dimension is the head layout ``[B, H, Nv, Nk]``: CPU tensors take
    :func:`wkv6_step`, CUDA tensors launch kernel K10. A state with as many
    dimensions as the vectors is the flat layout ``[B, Nv, H*Nk]``:
    :func:`wkv6_step_flat`, or K10 on the flat layout. The kernels' new
    state keeps the carried dtype (fp32 or bf16); their vectors may be of
    any float dtype and layout, as on the CPU (``wkv7_cuda.run_step``),
    and y returns in r's dtype on both devices."""
    vecs = (r, w_raw, k, v)
    if state.dim() == r.dim():
        H, N = r.shape[-2], r.shape[-1]
        if state.shape[-2:] != (N, H * N):
            raise ValueError(
                f"wkv6_step_auto: state {tuple(state.shape)} is not the flat "
                f"[B, {N}, {H * N}] wkv6 layout"
            )
        if state.is_cuda:
            return wkv7_cuda.run_step(wkv6_cuda.wkv6_step_flat, state, vecs, (u,))
        return wkv6_step_flat(state, *vecs, u)
    if state.is_cuda:
        return wkv7_cuda.run_step(wkv6_cuda.wkv6_step, state, vecs, (u,))
    return wkv6_step(state, *vecs, u)
