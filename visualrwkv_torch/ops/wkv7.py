"""RWKV-7 ("x070") WKV recurrence: plain PyTorch versions and dispatchers.

The recurrence (per head, head size N; fp32 state ``S`` of shape ``[N_v, N_k]``)::

    sa_t = S_{t-1} @ a_t
    S_t  = S_{t-1} * w_t[None, :] + sa_t[:, None] * b_t[None, :] + v_t[:, None] * k_t[None, :]
    y_t  = S_t @ r_t

with ``w_t = exp(-exp(w_raw_t))``. Streams are ``[B, T, H, N]``; the state is
``[B, H, N_v, N_k]`` fp32 (a decode carry may be bf16).

* :func:`wkv7_reference` — the sequential scan, fp32.
* :func:`wkv7_chunked` — the chunked matmul form of the JAX package
  (``visualrwkv_tpu/ops/wkv7.py::wkv7_chunked``), chunk <= 16.
* :func:`wkv7_step` — one token; :func:`wkv7_step_flat` — the same on the
  flat state layout ``[B, N_v, H*N_k]`` (:func:`state_to_flat`,
  :func:`state_from_flat`).
* :func:`wkv7_fwd_res_plain` / :func:`wkv7_bwd_plain` — the training
  forward that also returns the state entering every chunk, and the
  vector-Jacobian product from those states.
* :func:`wkv7` / :func:`wkv7_step_auto` — dispatch on the tensors' device:
  the plain versions for CPU tensors, the CUDA kernels
  (:mod:`visualrwkv_torch.ops.wkv7_cuda`) for CUDA tensors. Under autograd
  on CUDA, :class:`WKV7Function` runs kernel K5 forward and K6 backward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from visualrwkv_torch.ops import wkv7_cuda

Tensor = torch.Tensor

DEFAULT_CHUNK = 16
MAX_STABLE_CHUNK = 16  # docs/wkv_chunk_stability.md: the solve amplifies rounding above 16


def _validate(r, w, k, v, a, b):
    shape = r.shape
    for x in (w, k, v, a, b):
        if x.shape != shape:
            raise ValueError(f"wkv7 inputs must share shape; got {tuple(x.shape)} vs {tuple(shape)}")
    if len(shape) != 4:
        raise ValueError(f"wkv7 inputs must be [B, T, H, N]; got {tuple(shape)}")


def wkv7_step(state: Tensor, r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor,
              a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Single-token update. state ``[..., H, Nv, Nk]``; vectors ``[..., H, N]``.
    Returns (new_state fp32, y in r's dtype). The arithmetic is fp32, or
    float64 when the state is float64 (finite-difference checks)."""
    f32 = torch.float64 if state.dtype == torch.float64 else torch.float32
    out_dtype = r.dtype
    state = state.to(f32)
    r, k, v, a, b = (x.to(f32) for x in (r, k, v, a, b))
    w = torch.exp(-torch.exp(w_raw.to(f32)))
    # y against the OLD state: y = S(w*r) + (Sa)(b.r) + v(k.r)
    sa = torch.einsum("...ij,...j->...i", state, a)
    swr = torch.einsum("...ij,...j->...i", state, w * r)
    y = swr + sa * (b * r).sum(-1, keepdim=True) + v * (k * r).sum(-1, keepdim=True)
    state = state * w[..., None, :] + sa[..., :, None] * b[..., None, :] + v[..., :, None] * k[..., None, :]
    return state, y.to(out_dtype)


def wkv7_step_flat(state: Tensor, r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor,
                   a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """:func:`wkv7_step` on the flat state ``[B, N_v, H*N_k]`` (element
    ``[b, i, h*N + j]`` is ``S[b, h, i, j]``); vectors ``[B, H, N]``. Returns
    (new state in the carried dtype and layout, y in r's dtype)."""
    H = r.shape[-2]
    s, y = wkv7_step(state_from_flat(state, H), r, w_raw, k, v, a, b)
    return state_to_flat(s).to(state.dtype), y


def state_to_flat(state: Tensor) -> Tensor:
    """``[B, H, N_v, N_k]`` -> flat ``[B, N_v, H*N_k]`` (a decode carry)."""
    B, H, Nv, Nk = state.shape
    return state.transpose(1, 2).reshape(B, Nv, H * Nk)


def state_from_flat(state: Tensor, n_head: int) -> Tensor:
    """Flat ``[B, N_v, H*N_k]`` -> ``[B, H, N_v, N_k]``."""
    B, Nv, HN = state.shape
    return state.reshape(B, Nv, n_head, HN // n_head).transpose(1, 2)


def wkv7_reference(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
                   initial_state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Sequential fp32 scan (float64 for float64 streams). Returns (y
    ``[B, T, H, N]`` in r's dtype, final state fp32)."""
    _validate(r, w_raw, k, v, a, b)
    B, T, H, N = r.shape
    sdt = torch.float64 if r.dtype == torch.float64 else torch.float32
    state = (
        torch.zeros(B, H, N, N, dtype=sdt, device=r.device)
        if initial_state is None else initial_state.to(sdt)
    )
    ys = []
    for t in range(T):
        state, y = wkv7_step(state, r[:, t], w_raw[:, t], k[:, t], v[:, t], a[:, t], b[:, t])
        ys.append(y)
    y = torch.stack(ys, 1) if ys else r.new_zeros(r.shape)
    return y.to(r.dtype), state


def _tri_inverse_unit_lower(m_strict: Tensor) -> Tensor:
    """(I - M)^{-1} for strictly-lower-triangular M: (I+M)(I+M^2)(I+M^4)..."""
    L = m_strict.shape[-1]
    eye = torch.eye(L, dtype=m_strict.dtype, device=m_strict.device)
    t = eye + m_strict
    p = m_strict
    for _ in range(max(0, (L - 1).bit_length() - 1)):
        p = p @ p
        t = t @ (eye + p)
    return t


def _mm(x: Tensor, y: Tensor) -> Tensor:
    """Matmul with fp32 output (operands in their stored dtype)."""
    if x.dtype == torch.float32 and y.dtype == torch.float32:
        return x @ y
    return (x @ y).float()


def wkv7_chunked(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
                 initial_state: Optional[Tensor] = None,
                 chunk: int = DEFAULT_CHUNK) -> Tuple[Tensor, Tensor]:
    """Chunked matmul form, T % chunk == 0 (same semantics as the reference).

    Decay-adjusted intermediates are stored in the input dtype (bf16 on the
    serving path); cumulative decays and the carried state stay fp32."""
    _validate(r, w_raw, k, v, a, b)
    B, T, H, N = r.shape
    if T % chunk:
        raise ValueError(f"T={T} must be a multiple of chunk={chunk}")
    L, nc = chunk, T // chunk
    f32 = torch.float32
    idt = r.dtype if r.dtype in (torch.bfloat16, torch.float32) else f32
    dev = r.device

    z0 = (torch.zeros(B, H, N, N, dtype=f32, device=dev) if initial_state is None
          else initial_state.to(f32).transpose(-1, -2))  # carry Z = S^T

    def chunked(x, dt):
        return x.to(dt).permute(0, 2, 1, 3).reshape(B, H, nc, L, N)

    rc, kc, ac, bc, vc = (chunked(x, idt) for x in (r, k, a, b, v))
    wc = chunked(w_raw, f32)

    logw = -torch.exp(wc)
    g = torch.cumsum(logw, dim=-2)
    g_prev = g - logw
    g_last = g[..., -1:, :]

    a_t = ac * torch.exp(g_prev).to(idt)
    b_h = bc * torch.exp(-g).to(idt)
    k_h = kc * torch.exp(-g).to(idt)
    r_t = rc * torch.exp(g).to(idt)
    b_bar = bc * torch.exp(g_last - g).to(idt)
    k_bar = kc * torch.exp(g_last - g).to(idt)

    tt = lambda x: x.transpose(-1, -2)
    strict = torch.tril(torch.ones(L, L, dtype=f32, device=dev), -1)
    incl = torch.tril(torch.ones(L, L, dtype=f32, device=dev))

    m_mat = _mm(a_t, tt(b_h)) * strict
    n_mat = _mm(a_t, tt(k_h)) * strict
    t_inv = _tri_inverse_unit_lower(m_mat).to(idt)

    u0 = _mm(t_inv, _mm(n_mat.to(idt), vc).to(idt)).to(idt)
    ta = _mm(t_inv, a_t).to(idt)
    sb = (_mm(r_t, tt(b_h)) * incl).to(idt)
    sk = (_mm(r_t, tt(k_h)) * incl).to(idt)

    q_eff = (r_t.float() + _mm(sb, ta)).to(idt)
    y_loc = (_mm(sb, u0) + _mm(sk, vc)).to(idt)
    bta = _mm(tt(b_bar), ta).to(idt)
    h_loc = (_mm(tt(b_bar), u0) + _mm(tt(k_bar), vc)).to(idt)
    p_last = torch.exp(g_last)  # [B, H, nc, 1, N]

    # scan over chunks in fp32: Y_c = q_eff_c Z + y_loc_c; Z <- p_L Z + bta_c Z + h_loc_c
    z = z0
    ys = []
    for c in range(nc):
        ys.append((q_eff[:, :, c].float() @ z + y_loc[:, :, c].float()).to(idt))
        z = (p_last[:, :, c].reshape(B, H, N, 1) * z + bta[:, :, c].float() @ z
             + h_loc[:, :, c].float())
    y = torch.stack(ys, 2).reshape(B, H, T, N).permute(0, 2, 1, 3)
    return y.to(r.dtype), z.transpose(-1, -2)


def wkv7_plain(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
               initial_state: Optional[Tensor] = None,
               chunk: int = DEFAULT_CHUNK) -> Tuple[Tensor, Tensor]:
    """The plain path of :func:`wkv7`: chunked (solve length capped at 16)
    when T divides, else the sequential scan."""
    T = r.shape[1]
    for c in (16, 8, 4):
        if c <= min(chunk, MAX_STABLE_CHUNK) and T % c == 0:
            return wkv7_chunked(r, w_raw, k, v, a, b, initial_state, chunk=c)
    return wkv7_reference(r, w_raw, k, v, a, b, initial_state)


def wkv7_fwd_res_plain(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
                       initial_state: Optional[Tensor] = None,
                       chunk: int = DEFAULT_CHUNK) -> Tuple[Tensor, Tensor, Tensor]:
    """The sequential scan that also returns the state entering every chunk:
    (y, final state, ``zin`` fp32 ``[B*H, T/chunk, N, N]``), where
    ``zin[bh, c]`` is the TRANSPOSE of the state before step ``c * chunk``
    (the layout kernel K5 writes and K6 reads coalesced, and the one the
    JAX package's ``wkv7_pallas_fwd_res`` saves)."""
    _validate(r, w_raw, k, v, a, b)
    B, T, H, N = r.shape
    if T == 0 or T % chunk:
        raise ValueError(f"T={T} must be a positive multiple of chunk={chunk}")
    state = (torch.zeros(B, H, N, N, dtype=torch.float32, device=r.device)
             if initial_state is None else initial_state.to(torch.float32))
    ys, zs = [], []
    for t in range(T):
        if t % chunk == 0:
            zs.append(state.transpose(-1, -2).reshape(B * H, N, N))
        state, y = wkv7_step(state, r[:, t], w_raw[:, t], k[:, t], v[:, t], a[:, t], b[:, t])
        ys.append(y)
    return torch.stack(ys, 1).to(r.dtype), state, torch.stack(zs, 1)


def wkv7_bwd_plain(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
                   zin: Tensor, dy: Tensor, dsfinal: Tensor,
                   chunk: int = DEFAULT_CHUNK) -> Tuple[Tensor, ...]:
    """Vector-Jacobian product of the recurrence from the saved chunk states
    (the plain version of kernel K6): the chunks are walked in reverse, each
    differentiated by fp32 autograd through :func:`wkv7_reference` from its
    saved entering state, with the state cotangent carried between chunks.
    Returns (dr, dw_raw, dk, dv, da, db) in the stream dtype and the fp32
    cotangent of the initial state."""
    _validate(r, w_raw, k, v, a, b)
    B, T, H, N = r.shape
    if T % chunk:
        raise ValueError(f"T={T} must be a multiple of chunk={chunk}")
    f32 = torch.float32
    ds = dsfinal.to(f32)
    pieces = []
    for c in reversed(range(T // chunk)):
        sl = slice(c * chunk, (c + 1) * chunk)
        with torch.enable_grad():
            xs = [x[:, sl].detach().to(f32).requires_grad_(True) for x in (r, w_raw, k, v, a, b)]
            s_in = zin[:, c].reshape(B, H, N, N).transpose(-1, -2).detach().to(f32).requires_grad_(True)
            y, s_out = wkv7_reference(*xs, s_in)
            grads = torch.autograd.grad((y, s_out), xs + [s_in], (dy[:, sl].to(f32), ds))
        pieces.append(grads[:6])
        ds = grads[6]
    out = [torch.cat([p[i] for p in reversed(pieces)], 1).to(r.dtype) for i in range(6)]
    return (*out, ds)


class WKV7Function(torch.autograd.Function):
    """The differentiable WKV7 on CUDA tensors: forward is kernel K5 (which
    saves the chunk states), backward is kernel K6. Counterpart of the JAX
    package's ``_wkv7_cv_pallas_blocked`` custom VJP."""

    @staticmethod
    def forward(ctx, r, w_raw, k, v, a, b, initial_state):
        y, s, zin = wkv7_cuda.wkv7_fwd_res(r, w_raw, k, v, a, b, initial_state)
        ctx.save_for_backward(r, w_raw, k, v, a, b, zin)
        ctx.has_initial = initial_state is not None
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        r, w_raw, k, v, a, b, zin = ctx.saved_tensors
        B, T, H, N = r.shape
        # a cotangent that autograd did not materialise is zero
        dy = torch.zeros_like(r) if dy is None else dy.to(r.dtype).contiguous()
        ds = (torch.zeros(B, H, N, N, dtype=torch.float32, device=r.device) if ds is None
              else ds.to(torch.float32).contiguous())
        grads = wkv7_cuda.wkv7_bwd(r, w_raw, k, v, a, b, zin, dy, ds)
        return (*grads[:6], grads[6] if ctx.has_initial else None)


def wkv7(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
         initial_state: Optional[Tensor] = None,
         chunk: int = DEFAULT_CHUNK) -> Tuple[Tensor, Tensor]:
    """Entry point of the models. CPU tensors take the plain path, which
    autograd differentiates through PyTorch ops. CUDA tensors launch kernel
    K1 (``csrc/wkv7.cu``, no chunk) or, when grad mode is on and an input
    needs a gradient, :class:`WKV7Function` (K5 forward, K6 backward; T must
    be a multiple of 16)."""
    _validate(r, w_raw, k, v, a, b)
    if r.is_cuda:
        inputs = (r, w_raw, k, v, a, b, initial_state)
        if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in inputs):
            return WKV7Function.apply(*inputs)
        return wkv7_cuda.wkv7_fwd(r, w_raw, k, v, a, b, initial_state)
    return wkv7_plain(r, w_raw, k, v, a, b, initial_state, chunk)


def wkv7_step_auto(state: Tensor, r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor,
                   a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Decode-step entry point. A 4-D state is the head layout
    ``[B, H, Nv, Nk]``: CPU tensors take :func:`wkv7_step`, CUDA tensors
    launch kernel K2. A 3-D state is the flat layout ``[B, Nv, H*Nk]``:
    :func:`wkv7_step_flat` or kernel K4. The kernels' new state keeps the
    carried dtype (fp32 or bf16)."""
    if state.dim() == 3:
        H, N = r.shape[-2], r.shape[-1]
        if state.shape[-2:] != (N, H * N):
            raise ValueError(
                f"wkv7_step_auto: 3-D state {tuple(state.shape)} is not the flat "
                f"[B, {N}, {H * N}] wkv7 layout"
            )
        if state.is_cuda:
            return wkv7_cuda.wkv7_step_flat(state, r, w_raw, k, v, a, b)
        return wkv7_step_flat(state, r, w_raw, k, v, a, b)
    if state.is_cuda:
        return wkv7_cuda.wkv7_step(state, r, w_raw, k, v, a, b)
    return wkv7_step(state, r, w_raw, k, v, a, b)
