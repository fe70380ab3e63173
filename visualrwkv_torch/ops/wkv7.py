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
* :func:`wkv7_step` — one token.
* :func:`wkv7` / :func:`wkv7_step_auto` — dispatch on the tensors' device:
  the plain versions for CPU tensors, the CUDA kernels
  (:mod:`visualrwkv_torch.ops.wkv7_cuda`) for CUDA tensors.
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
    Returns (new_state fp32, y in r's dtype)."""
    f32 = torch.float32
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


def wkv7_reference(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
                   initial_state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Sequential fp32 scan. Returns (y ``[B, T, H, N]`` in r's dtype, final state fp32)."""
    _validate(r, w_raw, k, v, a, b)
    B, T, H, N = r.shape
    state = (
        torch.zeros(B, H, N, N, dtype=torch.float32, device=r.device)
        if initial_state is None else initial_state.to(torch.float32)
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


def wkv7(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
         initial_state: Optional[Tensor] = None,
         chunk: int = DEFAULT_CHUNK) -> Tuple[Tensor, Tensor]:
    """Entry point of the models. CPU tensors take the plain path; CUDA
    tensors launch kernel K1 (``csrc/wkv7.cu``), which has no chunk."""
    _validate(r, w_raw, k, v, a, b)
    if r.is_cuda:
        return wkv7_cuda.wkv7_fwd(r, w_raw, k, v, a, b, initial_state)
    return wkv7_plain(r, w_raw, k, v, a, b, initial_state, chunk)


def wkv7_step_auto(state: Tensor, r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor,
                   a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Decode-step entry point on the head layout ``[B, H, Nv, Nk]``. CPU
    tensors take :func:`wkv7_step`; CUDA tensors launch kernel K2, whose
    new state keeps the carried dtype (fp32 or bf16)."""
    if state.dim() != 4:
        raise NotImplementedError("only the head state layout [B, H, Nv, Nk] is ported")
    if state.is_cuda:
        return wkv7_cuda.wkv7_step(state, r, w_raw, k, v, a, b)
    return wkv7_step(state, r, w_raw, k, v, a, b)
