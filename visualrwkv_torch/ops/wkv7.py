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
* :func:`wkv7_packed_plain`, :func:`wkv7_fwd_res_packed_plain`,
  :func:`wkv7_bwd_packed_plain` — the same functions for head pairs (an
  even head count), with the chunk states in the packed layout of the JAX
  package (:func:`_pack_state_z`); :func:`_pack_stream` and the other
  layout functions are the JAX package's.
* :func:`wkv7_v2` — the chunk-batched forward of the JAX package's
  ``wkv7_pallas_v2`` (chunk 32): kernel K16 on CUDA tensors, its plain
  version :func:`wkv7_v2_plain` on the CPU. No dispatcher calls it.
* :func:`wkv7_scan_states` — a short window with the state after every
  position (speculative decoding's verify pass): K2 once a position on
  CUDA.
* :func:`wkv7` / :func:`wkv7_step_auto` — dispatch on the tensors' device
  and on :func:`set_wkv_impl`: the plain versions for CPU tensors, the CUDA
  kernels (:mod:`visualrwkv_torch.ops.wkv7_cuda`) for CUDA tensors. Under
  autograd, :class:`WKV7Function` (K5 forward, K6 backward) or, packed,
  :class:`WKV7PackedFunction` (K12, K13); both run their forward through
  the operator ``visualrwkv_torch::wkv7_fwd_res``, which the selective
  checkpoint policy ``grad_cp="wkv"`` saves. Inside :func:`wkv_seq_axis`
  (context parallelism, the token axis split over a process group) both
  :func:`wkv7` and ``ops.wkv6.wkv6`` run the ring of
  :mod:`visualrwkv_torch.ops.wkv_sp` instead.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from visualrwkv_torch.ops import wkv7_cuda
from visualrwkv_torch.ops.padding import pad_steps

Tensor = torch.Tensor

DEFAULT_CHUNK = 16
MAX_STABLE_CHUNK = 16  # docs/wkv_chunk_stability.md: the solve amplifies rounding above 16

WKV_IMPLS = ("auto", "pallas", "chunked", "packed")
_IMPL_MODE = "auto"


def set_wkv_impl(mode: str) -> None:
    """Select the implementation :func:`wkv7` runs, as the JAX package's
    ``set_wkv_impl`` (and the training CLI's ``--wkv_impl``) does. "auto"
    and "pallas": the head-layout kernels (K1; K5 / K6 under autograd) on
    CUDA tensors. "packed": the head-pair kernels (K11; K12 / K13) when the
    head count is even, else the head layout. "chunked": the plain chunked
    form on any device, differentiated by autograd (the JAX package's jnp
    path). CPU tensors take the plain versions in every mode."""
    global _IMPL_MODE
    assert mode in WKV_IMPLS, mode
    _IMPL_MODE = mode


def get_wkv_impl() -> str:
    """The mode :func:`set_wkv_impl` selected."""
    return _IMPL_MODE


# The seq process group of :func:`wkv_seq_axis` (None: no token split). The
# JAX package's ``wkv_spmd`` / ``set_wkv_spmd`` partition a Pallas call over
# a mesh's batch and head axes; here each process runs its own rows, so they
# have no counterpart.
_WKV_SEQ_AXIS = None


def current_seq_axis():
    """The seq process group declared by :func:`wkv_seq_axis` (None when not
    under one)."""
    return _WKV_SEQ_AXIS


@contextlib.contextmanager
def wkv_seq_axis(group):
    """Declare that the WKV calls made inside run on this rank's part of a
    token axis split over the process group ``group``: :func:`wkv7` and
    ``ops.wkv6.wkv6`` then run the context-parallel ring
    (:mod:`visualrwkv_torch.ops.wkv_sp`). ``None`` clears it (the ring's own
    local runs); a ring of one rank takes a process group of size one."""
    global _WKV_SEQ_AXIS
    prev = _WKV_SEQ_AXIS
    _WKV_SEQ_AXIS = group
    try:
        yield
    finally:
        _WKV_SEQ_AXIS = prev


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


def wkv7_scan_states(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
                     initial_state: Optional[Tensor] = None,
                     chunk: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """WKV7 over a short window, with the state after every position: the
    speculative verify pass rolls the recurrence back to the last accepted
    token (``infer.speculative``). CPU tensors take a loop of
    :func:`wkv7_step`; CUDA tensors launch kernel K2 once a position, each
    launch writing its state into the trail (``wkv7_cuda.run_trail``).
    ``chunk`` is accepted and ignored, so that this fits
    ``tmix_x070(wkv_fn=...)``. Returns (y ``[B, T, H, N]`` in r's dtype,
    states fp32 ``[B, T, H, N, N]``, ``[:, t]`` the state after position
    t)."""
    _validate(r, w_raw, k, v, a, b)
    if r.is_cuda:
        return wkv7_cuda.run_trail(wkv7_cuda.wkv7_step, (r, w_raw, k, v, a, b), initial_state)
    B, T, H, N = r.shape
    s = torch.zeros(B, H, N, N, device=r.device) if initial_state is None else initial_state.float()
    ys, states = [], []
    for t in range(T):
        s, y = wkv7_step(s, r[:, t], w_raw[:, t], k[:, t], v[:, t], a[:, t], b[:, t])
        ys.append(y)
        states.append(s)
    return torch.stack(ys, 1), torch.stack(states, 1)


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


def _block_solve(m_strict: Tensor, rhs: Tensor, solve: int) -> Tensor:
    """u = (I - M)^{-1} rhs by block forward substitution with length-``solve``
    diagonal blocks, u_i = T_ii (rhs_i + sum_{j<i} M_ij u_j): only the
    diagonal blocks' inverses are formed, so the stability envelope is that
    of ``solve``, not of the chunk (the JAX package's ``_btri_solve``,
    ``docs/wkv_chunk_stability.md``)."""
    L = m_strict.shape[-1]
    S = solve
    us = []
    for i in range(L // S):
        q = rhs[..., i * S:(i + 1) * S, :]
        for j in range(i):
            q = q + _mm(m_strict[..., i * S:(i + 1) * S, j * S:(j + 1) * S], us[j])
        t_ii = _tri_inverse_unit_lower(m_strict[..., i * S:(i + 1) * S, i * S:(i + 1) * S])
        us.append(_mm(t_ii, q))
    return torch.cat(us, dim=-2)


def _mm(x: Tensor, y: Tensor) -> Tensor:
    """Matmul with fp32 output (operands in their stored dtype)."""
    if x.dtype == torch.float32 and y.dtype == torch.float32:
        return x @ y
    return (x @ y).float()


def wkv7_chunked(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
                 initial_state: Optional[Tensor] = None,
                 chunk: int = DEFAULT_CHUNK, return_states: bool = False, solve: int = 0):
    """Chunked matmul form, T % chunk == 0 (same semantics as the reference).

    Decay-adjusted intermediates are stored in the input dtype (bf16 on the
    serving path); cumulative decays and the carried state stay fp32.
    ``solve`` below the chunk solves each chunk's triangular system by block
    forward substitution with length-``solve`` blocks (:func:`_block_solve`)
    instead of forming the whole inverse. Returns (y, final state), and with
    ``return_states`` also the transposed state entering every chunk, fp32
    ``[B*H, T/chunk, N, N]``."""
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
    nv = _mm(n_mat.to(idt), vc).to(idt)
    if 0 < solve < L:
        u0 = _block_solve(m_mat, nv.float(), solve).to(idt)
        ta = _block_solve(m_mat, a_t.float(), solve).to(idt)
    else:
        t_inv = _tri_inverse_unit_lower(m_mat).to(idt)
        u0 = _mm(t_inv, nv).to(idt)
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
    ys, zs = [], []
    for c in range(nc):
        zs.append(z)
        ys.append((q_eff[:, :, c].float() @ z + y_loc[:, :, c].float()).to(idt))
        z = (p_last[:, :, c].reshape(B, H, N, 1) * z + bta[:, :, c].float() @ z
             + h_loc[:, :, c].float())
    y = torch.stack(ys, 2).reshape(B, H, T, N).permute(0, 2, 1, 3)
    if return_states:
        return y.to(r.dtype), z.transpose(-1, -2), torch.stack(zs, 2).reshape(B * H, nc, N, N)
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


def _check_v2(T: int, chunk: int, t_block: int, g_heads: int) -> None:
    """The reference's conditions on its grid: T tiles by ``t_block`` and
    ``t_block`` by ``chunk``; ``g_heads`` (heads a TPU program) is a
    positive count."""
    if T % t_block or t_block % chunk:
        raise ValueError(f"T={T} must tile by t_block={t_block} (chunk {chunk})")
    if g_heads < 1:
        raise ValueError(f"g_heads must be a positive head count; got {g_heads}")


def wkv7_v2_plain(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
                  initial_state: Optional[Tensor] = None,
                  chunk: int = wkv7_cuda.V2_CHUNK) -> Tuple[Tensor, Tensor]:
    """The plain version of K16: the chunked form in fp32 at ``chunk`` (32),
    each chunk's system solved by block forward substitution with length-16
    diagonal blocks (the JAX package's ``_btri_solve``; the full chunk-32
    inverse of ``wkv7_pallas_v2`` amplifies bf16 rounding,
    ``docs/wkv_chunk_stability.md``). Returns (y in r's dtype, final fp32
    state)."""
    _validate(r, w_raw, k, v, a, b)
    f32 = torch.float32
    y, s = wkv7_chunked(*(x.to(f32) for x in (r, w_raw, k, v, a, b)), initial_state,
                        chunk=chunk, solve=MAX_STABLE_CHUNK)
    return y.to(r.dtype), s


def wkv7_v2(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
            initial_state: Optional[Tensor] = None, chunk: int = wkv7_cuda.V2_CHUNK,
            t_block: int = 256, g_heads: int = 4) -> Tuple[Tensor, Tensor]:
    """The chunk-batched forward, counterpart of the JAX package's
    ``wkv7_pallas_v2`` (same semantics as :func:`wkv7`; it raises for the
    same inputs: T must tile by ``t_block`` and ``t_block`` by ``chunk``).
    ``t_block`` and ``g_heads`` shape the TPU grid and do not change the
    result. CUDA tensors launch kernel K16 (chunk 32), CPU tensors take
    :func:`wkv7_v2_plain`. No dispatcher calls it, as in the JAX package."""
    _validate(r, w_raw, k, v, a, b)
    _check_v2(r.shape[1], chunk, t_block, g_heads)
    if r.is_cuda:
        if chunk != wkv7_cuda.V2_CHUNK:
            raise ValueError(f"wkv7_v2: kernel K16 runs chunk {wkv7_cuda.V2_CHUNK}; got {chunk}")
        return wkv7_cuda.wkv7_fwd_v2(r, w_raw, k, v, a, b, initial_state)
    return wkv7_v2_plain(r, w_raw, k, v, a, b, initial_state, chunk)


def wkv7_fwd_res_plain(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
                       initial_state: Optional[Tensor] = None,
                       chunk: int = DEFAULT_CHUNK) -> Tuple[Tensor, Tensor, Tensor]:
    """The forward that also returns the state entering every chunk: (y,
    final state, ``zin`` fp32 ``[B*H, T/chunk, N, N]``), where ``zin[bh, c]``
    is the TRANSPOSE of the state before step ``c * chunk`` (the layout
    kernel K5 writes and K6 reads coalesced, and the one the JAX package's
    ``wkv7_pallas_fwd_res`` saves). The chunked form computed in fp32
    whatever the stream dtype (the kernel's arithmetic is fp32); y is cast
    back to the stream dtype."""
    _validate(r, w_raw, k, v, a, b)
    T = r.shape[1]
    if T == 0 or T % chunk or chunk > MAX_STABLE_CHUNK:
        raise ValueError(f"T={T} must be a positive multiple of chunk={chunk} (<= {MAX_STABLE_CHUNK})")
    f32 = torch.float32
    y, s, zin = wkv7_chunked(*(x.to(f32) for x in (r, w_raw, k, v, a, b)), initial_state,
                             chunk=chunk, return_states=True)
    return y.to(r.dtype), s, zin


def wkv7_bwd_plain(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
                   zin: Tensor, dy: Tensor, dsfinal: Tensor,
                   chunk: int = DEFAULT_CHUNK) -> Tuple[Tensor, ...]:
    """Vector-Jacobian product of the recurrence (the plain version of
    kernel K6): fp32 autograd through :func:`wkv7_chunked` from the state
    entering the first chunk, ``zin[:, 0]`` (the later saved states are the
    same function of it, which K6 reads instead of recomputing them), as
    the JAX package's CPU path differentiates its chunked form. Returns
    (dr, dw_raw, dk, dv, da, db) in the stream dtype and the fp32 cotangent
    of the initial state."""
    _validate(r, w_raw, k, v, a, b)
    B, T, H, N = r.shape
    if T % chunk:
        raise ValueError(f"T={T} must be a multiple of chunk={chunk}")
    f32 = torch.float32
    with torch.enable_grad():
        xs = [x.detach().to(f32).requires_grad_(True) for x in (r, w_raw, k, v, a, b)]
        s_in = zin[:, 0].reshape(B, H, N, N).transpose(-1, -2).detach().to(f32).requires_grad_(True)
        y, s_out = wkv7_chunked(*xs, s_in, chunk=chunk)
        grads = torch.autograd.grad((y, s_out), xs + [s_in], (dy.to(f32), dsfinal.to(f32)))
    return (*(g.to(r.dtype) for g in grads[:6]), grads[6])


def _check_pairs(H: int) -> None:
    if H % 2:
        raise ValueError(f"packed layout needs an even head count, got H={H}")


def _pack_stream(x: Tensor, B: int, T: int, H: int, N: int) -> Tensor:
    """``[B, T, H, N]`` -> ``[B*H/2, T, 2N]`` (head pairs side by side)."""
    x = x.reshape(B, T, H // 2, 2 * N)
    return x.permute(0, 2, 1, 3).reshape(B * H // 2, T, 2 * N)


def _unpack_stream(x: Tensor, B: int, T: int, H: int, N: int) -> Tensor:
    return x.reshape(B, H // 2, T, 2 * N).permute(0, 2, 1, 3).reshape(B, T, H, N)


def _pack_state_z(s: Tensor, B: int, H: int, N: int) -> Tensor:
    """S ``[B, H, Nv, Nk]`` -> packed Z = S^T ``[B*H/2, Nk, 2*Nv]``: element
    ``[p, j, h2*N + i]`` is ``S_{2p+h2}[i, j]``."""
    z = s.float().transpose(-1, -2).reshape(B, H // 2, 2, N, N)
    return z.permute(0, 1, 3, 2, 4).reshape(B * H // 2, N, 2 * N)


def _unpack_state_z(z: Tensor, B: int, H: int, N: int) -> Tensor:
    z = z.reshape(B, H // 2, N, 2, N)
    return z.permute(0, 1, 3, 2, 4).reshape(B, H, N, N).transpose(-1, -2)


def _pack_zin(zin: Tensor, B: int, H: int) -> Tensor:
    """Head-layout chunk states ``[B*H, nc, N, N]`` (Z = S^T) -> packed
    ``[B*H/2, nc, N, 2N]``."""
    _, nc, N, _ = zin.shape
    z = zin.reshape(B, H // 2, 2, nc, N, N).permute(0, 1, 3, 4, 2, 5)
    return z.reshape(B * H // 2, nc, N, 2 * N)


def _unpack_zin(zin: Tensor, B: int, H: int) -> Tensor:
    _, nc, N, _ = zin.shape
    z = zin.reshape(B, H // 2, nc, N, 2, N).permute(0, 1, 4, 2, 3, 5)
    return z.reshape(B * H, nc, N, N)


def wkv7_packed_plain(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
                      initial_state: Optional[Tensor] = None,
                      chunk: int = DEFAULT_CHUNK) -> Tuple[Tensor, Tensor]:
    """The plain version of kernel K11 (the JAX package's
    ``wkv7_pallas_packed``): :func:`wkv7_plain` for an even head count. The
    pairing changes where a head's values lie in the TPU kernel's streams,
    not what is computed; the public layouts are the head layout's."""
    _validate(r, w_raw, k, v, a, b)
    _check_pairs(r.shape[2])
    return wkv7_plain(r, w_raw, k, v, a, b, initial_state, chunk)


def wkv7_fwd_res_packed_plain(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor,
                              b: Tensor, initial_state: Optional[Tensor] = None,
                              chunk: int = DEFAULT_CHUNK) -> Tuple[Tensor, Tensor, Tensor]:
    """The plain version of kernel K12 (``wkv7_pallas_fwd_res_packed``): (y,
    final state, packed ``zin`` fp32 ``[B*H/2, T/chunk, N, 2N]``, element
    ``[p, c, j, h2*N + i]`` the state ``S_{2p+h2}[i, j]`` before step
    ``c * chunk``)."""
    _validate(r, w_raw, k, v, a, b)
    B, _, H, _ = r.shape
    _check_pairs(H)
    y, s, zin = wkv7_fwd_res_plain(r, w_raw, k, v, a, b, initial_state, chunk)
    return y, s, _pack_zin(zin, B, H)


def wkv7_bwd_packed_plain(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
                          zin: Tensor, dy: Tensor, dsfinal: Tensor,
                          chunk: int = DEFAULT_CHUNK) -> Tuple[Tensor, ...]:
    """The plain version of kernel K13 (``wkv7_pallas_bwd_packed``):
    :func:`wkv7_bwd_plain` from the packed ``zin``. ``dsfinal`` and the
    returned initial-state cotangent are ``[B, H, N, N]``."""
    _validate(r, w_raw, k, v, a, b)
    B, _, H, _ = r.shape
    _check_pairs(H)
    return wkv7_bwd_plain(r, w_raw, k, v, a, b, _unpack_zin(zin, B, H), dy, dsfinal, chunk)


@torch.library.custom_op(
    "visualrwkv_torch::wkv7_fwd_res", mutates_args=(),
    schema="(Tensor r, Tensor w_raw, Tensor k, Tensor v, Tensor a, Tensor b, "
           "Tensor? initial_state, bool packed) -> (Tensor, Tensor, Tensor)",
)
def wkv7_fwd_res_op(r, w_raw, k, v, a, b, initial_state, packed):
    """The training forward as one operator, so that a selective checkpoint
    policy can save its outputs (``grad_cp="wkv"``). CUDA tensors launch K5
    (K12 when ``packed``), CPU tensors take the plain versions. Returns (y,
    final state, zin)."""
    if r.is_cuda:
        fn = wkv7_cuda.wkv7_fwd_res_packed if packed else wkv7_cuda.wkv7_fwd_res
    else:
        fn = wkv7_fwd_res_packed_plain if packed else wkv7_fwd_res_plain
    return fn(r, w_raw, k, v, a, b, initial_state)


def _fwd_saving(ctx, packed: bool, r, w_raw, k, v, a, b, initial_state):
    T = r.shape[1]
    xs = pad_steps((r, w_raw, k, v, a, b), 1, T + (-T) % wkv7_cuda.CHUNK)
    s0 = None if initial_state is None else initial_state.contiguous()
    y, s, zin = torch.ops.visualrwkv_torch.wkv7_fwd_res(*xs, s0, packed)
    ctx.save_for_backward(*xs, zin)
    ctx.has_initial = initial_state is not None
    ctx.steps = T
    return (y if y.shape[1] == T else y[:, :T].contiguous()), s


def _bwd_from_saved(ctx, packed: bool, dy, ds):
    r, w_raw, k, v, a, b, zin = ctx.saved_tensors  # padded to a multiple of 16 steps
    B, Tp, H, N = r.shape
    T = ctx.steps
    # a cotangent that autograd did not materialise is zero, as is a padding step's
    dy = torch.zeros_like(r) if dy is None else pad_steps((dy.to(r.dtype),), -1, Tp)[0].contiguous()
    ds = (torch.zeros(B, H, N, N, dtype=torch.float32, device=r.device) if ds is None
          else ds.to(torch.float32).contiguous())
    if r.is_cuda:
        bwd = wkv7_cuda.wkv7_bwd_packed if packed else wkv7_cuda.wkv7_bwd
    else:
        bwd = wkv7_bwd_packed_plain if packed else wkv7_bwd_plain
    grads = bwd(r, w_raw, k, v, a, b, zin, dy, ds)
    return (*(g if Tp == T else g[:, :T] for g in grads[:6]), grads[6] if ctx.has_initial else None)


class WKV7Function(torch.autograd.Function):
    """The differentiable WKV7 from the saved chunk states: forward is
    :func:`wkv7_fwd_res_op` (kernel K5 on CUDA, which saves the chunk
    states), backward is kernel K6 (the plain versions on the CPU).
    Counterpart of the JAX package's ``_wkv7_cv_pallas_blocked`` custom
    VJP. Any T: the kernels' 16-step chunks are filled with identity steps
    (:func:`visualrwkv_torch.ops.padding.pad_steps`) on both devices, and
    the outputs and gradients cut back to T."""

    @staticmethod
    def forward(ctx, r, w_raw, k, v, a, b, initial_state):
        return _fwd_saving(ctx, False, r, w_raw, k, v, a, b, initial_state)

    @staticmethod
    def backward(ctx, dy, ds):
        return _bwd_from_saved(ctx, False, dy, ds)


class WKV7PackedFunction(torch.autograd.Function):
    """:class:`WKV7Function` on head pairs: kernel K12 forward, saving the
    packed chunk states, and K13 backward (the packed plain versions on the
    CPU). Counterpart of the JAX package's ``_wkv7_cv_packed``."""

    @staticmethod
    def forward(ctx, r, w_raw, k, v, a, b, initial_state):
        return _fwd_saving(ctx, True, r, w_raw, k, v, a, b, initial_state)

    @staticmethod
    def backward(ctx, dy, ds):
        return _bwd_from_saved(ctx, True, dy, ds)


def wkv7(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
         initial_state: Optional[Tensor] = None,
         chunk: int = DEFAULT_CHUNK) -> Tuple[Tensor, Tensor]:
    """Entry point of the models, by the mode of :func:`set_wkv_impl`.
    "chunked": :func:`wkv7_plain` on any device, which autograd
    differentiates. Otherwise, with grad mode on and an input that needs a
    gradient, :class:`WKV7Function` (K5 forward, K6 backward on CUDA, their
    plain versions on the CPU), or :class:`WKV7PackedFunction` in "packed"
    mode with an even head count (K12, K13), at any T on both devices (a T
    that is not a multiple of 16 is padded with identity steps). Those run
    the kernels' 16-step chunk whatever ``chunk`` is: the JAX package's
    fused path takes a chunk of 8 to harden its solve, which the kernels'
    fp32 forward substitution over 16 steps does not need (it reads about
    1e-6 relative error on the adversarial input of
    ``tests/test_torch_wkv7_chunked.py``, where the limit is 1e-5).
    Without a gradient, CUDA tensors launch K1 (K11 when packed), K5's
    kernel without the saved states: it too runs the 16-step chunk whatever
    ``chunk`` is, at any T (the steps past T of its last chunk are identity
    steps inside the kernel), and its envelope is K5's: finite up to w_raw
    of about 2.4 on a whole chunk, where the models keep w_raw <= -0.5. CPU
    tensors take :func:`wkv7_plain` (:func:`wkv7_packed_plain`). The
    kernels take streams of any float dtype and layout, as the plain path
    does: they run in the streams' common dtype (fp32 or bf16, else fp32),
    made contiguous, and y returns in r's dtype."""
    if _WKV_SEQ_AXIS is not None:
        from visualrwkv_torch.ops.wkv_sp import wkv7_seq_shard

        return wkv7_seq_shard(r, w_raw, k, v, a, b, initial_state, chunk, group=_WKV_SEQ_AXIS)
    _validate(r, w_raw, k, v, a, b)
    if _IMPL_MODE == "chunked":
        return wkv7_plain(r, w_raw, k, v, a, b, initial_state, chunk)
    packed = _IMPL_MODE == "packed" and r.shape[2] % 2 == 0
    inputs = (r, w_raw, k, v, a, b, initial_state)
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in inputs):
        return (WKV7PackedFunction if packed else WKV7Function).apply(*inputs)
    if r.is_cuda:
        kernel = wkv7_cuda.wkv7_fwd_packed if packed else wkv7_cuda.wkv7_fwd
        return wkv7_cuda.run_streams(kernel, inputs[:6], initial_state)
    return (wkv7_packed_plain if packed else wkv7_plain)(*inputs, chunk)


def wkv7_step_auto(state: Tensor, r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor,
                   a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Decode-step entry point on vectors ``[B, H, N]``. A state with one
    more dimension is the head layout ``[B, H, Nv, Nk]``: CPU tensors take
    :func:`wkv7_step`, CUDA tensors launch kernel K2. A state with as many
    dimensions as the vectors is the flat layout ``[B, Nv, H*Nk]``:
    :func:`wkv7_step_flat` or kernel K4. The kernels' new state keeps the
    carried dtype (fp32 or bf16). On CUDA the vectors may be of any float
    dtype and layout and carry more leading dimensions than B, as on the CPU
    (``wkv7_cuda.run_step``); y returns in r's dtype on both devices."""
    vecs = (r, w_raw, k, v, a, b)
    if state.dim() == r.dim():
        H, N = r.shape[-2], r.shape[-1]
        if state.shape[-2:] != (N, H * N):
            raise ValueError(
                f"wkv7_step_auto: state {tuple(state.shape)} is not the flat "
                f"[B, {N}, {H * N}] wkv7 layout"
            )
        if state.is_cuda:
            return wkv7_cuda.run_step(wkv7_cuda.wkv7_step_flat, state, vecs)
        return wkv7_step_flat(state, *vecs)
    if state.is_cuda:
        return wkv7_cuda.run_step(wkv7_cuda.wkv7_step, state, vecs)
    return wkv7_step(state, *vecs)
