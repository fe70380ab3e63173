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
* :func:`wkv4_chunked_plain`, :func:`wkv4_chunked_bwd_plain` — the same
  two functions by K17's and K18's own algorithm, the chunked scan over T,
  written in torch so that the CPU holds the algorithm against JAX; only
  tests and ``chip_smoke.py`` call them.
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


def _float(k: Tensor):
    """The arithmetic type of the plain versions: float64 for float64 k,
    else fp32."""
    return torch.float64 if k.dtype == torch.float64 else torch.float32


def _cut(x: Tensor, chunk: int) -> Tensor:
    """A ``[B, T, C]`` stream cut into chunks of ``chunk`` steps ``[B, n,
    chunk, C]``, the last one filled with zeros past T."""
    B, T, C = x.shape
    n = -(-T // chunk)
    return torch.nn.functional.pad(x, (0, 0, 0, n * chunk - T)).reshape(B, n, chunk, C)


def _chunks(k: Tensor, v: Tensor, chunk: int):
    """k, v cut into chunks (:func:`_cut`), the mask of real steps ``[n,
    chunk]`` and each chunk's length ``[n]``."""
    T = k.shape[1]
    n = -(-T // chunk)
    t = torch.arange(n * chunk, device=k.device).reshape(n, chunk)
    lens = torch.clamp(T - torch.arange(n, device=k.device) * chunk, max=chunk)
    return (_cut(k, chunk), _cut(v, chunk)), t < T, lens


def _summaries(w: Tensor, k: Tensor, v: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Step (i) of the chunked forward: each chunk ``[B, n, L, C]`` walked
    from the zero state, all chunks at once: its summary (a, b, p), each
    ``[B, n, C]``, with a e^p = sum_i e^{(len-1-i) w + k_i} v_i and b the
    same without v. The walk runs in the frame of the chunk's first k
    (:func:`_frame`)."""
    B, n, L, C = k.shape
    R = k[:, :, 0]
    a = k.new_zeros(B, n, C)
    b = torch.zeros_like(a)
    p = torch.full_like(a, PP_INIT)
    for i in range(L):
        kt, vt, m = k[:, :, i] - R, v[:, :, i], mask[:, i, None]
        ww = w + p
        pn = torch.maximum(ww, kt)
        e1, e2 = torch.exp(ww - pn), torch.exp(kt - pn)
        a, b, p = (torch.where(m, e1 * a + e2 * vt, a), torch.where(m, e1 * b + e2, b),
                   torch.where(m, pn, p))
    return a, b, p + R


def _frame(pp: Tensor, k0: Tensor) -> Tensor:
    """The reference R of a chunk's walk: max(entering pp, the chunk's first
    k). The step is invariant under pp -> pp - R, k -> k - R; walked so, pp
    stays near 0, where adding w rounds on a fine grid. Walked at pp ~ 80,
    every w + pp rounds on a 7.6e-6 grid, by the same fraction of it at every
    step of a channel, and the stored aa, bb drift with it."""
    return torch.maximum(pp, k0)


def _combine(x, y):
    """Step (ii)'s associative map: the summary (a, b, p, d) of chunk x then
    chunk y (d = a chunk's length times w); a state is a summary whose d is
    not read. Computed from dlt = (x.p - y.p) + y.d, x's decayed p against
    y's, a difference of two nearby values and a small one, so that the
    weights do not round on a large p's grid: p' = x.p + y.d where x wins
    (dlt > 0), else y.p; the weights e^{min(dlt, 0)} and e^{-max(dlt, 0)}
    (every exponent <= 0; -1e30 absorbs d)."""
    xa, xb, xp, xd = x
    ya, yb, yp, yd = y
    dlt = (xp - yp) + yd
    e1, e2 = torch.exp(torch.clamp(dlt, max=0)), torch.exp(-torch.clamp(dlt, min=0))
    return e1 * xa + e2 * ya, e1 * xb + e2 * yb, torch.where(dlt > 0, xp + yd, yp), xd + yd


def _entry_states(w: Tensor, k: Tensor, v: Tensor, state: Tensor, chunk: int):
    """Steps (i) and (ii): the state entering each chunk ``[B, n, 3, C]``, a
    scan of the summaries along the chunks from ``state`` as the kernels run
    it, a tree (Hillis-Steele: log2(n) levels, each combining every element
    with the one ``off`` before it) over [state, summary 0, ..., summary
    n - 2]; with the chunked k, v and the mask of real steps."""
    (kc, vc), mask, lens = _chunks(k, v, chunk)
    a, b, p = _summaries(w, kc, vc, mask)
    d = lens[:, None] * w
    aa, bb, pp = state.unbind(-1)
    x = [torch.cat([s[:, None], t[:, :-1]], 1) for s, t in zip((aa, bb, pp, torch.zeros_like(pp)),
                                                                (a, b, p, d.expand_as(p)))]
    off = 1
    while off < x[0].shape[1]:
        head = [t[:, off:] for t in x]
        y = _combine([t[:, :-off] for t in x], head)
        x = [torch.cat([t[:, :off], u], 1) for t, u in zip(x, y)]
        off *= 2
    return torch.stack(x[:3], 2), kc, vc, mask


def wkv4_chunked_plain(w: Tensor, u: Tensor, k: Tensor, v: Tensor, initial_state: Optional[Tensor],
                       chunk: int) -> Tuple[Tensor, Tensor]:
    """The sequence form by kernel K17's algorithm, a chunked scan over T
    in chunks of ``chunk`` steps (the last may be shorter): (i) each chunk's
    summary from the zero state, (ii) a scan of the summaries along the
    chunks from the initial state, giving the state entering each chunk,
    (iii) each chunk replayed from its entering state with the step of
    :func:`wkv4_step`, writing y; the last chunk's replay gives the final
    state. In exact arithmetic it equals :func:`wkv4_plain`. Same arguments
    and results; fp32, or float64 for float64 k."""
    B, T, C = k.shape
    f = _float(k)
    wf, uf, kf, vf = (x.to(f) for x in (w, u, k, v))
    state = (wkv4_init_state(B, C, k.device) if initial_state is None else initial_state).to(f)
    if T == 0:
        return kf.new_zeros(B, 0, C), state
    ent, kc, vc, mask = _entry_states(wf, kf, vf, state, chunk)
    aa, bb, pp = ent.unbind(2)
    R = _frame(pp, kc[:, :, 0])
    pp = pp - R
    ys = []
    for i in range(chunk):
        kt, vt, m = kc[:, :, i] - R, vc[:, :, i], mask[:, i, None]
        ww = uf + kt
        p = torch.maximum(pp, ww)
        e1, e2 = torch.exp(pp - p), torch.exp(ww - p)
        ys.append((e1 * aa + e2 * vt) / (e1 * bb + e2))
        ww = wf + pp
        p = torch.maximum(ww, kt)
        e1, e2 = torch.exp(ww - p), torch.exp(kt - p)
        aa, bb, pp = (torch.where(m, e1 * aa + e2 * vt, aa), torch.where(m, e1 * bb + e2, bb),
                      torch.where(m, p, pp))
    y = torch.stack(ys, 2).reshape(B, -1, C)[:, :T]
    return y, torch.stack([aa[:, -1], bb[:, -1], pp[:, -1] + R[:, -1]], -1)


def _bwd_step(aa, bb, pp, kt, vt, gy, wf, uf):
    """The forward values of one step that its VJP reads: (e1, e2, y's
    denominator, y, f1, f2, the decayed pp ww2, the bonus ww)."""
    ww = uf + kt
    p = torch.maximum(pp, ww)
    e1, e2 = torch.exp(pp - p), torch.exp(ww - p)
    num, den = e1 * aa + e2 * vt, e1 * bb + e2
    ww2 = wf + pp
    p2 = torch.maximum(ww2, kt)
    return e1, e2, den, num / den, torch.exp(ww2 - p2), torch.exp(kt - p2), ww2, ww


def _share(a: Tensor, b: Tensor) -> Tensor:
    """The share of max(a, b)'s cotangent that goes to a: 1 where a > b, 0
    where a < b, 1/2 on a tie (``torch.maximum``'s backward)."""
    return torch.where(a > b, 1.0, torch.where(a < b, 0.0, 0.5)).to(a.dtype)


def wkv4_chunked_bwd_plain(w: Tensor, u: Tensor, k: Tensor, v: Tensor, initial_state: Optional[Tensor],
                           dy: Tensor, ds: Optional[Tensor], chunk: int
                           ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Optional[Tensor]]:
    """The VJP of :func:`wkv4_plain` by kernel K18's algorithm, the reverse
    chunk scan. A step's reverse map is affine in the cotangent g = (gaa,
    gbb, gpp) of the state it leaves: g_before = M g_after + c, with M =
    [[f1, 0, 0], [0, f1, 0], [m_a, m_b, m_p]] (m_p the share of max(w + pp,
    k) that goes to w + pp: 0, 1/2 or 1) and c from dy and the forward
    values only. (i) The state entering each chunk (:func:`wkv4_chunked_plain`'s
    steps (i) and (ii)); (ii) each chunk's map (M, c), composed over its
    steps walking forward from its entering state; (iii) a scan of the maps
    from the last chunk (its exit cotangent ``ds`` or zero) back to the
    first, giving each chunk's exit cotangent; (iv) each chunk's reverse
    walk of :func:`wkv4_bwd_plain` from its exit cotangent, writing dk and
    dv and its sums of dw and du; the first chunk's gives the initial
    state's cotangent. In exact arithmetic it equals
    :func:`wkv4_bwd_plain`. Same arguments and results, and ``chunk``."""
    B, T, C = k.shape
    f = _float(k)
    wf, uf, kf, vf, gyf = (x.to(f) for x in (w, u, k, v, dy))
    state = (wkv4_init_state(B, C, k.device) if initial_state is None else initial_state).to(f)
    g = torch.zeros(B, C, 3, dtype=f, device=k.device) if ds is None else ds.to(f)
    if T == 0:
        zero = wf.new_zeros(C)
        return zero, zero, kf.new_zeros(B, 0, C), vf.new_zeros(B, 0, C), None if initial_state is None else g
    ent, kc, vc, mask = _entry_states(wf, kf, vf, state, chunk)
    gc = _cut(gyf, chunk)
    n = kc.shape[1]
    # (ii) each chunk's map, and the states entering its steps
    aa, bb, pp = ent.unbind(2)
    R = _frame(pp, kc[:, :, 0])
    pp = pp - R
    kc = kc - R[:, :, None]
    one, zero = torch.ones_like(aa), torch.zeros_like(aa)
    F, A, Bm, P, ca, cb, cp = one, zero, zero, one, zero, zero, zero
    states = []
    for i in range(chunk):
        kt, vt, gy, m = kc[:, :, i], vc[:, :, i], gc[:, :, i], mask[:, i, None]
        states.append((aa, bb, pp))
        e1, e2, den, y, f1, f2, ww2, ww = _bwd_step(aa, bb, pp, kt, vt, gy, wf, uf)
        gnum, gden = gy / den, -gy * y / den
        b1, b2 = (gnum * aa + gden * bb) * e1, (gnum * vt + gden) * e2
        alpha = _share(ww2, kt)
        sca, scb, scp = gnum * e1, gden * e1, b1 - _share(pp, ww) * (b1 + b2)
        ma, mb = (1 - alpha) * f1 * aa - alpha * f2 * vt, (1 - alpha) * f1 * bb - alpha * f2
        # c += P c_t, then P = P M_t (padded steps: the identity)
        upd = lambda new, old: torch.where(m, new, old)
        ca, cb, cp = upd(ca + F * sca, ca), upd(cb + F * scb, cb), upd(cp + A * sca + Bm * scb + P * scp, cp)
        A, Bm, P, F = upd(A * f1 + P * ma, A), upd(Bm * f1 + P * mb, Bm), upd(P * alpha, P), upd(F * f1, F)
        aa, bb, pp = upd(f1 * aa + f2 * vt, aa), upd(f1 * bb + f2, bb), upd(torch.maximum(ww2, kt), pp)
    # (iii) the cotangent leaving each chunk, from the last chunk back
    exits = [None] * n
    gaa, gbb, gpp = g.unbind(-1)
    for j in range(n - 1, -1, -1):
        exits[j] = (gaa, gbb, gpp)
        gaa, gbb, gpp = (F[:, j] * gaa + ca[:, j], F[:, j] * gbb + cb[:, j],
                         A[:, j] * gaa + Bm[:, j] * gbb + P[:, j] * gpp + cp[:, j])
    # (iv) the reverse walk of every chunk from its exit cotangent
    gaa, gbb, gpp = (torch.stack(x, 1) for x in zip(*exits))
    gw = torch.zeros_like(gaa)
    gu = torch.zeros_like(gaa)
    dk, dv = torch.zeros_like(kc), torch.zeros_like(vc)
    for i in range(chunk - 1, -1, -1):
        aa, bb, pp = states[i]
        kt, vt, gy, m = kc[:, :, i], vc[:, :, i], gc[:, :, i], mask[:, i, None]
        e1, e2, den, y, f1, f2, ww2, ww = _bwd_step(aa, bb, pp, kt, vt, gy, wf, uf)
        gf1, gf2 = gaa * aa + gbb * bb, gaa * vt + gbb
        naa, nbb, gvt = gaa * f1, gbb * f1, gaa * f2
        a1, a2 = gf1 * f1, gf2 * f2
        to_ww2, to_k = _split_max(gpp - a1 - a2, ww2, kt)
        gww2, gkt = a1 + to_ww2, a2 + to_k
        gnum, gden = gy / den, -gy * y / den
        ge1, ge2 = gnum * aa + gden * bb, gnum * vt + gden
        naa, nbb, gvt = naa + gnum * e1, nbb + gden * e1, gvt + gnum * e2
        b1, b2 = ge1 * e1, ge2 * e2
        to_pp, to_ww = _split_max(-b1 - b2, pp, ww)
        npp = gww2 + b1 + to_pp
        gww = b2 + to_ww
        gw = torch.where(m, gw + gww2, gw)
        gu = torch.where(m, gu + gww, gu)
        dk[:, :, i], dv[:, :, i] = torch.where(m, gkt + gww, 0.0), torch.where(m, gvt, 0.0)
        gaa, gbb, gpp = torch.where(m, naa, gaa), torch.where(m, nbb, gbb), torch.where(m, npp, gpp)
    ds0 = None if initial_state is None else torch.stack([gaa[:, 0], gbb[:, 0], gpp[:, 0]], -1)
    dk, dv = (x.reshape(B, -1, C)[:, :T] for x in (dk, dv))
    return gw.sum((0, 1)), gu.sum((0, 1)), dk, dv, ds0


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
