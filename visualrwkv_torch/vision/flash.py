"""Attention of the vision towers: kernel K3 (``csrc/attention.cu``, the
forward) and kernels K14 / K15 (``csrc/attention_bwd.cu``, the backward),
with their plain PyTorch versions.

- :func:`mha` — bidirectional no-bias MHA, ``[B, N, h, hd]``, scale
  ``1/sqrt(hd)``, fp32 softmax (DINOv2 / SigLIP at N >= 256). Counterpart
  of ``visualrwkv_tpu/vision/flash.py::flash_mha`` (the stock TPU flash
  kernel, forward and backward).
- :func:`sam_attention` — SAM global attention, ``[G, N, hd]`` with the
  decomposed rel-pos bias ``rel_h[q, key // Wk] + rel_w[q, key % Wk]``.
  Counterpart of ``sam_flash_attention`` (``_sam_flash_fwd_impl`` and the
  two-pass backward ``_sam_flash_bwd_impl``).

Both dispatch on the device: CPU tensors take the plain versions
(:func:`mha_reference`, :func:`sam_attend_reference`; under autograd
:func:`attention_fwd_plain` and :func:`attention_bwd_plain`); CUDA tensors
launch the kernels (bf16; head dim 64 for SAM-B and DINOv2-L, 72 for
SigLIP-so400m) or raise. When an input requires a gradient, both go through
:class:`AttentionFunction`: K3 also writes the log-sum-exp of every query
row, and the backward is K14 (dq and the rel-pos tables' gradients) then
K15 (dk, dv).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from visualrwkv_torch import cuda_build

Tensor = torch.Tensor
_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL_HEAD_DIMS = (64, 72)  # the head dims csrc/attention.cu is compiled for


def mha_reference(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """softmax(Q K^T / sqrt(hd)) V with fp32 logits and softmax; [B, N, h, hd]."""
    hd = q.shape[-1]
    qt, kt, vt = (x.transpose(1, 2).float() for x in (q, k, v))  # [B, h, N, hd]
    logits = (qt @ kt.transpose(-1, -2)) * hd**-0.5
    probs = torch.softmax(logits, dim=-1).to(q.dtype).float()
    return (probs @ vt).transpose(1, 2).to(q.dtype)


def sam_attend_reference(q: Tensor, k: Tensor, v: Tensor, rel_h: Tensor, rel_w: Tensor,
                         scale: float, block: int = 1024) -> Tensor:
    """Exact attention with the decomposed bias, over query blocks of
    ``block`` rows (bounds the [G, block, N] logits). q/k/v [G, N, hd];
    rel_h [G, N, Hk]; rel_w [G, N, Wk]."""
    return _attend_blocks(q, k, v, rel_h, rel_w, scale, True, block, with_lse=False)[0]


def _attend_blocks(q: Tensor, k: Tensor, v: Tensor, rel_h: Optional[Tensor],
                   rel_w: Optional[Tensor], scale: float, prescale: bool,
                   block: int = 1024, with_lse: bool = True) -> Tuple[Tensor, Optional[Tensor]]:
    """(out, lse) of attention on ``[G, N, hd]`` over query blocks, fp32
    softmax; ``lse`` [G, N] fp32 (None unless ``with_lse``) is the
    log-sum-exp of each query row's logits. ``prescale``: q is scaled and
    rounded to its dtype before the product (SAM, as the JAX package
    does); else the fp32 product is scaled (the MHA of
    :func:`mha_reference`)."""
    G, N, hd = q.shape
    dt = q.dtype
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    lse = torch.empty(G, N, dtype=torch.float32, device=q.device) if with_lse else None
    for s in range(0, N, block):
        e = min(N, s + block)
        logits = _block_logits(q[:, s:e], kf, rel_h, rel_w, s, e, scale, prescale)
        if with_lse:
            lse[:, s:e] = torch.logsumexp(logits, dim=-1)
        attn = torch.softmax(logits, dim=-1).to(dt).float()
        out[:, s:e] = (attn @ vf).to(dt)
    return out, lse


def _block_logits(q_blk: Tensor, kf: Tensor, rel_h: Optional[Tensor], rel_w: Optional[Tensor],
                  s: int, e: int, scale: float, prescale: bool) -> Tensor:
    """fp32 logits [G, e - s, N] of the query rows s..e, bias included."""
    if prescale:
        logits = (q_blk.float() * scale).to(q_blk.dtype).float() @ kf.transpose(-1, -2)
    else:
        logits = (q_blk.float() @ kf.transpose(-1, -2)) * scale
    if rel_h is not None:
        G, N = kf.shape[0], kf.shape[1]
        bias = rel_h[:, s:e, :, None].float() + rel_w[:, s:e, None, :].float()
        logits = logits + bias.reshape(G, e - s, N)
    return logits


def _to_groups(x: Tensor) -> Tensor:
    """MHA layout ``[B, N, h, d]`` -> ``[B*h, N, d]`` (group g = b*h + head)."""
    B, N, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * h, N, d)


def _from_groups(x: Tensor, B: int, h: int) -> Tensor:
    G, N, d = x.shape
    return x.reshape(B, h, N, d).permute(0, 2, 1, 3).contiguous()


def attention_fwd_plain(q: Tensor, k: Tensor, v: Tensor, rel_h: Optional[Tensor],
                        rel_w: Optional[Tensor], scale: float, layout: str,
                        block: int = 1024) -> Tuple[Tensor, Tensor]:
    """The plain version of K3 with its log-sum-exp output: (o, lse).
    ``layout="sam"``: q/k/v/o ``[G, N, hd]`` with the bias tables;
    ``layout="mha"``: ``[B, N, h, hd]``, no bias, lse ``[B*h, N]``."""
    if layout == "sam":
        return _attend_blocks(q, k, v, rel_h, rel_w, scale, True, block)
    B, _, h, _ = q.shape
    o, lse = _attend_blocks(_to_groups(q), _to_groups(k), _to_groups(v), None, None, scale,
                            False, block)
    return _from_groups(o, B, h), lse


def attention_bwd_plain(q: Tensor, k: Tensor, v: Tensor, rel_h: Optional[Tensor],
                        rel_w: Optional[Tensor], o: Tensor, lse: Tensor, do: Tensor,
                        scale: float, layout: str, block: int = 1024):
    """The plain version of K14 + K15, the FlashAttention-2 backward of the
    JAX package's ``_sam_flash_bwd_impl``, from the saved output and
    log-sum-exp: (dq, dk, dv, d rel_h, d rel_w), the tables' gradients None
    without a bias. Per query block, in fp32: p recomputed from ``lse``,
    ``dP = dO V^T``, ``dS = p (dP - delta)`` with ``delta = rowsum(dO O)``;
    dS is rounded to the input dtype before the products (as the reference
    kernels do), ``dq = dS K scale``, ``dk = dS^T q scale`` (the unscaled
    q), ``dv = p^T dO`` (p rounded to the input dtype), and the tables'
    gradients are the sums of dS over each grid row (d rel_h) and each grid
    column (d rel_w) of the keys. Layouts as :func:`attention_fwd_plain`."""
    if layout == "sam":
        return _bwd_blocks(q, k, v, rel_h, rel_w, o, lse, do, scale, True, block)
    B, _, h, _ = q.shape
    dq, dk, dv, _, _ = _bwd_blocks(*(_to_groups(x) for x in (q, k, v)), None, None, _to_groups(o),
                                   lse, _to_groups(do), scale, False, block)
    return _from_groups(dq, B, h), _from_groups(dk, B, h), _from_groups(dv, B, h), None, None


def _bwd_blocks(q: Tensor, k: Tensor, v: Tensor, rel_h: Optional[Tensor],
                rel_w: Optional[Tensor], o: Tensor, lse: Tensor, do: Tensor, scale: float,
                prescale: bool, block: int):
    """:func:`attention_bwd_plain` on ``[G, N, hd]`` over query blocks;
    ``prescale`` as in :func:`_attend_blocks`."""
    G, N, hd = q.shape
    dt = q.dtype
    kf, vf, qf = k.float(), v.float(), q.float()
    delta = (do.float() * o.float()).sum(-1)  # [G, N]
    dq = torch.empty(G, N, hd, dtype=torch.float32, device=q.device)
    dk = torch.zeros(G, N, hd, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    drh = drw = None
    if rel_h is not None:
        Hk, Wk = rel_h.shape[-1], rel_w.shape[-1]
        drh = torch.empty(G, N, Hk, dtype=torch.float32, device=q.device)
        drw = torch.empty(G, N, Wk, dtype=torch.float32, device=q.device)
    for s in range(0, N, block):
        e = min(N, s + block)
        logits = _block_logits(q[:, s:e], kf, rel_h, rel_w, s, e, scale, prescale)
        p = torch.exp(logits - lse[:, s:e, None].float())
        do_blk = do[:, s:e].float()
        dp = do_blk @ vf.transpose(-1, -2)
        ds = (p * (dp - delta[:, s:e, None])).to(dt).float()
        dq[:, s:e] = (ds @ kf) * scale
        dv += p.to(dt).float().transpose(-1, -2) @ do_blk
        dk += (ds.transpose(-1, -2) @ qf[:, s:e]) * scale
        if drh is not None:
            grid = ds.reshape(G, e - s, Hk, Wk)
            drh[:, s:e] = grid.sum(-1)
            drw[:, s:e] = grid.sum(-2)
    grads = (dq.to(dt), dk.to(dt), dv.to(dt))
    if drh is None:
        return (*grads, None, None)
    return (*grads, drh.to(rel_h.dtype), drw.to(rel_w.dtype))


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("attention")
    if lib.attention_fwd.argtypes is None:
        lib.attention_fwd.argtypes = [_I, _I, _I, _I, ctypes.c_float] + [_P] * 5 + [_I, _I] + [_P] * 3
        lib.attention_fwd_plan.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
        lib.attention_fwd.restype = lib.attention_fwd_plan.restype = _I
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load("attention_bwd")
    if lib.attention_bwd_dq.argtypes is None:
        head = [_I, _I, _I, _I, ctypes.c_float] + [_P] * 5 + [_I, _I]
        lib.attention_bwd_dq.argtypes = head + [_P] * 8
        lib.attention_bwd_dkv.argtypes = head + [_P] * 6
        lib.attention_bwd_plan.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
        lib.attention_bwd_dq.restype = lib.attention_bwd_dkv.restype = _I
        lib.attention_bwd_plan.restype = _I
    return lib


PATHS = ("mha", "rows", "general")  # K3's and K14's modes, in the kernels' numbering
FWD_ROWS_MAX_HK = 256  # K3's "rows" path stages rel_h of a block's query rows in shared memory
BWD_BLOCK_ROWS = 128  # query rows of a K14 block, keys of a K15 block
BWD_TABLES = ("none", "tma", "loads")  # how K15 stages the tables, likewise


def fwd_plan(hd: int, Hk: int = 0, Wk: int = 0) -> dict:
    """How K3 (``csrc/attention.cu``, ``make_plan``) tiles a call; ``Hk =
    Wk = 0`` without a bias. ``path``: "mha" (no bias, 64-key tiles),
    "rows" (head dim 64 and a grid at most 64 wide and ``FWD_ROWS_MAX_HK``
    tall: a key tile is one grid row, ``Wk`` keys padded to ``key_tile``, a
    multiple of 16; rel_w stays in registers, rel_h is staged in shared
    memory) or "general" (64-key tiles, the bias read from the tables);
    ``block_rows``: the query rows of a block, 64 a consumer warpgroup: 64
    for head dim 64 without a bias (three blocks a multiprocessor), else
    128 (one)."""
    if not Hk:
        return {"path": "mha", "key_tile": 64, "block_rows": 64 if hd == 64 else 128}
    rows = hd == 64 and Wk <= 64 and Hk <= FWD_ROWS_MAX_HK
    return {"path": "rows" if rows else "general", "key_tile": -(-Wk // 16) * 16 if rows else 64,
            "block_rows": 128}


def fwd_plan_kernel(hd: int, Hk: int = 0, Wk: int = 0) -> dict:
    """K3's plan as the compiled library reports it (``attention_fwd_plan``):
    the keys of :func:`fwd_plan` and the dynamic shared memory (``smem``,
    bytes)."""
    out = (_I * 4)()
    _lib().attention_fwd_plan(hd, int(Hk > 0), Hk, Wk, out)
    return {"path": PATHS[out[0]], "key_tile": out[1], "block_rows": out[2], "smem": out[3]}


def bwd_plan(hd: int, Hk: int = 0, Wk: int = 0) -> dict:
    """How K14 / K15 (``csrc/attention_bwd.cu``, ``make_plan``) tile a call;
    ``Hk = Wk = 0`` without a bias. ``dq_path``: "mha" (no bias, 64-key
    tiles), "rows" (a key tile is one grid row, ``Wk`` keys padded to
    ``dq_key_tile``, a multiple of 16; head dim 64 and ``Wk <= 64``) or
    "general" (64-key tiles, the tables' gradients summed in shared
    memory). ``dkv_hspan``: the rel_h columns a K15 block of 128 keys
    stages per query (the grid rows its keys can span; by TMA, from a
    column rounded down to a multiple of 4, a box of at least ``hspan + 3``
    columns, 4 mod 8); ``dkv_tables``:
    "tma" (``Hk`` and ``Wk`` multiples of 4) or "loads" (the producer
    threads copy them); ``dkv_table_bytes``: what a K15 block reads of both
    tables per 64-query tile."""
    if not Hk:
        return {"dq_path": "mha", "dq_key_tile": 64, "dkv_hspan": 0, "dkv_tables": "none",
                "dkv_table_bytes": 0}
    hspan = min(Hk, (BWD_BLOCK_ROWS - 1) // Wk + 2)
    rows = hd == 64 and Wk <= 64
    tma = Hk % 4 == 0 and Wk % 4 == 0
    return {"dq_path": "rows" if rows else "general",
            "dq_key_tile": -(-Wk // 16) * 16 if rows else 64, "dkv_hspan": hspan,
            "dkv_tables": "tma" if tma else "loads",
            "dkv_table_bytes": 64 * (((hspan + 6) // 8 * 8 + 4 if tma else hspan) + Wk) * 4}


def bwd_plan_kernel(hd: int, Hk: int = 0, Wk: int = 0) -> dict:
    """The plan as the compiled library reports it (``attention_bwd_plan``):
    the keys of :func:`bwd_plan` but ``dkv_table_bytes``, and each kernel's
    dynamic shared memory (``dq_smem``, ``dkv_smem``, bytes)."""
    out = (_I * 6)()
    _bwd_lib().attention_bwd_plan(hd, int(Hk > 0), Hk, Wk, out)
    return {"dq_path": PATHS[out[0]], "dq_key_tile": out[1], "dkv_hspan": out[2],
            "dkv_tables": BWD_TABLES[out[3]], "dq_smem": out[4], "dkv_smem": out[5]}


def _check_inputs(what: str, q: Tensor, k: Tensor, v: Tensor, G: int, N: int,
                  rel_h: Optional[Tensor], rel_w: Optional[Tensor], more=()) -> Tuple[int, int]:
    """Device, dtype and shape checks of the kernels' inputs; (Hk, Wk)."""
    dev = q.device
    ts = [q, k, v, *more] + ([rel_h, rel_w] if rel_h is not None else [])
    for x in ts:
        if not x.is_cuda or x.device != dev or not x.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous and on one CUDA device")
    if any(x.dtype != torch.bfloat16 for x in (q, k, v)):
        raise ValueError(f"{what}: q, k, v must be bf16; got {[x.dtype for x in (q, k, v)]}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: head dim must be one of {KERNEL_HEAD_DIMS}; got {q.shape[-1]}")
    if rel_h is None:
        return 0, 0
    Hk, Wk = rel_h.shape[-1], rel_w.shape[-1]
    if rel_h.dtype != torch.float32 or rel_w.dtype != torch.float32:
        raise ValueError(f"{what}: rel_h / rel_w must be fp32")
    if rel_h.shape != (G, N, Hk) or rel_w.shape != (G, N, Wk) or Hk * Wk != N:
        raise ValueError(
            f"{what}: rel tables {tuple(rel_h.shape)} {tuple(rel_w.shape)} do not tile N={N}"
        )
    return Hk, Wk


def _geometry(q: Tensor, layout: str) -> Tuple[int, int, int]:
    """(G, N, heads) of the kernels' grid for a layout."""
    if layout == "sam":
        return q.shape[0], q.shape[1], 1
    B, N, h, _ = q.shape
    return B * h, N, h


def _counter(kernel: str, layout: str) -> str:
    return f"{kernel}_{'relpos' if layout == 'sam' else 'mha'}"


def _attention_cuda(q: Tensor, k: Tensor, v: Tensor, rel_h: Optional[Tensor],
                    rel_w: Optional[Tensor], scale: float, layout: str,
                    with_lse: bool = False):
    """K3: o, or (o, lse [G, N] fp32) with ``with_lse``."""
    dev = q.device
    G, N, heads = _geometry(q, layout)
    Hk, Wk = _check_inputs("attention_fwd", q, k, v, G, N, rel_h, rel_w)
    o = torch.empty_like(q)
    lse = torch.empty(G, N, dtype=torch.float32, device=dev) if with_lse else None
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.attention_fwd(
            G, N, heads, q.shape[-1], float(scale), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if rel_h is None else rel_h.data_ptr(),
            None if rel_w is None else rel_w.data_ptr(), Hk, Wk, o.data_ptr(),
            None if lse is None else lse.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    cuda_build.check(lib, err, "attention_fwd")
    cuda_build.LAUNCHES[_counter("attention_fwd", layout)] += 1
    return (o, lse) if with_lse else o


def attention_bwd_dq_cuda(q: Tensor, k: Tensor, v: Tensor, rel_h: Optional[Tensor],
                          rel_w: Optional[Tensor], o: Tensor, lse: Tensor, do: Tensor,
                          scale: float, layout: str):
    """K14: (dq, d rel_h, d rel_w, delta), delta = rowsum(dO O) fp32 [G, N]
    for K15; the tables' gradients None without a bias."""
    dev = q.device
    G, N, heads = _geometry(q, layout)
    Hk, Wk = _check_inputs("attention_bwd_dq", q, k, v, G, N, rel_h, rel_w, (o, lse, do))
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"attention_bwd_dq: o and do must be bf16 {tuple(q.shape)}; got "
                         f"{o.dtype} {tuple(o.shape)}, {do.dtype} {tuple(do.shape)}")
    if lse.dtype != torch.float32 or lse.shape != (G, N):
        raise ValueError(f"attention_bwd_dq: lse must be fp32 {(G, N)}; got {lse.dtype} {tuple(lse.shape)}")
    dq = torch.empty_like(q)
    delta = torch.empty(G, N, dtype=torch.float32, device=dev)
    drh = drw = None
    if rel_h is not None:
        drh, drw = torch.empty_like(rel_h), torch.empty_like(rel_w)
    ptr = lambda x: None if x is None else x.data_ptr()
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        err = lib.attention_bwd_dq(
            G, N, heads, q.shape[-1], float(scale), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ptr(rel_h), ptr(rel_w), Hk, Wk, o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), ptr(drh), ptr(drw),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, err, "attention_bwd_dq")
    cuda_build.LAUNCHES[_counter("attention_bwd_dq", layout)] += 1
    return dq, drh, drw, delta


def attention_bwd_dkv_cuda(q: Tensor, k: Tensor, v: Tensor, rel_h: Optional[Tensor],
                           rel_w: Optional[Tensor], do: Tensor, lse: Tensor, delta: Tensor,
                           scale: float, layout: str) -> Tuple[Tensor, Tensor]:
    """K15: (dk, dv), from K14's delta."""
    dev = q.device
    G, N, heads = _geometry(q, layout)
    Hk, Wk = _check_inputs("attention_bwd_dkv", q, k, v, G, N, rel_h, rel_w, (do, lse, delta))
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"attention_bwd_dkv: do must be bf16 {tuple(q.shape)}; got {do.dtype} {tuple(do.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.dtype != torch.float32 or x.shape != (G, N):
            raise ValueError(f"attention_bwd_dkv: {name} must be fp32 {(G, N)}; got {x.dtype} {tuple(x.shape)}")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ptr = lambda x: None if x is None else x.data_ptr()
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        err = lib.attention_bwd_dkv(
            G, N, heads, q.shape[-1], float(scale), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ptr(rel_h), ptr(rel_w), Hk, Wk, do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, err, "attention_bwd_dkv")
    cuda_build.LAUNCHES[_counter("attention_bwd_dkv", layout)] += 1
    return dk, dv


def _attention_bwd_cuda(q: Tensor, k: Tensor, v: Tensor, rel_h: Optional[Tensor],
                        rel_w: Optional[Tensor], o: Tensor, lse: Tensor, do: Tensor,
                        scale: float, layout: str):
    """K14 then K15 on the current stream: (dq, dk, dv, d rel_h, d rel_w)."""
    dq, drh, drw, delta = attention_bwd_dq_cuda(q, k, v, rel_h, rel_w, o, lse, do, scale, layout)
    dk, dv = attention_bwd_dkv_cuda(q, k, v, rel_h, rel_w, do, lse, delta, scale, layout)
    return dq, dk, dv, drh, drw


def attention_fwd(q: Tensor, k: Tensor, v: Tensor, rel_h: Optional[Tensor],
                  rel_w: Optional[Tensor], scale: float, layout: str) -> Tuple[Tensor, Tensor]:
    """(o, lse): K3 with its log-sum-exp output on CUDA, the plain version
    on the CPU. Layouts as :func:`attention_fwd_plain`."""
    if not q.is_cuda:
        return attention_fwd_plain(q, k, v, rel_h, rel_w, scale, layout)
    return _attention_cuda(q, k, v, rel_h, rel_w, scale, layout, with_lse=True)


def attention_bwd(q: Tensor, k: Tensor, v: Tensor, rel_h: Optional[Tensor],
                  rel_w: Optional[Tensor], o: Tensor, lse: Tensor, do: Tensor, scale: float,
                  layout: str):
    """(dq, dk, dv, d rel_h, d rel_w): K14 + K15 on CUDA, the plain version
    on the CPU."""
    fn = _attention_bwd_cuda if q.is_cuda else attention_bwd_plain
    return fn(q, k, v, rel_h, rel_w, o, lse, do, scale, layout)


class AttentionFunction(torch.autograd.Function):
    """Differentiable attention of the towers: forward K3 with lse, backward
    K14 + K15 (the plain versions on the CPU). Counterpart of the JAX
    package's ``sam_flash_attention`` custom VJP and of the stock kernel's
    backward behind ``flash_mha``."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, scale, layout):
        o, lse = attention_fwd(q, k, v, rel_h, rel_w, scale, layout)
        ctx.save_for_backward(q, k, v, rel_h, rel_w, o, lse)
        ctx.scale, ctx.layout = scale, layout
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, rel_h, rel_w, o, lse = ctx.saved_tensors
        grads = attention_bwd(q, k, v, rel_h, rel_w, o, lse, do.to(q.dtype).contiguous(),
                              ctx.scale, ctx.layout)
        return (*grads, None, None)


def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in xs)


def mha(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """No-bias MHA on ``[B, N, h, hd]``: plain on CPU, K3 on CUDA; through
    :class:`AttentionFunction` when an input requires a gradient."""
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"mha: q, k, v must share a [B, N, h, hd] shape; got {q.shape}, {k.shape}, {v.shape}")
    scale = q.shape[-1] ** -0.5
    if _wants_grad(q, k, v):
        return AttentionFunction.apply(q, k, v, None, None, scale, "mha")
    if not q.is_cuda:
        return mha_reference(q, k, v)
    return _attention_cuda(q, k, v, None, None, scale, "mha")


def sam_attention(q: Tensor, k: Tensor, v: Tensor, rel_h: Tensor, rel_w: Tensor,
                  scale: float) -> Tensor:
    """SAM global attention on ``[G, N, hd]`` with the decomposed rel-pos
    bias: plain on CPU, K3 on CUDA; through :class:`AttentionFunction` when
    an input requires a gradient."""
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 3:
        raise ValueError(f"sam_attention: q, k, v must share a [G, N, hd] shape; got {q.shape}")
    if _wants_grad(q, k, v, rel_h, rel_w):
        return AttentionFunction.apply(q, k, v, rel_h, rel_w, scale, "sam")
    if not q.is_cuda:
        return sam_attend_reference(q, k, v, rel_h, rel_w, scale)
    return _attention_cuda(q, k, v, rel_h, rel_w, scale, "sam")
