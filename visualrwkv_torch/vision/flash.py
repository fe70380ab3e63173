"""Attention of the vision towers: kernel K3 (``csrc/attention.cu``) and its
plain PyTorch versions.

- :func:`mha` — bidirectional no-bias MHA, ``[B, N, h, hd]``, scale
  ``1/sqrt(hd)``, fp32 softmax (DINOv2 / SigLIP at N >= 256). Counterpart
  of ``visualrwkv_tpu/vision/flash.py::flash_mha``.
- :func:`sam_attention` — SAM global attention, ``[G, N, hd]`` with the
  decomposed rel-pos bias ``rel_h[q, key // Wk] + rel_w[q, key % Wk]``.
  Counterpart of ``sam_flash_attention``.

Both dispatch on the device: CPU tensors take the plain version
(:func:`mha_reference`, :func:`sam_attend_reference`); CUDA tensors launch
K3 (bf16; head dim 64 for SAM-B and DINOv2-L, 72 for SigLIP-so400m) or
raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

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
    G, N, hd = q.shape
    dt = q.dtype
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    for s in range(0, N, block):
        e = min(N, s + block)
        qs = (q[:, s:e].float() * scale).to(dt).float()
        logits = qs @ kf.transpose(-1, -2)
        bias = (rel_h[:, s:e, :, None].float() + rel_w[:, s:e, None, :].float()).reshape(G, e - s, N)
        attn = torch.softmax(logits + bias, dim=-1).to(dt).float()
        out[:, s:e] = (attn @ vf).to(dt)
    return out


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("attention")
    if lib.attention_fwd.argtypes is None:
        lib.attention_fwd.argtypes = [_I, _I, _I, _I, ctypes.c_float] + [_P] * 5 + [_I, _I, _P, _P]
        lib.attention_fwd.restype = _I
    return lib


def _attention_cuda(q: Tensor, k: Tensor, v: Tensor, G: int, N: int, heads: int,
                    scale: float, rel_h: Optional[Tensor], rel_w: Optional[Tensor],
                    counter: str) -> Tensor:
    dev = q.device
    ts = [q, k, v] + ([rel_h, rel_w] if rel_h is not None else [])
    for x in ts:
        if not x.is_cuda or x.device != dev or not x.is_contiguous():
            raise ValueError("attention_fwd: tensors must be contiguous and on one CUDA device")
    if any(x.dtype != torch.bfloat16 for x in (q, k, v)):
        raise ValueError(f"attention_fwd: q, k, v must be bf16; got {[x.dtype for x in (q, k, v)]}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention_fwd: head dim must be one of {KERNEL_HEAD_DIMS}; got {q.shape[-1]}")
    Hk = Wk = 0
    if rel_h is not None:
        Hk, Wk = rel_h.shape[-1], rel_w.shape[-1]
        if rel_h.dtype != torch.float32 or rel_w.dtype != torch.float32:
            raise ValueError("attention_fwd: rel_h / rel_w must be fp32")
        if rel_h.shape != (G, N, Hk) or rel_w.shape != (G, N, Wk) or Hk * Wk != N:
            raise ValueError(
                f"attention_fwd: rel tables {tuple(rel_h.shape)} {tuple(rel_w.shape)} "
                f"do not tile N={N}"
            )
    o = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.attention_fwd(
            G, N, heads, q.shape[-1], float(scale), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if rel_h is None else rel_h.data_ptr(),
            None if rel_w is None else rel_w.data_ptr(),
            Hk, Wk, o.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    cuda_build.check(lib, err, "attention_fwd")
    cuda_build.LAUNCHES[counter] += 1
    return o


def mha(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """No-bias MHA on ``[B, N, h, hd]``: plain on CPU, K3 on CUDA."""
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"mha: q, k, v must share a [B, N, h, hd] shape; got {q.shape}, {k.shape}, {v.shape}")
    if not q.is_cuda:
        return mha_reference(q, k, v)
    B, N, h, hd = q.shape
    return _attention_cuda(q, k, v, B * h, N, h, hd**-0.5, None, None, "attention_fwd_mha")


def sam_attention(q: Tensor, k: Tensor, v: Tensor, rel_h: Tensor, rel_w: Tensor,
                  scale: float) -> Tensor:
    """SAM global attention on ``[G, N, hd]`` with the decomposed rel-pos
    bias: plain on CPU, K3 on CUDA."""
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 3:
        raise ValueError(f"sam_attention: q, k, v must share a [G, N, hd] shape; got {q.shape}")
    if not q.is_cuda:
        return sam_attend_reference(q, k, v, rel_h, rel_w, scale)
    G, N, _ = q.shape
    return _attention_cuda(q, k, v, G, N, 1, scale, rel_h, rel_w, "attention_fwd_relpos")
