"""Wrappers of the WKV7 CUDA kernels (``csrc/wkv7.cu``): K1 ``wkv7_fwd``
and K2 ``wkv7_step``. They take CUDA tensors only; the dispatchers in
:mod:`visualrwkv_torch.ops.wkv7` send CPU tensors to the plain versions.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream, raises on a
CUDA error, and adds one to its entry of ``cuda_build.LAUNCHES``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from visualrwkv_torch import cuda_build

Tensor = torch.Tensor

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("wkv7")
    if lib.wkv7_fwd.argtypes is None:
        lib.wkv7_fwd.argtypes = [_I, _I, _I, _I, _I] + [_P] * 10
        lib.wkv7_fwd.restype = _I
        lib.wkv7_step.argtypes = [_I, _I, _I, _I] + [_P] * 10
        lib.wkv7_step.restype = _I
    return lib


def _check_cuda(name: str, xs, device) -> None:
    for x in xs:
        if not x.is_cuda or x.device != device:
            raise ValueError(f"{name}: takes CUDA tensors on one device; got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def wkv7_fwd(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
             initial_state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """K1: streams ``[B, T, H, 64]`` (all fp32 or all bf16), optional fp32
    initial state ``[B, H, 64, 64]``. Returns (y in the stream dtype, final
    fp32 state)."""
    B, T, H, N = r.shape
    dev = r.device
    streams = (r, w_raw, k, v, a, b)
    _check_cuda("wkv7_fwd", streams, dev)
    if r.dtype not in _DTYPE_CODE or any(x.dtype != r.dtype for x in streams):
        raise ValueError(f"wkv7_fwd: streams must all be fp32 or all bf16; got {[x.dtype for x in streams]}")
    if N != 64:
        raise ValueError(f"wkv7_fwd: head size must be 64; got {N}")
    if initial_state is not None:
        _check_cuda("wkv7_fwd", (initial_state,), dev)
        if initial_state.dtype != torch.float32 or initial_state.shape != (B, H, N, N):
            raise ValueError(
                f"wkv7_fwd: initial_state must be fp32 {(B, H, N, N)}; got "
                f"{initial_state.dtype} {tuple(initial_state.shape)}"
            )
    y = torch.empty_like(r)
    s_out = torch.empty(B, H, N, N, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.wkv7_fwd(
            _DTYPE_CODE[r.dtype], B, T, H, N, *(x.data_ptr() for x in streams),
            None if initial_state is None else initial_state.data_ptr(),
            y.data_ptr(), s_out.data_ptr(), _stream(dev),
        )
    cuda_build.check(lib, err, "wkv7_fwd")
    cuda_build.LAUNCHES["wkv7_fwd"] += 1
    return y, s_out


def wkv7_step(state: Tensor, r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor,
              a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """K2: state ``[B, H, 64, 64]`` fp32 or bf16, vectors ``[B, H, 64]`` fp32
    (the decode step's dtype). Returns (new state in the state's dtype, fp32
    y)."""
    B, H, Nv, Nk = state.shape
    dev = state.device
    vecs = (r, w_raw, k, v, a, b)
    _check_cuda("wkv7_step", (state,) + vecs, dev)
    if Nv != 64 or Nk != 64:
        raise ValueError(f"wkv7_step: head size must be 64; got {tuple(state.shape)}")
    if state.dtype not in _DTYPE_CODE:
        raise ValueError(f"wkv7_step: state must be fp32 or bf16; got {state.dtype}")
    if any(x.dtype != torch.float32 for x in vecs):
        raise ValueError(f"wkv7_step: vectors must be fp32; got {[x.dtype for x in vecs]}")
    if any(x.shape != (B, H, Nk) for x in vecs):
        raise ValueError(f"wkv7_step: vectors must be {(B, H, Nk)}; got {[tuple(x.shape) for x in vecs]}")
    s_out = torch.empty_like(state)
    y = torch.empty_like(r)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.wkv7_step(
            _DTYPE_CODE[state.dtype], B, H, Nk, state.data_ptr(),
            *(x.data_ptr() for x in vecs), s_out.data_ptr(), y.data_ptr(), _stream(dev),
        )
    cuda_build.check(lib, err, "wkv7_step")
    cuda_build.LAUNCHES["wkv7_step"] += 1
    return s_out, y
