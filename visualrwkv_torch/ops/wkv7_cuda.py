"""Wrappers of the WKV7 CUDA kernels: K1 ``wkv7_fwd``, K2 ``wkv7_step``,
K4 ``wkv7_step_flat`` and K5 ``wkv7_fwd_res`` (``csrc/wkv7.cu``) and K6
``wkv7_bwd`` (``csrc/wkv7_train.cu``). They take CUDA tensors only; the
dispatchers in :mod:`visualrwkv_torch.ops.wkv7` send CPU tensors to the
plain versions.

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
CHUNK = 16  # K5 saves, and K6 reads, the state entering every 16 steps


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("wkv7")
    if lib.wkv7_fwd.argtypes is None:
        lib.wkv7_fwd.argtypes = [_I, _I, _I, _I, _I] + [_P] * 10
        lib.wkv7_fwd.restype = _I
        lib.wkv7_fwd_res.argtypes = [_I, _I, _I, _I, _I] + [_P] * 11
        lib.wkv7_fwd_res.restype = _I
        for fn in (lib.wkv7_step, lib.wkv7_step_flat):
            fn.argtypes = [_I, _I, _I, _I] + [_P] * 10
            fn.restype = _I
    return lib


def _train_lib() -> ctypes.CDLL:
    lib = cuda_build.load("wkv7_train")
    if lib.wkv7_bwd.argtypes is None:
        lib.wkv7_bwd.argtypes = [_I, _I, _I, _I, _I] + [_P] * 17
        lib.wkv7_bwd.restype = _I
    return lib


def _check_cuda(name: str, xs, device) -> None:
    for x in xs:
        if not x.is_cuda or x.device != device:
            raise ValueError(f"{name}: takes CUDA tensors on one device; got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_streams(name: str, streams, states=()) -> None:
    """Streams ``[B, T, H, 64]`` of one dtype (fp32 or bf16) on one CUDA
    device; ``states`` (each may be None) fp32 ``[B, H, 64, 64]``."""
    r = streams[0]
    B, T, H, N = r.shape
    _check_cuda(name, streams, r.device)
    if r.dtype not in _DTYPE_CODE or any(x.dtype != r.dtype for x in streams):
        raise ValueError(f"{name}: streams must all be fp32 or all bf16; got {[x.dtype for x in streams]}")
    if any(x.shape != r.shape for x in streams):
        raise ValueError(f"{name}: streams must share a shape; got {[tuple(x.shape) for x in streams]}")
    if N != 64:
        raise ValueError(f"{name}: head size must be 64; got {N}")
    for s in states:
        if s is None:
            continue
        _check_cuda(name, (s,), r.device)
        if s.dtype != torch.float32 or s.shape != (B, H, N, N):
            raise ValueError(
                f"{name}: a state must be fp32 {(B, H, N, N)}; got {s.dtype} {tuple(s.shape)}"
            )


def _ptr(x: Optional[Tensor]):
    return None if x is None else x.data_ptr()


def wkv7_fwd(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
             initial_state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """K1: streams ``[B, T, H, 64]`` (all fp32 or all bf16), optional fp32
    initial state ``[B, H, 64, 64]``. Returns (y in the stream dtype, final
    fp32 state)."""
    B, T, H, N = r.shape
    dev = r.device
    streams = (r, w_raw, k, v, a, b)
    _check_streams("wkv7_fwd", streams, (initial_state,))
    y = torch.empty_like(r)
    s_out = torch.empty(B, H, N, N, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.wkv7_fwd(
            _DTYPE_CODE[r.dtype], B, T, H, N, *(x.data_ptr() for x in streams),
            _ptr(initial_state), y.data_ptr(), s_out.data_ptr(), _stream(dev),
        )
    cuda_build.check(lib, err, "wkv7_fwd")
    cuda_build.LAUNCHES["wkv7_fwd"] += 1
    return y, s_out


def wkv7_fwd_res(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
                 initial_state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """K5: K1 that also saves the state entering every 16-step chunk. T must
    be a multiple of 16. Returns (y, final fp32 state, ``zin`` fp32
    ``[B*H, T/16, 64, 64]`` with ``zin[bh, c]`` the TRANSPOSE of the state
    before step ``16 c``, so ``zin[:, 0]`` is the transposed initial state)."""
    B, T, H, N = r.shape
    dev = r.device
    streams = (r, w_raw, k, v, a, b)
    _check_streams("wkv7_fwd_res", streams, (initial_state,))
    if T == 0 or T % CHUNK:
        raise ValueError(f"wkv7_fwd_res: T={T} must be a positive multiple of {CHUNK}")
    y = torch.empty_like(r)
    s_out = torch.empty(B, H, N, N, dtype=torch.float32, device=dev)
    zin = torch.empty(B * H, T // CHUNK, N, N, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.wkv7_fwd_res(
            _DTYPE_CODE[r.dtype], B, T, H, N, *(x.data_ptr() for x in streams),
            _ptr(initial_state), y.data_ptr(), s_out.data_ptr(), zin.data_ptr(), _stream(dev),
        )
    cuda_build.check(lib, err, "wkv7_fwd_res")
    cuda_build.LAUNCHES["wkv7_fwd_res"] += 1
    return y, s_out, zin


def wkv7_bwd(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
             zin: Tensor, dy: Tensor, dsfinal: Tensor) -> Tuple[Tensor, ...]:
    """K6: the vector-Jacobian product of the recurrence from K5's saved
    states. ``dy`` in the stream dtype ``[B, T, H, 64]``, ``dsfinal`` (the
    cotangent of the final state) fp32 ``[B, H, 64, 64]``. Returns (dr,
    dw_raw, dk, dv, da, db) in the stream dtype and the fp32 cotangent of
    the initial state; all arithmetic fp32."""
    B, T, H, N = r.shape
    dev = r.device
    streams = (r, w_raw, k, v, a, b, dy)
    _check_streams("wkv7_bwd", streams, (dsfinal,))
    if T == 0 or T % CHUNK:
        raise ValueError(f"wkv7_bwd: T={T} must be a positive multiple of {CHUNK}")
    _check_cuda("wkv7_bwd", (zin,), dev)
    if zin.dtype != torch.float32 or zin.shape != (B * H, T // CHUNK, N, N):
        raise ValueError(
            f"wkv7_bwd: zin must be fp32 {(B * H, T // CHUNK, N, N)}; got {zin.dtype} {tuple(zin.shape)}"
        )
    grads = [torch.empty_like(r) for _ in range(6)]
    ds0 = torch.empty(B, H, N, N, dtype=torch.float32, device=dev)
    lib = _train_lib()
    with torch.cuda.device(dev):
        err = lib.wkv7_bwd(
            _DTYPE_CODE[r.dtype], B, T, H, N, *(x.data_ptr() for x in streams[:6]),
            zin.data_ptr(), dy.data_ptr(), dsfinal.data_ptr(),
            *(g.data_ptr() for g in grads), ds0.data_ptr(), _stream(dev),
        )
    cuda_build.check(lib, err, "wkv7_bwd")
    cuda_build.LAUNCHES["wkv7_bwd"] += 1
    return (*grads, ds0)


def _step(name: str, flat: bool, state: Tensor, vecs) -> Tuple[Tensor, Tensor]:
    r = vecs[0]
    dev = state.device
    _check_cuda(name, (state,) + tuple(vecs), dev)
    if r.dim() != 3 or r.shape[-1] != 64:
        raise ValueError(f"{name}: vectors must be [B, H, 64]; got {tuple(r.shape)}")
    B, H, N = r.shape
    want = (B, N, H * N) if flat else (B, H, N, N)
    if state.shape != want:
        raise ValueError(f"{name}: state must be {want}; got {tuple(state.shape)}")
    if state.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: state must be fp32 or bf16; got {state.dtype}")
    if any(x.dtype != torch.float32 for x in vecs):
        raise ValueError(f"{name}: vectors must be fp32; got {[x.dtype for x in vecs]}")
    if any(x.shape != (B, H, N) for x in vecs):
        raise ValueError(f"{name}: vectors must be {(B, H, N)}; got {[tuple(x.shape) for x in vecs]}")
    s_out = torch.empty_like(state)
    y = torch.empty_like(r)
    lib = _lib()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(
            _DTYPE_CODE[state.dtype], B, H, N, state.data_ptr(),
            *(x.data_ptr() for x in vecs), s_out.data_ptr(), y.data_ptr(), _stream(dev),
        )
    cuda_build.check(lib, err, name)
    cuda_build.LAUNCHES[name] += 1
    return s_out, y


def wkv7_step(state: Tensor, r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor,
              a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """K2: state ``[B, H, 64, 64]`` fp32 or bf16, vectors ``[B, H, 64]`` fp32
    (the decode step's dtype). Returns (new state in the state's dtype, fp32
    y)."""
    return _step("wkv7_step", False, state, (r, w_raw, k, v, a, b))


def wkv7_step_flat(state: Tensor, r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor,
                   a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """K4: K2 on the flat state ``[B, 64, H*64]`` (element ``[b, i, h*64 + j]``
    is ``S[b, h, i, j]``), fp32 or bf16. Returns (new state in the state's
    dtype and layout, fp32 y ``[B, H, 64]``)."""
    return _step("wkv7_step_flat", True, state, (r, w_raw, k, v, a, b))
