"""Wrappers of the RWKV-4 CUDA kernels (``csrc/wkv4.cu``): K17
``wkv4_fwd``, the sequence forward of the per-channel (aa, bb, pp)
recurrence, and K18 ``wkv4_bwd``, its VJP. Neither is a TPU kernel: the JAX
package runs this recurrence as a ``lax.scan`` that XLA fuses and autodiff
differentiates. They take CUDA tensors only; :mod:`visualrwkv_torch.ops.wkv4`
sends CPU tensors to the plain versions. :func:`fwd_plan` chooses the
threads a block (one thread a (b, c), both kernels).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream, raises on a
CUDA error, and adds one to ``cuda_build.LAUNCHES[<its name>]``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from visualrwkv_torch import cuda_build
from visualrwkv_torch.ops.wkv7_cuda import _check_cuda, _stream

Tensor = torch.Tensor

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
# threads a block, the most first, and the blocks to reach: about one for
# each of the H100's 132 multiprocessors (a thread walks one channel)
FWD_THREADS = (128, 64, 32)
FWD_BLOCKS = 128


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("wkv4")
    if lib.wkv4_fwd.argtypes is None:
        lib.wkv4_fwd.argtypes = [_I] * 5 + [_P] * 8
        lib.wkv4_fwd.restype = _I
        lib.wkv4_bwd.argtypes = [_I] * 5 + [_P] * 14
        lib.wkv4_bwd.restype = _I
    return lib


def fwd_plan(B: int, C: int) -> dict:
    """K17's launch for ``B`` rows of ``C`` channels: the most threads a
    block of ``FWD_THREADS`` that still gives ``FWD_BLOCKS`` blocks, else
    the fewest."""
    n = B * C
    threads = next((t for t in FWD_THREADS if -(-n // t) >= FWD_BLOCKS), FWD_THREADS[-1])
    return {"threads": threads, "blocks": -(-n // threads)}


def _check(name: str, w: Tensor, u: Tensor, k: Tensor, v: Tensor, states=(), streams=()) -> None:
    """k, v one ``[B, T, C]`` of fp32 or bf16; w, u fp32 ``[C]``; each of
    ``states`` (None allowed) fp32 ``[B, C, 3]``; each of ``streams`` fp32
    ``[B, T, C]``; all on one CUDA device, contiguous."""
    if k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"{name}: k, v must be one [B, T, C]; got {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, C = k.shape
    states = tuple(s for s in states if s is not None)
    _check_cuda(name, (w, u, k, v, *states, *streams), k.device)
    if k.dtype not in _DTYPE_CODE or v.dtype != k.dtype:
        raise ValueError(f"{name}: k, v must be fp32 or bf16, one dtype; got {k.dtype}, {v.dtype}")
    if any(x.dtype != torch.float32 or x.shape != (C,) for x in (w, u)):
        raise ValueError(f"{name}: w, u must be fp32 [{C}]; got {[(x.dtype, tuple(x.shape)) for x in (w, u)]}")
    for s in states:
        if s.dtype != torch.float32 or s.shape != (B, C, 3):
            raise ValueError(f"{name}: a state must be fp32 {(B, C, 3)}; got {s.dtype} {tuple(s.shape)}")
    for x in streams:
        if x.dtype != torch.float32 or x.shape != (B, T, C):
            raise ValueError(f"{name}: dy must be fp32 {(B, T, C)}; got {x.dtype} {tuple(x.shape)}")


def wkv4_fwd(w: Tensor, u: Tensor, k: Tensor, v: Tensor,
             initial_state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """K17: k, v ``[B, T, C]`` fp32 or bf16 (one dtype), w and u fp32 ``[C]``
    (w the log decay ``-exp(time_decay)``), initial state fp32 ``[B, C, 3]``
    or None (aa = bb = 0, pp = -1e30). Returns (y fp32 ``[B, T, C]``, final
    state fp32 ``[B, C, 3]``)."""
    name = "wkv4_fwd"
    _check(name, w, u, k, v, (initial_state,))
    B, T, C = k.shape
    dev = k.device
    y = torch.empty(B, T, C, device=dev)
    s_out = torch.empty(B, C, 3, device=dev)
    plan = fwd_plan(B, C)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.wkv4_fwd(_DTYPE_CODE[k.dtype], plan["threads"], B, T, C, w.data_ptr(), u.data_ptr(),
                           k.data_ptr(), v.data_ptr(),
                           None if initial_state is None else initial_state.data_ptr(),
                           y.data_ptr(), s_out.data_ptr(), _stream(dev))
    cuda_build.check(lib, err, name)
    cuda_build.LAUNCHES[name] += 1
    return y, s_out


def wkv4_bwd(w: Tensor, u: Tensor, k: Tensor, v: Tensor, initial_state: Optional[Tensor],
             dy: Tensor, ds: Optional[Tensor] = None
             ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Optional[Tensor]]:
    """K18, the VJP of :func:`wkv4_fwd` on the same inputs: dy fp32
    ``[B, T, C]`` the cotangent of y, ds fp32 ``[B, C, 3]`` (or None: zero)
    that of the final state. The kernel recomputes the states entering each
    step into a workspace ``[B, T, 3, C]`` fp32 (``torch.empty``, freed with
    the call). Returns (dw, du fp32 ``[C]``, dk, dv fp32 ``[B, T, C]``, d
    initial state fp32 ``[B, C, 3]`` or None when no initial state was
    given); dw and du are the kernel's per-row partial sums, summed over B
    here."""
    name = "wkv4_bwd"
    _check(name, w, u, k, v, (initial_state, ds), (dy,))
    B, T, C = k.shape
    dev = k.device
    ws = torch.empty(B, T, 3, C, device=dev)
    dk = torch.empty(B, T, C, device=dev)
    dv = torch.empty(B, T, C, device=dev)
    dw_part = torch.empty(B, C, device=dev)
    du_part = torch.empty(B, C, device=dev)
    ds0 = None if initial_state is None else torch.empty(B, C, 3, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    plan = fwd_plan(B, C)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.wkv4_bwd(_DTYPE_CODE[k.dtype], plan["threads"], B, T, C, w.data_ptr(), u.data_ptr(),
                           k.data_ptr(), v.data_ptr(), ptr(initial_state), dy.data_ptr(), ptr(ds),
                           ws.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw_part.data_ptr(),
                           du_part.data_ptr(), ptr(ds0), _stream(dev))
    cuda_build.check(lib, err, name)
    cuda_build.LAUNCHES[name] += 1
    return dw_part.sum(0), du_part.sum(0), dk, dv, ds0
