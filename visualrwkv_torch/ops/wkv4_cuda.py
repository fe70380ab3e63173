"""Wrappers of the RWKV-4 CUDA kernels (``csrc/wkv4.cu``): K17
``wkv4_fwd``, the sequence forward of the per-channel (aa, bb, pp)
recurrence, and K18 ``wkv4_bwd``, its VJP, each a chunked scan over T. Neither
is a TPU kernel: the JAX package runs this recurrence as a ``lax.scan`` that
XLA fuses and autodiff differentiates. They take CUDA tensors only;
:mod:`visualrwkv_torch.ops.wkv4` sends CPU tensors to the plain versions.
:func:`fwd_plan` and :func:`bwd_plan` choose the chunks and the grid.

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
# A block owns one row and CHANNELS channels (a lane each, a half-warp)
# across all chunks of T, in chunk slots of CHANNELS threads (the library's
# CH). The slots a block at most (K17 1024 threads, K18 512) and the steps a
# chunk at most (what the staged rows of a round fit in shared memory: K17 k
# and v, K18 k, v, dy and the states entering each step); a block takes
# fewer slots while they would hold fewer than MIN_CHUNK steps each. The
# library refuses more slots than 64 (K17) / 32 (K18) or more shared memory
# than a block has.
CHANNELS = 16
FWD_SLOTS, BWD_SLOTS = 64, 32
FWD_MAX_CHUNK, BWD_MAX_CHUNK = 24, 16
MIN_CHUNK = 8


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("wkv4")
    if lib.wkv4_fwd.argtypes is None:
        lib.wkv4_fwd.argtypes = [_I] * 6 + [_P] * 8
        lib.wkv4_fwd.restype = _I
        lib.wkv4_bwd.argtypes = [_I] * 6 + [_P] * 14
        lib.wkv4_bwd.restype = _I
        lib.wkv4_smem_bytes.argtypes = [_I] * 4
        lib.wkv4_smem_bytes.restype = ctypes.c_long
    return lib


def _padded(chunk: int) -> int:
    return chunk | 1  # a slot's rows in shared memory: odd, so two half-warps read different banks


def smem_bytes(kernel: str, dtype: torch.dtype, slots: int, chunk: int) -> int:
    """A block's shared memory (the library's ``wkv4_smem_bytes``): K17
    ("fwd") the summaries [4, 16, slots + 1] and the carry [3, 16] fp32, k
    and v [slots, padded chunk, 16] in their dtype; K18 ("bwd") the maps [7,
    16, slots + 1], the carry, dy and the three step states [slots, padded
    chunk, 16] fp32, then k and v."""
    kv = 2 * slots * _padded(chunk) * CHANNELS * (2 if dtype == torch.bfloat16 else 4)
    if kernel == "fwd":
        return 4 * CHANNELS * (slots + 1) * 4 + 3 * CHANNELS * 4 + kv
    return 7 * CHANNELS * (slots + 1) * 4 + 3 * CHANNELS * 4 + slots * _padded(chunk) * CHANNELS * 16 + kv


def kernel_smem_bytes(kernel: str, dtype: torch.dtype, slots: int, chunk: int) -> int:
    """The library's own count of a block's shared memory (``wkv4_smem_bytes``;
    kernel "fwd" K17, "bwd" K18), which :func:`smem_bytes` must equal."""
    return _lib().wkv4_smem_bytes(int(kernel == "bwd"), _DTYPE_CODE[dtype], slots, chunk)


def _plan(kernel: str, B: int, T: int, C: int, dtype, most_slots: int, max_chunk: int) -> dict:
    slots = 32 // CHANNELS  # a warp's slots
    while slots < most_slots and slots * MIN_CHUNK < T:
        slots *= 2
    rounds = -(-T // (slots * max_chunk))
    chunk = -(-T // (slots * rounds)) if T else 1
    chunks = -(-T // chunk)
    tiles = -(-C // CHANNELS)
    return {"chunk": chunk, "slots": slots, "chunks": chunks, "rounds": -(-chunks // slots),
            "threads": CHANNELS * slots, "grid": (tiles, B), "blocks": tiles * B,
            "smem_bytes": smem_bytes(kernel, dtype, slots, chunk)}


def fwd_plan(B: int, T: int, C: int, dtype: torch.dtype = torch.float32) -> dict:
    """K17's chunks and grid for ``B`` rows of ``T`` steps and ``C``
    channels: a block a (tile of 16 channels, row), ``slots`` chunk slots a
    block (the most of ``FWD_SLOTS`` that leaves each slot ``MIN_CHUNK``
    steps), chunks of ``chunk`` steps (at most ``FWD_MAX_CHUNK``; the last
    may be shorter), ``rounds`` rounds of ``slots`` chunks. At B=1 T=1056
    C=2048: 128 blocks of 64 slots, chunks of 17 steps, one round. T = 0:
    no chunk, the entering state out."""
    return _plan("fwd", B, T, C, dtype, FWD_SLOTS, FWD_MAX_CHUNK)


def bwd_plan(B: int, T: int, C: int, dtype: torch.dtype = torch.float32) -> dict:
    """K18's chunks and grid, as :func:`fwd_plan` with ``BWD_SLOTS`` and
    ``BWD_MAX_CHUNK``, and its workspace (``"workspace"``): the state
    entering each chunk, ``[B, chunks, 3, C]`` fp32, where T takes more than
    one round (with one, the states stay in shared memory: ``[B, 0, 3,
    C]``). At B=1 T=1056: 32 slots, chunks of 11 steps, three rounds; at the
    v4 adapter's B=8 T=64: 8 slots of 8 steps, one round."""
    plan = _plan("bwd", B, T, C, dtype, BWD_SLOTS, BWD_MAX_CHUNK)
    plan["workspace"] = (B, plan["chunks"] if plan["rounds"] > 1 else 0, 3, C)
    return plan


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
    plan = fwd_plan(B, T, C, k.dtype)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.wkv4_fwd(_DTYPE_CODE[k.dtype], plan["slots"], plan["chunk"], B, T, C, w.data_ptr(), u.data_ptr(),
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
    that of the final state. The kernel writes the state entering each
    chunk into a workspace ``[B, chunks, 3, C]`` fp32 where T takes more
    than one round (:func:`bwd_plan`; ``torch.empty``, freed with the
    call). Returns (dw, du fp32 ``[C]``, dk, dv fp32 ``[B, T, C]``, d
    initial state fp32 ``[B, C, 3]`` or None when no initial state was
    given); dw and du are the kernel's per-row partial sums, summed over B
    here."""
    name = "wkv4_bwd"
    _check(name, w, u, k, v, (initial_state, ds), (dy,))
    B, T, C = k.shape
    dev = k.device
    plan = bwd_plan(B, T, C, k.dtype)
    ws = torch.empty(plan["workspace"], device=dev)
    dk = torch.empty(B, T, C, device=dev)
    dv = torch.empty(B, T, C, device=dev)
    dw_part = torch.empty(B, C, device=dev)
    du_part = torch.empty(B, C, device=dev)
    ds0 = None if initial_state is None else torch.empty(B, C, 3, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.wkv4_bwd(_DTYPE_CODE[k.dtype], plan["slots"], plan["chunk"], B, T, C, w.data_ptr(), u.data_ptr(),
                           k.data_ptr(), v.data_ptr(), ptr(initial_state), dy.data_ptr(), ptr(ds),
                           ws.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw_part.data_ptr(),
                           du_part.data_ptr(), ptr(ds0), _stream(dev))
    cuda_build.check(lib, err, name)
    cuda_build.LAUNCHES[name] += 1
    return dw_part.sum(0), du_part.sum(0), dk, dv, ds0
