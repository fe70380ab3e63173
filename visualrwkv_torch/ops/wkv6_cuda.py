"""Wrappers of the WKV6 CUDA kernels: K7 ``wkv6_fwd``, K8 ``wkv6_fwd_res``
and K10 ``wkv6_step`` / ``wkv6_step_flat`` (the head and the flat decode
state, ``csrc/wkv6.cu``) and K9 ``wkv6_bwd``
(``csrc/wkv6_train.cu``). They take CUDA tensors only; the dispatchers in
:mod:`visualrwkv_torch.ops.wkv6` send CPU tensors to the plain versions.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream, raises on a
CUDA error, and adds one to its entry of ``cuda_build.LAUNCHES``. The bonus
``u`` is fp32 ``[H, 64]``. ``chunk`` sets the decay floor ``-80 / chunk`` of
the sequence kernels (K7-K9), any ``chunk >= 1`` (the models' ``chunk_len``
is 16, or lower to harden the WKV7 solve); the step (K10) has none. K7 and
K8 work in 16-step chunks, with a factor form of their matrix for each range
of the floor (``csrc/wkv6_chunk.cuh``); :func:`fwd_plan` chooses how many
value rows of a head's state one of their blocks owns. K9 is two launches a
call (:func:`bwd_plan`), counted as one. K10 is K2's kernel body
(``csrc/wkv_step.cuh``) with the RWKV-6 bonus: a block owns a slice of value
rows of one head, :func:`step_plan` chooses how many; :func:`step_floor`
launches an empty kernel on K10's grid, to measure the launch floor
(``csrc/launch_floor.cu``; no path runs it).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from visualrwkv_torch import cuda_build
from visualrwkv_torch.ops import wkv7_cuda
from visualrwkv_torch.ops.wkv7_cuda import _DTYPE_CODE, _check_cuda, _check_streams, _floor_lib, _ptr, _stream

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
CHUNK = 16  # K8 saves, and K9 reads, the state entering every 16 steps
BWD_CHUNK_THREADS = 256  # K9's second pass: threads a block, one block a (b, h, chunk)
# K7 / K8: value rows of a head's state a block may own, the most first, and
# the blocks to reach: about one for each of the H100's 132 multiprocessors
# (at B*H = 64, 128 blocks of 32 rows ran 21 % faster than 256 of 16)
FWD_ROWS = (64, 32, 16)
FWD_BLOCKS = 128


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("wkv6")
    if lib.wkv6_fwd.argtypes is None:
        lib.wkv6_fwd.argtypes = [_I] * 6 + [_F] + [_P] * 9
        lib.wkv6_fwd.restype = _I
        lib.wkv6_fwd_res.argtypes = [_I] * 6 + [_F] + [_P] * 10
        lib.wkv6_fwd_res.restype = _I
        lib.wkv6_fwd_smem_bytes.argtypes = [_I, _I]
        lib.wkv6_fwd_smem_bytes.restype = _I
        lib.wkv6_step.argtypes = [_I] * 5 + [_P] * 9
        lib.wkv6_step.restype = _I
        lib.wkv6_step_flat.argtypes = [_I] * 5 + [_P] * 9
        lib.wkv6_step_flat.restype = _I
    return lib


def _train_lib() -> ctypes.CDLL:
    lib = cuda_build.load("wkv6_train")
    if lib.wkv6_bwd.argtypes is None:
        lib.wkv6_bwd.argtypes = [_I] * 6 + [_F] + [_P] * 16
        lib.wkv6_bwd.restype = _I
        lib.wkv6_bwd_chunk_smem_bytes.argtypes = [_I]
        lib.wkv6_bwd_chunk_smem_bytes.restype = _I
    return lib


def _check_u(name: str, u: Tensor, H: int, device) -> None:
    _check_cuda(name, (u,), device)
    if u.dtype != torch.float32 or u.shape != (H, 64):
        raise ValueError(f"{name}: u must be fp32 {(H, 64)}; got {u.dtype} {tuple(u.shape)}")


def _floor(chunk: int) -> float:
    if chunk <= 0:
        raise ValueError(f"chunk must be positive; got {chunk}")
    return -80.0 / chunk


def fwd_plan(B: int, H: int, dtype: torch.dtype) -> dict:
    """K7 / K8's launch for B * H heads: the value rows of a head's state a
    block owns (the most of ``FWD_ROWS`` that still gives ``FWD_BLOCKS``
    blocks, else the fewest), the blocks, the threads a block (8 a row, 4 at
    64 rows) and the dynamic shared memory of a block, bytes, as ``csrc/wkv6.cu``'s
    ``FwdSmem`` lays it out: three stages of r, w, k and the block's v
    columns in the stream dtype, six fp32 16 x 68 factor tiles, two copies
    of the slice of S, the decay (two), A and u."""
    rows = next((n for n in FWD_ROWS if B * H * (64 // n) >= FWD_BLOCKS), FWD_ROWS[-1])
    esz = 2 if dtype == torch.bfloat16 else 4
    ldp = 64 + 4
    smem = (3 * (3 * CHUNK * 64 + CHUNK * rows) * esz + 6 * CHUNK * ldp * 4 + 2 * rows * ldp * 4
            + 2 * 64 * 4 + CHUNK * CHUNK * 4 + 64 * 4)
    return {"rows": rows, "blocks": B * H * (64 // rows), "threads": rows * (4 if rows == 64 else 8),
            "smem_bytes": smem}


def step_plan(B: int, H: int, state_dtype: torch.dtype, flat: bool = False) -> dict:
    """K10's launch for B * H heads (``wkv7_cuda.step_launch``: the kernel
    body of K2). An fp32 state takes K2's rows (``wkv7_cuda.step_plan``): 32,
    two a thread, 128 blocks at the 7B's B=1 H=64. A bf16 state takes whole
    heads at every batch, two rows a thread: at B=1 H=64 its 64 blocks of 8
    KiB read 7-8 % faster on the H100 than 128 blocks of 4 KiB, L2-hot and
    L2-cold (``PERF.md``). On the flat state (``flat``) an fp32 state takes
    K4's rows (``wkv7_cuda.step_plan(..., flat=True)``), a bf16 state whole
    heads; the rows change no arithmetic, so the flat K10 is bit-equal to
    K10."""
    if state_dtype == torch.bfloat16:
        return wkv7_cuda.step_launch(B, H, state_dtype, 64)
    return wkv7_cuda.step_plan(B, H, state_dtype, flat)


def bwd_plan(B: int, T: int, H: int, dtype: torch.dtype) -> dict:
    """K9's two launches for B * H heads of T steps: ``"state"``, the first
    pass, is laid out as K8 (:func:`fwd_plan`); ``"chunk"``, the second, has
    a block of ``BWD_CHUNK_THREADS`` for each (b, h, chunk) and the dynamic
    shared memory ``csrc/wkv6_chunk_bwd.cuh``'s ``Wkv6BwdSmem`` lays out: r,
    w, k in the stream dtype; six fp32 16 x 68 tiles (v, dy, the running
    log decay g and g_p, P_R, dKbar); dSK as 16 x 20; Z0 and dZ1 as 64 x 68.
    ``workspace_bytes``: the fp32 cotangent of the state leaving every
    chunk, zin's size, that the first pass writes and the second reads;
    ``du_bytes``: the second pass's partial sums of du, one a (b, h, chunk)."""
    esz = 2 if dtype == torch.bfloat16 else 4
    ldp = 64 + 4
    smem = 3 * CHUNK * 64 * esz + 6 * CHUNK * ldp * 4 + CHUNK * (CHUNK + 4) * 4 + 2 * 64 * ldp * 4
    nc = T // CHUNK
    return {"state": fwd_plan(B, H, dtype),
            "chunk": {"blocks": B * H * nc, "threads": BWD_CHUNK_THREADS, "smem_bytes": smem},
            "workspace_bytes": B * H * nc * 64 * 64 * 4, "du_bytes": B * H * nc * 64 * 4}


def kernel_bwd_chunk_smem_bytes(dtype: torch.dtype) -> int:
    """The library's own count of a K9 second-pass block's shared memory."""
    return _train_lib().wkv6_bwd_chunk_smem_bytes(_DTYPE_CODE[dtype])


def kernel_smem_bytes(dtype: torch.dtype, rows: int) -> int:
    """The library's own count of a K7 / K8 block's shared memory (-1: it has
    no instantiation for ``rows``)."""
    return _lib().wkv6_fwd_smem_bytes(_DTYPE_CODE[dtype], rows)


def wkv6_fwd(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, u: Tensor,
             initial_state: Optional[Tensor] = None, chunk: int = 16) -> Tuple[Tensor, Tensor]:
    """K7: streams ``[B, T, H, 64]`` (all fp32 or all bf16), u fp32 ``[H, 64]``,
    optional fp32 initial state ``[B, H, 64, 64]``. Returns (y in the stream
    dtype, final fp32 state)."""
    B, T, H, N = r.shape
    dev = r.device
    floor = _floor(chunk)
    streams = (r, w_raw, k, v)
    _check_streams("wkv6_fwd", streams, (initial_state,))
    _check_u("wkv6_fwd", u, H, dev)
    y = torch.empty_like(r)
    s_out = torch.empty(B, H, N, N, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.wkv6_fwd(
            _DTYPE_CODE[r.dtype], fwd_plan(B, H, r.dtype)["rows"], B, T, H, N, floor,
            *(x.data_ptr() for x in streams), u.data_ptr(), _ptr(initial_state), y.data_ptr(),
            s_out.data_ptr(), _stream(dev),
        )
    cuda_build.check(lib, err, "wkv6_fwd")
    cuda_build.LAUNCHES["wkv6_fwd"] += 1
    return y, s_out


def wkv6_fwd_res(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, u: Tensor,
                 initial_state: Optional[Tensor] = None,
                 chunk: int = 16) -> Tuple[Tensor, Tensor, Tensor]:
    """K8: K7 that also saves the state entering every 16-step chunk. T must
    be a multiple of 16. Returns (y, final fp32 state, ``zin`` fp32
    ``[B*H, T/16, 64, 64]`` with ``zin[bh, c]`` the TRANSPOSE of the state
    before step ``16 c``)."""
    B, T, H, N = r.shape
    dev = r.device
    floor = _floor(chunk)
    if T == 0 or T % CHUNK:
        raise ValueError(f"wkv6_fwd_res: T={T} must be a positive multiple of {CHUNK}")
    streams = (r, w_raw, k, v)
    _check_streams("wkv6_fwd_res", streams, (initial_state,))
    _check_u("wkv6_fwd_res", u, H, dev)
    y = torch.empty_like(r)
    s_out = torch.empty(B, H, N, N, dtype=torch.float32, device=dev)
    zin = torch.empty(B * H, T // CHUNK, N, N, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.wkv6_fwd_res(
            _DTYPE_CODE[r.dtype], fwd_plan(B, H, r.dtype)["rows"], B, T, H, N, floor,
            *(x.data_ptr() for x in streams), u.data_ptr(), _ptr(initial_state), y.data_ptr(),
            s_out.data_ptr(), zin.data_ptr(), _stream(dev),
        )
    cuda_build.check(lib, err, "wkv6_fwd_res")
    cuda_build.LAUNCHES["wkv6_fwd_res"] += 1
    return y, s_out, zin


def wkv6_bwd(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, u: Tensor, zin: Tensor,
             dy: Tensor, dsfinal: Tensor, chunk: int = 16) -> Tuple[Tensor, ...]:
    """K9: the vector-Jacobian product of the recurrence from K8's saved
    states (the two-pass chunked kernel; :func:`bwd_plan`). ``dy`` in the
    stream dtype ``[B, T, H, 64]``, ``dsfinal`` (the cotangent of the final
    state) fp32 ``[B, H, 64, 64]``. Returns (dr, dw_raw, dk, dv) in the
    stream dtype, du fp32 ``[H, 64]`` (the kernel's partial sums a (b, h,
    chunk) added here) and the fp32 cotangent of the initial state; all
    arithmetic fp32. Both passes launch on the current stream, the second
    reading the first's workspace (``torch.empty`` of zin's shape), and count
    one launch together."""
    B, T, H, N = r.shape
    dev = r.device
    floor = _floor(chunk)
    streams = (r, w_raw, k, v, dy)
    _check_streams("wkv6_bwd", streams, (dsfinal,))
    _check_u("wkv6_bwd", u, H, dev)
    if T == 0 or T % CHUNK:
        raise ValueError(f"wkv6_bwd: T={T} must be a positive multiple of {CHUNK}")
    _check_cuda("wkv6_bwd", (zin,), dev)
    if zin.dtype != torch.float32 or zin.shape != (B * H, T // CHUNK, N, N):
        raise ValueError(
            f"wkv6_bwd: zin must be fp32 {(B * H, T // CHUNK, N, N)}; got {zin.dtype} {tuple(zin.shape)}"
        )
    grads = [torch.empty_like(r) for _ in range(4)]
    du_part = torch.empty(B, H, T // CHUNK, N, dtype=torch.float32, device=dev)
    ds0 = torch.empty(B, H, N, N, dtype=torch.float32, device=dev)
    dz1 = torch.empty_like(zin)
    lib = _train_lib()
    with torch.cuda.device(dev):
        err = lib.wkv6_bwd(
            _DTYPE_CODE[r.dtype], fwd_plan(B, H, r.dtype)["rows"], B, T, H, N, floor,
            *(x.data_ptr() for x in streams[:4]), u.data_ptr(), zin.data_ptr(), dy.data_ptr(),
            dsfinal.data_ptr(), *(g.data_ptr() for g in grads), du_part.data_ptr(), ds0.data_ptr(),
            dz1.data_ptr(), _stream(dev),
        )
    cuda_build.check(lib, err, "wkv6_bwd")
    cuda_build.LAUNCHES["wkv6_bwd"] += 1
    return (*grads, du_part.sum((0, 2)), ds0)


def _step_args(name: str, state: Tensor, vecs, u: Tensor, flat: bool = False) -> Tuple[int, int, dict]:
    """Check a step's state (the head layout, or the flat one when ``flat``),
    vectors and bonus; (B, H, :func:`step_plan`)."""
    r = vecs[0]
    dev = state.device
    _check_cuda(name, (state,) + tuple(vecs), dev)
    if r.dim() != 3 or r.shape[-1] != 64:
        raise ValueError(f"{name}: vectors must be [B, H, 64]; got {tuple(r.shape)}")
    B, H, N = r.shape
    _check_u(name, u, H, dev)
    want = (B, N, H * N) if flat else (B, H, N, N)
    if state.shape != want:
        raise ValueError(f"{name}: state must be {want}; got {tuple(state.shape)}")
    if state.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: state must be fp32 or bf16; got {state.dtype}")
    if any(x.dtype != torch.float32 or x.shape != (B, H, N) for x in vecs):
        raise ValueError(f"{name}: vectors must be fp32 {(B, H, N)}; got "
                         f"{[(x.dtype, tuple(x.shape)) for x in vecs]}")
    if any(x.data_ptr() % 16 for x in (state, u) + tuple(vecs)):
        raise ValueError(f"{name}: the kernel reads 16 bytes at once; every tensor must start 16-byte aligned")
    return B, H, step_plan(B, H, state.dtype, flat)


def _step(name: str, flat: bool, state: Tensor, vecs, u: Tensor) -> Tuple[Tensor, Tensor]:
    B, H, plan = _step_args(name, state, vecs, u, flat)
    dev = state.device
    s_out = torch.empty_like(state)
    y = torch.empty_like(vecs[0])
    lib = _lib()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(
            _DTYPE_CODE[state.dtype], plan["rows"], B, H, 64, state.data_ptr(),
            *(x.data_ptr() for x in vecs), u.data_ptr(), s_out.data_ptr(), y.data_ptr(), _stream(dev),
        )
    cuda_build.check(lib, err, name)
    cuda_build.LAUNCHES[name] += 1
    return s_out, y


def wkv6_step(state: Tensor, r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor,
              u: Tensor) -> Tuple[Tensor, Tensor]:
    """K10: state ``[B, H, 64, 64]`` fp32 or bf16, vectors ``[B, H, 64]`` fp32
    (the decode step's dtype), u fp32 ``[H, 64]``; no decay floor. Laid out
    by :func:`step_plan`. Returns (new state in the state's dtype, fp32 y)."""
    return _step("wkv6_step", False, state, (r, w_raw, k, v), u)


def wkv6_step_flat(state: Tensor, r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor,
                   u: Tensor) -> Tuple[Tensor, Tensor]:
    """K10 on the flat state ``[B, 64, H*64]`` (element ``[b, i, h*64 + j]``
    is ``S[b, h, i, j]``), fp32 or bf16: the same kernel with K4's row
    stride, bit-equal to :func:`wkv6_step` on the same state. Returns (new
    state in the state's dtype and layout, fp32 y ``[B, H, 64]``)."""
    return _step("wkv6_step_flat", True, state, (r, w_raw, k, v), u)


def step_floor(state: Tensor, r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, u: Tensor,
               flat: bool = False) -> None:
    """The launch floor of :func:`wkv6_step` (:func:`wkv6_step_flat` when
    ``flat``, on a flat state) on these inputs: the empty kernel of
    ``csrc/launch_floor.cu`` launched on K10's grid and block
    (:func:`step_plan`) with K10's pointers. It computes nothing and no path
    calls it; it is timed beside K10."""
    vecs = (r, w_raw, k, v)
    B, H, plan = _step_args("step_floor", state, vecs, u, flat)
    dev = state.device
    lib = _floor_lib()
    with torch.cuda.device(dev):
        err = lib.launch_floor(plan["blocks"], plan["threads"], H, state.data_ptr(),
                               *(x.data_ptr() for x in vecs), u.data_ptr(), None,
                               state.data_ptr(), r.data_ptr(), _stream(dev))
    cuda_build.check(lib, err, "step_floor")
    cuda_build.LAUNCHES["wkv6_step_floor"] += 1
