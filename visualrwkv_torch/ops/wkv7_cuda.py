"""Wrappers of the WKV7 CUDA kernels: K1 ``wkv7_fwd``, K2 ``wkv7_step``,
K4 ``wkv7_step_flat`` and K5 ``wkv7_fwd_res`` (``csrc/wkv7.cu``), K6
``wkv7_bwd`` (``csrc/wkv7_train.cu``), the head-pair ("packed") kernels
K11 ``wkv7_fwd_packed``, K12 ``wkv7_fwd_res_packed`` and K13
``wkv7_bwd_packed`` (``csrc/wkv7_packed.cu``), and K16 ``wkv7_fwd_v2``, the
chunked matrix form of the forward (``csrc/wkv7_v2.cu``; two launches,
:func:`v2_plan`). They take CUDA tensors only;
the dispatchers in :mod:`visualrwkv_torch.ops.wkv7` send CPU tensors to the
plain versions. K1, K5, K11 and K12 are one chunked kernel
(``csrc/wkv7_chunk.cuh``; K5 and K12 also save the chunk states, K1 and
K11 take any T) whose block owns a slice of value rows of one head;
:func:`fwd_res_plan` chooses how many. K6 and K13 are one two-pass chunked VJP
(``csrc/wkv7_chunk_bwd.cuh``): a pass laid out as K5 that carries the state
cotangent through a workspace, then a block for each (b, h, chunk);
:func:`bwd_plan` gives both launches. K2 and K4 are one kernel whose block
owns a slice of value rows of one head; :func:`step_plan` chooses how many.
:func:`step_floor` launches an empty kernel on K2's grid, to measure the
launch floor (``csrc/launch_floor.cu``; no path runs it). :func:`run_trail`
launches a step kernel once a position of a short window, each launch
writing into the next slice of a state trail (the steps' ``out``).

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
CHUNK = 16  # K5 / K12 save, and K6 / K13 read, the state entering every 16 steps
V2_CHUNK = 32  # K16's chunk, the default of the JAX package's wkv7_pallas_v2
# K16's launches (csrc/wkv7_v2.cu): threads a block of either phase; phase
# 2's value columns of Z a block may own with bf16 streams (the most first)
# and the blocks to reach, its columns with fp32 streams, and its chunks of
# operands in flight
V2_THREADS = 128
V2_COLS = (64, 32, 16)
V2_BLOCKS = 256
V2_COLS_F32 = 8
V2_STAGES = 3
# K1 / K5 / K11 / K12: value rows of a head's state a block may own, the most
# first, and the blocks to reach: about one for each of the H100's 132
# multiprocessors
FWD_RES_ROWS = (64, 32, 16)
FWD_RES_BLOCKS = 128
BWD_CHUNK_THREADS = 256  # K6 / K13's second pass: threads of a block of one (b, h, chunk)
# K2 / K4: value rows of a head's state a block may own, the most first, the
# blocks to reach (about one for each multiprocessor), and the threads a block
# may have (csrc/wkv7.cu's STEP_THREADS: past them a thread takes two rows)
STEP_ROWS = (64, 32, 16, 8)
STEP_BLOCKS = 128
STEP_THREADS = 256


def _declare(lib: ctypes.CDLL, fwd: str, fwd_res: str, bwd: Optional[str]) -> None:
    getattr(lib, fwd).argtypes = [_I] * 6 + [_P] * 10
    getattr(lib, fwd_res).argtypes = [_I] * 6 + [_P] * 11
    names = [fwd, fwd_res]
    if bwd is not None:
        getattr(lib, bwd).argtypes = [_I] * 6 + [_P] * 18
        names.append(bwd)
    for n in names:
        getattr(lib, n).restype = _I


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("wkv7")
    if lib.wkv7_fwd.argtypes is None:
        _declare(lib, "wkv7_fwd", "wkv7_fwd_res", None)
        for fn in (lib.wkv7_step, lib.wkv7_step_flat):
            fn.argtypes = [_I] * 5 + [_P] * 10
            fn.restype = _I
        lib.wkv7_fwd_res_smem_bytes.argtypes = [_I, _I]
        lib.wkv7_fwd_res_smem_bytes.restype = _I
    return lib


def _train_lib() -> ctypes.CDLL:
    lib = cuda_build.load("wkv7_train")
    if lib.wkv7_bwd.argtypes is None:
        lib.wkv7_bwd.argtypes = [_I] * 6 + [_P] * 18
        lib.wkv7_bwd.restype = _I
        lib.wkv7_bwd_chunk_smem_bytes.argtypes = [_I]
        lib.wkv7_bwd_chunk_smem_bytes.restype = _I
    return lib


def _v2_lib() -> ctypes.CDLL:
    lib = cuda_build.load("wkv7_v2")
    if lib.wkv7_fwd_v2.argtypes is None:
        lib.wkv7_fwd_v2.argtypes = [_I] * 5 + [_P] * 11
        lib.wkv7_fwd_v2_phase.argtypes = [_I] * 6 + [_P] * 11
        lib.wkv7_v2_state_plan.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
        for fn in (lib.wkv7_v2_scratch_bytes, lib.wkv7_v2_chunk_smem_bytes):
            fn.argtypes = [_I]
        for fn in (lib.wkv7_fwd_v2, lib.wkv7_fwd_v2_phase, lib.wkv7_v2_state_plan,
                   lib.wkv7_v2_scratch_bytes, lib.wkv7_v2_chunk_smem_bytes):
            fn.restype = _I
    return lib


def _floor_lib() -> ctypes.CDLL:
    lib = cuda_build.load("launch_floor")
    if lib.launch_floor.argtypes is None:
        lib.launch_floor.argtypes = [_I] * 3 + [_P] * 10
        lib.launch_floor.restype = _I
    return lib


def _packed_lib() -> ctypes.CDLL:
    lib = cuda_build.load("wkv7_packed")
    if lib.wkv7_fwd_packed.argtypes is None:
        _declare(lib, "wkv7_fwd_packed", "wkv7_fwd_res_packed", "wkv7_bwd_packed")
    return lib


def zin_shape(B: int, T: int, H: int, N: int, packed: bool) -> Tuple[int, int, int, int]:
    """Shape of the saved chunk states: ``[B*H, T/16, N, N]`` (head layout,
    ``zin[bh, c]`` the transposed state before step 16c) or, packed,
    ``[B*H/2, T/16, N, 2N]`` (``zin[p, c, j, h2*N + i]`` is
    ``S_{2p+h2}[i, j]``)."""
    return (B * H // 2, T // CHUNK, N, 2 * N) if packed else (B * H, T // CHUNK, N, N)


def fwd_res_plan(B: int, H: int, dtype: torch.dtype) -> dict:
    """K1 / K5 / K11 / K12's launch for B * H heads: the value rows of a head's state a
    block owns (the most of ``FWD_RES_ROWS`` that still gives
    ``FWD_RES_BLOCKS`` blocks, else the fewest), the blocks, the threads a
    block (8 a row, 4 at 64 rows) and the dynamic shared memory of a block,
    bytes, as ``csrc/wkv7_chunk.cuh``'s ``ChunkSmem`` lays it out: three
    stages of r, w, k, a, b and the block's v columns in the stream dtype,
    twelve fp32 16 x 68 factor tiles, the decay (two), two sets of the four
    16 x 16 matrices, the slice of S and the solve's right-hand sides."""
    rows = next((n for n in FWD_RES_ROWS if B * H * (64 // n) >= FWD_RES_BLOCKS), FWD_RES_ROWS[-1])
    esz = 2 if dtype == torch.bfloat16 else 4
    ldp = 64 + 4
    smem = (3 * (5 * CHUNK * 64 + CHUNK * rows) * esz + 12 * CHUNK * ldp * 4 + 2 * 64 * 4
            + 2 * 4 * CHUNK * CHUNK * 4 + rows * ldp * 4 + CHUNK * rows * 4)
    return {"rows": rows, "blocks": B * H * (64 // rows), "threads": rows * (4 if rows == 64 else 8),
            "smem_bytes": smem}


def step_launch(B: int, H: int, state_dtype: torch.dtype, rows: int) -> dict:
    """The launch of the step kernel (``csrc/wkv_step.cuh``: K2, K4, K10) for
    B * H heads with ``rows`` value rows of a head's state a block: the
    blocks, the lanes a state row takes (16 bytes a lane: 16 for an fp32
    state, 8 for bf16), the rows a thread (one, or two once the rows take
    more than ``STEP_THREADS`` lanes) and the threads a block."""
    lanes = 64 * (2 if state_dtype == torch.bfloat16 else 4) // 16
    per_thread = 2 if rows * lanes > STEP_THREADS else 1
    return {"rows": rows, "blocks": B * H * (64 // rows), "lanes_per_row": lanes,
            "rows_per_thread": per_thread, "threads": rows * lanes // per_thread}


def step_plan(B: int, H: int, state_dtype: torch.dtype, flat: bool = False) -> dict:
    """K2's (K4's, ``flat``) launch for B * H heads (:func:`step_launch`). The
    rows are the most of ``STEP_ROWS`` that give ``STEP_BLOCKS`` blocks (else
    the fewest) among those whose block has at most ``STEP_THREADS`` threads:
    16 at B=1 H=32; from B=4 on, 32 for an fp32 state and whole heads for
    bf16, two rows a thread. K4 with an fp32 state takes the fewest rows at
    every batch: its rows lie H * 256 bytes apart, and there 8-row blocks
    read fastest on the H100 (``PERF.md``). The rows change no arithmetic, so
    K4 stays bit-equal to K2."""
    fits = [n for n in STEP_ROWS if step_launch(1, 1, state_dtype, n)["threads"] <= STEP_THREADS]
    if flat and state_dtype == torch.float32:
        fits = fits[-1:]
    rows = next((n for n in fits if B * H * (64 // n) >= STEP_BLOCKS), fits[-1])
    return step_launch(B, H, state_dtype, rows)


def v2_plan(B: int, T: int, H: int, dtype: torch.dtype) -> dict:
    """K16's two launches for B * H heads of T steps (``csrc/wkv7_v2.cu``).
    ``"chunk"``, phase 1: a block of ``V2_THREADS`` for each (b, h, 32-step
    chunk) and its dynamic shared memory (bf16 streams: the fp32 a_t, b_h,
    k_h, the bf16 r_t, b_h and k_h, b_bar^T, k_bar^T, v^T, sb and sk, and
    four vectors; fp32 streams: nine fp32 32 x 68 arrays
    and four 32 x 36). ``"state"``, phase 2: a block of ``V2_THREADS`` for
    each (b, h, slice of value columns of Z: with bf16 streams the most of
    ``V2_COLS`` that still give ``V2_BLOCKS`` blocks, else the fewest;
    ``V2_COLS_F32`` with fp32 streams) and its shared memory: ``V2_STAGES`` stages of q_eff
    and bta (rows padded by 16 bytes), the slice's y_loc and h_loc and
    p_last, then Z twice (bf16 Z^T with bf16 streams, fp32 Z with fp32).
    ``scratch_bytes``: what phase 1 writes and phase 2 reads, q_eff, y_loc,
    bta and h_loc a chunk in the scratch type (bf16 with bf16 streams, fp32
    with fp32) and p_last in fp32."""
    bf = dtype == torch.bfloat16
    esz = 2 if bf else 4
    nc = T // V2_CHUNK
    L, N = V2_CHUNK, 64
    if bf:
        p1 = 3 * L * (N + 4) * 4 + L * (N + 8) * 2 + max(2 * L * (N + 8), 2 * N * (L + 8)) * 2 \
            + 3 * N * (L + 8) * 2 + 2 * L * (L + 8) * 2 + 4 * N * 4
    else:
        p1 = (9 * L * (N + 4) + 4 * L * (L + 4)) * 4
    cols = next((n for n in V2_COLS if B * H * (N // n) >= V2_BLOCKS), V2_COLS[-1]) if bf else V2_COLS_F32
    ldq = N + 16 // esz
    stage = (L + N) * ldq * esz + (L + N) * cols * esz + N * 4
    z = 2 * cols * (N + 8) * 2 if bf else 2 * N * (cols + 4) * 4
    return {"chunk": {"blocks": B * H * nc, "threads": V2_THREADS, "smem_bytes": p1},
            "state": {"cols": cols, "blocks": B * H * (N // cols), "threads": V2_THREADS,
                      "stages": V2_STAGES, "smem_bytes": V2_STAGES * stage + z},
            "scratch_bytes": B * H * nc * ((2 * L * N + 2 * N * N) * esz + N * 4)}


def kernel_v2_plan(B: int, H: int, dtype: torch.dtype) -> dict:
    """The library's own numbers for K16's launches over B * H heads: phase
    1's shared memory, phase 2's value columns, stages and shared memory,
    and the scratch bytes a chunk."""
    lib = _v2_lib()
    code = _DTYPE_CODE[dtype]
    out = (ctypes.c_int * 3)()
    cuda_build.check(lib, lib.wkv7_v2_state_plan(code, B * H, out), "wkv7_v2_state_plan")
    return {"chunk_smem_bytes": lib.wkv7_v2_chunk_smem_bytes(code), "cols": out[0], "stages": out[1],
            "state_smem_bytes": out[2], "scratch_bytes_a_chunk": lib.wkv7_v2_scratch_bytes(code)}


def bwd_plan(B: int, T: int, H: int, dtype: torch.dtype) -> dict:
    """K6 / K13's two launches for B * H heads of T steps: ``"state"``, the
    first pass, is laid out as K5 (:func:`fwd_res_plan`); ``"chunk"``, the
    second, has a block of ``BWD_CHUNK_THREADS`` for each (b, h, chunk) and
    the dynamic shared memory ``csrc/wkv7_chunk_bwd.cuh``'s ``ChunkBwdSmem``
    lays out: r, w, k, a, b in the stream dtype; v, dy and nine fp32 16 x 68
    tiles (the factors az, bl, am, rm, bm, km, the running log decay g, u
    and dWpre; the eight 16 x 20 cotangent matrices take the place of az, bl
    and the four 16 x 16 matrices once the solves are done); the decay; Z0
    and dZ1 as 64 x 68. ``workspace_bytes``: the fp32 cotangent of the state
    leaving every chunk, zin's size, that the first pass writes and the second
    reads."""
    esz = 2 if dtype == torch.bfloat16 else 4
    ldp = 64 + 4
    tile = CHUNK * ldp * 4
    aliased = max(2 * tile + 4 * CHUNK * CHUNK * 4, 8 * CHUNK * (CHUNK + 4) * 4)
    smem = 5 * CHUNK * 64 * esz + 2 * tile + aliased + 7 * tile + 64 * 4 + 2 * 64 * ldp * 4
    return {"state": fwd_res_plan(B, H, dtype),
            "chunk": {"blocks": B * H * (T // CHUNK), "threads": BWD_CHUNK_THREADS, "smem_bytes": smem},
            "workspace_bytes": B * H * (T // CHUNK) * 64 * 64 * 4}


def kernel_smem_bytes(dtype: torch.dtype, rows: int) -> int:
    """The library's own count of a K1 / K5 / K11 / K12 block's shared memory
    (-1: it has no instantiation for ``rows``)."""
    return _lib().wkv7_fwd_res_smem_bytes(_DTYPE_CODE[dtype], rows)


def kernel_bwd_chunk_smem_bytes(dtype: torch.dtype) -> int:
    """The library's own count of a K6 / K13 second-pass block's shared
    memory."""
    return _train_lib().wkv7_bwd_chunk_smem_bytes(_DTYPE_CODE[dtype])


def _check_cuda(name: str, xs, device) -> None:
    for x in xs:
        if not x.is_cuda or x.device != device:
            raise ValueError(f"{name}: takes CUDA tensors on one device; got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def operand(x: Tensor, dtype: torch.dtype) -> Tensor:
    """``x`` as the kernels take it: in ``dtype``, contiguous and starting
    16-byte aligned (a copy only where ``x`` is not already so)."""
    x = x.to(dtype).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def stream_dtype(xs) -> torch.dtype:
    """The dtype the sequence kernels run a call's streams in: their common
    dtype where a kernel has it (fp32 or bf16), else fp32."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return dt if dt in _DTYPE_CODE else torch.float32


def run_streams(kernel, streams, initial_state) -> Tuple[Tensor, Tensor]:
    """A sequence kernel ``kernel(*streams, initial_state) -> (y, state)`` on
    streams of any float dtypes and layouts, as the plain path takes them:
    the streams become operands in their common dtype (:func:`stream_dtype`),
    the initial state an fp32 one. Returns (y in the first stream's dtype,
    the kernel's fp32 state)."""
    dt = stream_dtype(streams)
    s0 = None if initial_state is None else operand(initial_state, torch.float32)
    y, s = kernel(*(operand(x, dt) for x in streams), s0)
    return y.to(streams[0].dtype), s


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


def _check_pairs(name: str, H: int) -> None:
    if H % 2:
        raise ValueError(f"{name}: the packed kernels need an even head count; got H={H}")


def _fwd(name: str, get_lib, save: bool, streams, initial_state):
    """K1 / K5 / K11 / K12, one kernel laid out by :func:`fwd_res_plan`:
    (y, final state[, zin])."""
    r = streams[0]
    B, T, H, N = r.shape
    dev = r.device
    packed = name.endswith("_packed")
    if save and (T == 0 or T % CHUNK):
        raise ValueError(f"{name}: T={T} must be a positive multiple of {CHUNK}")
    if packed:
        _check_pairs(name, H)
    _check_streams(name, streams, (initial_state,))
    y = torch.empty_like(r)
    s_out = torch.empty(B, H, N, N, dtype=torch.float32, device=dev)
    zin = torch.empty(zin_shape(B, T, H, N, packed), dtype=torch.float32, device=dev) if save else None
    lib = get_lib()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(
            _DTYPE_CODE[r.dtype], fwd_res_plan(B, H, r.dtype)["rows"], B, T, H, N,
            *(x.data_ptr() for x in streams),
            _ptr(initial_state), y.data_ptr(), s_out.data_ptr(),
            *((zin.data_ptr(),) if save else ()), _stream(dev),
        )
    cuda_build.check(lib, err, name)
    cuda_build.LAUNCHES[name] += 1
    return (y, s_out, zin) if save else (y, s_out)


def _bwd(name: str, get_lib, streams, zin: Tensor, dsfinal: Tensor) -> Tuple[Tensor, ...]:
    """K6 / K13: the seven gradients; both passes launch on the current
    stream, the second reading the first's workspace (``torch.empty`` of
    zin's shape), and count one launch together."""
    r = streams[0]
    B, T, H, N = r.shape
    dev = r.device
    packed = name.endswith("_packed")
    _check_streams(name, streams, (dsfinal,))
    if packed:
        _check_pairs(name, H)
    if T == 0 or T % CHUNK:
        raise ValueError(f"{name}: T={T} must be a positive multiple of {CHUNK}")
    _check_cuda(name, (zin,), dev)
    want = zin_shape(B, T, H, N, packed)
    if zin.dtype != torch.float32 or zin.shape != want:
        raise ValueError(f"{name}: zin must be fp32 {want}; got {zin.dtype} {tuple(zin.shape)}")
    grads = [torch.empty_like(r) for _ in range(6)]
    ds0 = torch.empty(B, H, N, N, dtype=torch.float32, device=dev)
    dz1 = torch.empty_like(zin)
    lib = get_lib()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(
            _DTYPE_CODE[r.dtype], fwd_res_plan(B, H, r.dtype)["rows"], B, T, H, N,
            *(x.data_ptr() for x in streams[:6]), zin.data_ptr(), streams[6].data_ptr(),
            dsfinal.data_ptr(), *(g.data_ptr() for g in grads), ds0.data_ptr(), dz1.data_ptr(),
            _stream(dev),
        )
    cuda_build.check(lib, err, name)
    cuda_build.LAUNCHES[name] += 1
    return (*grads, ds0)


def wkv7_fwd(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
             initial_state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """K1: streams ``[B, T, H, 64]`` (all fp32 or all bf16), any T >= 0,
    optional fp32 initial state ``[B, H, 64, 64]``. The chunked kernel at
    chunk 16 (:func:`fwd_res_plan`), the steps past T of its last chunk
    masked to identity steps. Returns (y in the stream dtype, final fp32
    state)."""
    return _fwd("wkv7_fwd", _lib, False, (r, w_raw, k, v, a, b), initial_state)


def wkv7_fwd_res(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
                 initial_state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """K5: the forward that also saves the state entering every 16-step
    chunk (the chunked kernel; :func:`fwd_res_plan`). T must be a multiple
    of 16. Returns (y, final fp32 state, ``zin`` fp32
    ``[B*H, T/16, 64, 64]`` with ``zin[bh, c]`` the TRANSPOSE of the state
    before step ``16 c``, so ``zin[:, 0]`` is the transposed initial state)."""
    return _fwd("wkv7_fwd_res", _lib, True, (r, w_raw, k, v, a, b), initial_state)


def wkv7_bwd(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
             zin: Tensor, dy: Tensor, dsfinal: Tensor) -> Tuple[Tensor, ...]:
    """K6: the vector-Jacobian product of the recurrence from K5's saved
    states (the two-pass chunked kernel; :func:`bwd_plan`). T must be a
    multiple of 16. ``dy`` in the stream dtype ``[B, T, H, 64]``,
    ``dsfinal`` (the cotangent of the final state) fp32 ``[B, H, 64, 64]``.
    Returns (dr, dw_raw, dk, dv, da, db) in the stream dtype and the fp32
    cotangent of the initial state; all arithmetic fp32."""
    return _bwd("wkv7_bwd", _train_lib, (r, w_raw, k, v, a, b, dy), zin, dsfinal)


def _v2_args(name: str, streams, initial_state) -> Tuple[int, int, int]:
    r = streams[0]
    B, T, H, N = r.shape
    _check_streams(name, streams, (initial_state,))
    if T == 0 or T % V2_CHUNK:
        raise ValueError(f"{name}: T={T} must be a positive multiple of {V2_CHUNK}")
    return B, T, H


def v2_buffers(r: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """K16's outputs and scratch for streams shaped and typed as ``r``: (y,
    final state, scratch bytes), each ``torch.empty``."""
    B, T, H, N = r.shape
    lib = _v2_lib()
    scratch = torch.empty(B * H * (T // V2_CHUNK) * lib.wkv7_v2_scratch_bytes(_DTYPE_CODE[r.dtype]),
                          dtype=torch.uint8, device=r.device)
    return torch.empty_like(r), torch.empty(B, H, N, N, dtype=torch.float32, device=r.device), scratch


def _v2_call(name: str, phase: Optional[int], streams, initial_state, bufs) -> None:
    B, T, H = _v2_args(name, streams, initial_state)
    r = streams[0]
    dev = r.device
    y, s_out, scratch = bufs
    lib = _v2_lib()
    with torch.cuda.device(dev):
        args = (_DTYPE_CODE[r.dtype], B, T, H, 64, *(x.data_ptr() for x in streams), _ptr(initial_state),
                y.data_ptr(), s_out.data_ptr(), scratch.data_ptr(), _stream(dev))
        err = lib.wkv7_fwd_v2(*args) if phase is None else lib.wkv7_fwd_v2_phase(phase, *args)
    cuda_build.check(lib, err, name)
    cuda_build.LAUNCHES[name] += 1


def wkv7_fwd_v2(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
                initial_state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """K16: the chunked matrix form of :func:`wkv7_fwd` (chunk 32, two
    launches, :func:`v2_plan`: the chunk-local products of every chunk in
    parallel, then the boundary recurrence over slices of value columns),
    counterpart of the JAX package's ``wkv7_pallas_v2``. Streams ``[B, T,
    H, 64]`` (all fp32 or all bf16), T a positive multiple of 32, optional
    fp32 initial state. Returns (y in the stream dtype, final fp32 state).
    One call counts one launch of K16."""
    streams = (r, w_raw, k, v, a, b)
    _v2_args("wkv7_fwd_v2", streams, initial_state)
    bufs = v2_buffers(r)
    _v2_call("wkv7_fwd_v2", None, streams, initial_state, bufs)
    return bufs[0], bufs[1]


def wkv7_fwd_v2_phase(phase: int, r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor,
                      b: Tensor, initial_state: Optional[Tensor], bufs) -> None:
    """One phase of :func:`wkv7_fwd_v2` alone, into ``bufs`` (from
    :func:`v2_buffers`): 1 the chunk products into the scratch, 2 the
    boundary recurrence from it (y and the final state). It times the two
    phases apart; no path calls it, and it counts under its own name."""
    if phase not in (1, 2):
        raise ValueError(f"wkv7_fwd_v2_phase: phase must be 1 or 2; got {phase}")
    _v2_call("wkv7_fwd_v2_phase", phase, (r, w_raw, k, v, a, b), initial_state, bufs)


def wkv7_fwd_packed(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
                    initial_state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """K11: :func:`wkv7_fwd` under the head-pair implementation (H even); the
    same kernel, layouts and values, bit for bit."""
    return _fwd("wkv7_fwd_packed", _packed_lib, False, (r, w_raw, k, v, a, b), initial_state)


def wkv7_fwd_res_packed(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
                        initial_state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """K12: K5 with the saved states in the packed layout (:func:`zin_shape`);
    the same values as K5. T a multiple of 16, H even."""
    return _fwd("wkv7_fwd_res_packed", _packed_lib, True, (r, w_raw, k, v, a, b), initial_state)


def wkv7_bwd_packed(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
                    zin: Tensor, dy: Tensor, dsfinal: Tensor) -> Tuple[Tensor, ...]:
    """K13: :func:`wkv7_bwd` from the packed ``zin`` K12 saved; ``dsfinal``
    and the returned initial-state cotangent are ``[B, H, 64, 64]``."""
    return _bwd("wkv7_bwd_packed", _packed_lib, (r, w_raw, k, v, a, b, dy), zin, dsfinal)


def _step_args(name: str, flat: bool, state: Tensor, vecs) -> Tuple[int, int, dict]:
    """Check a step's state and vectors; (B, H, :func:`step_plan`)."""
    r = vecs[0]
    _check_cuda(name, (state,) + tuple(vecs), state.device)
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
    if any(x.data_ptr() % 16 for x in (state,) + tuple(vecs)):
        raise ValueError(f"{name}: the kernel reads 16 bytes at once; every tensor must start 16-byte aligned")
    return B, H, step_plan(B, H, state.dtype, flat)


def step_outputs(state: Tensor, r: Tensor, out) -> Tuple[Tensor, Tensor]:
    """A step's outputs: ``out`` = (new state, y), checked to be tensors the
    kernel may write (a state trail's slices), or new ones."""
    if out is None:
        return torch.empty_like(state), torch.empty_like(r)
    s_out, y = out
    for x, like in ((s_out, state), (y, r)):
        if x.shape != like.shape or x.dtype != like.dtype or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"step out: must be contiguous 16-byte aligned {like.dtype} "
                             f"{tuple(like.shape)}; got {x.dtype} {tuple(x.shape)}")
    return s_out, y


def _step(name: str, flat: bool, state: Tensor, vecs, out=None) -> Tuple[Tensor, Tensor]:
    B, H, plan = _step_args(name, flat, state, vecs)
    dev = state.device
    s_out, y = step_outputs(state, vecs[0], out)
    lib = _lib()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(
            _DTYPE_CODE[state.dtype], plan["rows"], B, H, 64, state.data_ptr(),
            *(x.data_ptr() for x in vecs), s_out.data_ptr(), y.data_ptr(), _stream(dev),
        )
    cuda_build.check(lib, err, name)
    cuda_build.LAUNCHES[name] += 1
    return s_out, y


def run_step(kernel, state: Tensor, vecs, extra=()) -> Tuple[Tensor, Tensor]:
    """A decode-step kernel on vectors ``[..., H, N]`` of any float dtype and
    layout and a state ``[..., H, Nv, Nk]`` (or flat ``[..., Nv, H*Nk]``) of
    any float dtype, as the plain steps take them: the leading dimensions
    fold into B, the vectors (and ``extra``, e.g. RWKV-6's bonus) become fp32
    contiguous operands, the state keeps its dtype where the kernel has it
    (fp32 or bf16, else fp32). Returns (new state in the kernel's state dtype
    and the state's shape, y in the vectors' dtype and shape)."""
    r = vecs[0]
    H, N = r.shape[-2:]
    sdt = state.dtype if state.dtype in (torch.float32, torch.bfloat16) else torch.float32
    s_in = operand(state, sdt)
    s_in = s_in.reshape((-1,) + tuple(state.shape[-(state.dim() - r.dim() + 2):]))
    xs = [operand(x, torch.float32).reshape(-1, H, N) for x in vecs]
    s, y = kernel(s_in, *xs, *(operand(x, torch.float32) for x in extra))
    return s.reshape(state.shape), y.reshape(r.shape).to(r.dtype)


def run_trail(kernel, streams, initial_state, extra=()) -> Tuple[Tensor, Tensor]:
    """A decode-step kernel (K2, K10) over a short window of streams ``[B, T,
    H, N]`` of any float dtype and layout, one launch a position, each
    writing its new state into the next slice of a state trail and reading
    the slice before. ``extra`` are further fp32 operands (RWKV-6's bonus).
    Returns (y ``[B, T, H, N]`` in the first stream's dtype, the trail fp32
    ``[B, T, H, N, N]``: ``[:, t]`` is the state after position t)."""
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad
                                       for x in (*streams, initial_state, *extra)):
        raise NotImplementedError("a state trail on CUDA has no backward: run it under torch.no_grad()")
    r = streams[0]
    B, T, H, N = r.shape
    f32 = torch.float32
    xs = [x.to(f32).transpose(0, 1).contiguous() for x in streams]  # [T, B, H, N]: x[t] contiguous
    ex = [operand(x, f32) for x in extra]
    s = (torch.zeros(B, H, N, N, device=r.device) if initial_state is None
         else operand(initial_state, f32))
    trail = torch.empty(T, B, H, N, N, device=r.device)
    y = torch.empty(T, B, H, N, device=r.device)
    for t in range(T):
        kernel(s, *(x[t] for x in xs), *ex, out=(trail[t], y[t]))
        s = trail[t]
    return y.transpose(0, 1).to(r.dtype), trail.transpose(0, 1)


def step_floor(state: Tensor, r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor,
               a: Tensor, b: Tensor) -> None:
    """The launch floor of :func:`wkv7_step` on these inputs: an empty kernel
    (``csrc/launch_floor.cu``) launched on K2's grid and block
    (:func:`step_plan`) with K2's arguments. It computes nothing and no path
    calls it; it is timed beside K2 / K4. The state is K2's ``[B, H, 64,
    64]``."""
    vecs = (r, w_raw, k, v, a, b)
    B, H, plan = _step_args("step_floor", False, state, vecs)
    dev = state.device
    lib = _floor_lib()
    with torch.cuda.device(dev):
        err = lib.launch_floor(plan["blocks"], plan["threads"], H, state.data_ptr(),
                               *(x.data_ptr() for x in vecs), state.data_ptr(), r.data_ptr(), _stream(dev))
    cuda_build.check(lib, err, "step_floor")
    cuda_build.LAUNCHES["step_floor"] += 1


def wkv7_step(state: Tensor, r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor,
              a: Tensor, b: Tensor, out=None) -> Tuple[Tensor, Tensor]:
    """K2: state ``[B, H, 64, 64]`` fp32 or bf16, vectors ``[B, H, 64]`` fp32
    (the decode step's dtype). Returns (new state in the state's dtype, fp32
    y), written into ``out`` = (state, y) when it is given (a slice of a
    state trail: ``ops.wkv7.wkv7_scan_states``)."""
    return _step("wkv7_step", False, state, (r, w_raw, k, v, a, b), out)


def wkv7_step_flat(state: Tensor, r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor,
                   a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """K4: K2 on the flat state ``[B, 64, H*64]`` (element ``[b, i, h*64 + j]``
    is ``S[b, h, i, j]``), fp32 or bf16. Returns (new state in the state's
    dtype and layout, fp32 y ``[B, H, 64]``)."""
    return _step("wkv7_step_flat", True, state, (r, w_raw, k, v, a, b))
