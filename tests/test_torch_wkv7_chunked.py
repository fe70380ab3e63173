"""The CPU side of the chunked WKV7 forward, kernels K5 ``wkv7_fwd_res``
and K12 ``wkv7_fwd_res_packed`` (the training forward) and K1 ``wkv7_fwd``
and K11 ``wkv7_fwd_packed`` (the prefill forward, the same kernel without
the saved states, at any T), one kernel in
``visualrwkv_torch/csrc/wkv7_chunk.cuh``: the row-slice plan
``wkv7_cuda.fwd_res_plan`` that the wrappers pass to the kernel, the
wrappers' refusals (checked before any library is loaded), how
``chip_smoke.py`` names the kernels' instantiations in a profile and in
ptxas's report, and the kernel's factorisation of a 16-step chunk written in
a few lines of torch, with its mask of the steps past T in the last chunk,
held against the sequential scan in float64.

The kernels' arithmetic is held against the plain versions on the card by
``chip_smoke.py``; the plain versions against the JAX package in
``tests/test_torch_wkv7_train.py`` and ``tests/test_torch_wkv7_packed.py``.

Tolerance of the factorisation: relative RMS <= 1e-5 against the float64
scan. It is fp32 arithmetic (the kernel's), whose rounding reads 1e-7 to
4e-7 on these inputs; the amplification of the solve on the adversarial
input (docs/wkv_chunk_stability.md) stays below 1e-5 in fp32."""

import os
import sys

import numpy as np
import pytest
import torch

from visualrwkv_torch.ops import wkv7 as pw
from visualrwkv_torch.ops import wkv7_cuda

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
BF, F32 = torch.bfloat16, torch.float32
SMEM_PER_SM = 233472  # bytes of shared memory of an H100 multiprocessor
SMEM_RESERVED = 1024  # kept back by CUDA for each resident block
L, MID = 16, 7  # the kernel's chunk and the reference step of its factors


def _chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


# (B, H, stream dtype) -> (value rows a block, blocks, threads, shared bytes):
# the smoke's training shape (x070 1B5, B=2 H=32; K12 too), B*H = 18 (the
# smoke's uneven case: 16 rows, 72 blocks), a head pair alone (the packed
# kernel's smallest H), B*H = 128 (64 rows), and K1 / K11's prefill shapes:
# one request (B=1 H=32, bf16 and fp32 streams) and the serving batch (B=4).
PLANS = {
    (1, 32, BF): (16, 128, 128, 98560),
    (1, 32, F32): (16, 128, 128, 130816),
    (4, 32, BF): (64, 128, 256, 119296),
    (2, 32, BF): (32, 128, 256, 105472),
    (2, 32, F32): (32, 128, 256, 139264),
    (3, 6, F32): (16, 72, 128, 130816),
    (3, 6, BF): (16, 72, 128, 98560),
    (1, 2, BF): (16, 8, 128, 98560),
    (2, 64, BF): (64, 128, 256, 119296),
    (4, 32, F32): (64, 128, 256, 156160),
}


@pytest.mark.parametrize("B,H,dtype", list(PLANS), ids=[f"B{b}H{h}-{str(d)[6:]}" for b, h, d in PLANS])
def test_fwd_res_plan(B, H, dtype):
    """Rows a block, blocks, threads and shared memory at each shape: every
    value row of every head in exactly one block, 8 threads a row (4 at 64
    rows), and a block fits on a multiprocessor."""
    plan = wkv7_cuda.fwd_res_plan(B, H, dtype)
    assert (plan["rows"], plan["blocks"], plan["threads"], plan["smem_bytes"]) == PLANS[(B, H, dtype)]
    assert plan["rows"] in wkv7_cuda.FWD_RES_ROWS and plan["blocks"] * plan["rows"] == B * H * 64
    assert plan["threads"] == plan["rows"] * (4 if plan["rows"] == 64 else 8)
    assert plan["smem_bytes"] + SMEM_RESERVED <= SMEM_PER_SM


def _streams(B, T, H, dtype=F32):
    return [torch.zeros(B, T, H, 64, dtype=dtype) for _ in range(6)]


@pytest.mark.parametrize("name", ["wkv7_fwd_res", "wkv7_fwd_res_packed"])
def test_wrappers_refuse_cpu_tensors(name):
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        getattr(wkv7_cuda, name)(*_streams(1, 32, 2), None)


@pytest.mark.parametrize("name", ["wkv7_fwd", "wkv7_fwd_packed"])
@pytest.mark.parametrize("T", [0, 24])
def test_k1_k11_take_any_t_and_refuse_only_the_device(name, T):
    """K1 / K11 take any T: a CPU tensor of a length that is not a multiple
    of 16 is refused for its device, not its length."""
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        getattr(wkv7_cuda, name)(*_streams(1, T, 2), None)


@pytest.mark.parametrize("name", ["wkv7_fwd_res", "wkv7_fwd_res_packed"])
@pytest.mark.parametrize("T", [0, 24])
def test_wrappers_refuse_t_not_a_multiple_of_16(name, T):
    """T is checked before the device: a CPU tensor of a bad length is
    refused for its length."""
    with pytest.raises(ValueError, match="multiple of 16"):
        getattr(wkv7_cuda, name)(*_streams(1, T, 2), None)


def test_k12_refuses_an_odd_head_count():
    with pytest.raises(ValueError, match="even head count"):
        wkv7_cuda.wkv7_fwd_res_packed(*_streams(1, 32, 3), None)


def _kernel_name(dt, rows, zheads, save):
    stream = "__nv_bfloat16" if dt else "float"
    return (f"void (anonymous namespace)::wkv7_fwd_res_kernel<{dt}, {rows}, {zheads}, {save}>(int, int, "
            f"{stream} const*, {stream} const*, {stream} const*, {stream} const*, {stream} const*, "
            f"{stream} const*, float const*, {stream}*, float*, float*)")


@pytest.mark.parametrize("zheads", [1, 2])
@pytest.mark.parametrize("dt", [0, 1])
@pytest.mark.parametrize("rows", [16, 32, 64])
def test_chip_smoke_names_the_instantiations(zheads, dt, rows):
    """A profiler's demangled kernel name ``wkv7_fwd_res_kernel<DT, ROWS,
    ZHEADS, 1>`` (SAVE) is K12 with ZHEADS 2, else K5, at every stream dtype
    and row count."""
    cs = _chip_smoke()
    name = _kernel_name(dt, rows, zheads, 1)
    assert cs._category(name) == ("K12 wkv7_fwd_res_packed" if zheads == 2 else "K5 wkv7_fwd_res")


@pytest.mark.parametrize("stream,heads,want", [("float", 1, "K1 wkv7_fwd"), ("__nv_bfloat16", 1, "K1 wkv7_fwd"),
                                               ("float", 2, "K11 wkv7_fwd_packed"),
                                               ("__nv_bfloat16", 2, "K11 wkv7_fwd_packed")])
def test_chip_smoke_still_names_k1_and_k11(stream, heads, want):
    """The prefill forward, ``wkv7_fwd_res_kernel<DT, ROWS, ZHEADS, 0>``
    (the chunked kernel without SAVE), is K1 on heads and K11 with the
    head-pair instantiation, at every row count, apart from K5 / K12."""
    cs = _chip_smoke()
    for rows in (16, 32, 64):
        assert cs._category(_kernel_name(int(stream != "float"), rows, heads, 0)) == want


def test_chip_smoke_keys_ptxas_report_of_k5_k12():
    """``parse_ptxas`` keys K1 / K5 / K11 / K12 by (dtype code, ROWS,
    ZHEADS, SAVE), as phase 1's no-spill check and the plans' log read them
    (ptxas's own lines as it reports a K5 and a K11 instantiation)."""
    cs = _chip_smoke()
    report = (
        "ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__88addf68_7_wkv7_cu_e1c8fcb119wkv7_fwd_res_"
        "kernelILi1ELi32ELi1ELi1EEEviiPKNSt11conditionalIXeqT_Li1EE13__nv_bfloat16fE4typeES6_S6_S6_S6_S6_PKfPS4"
        "_PfSA_' for 'sm_90a'\n"
        "ptxas info    : Used 121 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__73a7fe83_14_wkv7_packed_cu_e1c8fcb119wkv7_"
        "fwd_res_kernelILi0ELi16ELi2ELi0EEEviiPKNSt11conditionalIXeqT_Li1EE13__nv_bfloat16fE4typeES6_S6_S6_S6"
        "_S6_PKfPS4_PfSA_' for 'sm_90a'\n"
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size\n"
    )
    cs.PTXAS.clear()
    cs.parse_ptxas("wkv7", report)
    assert cs.PTXAS[("wkv7", "wkv7_fwd_res_kernel", (1, 32, 1, 1))] == {"registers": 121}
    assert cs.PTXAS[("wkv7", "wkv7_fwd_res_kernel", (0, 16, 2, 0))] == {"spill_bytes": 8, "registers": 128}
    cs.PTXAS.clear()


def _chunk_form(r, w_raw, k, v, a, b, s0):
    """The kernel's arithmetic in fp32: per 16-step chunk, the log decay's
    running sum g, the matrices' factors referenced at step 7, the solve by
    forward substitution, y and the state update (the "u form"). Any T: the
    steps of the last chunk past T are the kernel's identity steps, their
    streams zero (as its zero-filled loads) and their log decay exactly 0;
    their y is dropped."""
    B, T, H, N = r.shape
    Tp = -(-T // L) * L
    pad = lambda x: torch.cat([x, x.new_zeros(B, Tp - T, H, N)], 1)
    r, w_raw, k, v, a, b = (pad(x) for x in (r, w_raw, k, v, a, b))
    valid = (torch.arange(Tp) < T).view(1, Tp, 1, 1)
    lw_all = torch.where(valid, -torch.exp(w_raw), torch.zeros((), dtype=r.dtype))
    z = s0.transpose(-1, -2).clone()  # Z = S^T: column i is value row i of S
    strict = torch.ones(L, L, dtype=torch.bool).tril(-1)
    incl = torch.ones(L, L, dtype=torch.bool).tril()
    ys = []
    for c in range(0, Tp, L):
        R, LW, K, V, A, Bb = (x[:, c:c + L].transpose(1, 2) for x in (r, lw_all, k, v, a, b))
        g = torch.cumsum(LW, 2)
        gp, gm, gl = g - LW, g[:, :, MID:MID + 1], g[:, :, -1:]
        am, rm = A * torch.exp(gp - gm), R * torch.exp(g - gm)
        bm, km = Bb * torch.exp(gm - g), K * torch.exp(gm - g)
        tri = lambda x, y, mask: torch.where(mask, x @ y.transpose(-1, -2), 0.0)
        M, Nm, sb, sk = tri(am, bm, strict), tri(am, km, strict), tri(rm, bm, incl), tri(rm, km, incl)
        u = Nm @ V + (A * torch.exp(gp)) @ z
        for t in range(1, L):  # u[t] += M[t, :t] u[:t]
            u[:, :, t] += (M[:, :, t, :t, None] * u[:, :, :t]).sum(2)
        ys.append((R * torch.exp(g)) @ z + sb @ u + sk @ V)
        e = torch.exp(gl - g)
        z = torch.exp(gl).transpose(-1, -2) * z + (Bb * e).transpose(-1, -2) @ u + (K * e).transpose(-1, -2) @ V
    y = torch.cat(ys, 2).transpose(1, 2) if ys else r.new_zeros(B, 0, H, N)
    return y[:, :T], z.transpose(-1, -2)


def _construction(name, T=256, H=2, N=64, seed=0):
    """The adversarial and first-optimizer-step inputs of
    tests/test_wkv7_stability.py, the models' strongest decay (w_raw = -0.5)
    on every channel with |r| <= 1e-3 on a quarter, and w_raw = 2.0 on every
    channel (factors of e^{+-59} over a chunk)."""
    rng = np.random.default_rng(seed)
    shp = (1, T, H, N)
    r, v = rng.normal(size=shp) * 0.5, rng.normal(size=shp) * 0.5
    if name == "adversarial":
        u = rng.normal(size=(H, N))
        kk = np.broadcast_to(u / np.linalg.norm(u, axis=-1, keepdims=True), shp)
        kk = kk * ((-1.0) ** np.arange(T))[None, :, None, None]
        return r, np.full(shp, -7.0), rng.normal(size=shp) * 0.05, v, -kk, kk * 0.9
    if name == "first_optimizer_step":
        kf = rng.normal(size=(H, N))[None, None] + 0.15 * rng.normal(size=shp)
        kk = kf / np.linalg.norm(kf, axis=-1, keepdims=True)
        kk = kk * np.where(rng.random((1, T, 1, 1)) < 0.35, -1.0, 1.0)
        return r, np.full(shp, -6.0), rng.normal(size=shp) * 0.05, v, -kk, kk * 0.85
    k = rng.normal(size=shp) * 0.5
    kk = rng.normal(size=shp)
    kk /= np.linalg.norm(kk, axis=-1, keepdims=True)
    gate = rng.uniform(0, 1, shp)
    if name == "strongest_decay":
        r[..., ::4] = rng.uniform(-1e-3, 1e-3, r[..., ::4].shape)
        w_raw = np.full(shp, -0.5)
    else:  # "w_raw_2"
        w_raw = np.full(shp, 2.0)
    return r, w_raw, k, v, -kk, kk * gate


@pytest.mark.parametrize("name", ["adversarial", "first_optimizer_step", "strongest_decay", "w_raw_2"])
def test_chunk_factorisation_matches_sequential_scan(name):
    """The factorisation K5 / K12 compute, in fp32, against ``wkv7_reference``
    in float64 at T=256 H=2 with an initial state: y and the final state."""
    xs = [torch.from_numpy(np.ascontiguousarray(x)) for x in _construction(name)]
    s0 = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 2, 64, 64)) * 0.3)
    y_ref, s_ref = pw.wkv7_reference(*xs, s0)
    y, s = _chunk_form(*(x.float() for x in xs), s0.float())
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    rel = lambda x, ref: float((x.double() - ref).norm() / ref.norm())
    assert rel(y, y_ref) <= 1e-5, rel(y, y_ref)
    assert rel(s, s_ref) <= 1e-5, rel(s, s_ref)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", [1, 9, 24, 250])
def test_masked_last_chunk_matches_sequential_scan(T, with_state):
    """K1 / K11's mask of the last chunk, in the factorisation: at T that
    is not a multiple of 16 (1 and 9 inside the first chunk, 24 and 250 a
    partial chunk after whole ones), y and the final state against
    ``wkv7_reference`` in float64, with and without an initial state."""
    rng = np.random.default_rng(T)
    shp = (2, T, 2, 64)
    r, k, v = (rng.normal(size=shp) * 0.5 for _ in range(3))
    w_raw = -np.log1p(np.exp(-rng.normal(size=shp) * 2 - 1)) - 0.5
    kk = rng.normal(size=shp)
    kk /= np.linalg.norm(kk, axis=-1, keepdims=True)
    xs = [torch.from_numpy(x) for x in (r, w_raw, k, v, -kk, kk * rng.uniform(0, 1, shp))]
    s0 = torch.from_numpy(rng.normal(size=(2, 2, 64, 64)) * 0.3) if with_state else None
    y_ref, s_ref = pw.wkv7_reference(*xs, s0)
    y, s = _chunk_form(*(x.float() for x in xs), torch.zeros(2, 2, 64, 64) if s0 is None else s0.float())
    assert y.shape == (2, T, 2, 64)
    rel = lambda x, ref: float((x.double() - ref).norm() / ref.norm())
    assert rel(y, y_ref) <= 1e-5, rel(y, y_ref)
    assert rel(s, s_ref) <= 1e-5, rel(s, s_ref)
