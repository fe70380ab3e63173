"""The CPU side of the chunked WKV7 backward, kernels K6 ``wkv7_bwd`` and
K13 ``wkv7_bwd_packed`` (one two-pass kernel pair,
``visualrwkv_torch/csrc/wkv7_chunk_bwd.cuh``): the kernels' arithmetic
written in a few lines of torch (pass 1, the cotangent recurrence over value
rows; pass 2, the chunk-local sums over them, with the factors referenced at
step 7), held against float64 autograd of the sequential scan and against
the JAX package's ``wkv7_pallas_bwd`` in interpret mode; the two passes'
launch plans, held equal to what ``chip_smoke.py`` logs; and how
``chip_smoke.py`` names the kernels in a profile and in ptxas's report.

The kernels themselves are held against ``wkv7_bwd_plain`` on the card by
``chip_smoke.py``.

Tolerances: relative Frobenius error <= 1e-4 against float64 autograd of
``wkv7_reference`` (fp32 arithmetic, whose rounding the two triangular
solves of a chunk amplify on the adversarial inputs); max |delta| <= 1e-4 *
max |ref| against the Pallas backward (the same chunk form in fp32, the
factors referenced at the chunk's start there)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_wkv7_chunked import _construction
from test_torch_wkv7_train import _case
from torch_port_helpers import max_rel, to_np
from visualrwkv_torch.ops import wkv7 as pw
from visualrwkv_torch.ops import wkv7_cuda
from visualrwkv_tpu.ops import wkv7_pallas as jp

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
BF, F32 = torch.bfloat16, torch.float32
SMEM_PER_SM = 233472  # bytes of shared memory of an H100 multiprocessor
SMEM_RESERVED = 1024  # kept back by CUDA for each resident block
L, MID = 16, 7  # the kernels' chunk and the reference step of their factors
GRAD_TOL = 1e-4
NAMES = ("dr", "dw_raw", "dk", "dv", "da", "db", "d(initial state)")


def _chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def _factors(R, W, K, A, Bb):
    """One chunk's factors, [..., L, N] each: the log decay's running sum g,
    the tiles against the state (at most 1) and the matrices' factors
    referenced at step 7 (each spanning at most 8 steps)."""
    lw = -torch.exp(W)
    g = torch.cumsum(lw, -2)
    gp, gm, gl = g - lw, g[..., MID:MID + 1, :], g[..., -1:, :]
    f = dict(g=g, gp=gp, gm=gm, gl=gl, lw=lw, at=A * torch.exp(gp), rt=R * torch.exp(g),
             bbar=Bb * torch.exp(gl - g), kbar=K * torch.exp(gl - g))
    am, rm, bm, km = A * torch.exp(gp - gm), R * torch.exp(g - gm), Bb * torch.exp(gm - g), K * torch.exp(gm - g)
    strict = torch.ones(L, L, dtype=torch.bool).tril(-1)
    incl = torch.ones(L, L, dtype=torch.bool).tril()
    tri = lambda x, y, mask: torch.where(mask, x @ y.transpose(-1, -2), 0.0)
    f.update(am=am, rm=rm, bm=bm, km=km, M=tri(am, bm, strict), Nm=tri(am, km, strict),
             sb=tri(rm, bm, incl), sk=tri(rm, km, incl), strict=strict, incl=incl)
    return f


def _back_solve(M, x):
    """(I - M)^{-T} x for strictly lower M, x [..., L, n]: x[t] += M[t', t] x[t'], t' > t."""
    x = x.clone()
    for tp in range(L - 1, 0, -1):
        x[..., :tp, :] += M[..., tp, :tp, None] * x[..., tp:tp + 1, :]
    return x


def _forward_solve(M, x):
    """(I - M)^{-1} x: x[t] += M[t, s] x[s], s < t."""
    x = x.clone()
    for t in range(1, L):
        x[..., t, :] += (M[..., t, :t, None] * x[..., :t, :]).sum(-2)
    return x


def _two_pass_bwd(r, w_raw, k, v, a, b, zin, dy, dsf):
    """The kernels' VJP in fp32. Streams and dy ``[B, T, H, N]``, zin
    ``[B*H, T/16, N, N]`` (Z = S^T entering each chunk), dsf ``[B, H, N, N]``.
    Returns (dr, dw_raw, dk, dv, da, db, d(initial state))."""
    B, T, H, N = r.shape
    nc = T // L
    heads = lambda x: x.permute(0, 2, 1, 3).reshape(B * H, nc, L, N)
    R, W, K, V, A, Bb, DY = (heads(x) for x in (r, w_raw, k, v, a, b, dy))
    f = _factors(R, W, K, A, Bb)
    tt = lambda x: x.transpose(-1, -2)
    # pass 1: the cotangent dZ' of the state leaving each chunk, walked in
    # reverse; dv on the way (no sum over value rows)
    dz = dsf.reshape(B * H, N, N).transpose(-1, -2)
    dz1, dv = [None] * nc, torch.empty_like(V)
    for c in reversed(range(nc)):
        fc = {key: x[:, c] if x.dim() == 4 else x for key, x in f.items()}
        dz1[c] = dz
        dw = _back_solve(fc["M"], tt(fc["sb"]) @ DY[:, c] + fc["bbar"] @ dz)
        dv[:, c] = tt(fc["sk"]) @ DY[:, c] + fc["kbar"] @ dz + tt(fc["Nm"]) @ dw
        dz = tt(torch.exp(fc["gl"])) * dz + tt(fc["rt"]) @ DY[:, c] + tt(fc["at"]) @ dw
    ds0 = dz.transpose(-1, -2).reshape(B, H, N, N)
    # pass 2: every chunk on its own, from the state entering it and dZ'
    Z0, DZ1 = zin, torch.stack(dz1, 1)
    u = _forward_solve(f["M"], f["Nm"] @ V + f["at"] @ Z0)
    dw = _back_solve(f["M"], tt(f["sb"]) @ DY + f["bbar"] @ DZ1)
    dM, dN = (torch.where(f["strict"], x, 0.0) for x in (dw @ tt(u), dw @ tt(V)))
    dSB, dSK = (torch.where(f["incl"], x, 0.0) for x in (DY @ tt(u), DY @ tt(V)))
    pa, pr = dw @ tt(Z0), DY @ tt(Z0)
    dbbar, dkbar = u @ tt(DZ1), V @ tt(DZ1)
    zz = (DZ1 * Z0).sum(-1)  # [.., N (j)]
    qa, qr = dM @ f["bm"] + dN @ f["km"], dSB @ f["bm"] + dSK @ f["km"]
    dbm, dkm = tt(dM) @ f["am"] + tt(dSB) @ f["rm"], tt(dN) @ f["am"] + tt(dSK) @ f["rm"]
    g, gp, gm, gl = f["g"], f["gp"], f["gm"], f["gl"]
    da = pa * torch.exp(gp) + qa * torch.exp(gp - gm)
    dr = pr * torch.exp(g) + qr * torch.exp(g - gm)
    el, em = torch.exp(gl - g), torch.exp(gm - g)
    db = dbm * em + dbbar * el
    dk = dkm * em + dkbar * el
    # d log w_s: every term of the chunk's outputs carries e^{sum of lw over
    # the steps it spans}, so each adds its value to the steps it crosses
    # (no sum over the whole chunk that cancels): y's r e^{g} Z0 part spans
    # s <= t, u's a e^{g_p} Z0 part s < t, a pair (t, t1) of sb / sk the
    # steps t1 < s <= t and of M / Nm t1 < s < t, bbar / kbar's t < s, and
    # e^{g_l} Z0 all of them
    xr = f["rm"][..., :, None, :] * (dSB[..., None] * f["bm"][..., None, :, :]
                                     + dSK[..., None] * f["km"][..., None, :, :])  # [.., t, t1, j]
    xa = f["am"][..., :, None, :] * (dM[..., None] * f["bm"][..., None, :, :]
                                     + dN[..., None] * f["km"][..., None, :, :])
    pr0, pa0, bb0 = R * torch.exp(g) * pr, A * torch.exp(gp) * pa, (Bb * dbbar + K * dkbar) * el
    dlw = torch.exp(gl) * zz[..., None, :].expand_as(pr0).clone()
    for s in range(L):
        dlw[..., s, :] += (pr0[..., s:, :].sum(-2) + pa0[..., s + 1:, :].sum(-2) + bb0[..., :s, :].sum(-2)
                           + xr[..., s:, :s, :].sum((-3, -2)) + xa[..., s + 1:, :s, :].sum((-3, -2)))
    dwr = dlw * f["lw"]  # d log w / d w_raw = -exp(w_raw) = lw
    back = lambda x: x.reshape(B, H, T, N).permute(0, 2, 1, 3)
    return (*(back(x) for x in (dr, dwr, dk, dv, da, db)), ds0)


def _states(xs, s0):
    """zin ``[B*H, T/16, N, N]`` of the float64 sequential scan."""
    B, T, H, N = xs[0].shape
    s, zs = s0, []
    for t in range(0, T, L):
        zs.append(s.transpose(-1, -2).reshape(B * H, 1, N, N))
        _, s = pw.wkv7_reference(*(x[:, t:t + L] for x in xs), s)
    return torch.cat(zs, 1)


@pytest.mark.parametrize("name", ["adversarial", "first_optimizer_step", "strongest_decay", "w_raw_2"])
def test_two_pass_vjp_matches_float64_autograd(name):
    """The two passes in fp32 against float64 autograd of ``wkv7_reference``
    at T=256 H=2, with an initial state and a non-zero cotangent of the
    final state: all seven gradients finite, relative Frobenius error <=
    1e-4. ``w_raw_2`` puts factors of e^{+-59} in every chunk."""
    xs = [torch.from_numpy(np.ascontiguousarray(x)) for x in _construction(name)]
    rng = np.random.default_rng(2)
    s0 = torch.from_numpy(rng.normal(size=(1, 2, 64, 64)) * 0.3)
    dy = torch.from_numpy(rng.normal(size=xs[0].shape) * 0.5)
    dsf = torch.from_numpy(rng.normal(size=(1, 2, 64, 64)) * 0.1)
    leaves = [x.clone().requires_grad_(True) for x in xs + [s0]]
    y, s = pw.wkv7_reference(*leaves[:6], leaves[6])
    ref = torch.autograd.grad((y, s), leaves, (dy, dsf))
    zin = _states(xs, s0).float()
    got = _two_pass_bwd(*(x.float() for x in xs), zin, dy.float(), dsf.float())
    for what, g, g_ref in zip(NAMES, got, ref):
        assert torch.isfinite(g).all(), what
        rel = float((g.double() - g_ref).norm() / g_ref.norm())
        assert rel <= GRAD_TOL, (name, what, rel)


def test_two_pass_vjp_matches_jax_pallas_bwd():
    """The two passes against ``wkv7_pallas_bwd`` (interpret mode) at B=2
    T=48 H=2 from the Pallas forward's own saved states."""
    B, T, H = 2, 48, 2
    args, s0, dy, ds = _case(B, T, H, seed=5)
    jargs = [jnp.asarray(x) for x in args]
    _, _, zin = jp.wkv7_pallas_fwd_res(*jargs, jnp.asarray(s0), chunk=16)
    g_pallas = jp.wkv7_pallas_bwd(*jargs, zin, jnp.asarray(dy), jnp.asarray(ds), chunk=16)
    got = _two_pass_bwd(*(torch.from_numpy(x) for x in args), torch.from_numpy(np.array(zin)),
                        torch.from_numpy(dy), torch.from_numpy(ds))
    for what, g, ref in zip(NAMES, got, g_pallas):
        assert max_rel(to_np(g), np.asarray(ref)) < GRAD_TOL, what


# (B, H, stream dtype) -> pass 1's (value rows a block, blocks, threads,
# shared bytes) and pass 2's (blocks at T=2048, threads, shared bytes): the
# smoke's training shape (x070 1B5, B=2 H=32; K13 too), B*H = 18, a head
# pair alone and B*H = 128.
PLANS = {
    (2, 32, BF): ((32, 128, 256, 105472), (8192, 256, 97280)),
    (2, 32, F32): ((32, 128, 256, 139264), (8192, 256, 107520)),
    (3, 6, F32): ((16, 72, 128, 130816), (2304, 256, 107520)),
    (1, 2, BF): ((16, 8, 128, 98560), (256, 256, 97280)),
    (2, 64, BF): ((64, 128, 256, 119296), (16384, 256, 97280)),
}


@pytest.mark.parametrize("B,H,dtype", list(PLANS), ids=[f"B{b}H{h}-{str(d)[6:]}" for b, h, d in PLANS])
def test_bwd_plan(B, H, dtype):
    """Each pass's launch at T=2048: pass 1 is laid out as K5 (every value
    row of every head in one block, 8 threads a row, 4 at 64 rows); pass 2
    has a block of 256 threads for each (b, h, chunk), two of which fit on a
    multiprocessor; ``chip_smoke.wkv7_bwd_plan`` logs the same plan."""
    plan = wkv7_cuda.bwd_plan(B, 2048, H, dtype)
    p1, p2 = plan["state"], plan["chunk"]
    want1, want2 = PLANS[(B, H, dtype)]
    assert (p1["rows"], p1["blocks"], p1["threads"], p1["smem_bytes"]) == want1
    assert (p2["blocks"], p2["threads"], p2["smem_bytes"]) == want2
    assert p1 == wkv7_cuda.fwd_res_plan(B, H, dtype)  # pass 1 runs K5's layout
    assert p1["blocks"] * p1["rows"] == B * H * 64 and p2["blocks"] == B * H * 2048 // L
    assert p1["smem_bytes"] + SMEM_RESERVED <= SMEM_PER_SM
    assert 2 * (p2["smem_bytes"] + SMEM_RESERVED) <= SMEM_PER_SM
    assert plan["workspace_bytes"] == B * H * 2048 // L * 64 * 64 * 4


@pytest.mark.parametrize("zheads", [1, 2])
@pytest.mark.parametrize("dt", [0, 1])
def test_chip_smoke_names_both_passes(zheads, dt):
    """A profiler's demangled names of the two passes,
    ``wkv7_bwd_state_kernel<DT, ROWS, ZHEADS>`` and
    ``wkv7_bwd_chunk_kernel<DT, ZHEADS>``, are K13 with ZHEADS 2, else K6."""
    cs = _chip_smoke()
    s = "__nv_bfloat16" if dt else "float"
    want = "K13 wkv7_bwd_packed" if zheads == 2 else "K6 wkv7_bwd"
    state = (f"void (anonymous namespace)::wkv7_bwd_state_kernel<{dt}, 32, {zheads}>(int, int, "
             f"{s} const*, {s} const*, {s} const*, {s} const*, {s} const*, {s} const*, float const*, "
             f"{s}*, float*, float*, int)")
    chunk = (f"void (anonymous namespace)::wkv7_bwd_chunk_kernel<{dt}, {zheads}>(int, int, {s} const*, "
             f"{s} const*, {s} const*, {s} const*, {s} const*, {s} const*, {s} const*, float const*, "
             f"float const*, {s}*, {s}*, {s}*, {s}*, {s}*, int)")
    assert cs._category(state) == want
    assert cs._category(chunk) == want


def test_chip_smoke_keys_ptxas_report_of_both_passes():
    """``parse_ptxas`` keys the passes by their template arguments, as phase
    1's no-spill check reads them."""
    cs = _chip_smoke()
    report = (
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__1a2b3c4d_13_wkv7_train_cu_0123abcd21wkv7_"
        "bwd_state_kernelILi1ELi32ELi1EEEviiPKNSt11conditionalIXeqT_Li1EE13__nv_bfloat16fE4typeES6_S6_S6_"
        "S6_S6_PKfPS4_PfSA_i' for 'sm_90a'\n"
        "ptxas info    : Used 120 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__1a2b3c4d_13_wkv7_train_cu_0123abcd21wkv7_"
        "bwd_chunk_kernelILi0ELi2EEEviiPKNSt11conditionalIXeqT_Li1EE13__nv_bfloat16fE4typeES6_S6_S6_S6_S6_"
        "S6_PKfS8_PS4_S9_S9_S9_S9_i' for 'sm_90a'\n"
        "    16 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers, 16 bytes cumulative stack size\n"
    )
    cs.PTXAS.clear()
    cs.parse_ptxas("wkv7_train", report)
    assert cs.PTXAS[("wkv7_train", "wkv7_bwd_state_kernel", (1, 32, 1))] == {"registers": 120}
    assert cs.PTXAS[("wkv7_train", "wkv7_bwd_chunk_kernel", (0, 2))] == {"spill_bytes": 16, "registers": 128}
    cs.PTXAS.clear()


def _streams(B, T, H, dtype=F32):
    return [torch.zeros(B, T, H, 64, dtype=dtype) for _ in range(6)]


@pytest.mark.parametrize("name", ["wkv7_bwd", "wkv7_bwd_packed"])
def test_wrappers_refuse_cpu_tensors(name):
    xs = _streams(1, 32, 2)
    zin = torch.zeros(wkv7_cuda.zin_shape(1, 32, 2, 64, name.endswith("packed")))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        getattr(wkv7_cuda, name)(*xs, zin, xs[0], torch.zeros(1, 2, 64, 64))
