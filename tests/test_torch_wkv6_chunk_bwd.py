"""The CPU side of the chunked WKV6 backward, kernel K9 ``wkv6_bwd`` (two
kernels, ``visualrwkv_torch/csrc/wkv6_chunk_bwd.cuh``): the kernels'
arithmetic written in a few lines of torch (pass 1, the cotangent recurrence
over value rows, K8's walk in reverse; pass 2, the chunk-local sums over them,
each pair factor one exp2 of its difference and d log w summed over the
steps each term spans), held against float64 autograd of the floored
sequential scan and against the JAX package's ``wkv6_pallas_bwd`` in
interpret mode; the two passes' launch plans, held equal to what
``chip_smoke.py`` logs; and how ``chip_smoke.py`` names the kernels in a
profile and in ptxas's report.

The kernels themselves are held against ``wkv6_bwd_plain`` and fp32 autograd
of the floored scan on the card by ``chip_smoke.py``.

Tolerances: relative Frobenius error <= 1e-4 against float64 autograd of
``wkv6_reference`` (fp32 arithmetic over 16-step chunks, where the factors of
a chunk at the floor of chunk_len 1 span up to 2^-1700); max |delta| <= 1e-4
* max |ref| against the Pallas backward (the same chunk form in fp32, with
e^{+-g} factors and d log w as r dr - k dk summed over the chunk)."""

import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_wkv6 import _case
from torch_port_helpers import max_rel, to_np
from visualrwkv_torch.ops import wkv6 as pw
from visualrwkv_torch.ops import wkv6_cuda
from visualrwkv_tpu.ops import wkv6_pallas as jp

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
BF, F32 = torch.bfloat16, torch.float32
SMEM_PER_SM = 233472  # bytes of shared memory of an H100 multiprocessor
SMEM_RESERVED = 1024  # kept back by CUDA for each resident block
L = 16  # the kernels' chunk
LOG2E = 1.4426950408889634
GRAD_TOL = 1e-4
NAMES = ("dr", "dw_raw", "dk", "dv", "du", "d(initial state)")


def _chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def chunk_factors(w_raw, chunk_len):
    """A 16-step chunk's decay in log2 units, [..., 16, N] each: the floored
    log decay lw, its running sum g, g_p (the previous step's g, as the
    kernels keep it), g_l (step 15's g) and the pair factors [..., t, s, N] =
    2^(g_p,t - g_s) for s < t (one exp2 a pair), 0 elsewhere."""
    lw = torch.clamp_min(-torch.exp(w_raw), -80.0 / chunk_len) * LOG2E
    g = torch.cumsum(lw, -2)
    gp = torch.cat([torch.zeros_like(g[..., :1, :]), g[..., :-1, :]], -2)
    strict = torch.ones(L, L, dtype=torch.bool).tril(-1)
    pair = torch.exp2(torch.clamp_max(gp[..., :, None, :] - g[..., None, :, :], 0.0))
    return lw, g, gp, g[..., -1:, :], torch.where(strict[:, :, None], pair, 0.0)


def _heads(x, B, T, H):
    return x.float().permute(0, 2, 1, 3).reshape(B * H, T // L, L, x.shape[-1])


def _matrix(R, K, u_bh, pair):
    """A of every chunk: the strict part sum_j r_tj k_sj pair_tsj, the bonus
    sum_j u_j k_tj r_tj on the diagonal."""
    sk = torch.einsum("...tj,...sj,...tsj->...ts", R, K, pair)
    return sk + torch.diag_embed((u_bh[:, None, None, :] * K * R).sum(-1))


def per_pair_fwd(r, w_raw, k, v, u, s0, chunk_len):
    """K7 / K8's factor form 2 in fp32 (any floor): streams [B, T, H, N], T a
    multiple of 16. Returns (y, final state)."""
    B, T, H, N = r.shape
    R, W, K, V = (_heads(x, B, T, H) for x in (r, w_raw, k, v))
    u_bh = u.float().repeat(B, 1)
    _, g, gp, gl, pair = chunk_factors(W, chunk_len)
    A = _matrix(R, K, u_bh, pair)
    rq, kb, dec = R * torch.exp2(gp), K * torch.exp2(gl - g), torch.exp2(gl)
    Z = (torch.zeros(B * H, N, N) if s0 is None else s0.float().reshape(B * H, N, N).transpose(-1, -2))
    ys = []
    for c in range(T // L):
        ys.append(rq[:, c] @ Z + A[:, c] @ V[:, c])
        Z = dec[:, c, 0, :, None] * Z + kb[:, c].transpose(-1, -2) @ V[:, c]
    y = torch.stack(ys, 1).reshape(B, H, T, N).permute(0, 2, 1, 3)
    return y, Z.transpose(-1, -2).reshape(B, H, N, N)


def two_pass_bwd(r, w_raw, k, v, u, zin, dy, dsf, chunk_len):
    """K9's VJP in fp32. Streams and dy ``[B, T, H, N]``, zin
    ``[B*H, T/16, N, N]`` (Z = S^T entering each chunk), dsf ``[B, H, N, N]``.
    Returns (dr, dw_raw, dk, dv, du, d(initial state))."""
    B, T, H, N = r.shape
    nc = T // L
    R, W, K, V, DY = (_heads(x, B, T, H) for x in (r, w_raw, k, v, dy))
    u_bh = u.float().repeat(B, 1)
    _, g, gp, gl, pair = chunk_factors(W, chunk_len)
    A = _matrix(R, K, u_bh, pair)
    rq, kb, dec = R * torch.exp2(gp), K * torch.exp2(gl - g), torch.exp2(gl)
    tt = lambda x: x.transpose(-1, -2)
    # pass 1: the cotangent dZ of the state leaving each chunk, walked in
    # reverse; dv on the way (no sum over value rows)
    dz = tt(dsf.float().reshape(B * H, N, N))
    dz1, dv = [None] * nc, torch.empty_like(V)
    for c in reversed(range(nc)):
        dz1[c] = dz
        dv[:, c] = tt(A[:, c]) @ DY[:, c] + kb[:, c] @ dz
        dz = dec[:, c, 0, :, None] * dz + tt(rq[:, c]) @ DY[:, c]
    ds0 = tt(dz).reshape(B, H, N, N)
    # pass 2: every chunk on its own, from the state entering it and dZ1
    Z0, DZ1 = zin.float(), torch.stack(dz1, 1)
    strict = torch.ones(L, L, dtype=torch.bool).tril(-1)
    dsk = torch.where(strict, DY @ tt(V), 0.0)
    q = (DY * V).sum(-1, keepdim=True)  # the bonus's cotangent a step
    p_r, p_k = DY @ tt(Z0), V @ tt(DZ1)
    zz = (DZ1 * Z0).sum(-1)  # [.., N (j)]
    x_r = dsk[..., None] * pair * K[..., None, :, :]  # [t, s, j]: dSK_ts e_ts k_s
    x_k = dsk[..., None] * pair * R[..., :, None, :]  # dSK_ts e_ts r_t
    uu = u_bh[:, None, None, :]
    dr = p_r * torch.exp2(gp) + x_r.sum(-2) + q * uu * K
    dk = x_k.sum(-3) + p_k * torch.exp2(gl - g) + q * uu * R
    du = (q * K * R).reshape(B, H, nc * L, N).sum((0, 2))
    # d log w_s: each term of the chunk's outputs adds to the steps it spans
    # (no sum over the whole chunk that cancels): y's r e^{g_p} Z0 part the
    # steps before t, a pair (t, s) of sk the steps strictly between, the
    # k e^{g_l - g} Z1 part the steps after, and e^{g_l} Z0 every step
    x_pair = x_r * R[..., :, None, :]
    y0, z1 = R * torch.exp2(gp) * p_r, K * torch.exp2(gl - g) * p_k
    dlw = torch.exp2(gl) * zz[..., None, :].expand_as(y0).clone()
    for s in range(L):
        dlw[..., s, :] += (y0[..., s + 1:, :].sum(-2) + z1[..., :s, :].sum(-2)
                           + x_pair[..., s + 1:, :s, :].sum((-3, -2)))
    lw_nat = -torch.exp(W)
    dwr = torch.where(lw_nat > -80.0 / chunk_len, dlw * lw_nat, 0.0)
    back = lambda x: x.reshape(B, H, T, N).permute(0, 2, 1, 3)
    return (*(back(x) for x in (dr, dwr, dk, dv)), du, ds0)


def _states(xs, u, s0, chunk_len):
    """zin ``[B*H, T/16, N, N]`` of the float64 sequential scan."""
    B, T, H, N = xs[0].shape
    s, zs = s0, []
    for t in range(0, T, L):
        zs.append(s.transpose(-1, -2).reshape(B * H, 1, N, N))
        _, s = pw.wkv6_reference(*(x[:, t:t + L] for x in xs), u, s, chunk=chunk_len)
    return torch.cat(zs, 1)


# (name, chunk_len): the decay drawn across the floor at chunk 16; the floor
# binding on every channel at chunk 16 with |r| <= 1e-3 on every fourth
# channel; w_raw = 2.0 on every channel (e^-7.4 a step) at chunk 8, off its
# floor -10; the decay drawn across the floors of chunk_len 4 (-20) and 1
# (-80); w_raw = 4.3 on every channel at chunk 1 (e^-74 a step, off the floor).
GRAD_CASES = (("across the floor", 16), ("floor, tiny r", 16), ("w_raw = 2.0", 8), ("across the floor", 4),
              ("across the floor", 1), ("w_raw = 4.3", 1))


def _grad_case(name, chunk_len, B=1, T=64, H=2, seed=0):
    rng = np.random.default_rng(seed)
    shape = (B, T, H, 64)
    r, k, v = (rng.standard_normal(shape) * 0.5 for _ in range(3))
    if name == "across the floor":
        w_raw = rng.uniform(-3.0, math.log(80.0 / chunk_len) + 0.5, shape)
    elif name == "floor, tiny r":
        w_raw = rng.uniform(2.0, 2.5, shape)
        r[..., ::4] = rng.uniform(-1e-3, 1e-3, r[..., ::4].shape)
    else:
        w_raw = np.full(shape, float(name.split("= ")[1]))
    u = rng.standard_normal((H, 64)) * 0.3
    s0 = rng.standard_normal((B, H, 64, 64)) * 0.3
    dy = rng.standard_normal(shape) * 0.5
    dsf = rng.standard_normal((B, H, 64, 64)) * 0.1
    return [torch.from_numpy(x) for x in (r, w_raw, k, v, u, s0, dy, dsf)]


@pytest.mark.parametrize("name,chunk_len", GRAD_CASES, ids=[f"{n}-chunk{c}" for n, c in GRAD_CASES])
def test_two_pass_vjp_matches_float64_autograd(name, chunk_len):
    """The two passes in fp32 against float64 autograd of the floored
    ``wkv6_reference`` at T=64 H=2, with an initial state and a non-zero
    cotangent of the final state: all six gradients finite, relative
    Frobenius error <= 1e-4, dw_raw exactly 0 where the floor binds."""
    r, w_raw, k, v, u, s0, dy, dsf = _grad_case(name, chunk_len)
    leaves = [x.clone().requires_grad_(True) for x in (r, w_raw, k, v, u, s0)]
    y, s = pw.wkv6_reference(*leaves[:5], leaves[5], chunk=chunk_len)
    ref = torch.autograd.grad((y, s), leaves, (dy, dsf))
    zin = _states([r, w_raw, k, v], u, s0, chunk_len).float()
    got = two_pass_bwd(*(x.float() for x in (r, w_raw, k, v, u)), zin, dy.float(), dsf.float(), chunk_len)
    for what, g, g_ref in zip(NAMES, got, ref):
        assert torch.isfinite(g).all(), what
        rel = float((g.double() - g_ref).norm() / g_ref.norm()) if g_ref.norm() > 0 else float(g.abs().max())
        assert rel <= GRAD_TOL, (name, chunk_len, what, rel)
    floored = -torch.exp(w_raw) <= -80.0 / chunk_len
    assert bool((got[1][floored] == 0).all())
    if name.startswith("floor"):
        assert bool(floored.all())


def test_two_pass_vjp_matches_jax_pallas_bwd():
    """The two passes against ``wkv6_pallas_bwd`` (interpret mode) at B=2
    T=32 H=2, chunk 16, from the Pallas forward's own saved states, the floor
    binding on a fifth of the channels (``test_torch_wkv6._inputs``)."""
    B, T, H = 2, 32, 2
    args, s0, dy, ds = _case(B, T, H, seed=7)
    jargs = [jnp.asarray(x) for x in args]
    _, _, zin = jp.wkv6_pallas_fwd_res(*jargs, jnp.asarray(s0), chunk=16)
    g_pallas = jp.wkv6_pallas_bwd(*jargs, zin, jnp.asarray(dy), jnp.asarray(ds), chunk=16)
    got = two_pass_bwd(*(torch.from_numpy(x) for x in args), torch.from_numpy(np.array(zin)),
                       torch.from_numpy(dy), torch.from_numpy(ds), 16)
    for what, g, ref in zip(NAMES, got, g_pallas):
        assert max_rel(to_np(g), np.asarray(ref)) < GRAD_TOL, what


# (B, H, stream dtype) -> pass 1's (value rows a block, blocks, threads,
# shared bytes) and pass 2's (blocks at T=2048, threads, shared bytes): the
# smoke's training shape (x060 1.6B, B=2 H=32), B*H = 15, one head and
# B*H = 128.
PLANS = {
    (2, 32, BF): ((32, 128, 256, 66816), (8192, 256, 68352)),
    (2, 32, F32): ((32, 128, 256, 88320), (8192, 256, 74496)),
    (3, 5, F32): ((16, 60, 128, 76544), (1920, 256, 74496)),
    (1, 1, BF): ((16, 4, 128, 56576), (128, 256, 68352)),
    (2, 64, BF): ((64, 128, 256, 87296), (16384, 256, 68352)),
}


@pytest.mark.parametrize("B,H,dtype", list(PLANS), ids=[f"B{b}H{h}-{str(d)[6:]}" for b, h, d in PLANS])
def test_bwd_plan(B, H, dtype):
    """Each pass's launch at T=2048: pass 1 is laid out as K8 (every value
    row of every head in one block, 8 threads a row, 4 at 64 rows); pass 2
    has a block of 256 threads for each (b, h, chunk), three of which fit on
    a multiprocessor; ``chip_smoke.wkv6_bwd_plan`` logs the same plan."""
    plan = wkv6_cuda.bwd_plan(B, 2048, H, dtype)
    p1, p2 = plan["state"], plan["chunk"]
    want1, want2 = PLANS[(B, H, dtype)]
    assert (p1["rows"], p1["blocks"], p1["threads"], p1["smem_bytes"]) == want1
    assert (p2["blocks"], p2["threads"], p2["smem_bytes"]) == want2
    assert p1 == wkv6_cuda.fwd_plan(B, H, dtype)  # pass 1 runs K8's layout
    assert p1["blocks"] * p1["rows"] == B * H * 64 and p2["blocks"] == B * H * 2048 // L
    assert 2 * (p1["smem_bytes"] + SMEM_RESERVED) <= SMEM_PER_SM
    assert 3 * (p2["smem_bytes"] + SMEM_RESERVED) <= SMEM_PER_SM
    assert plan["workspace_bytes"] == B * H * 2048 // L * 64 * 64 * 4
    assert plan["du_bytes"] == B * H * 2048 // L * 64 * 4


@pytest.mark.parametrize("form", [0, 1, 2])
@pytest.mark.parametrize("dt", [0, 1])
def test_chip_smoke_names_both_passes(form, dt):
    """A profiler's demangled names of the two passes,
    ``wkv6_bwd_state_kernel<DT, ROWS, FORM>`` and
    ``wkv6_bwd_chunk_kernel<DT>``, are both K9, and K8's
    ``wkv6_fwd_kernel<DT, 1, ROWS, FORM>`` stays K8."""
    cs = _chip_smoke()
    s = "__nv_bfloat16" if dt else "float"
    state = (f"void (anonymous namespace)::wkv6_bwd_state_kernel<{dt}, 32, {form}>(int, int, float, "
             f"{s} const*, {s} const*, {s} const*, {s} const*, float const*, float const*, {s}*, float*, "
             f"float*)")
    chunk = (f"void (anonymous namespace)::wkv6_bwd_chunk_kernel<{dt}>(int, int, float, {s} const*, "
             f"{s} const*, {s} const*, {s} const*, float const*, {s} const*, float const*, float const*, "
             f"{s}*, {s}*, {s}*, float*)")
    fwd = (f"void (anonymous namespace)::wkv6_fwd_kernel<{dt}, 1, 32, {form}>(int, int, float, {s} const*, "
           f"{s} const*, {s} const*, {s} const*, float const*, float const*, {s}*, float*, float*)")
    assert cs._category(state) == cs._category(chunk) == "K9 wkv6_bwd"
    assert cs._category(fwd) == "K8 wkv6_fwd_res"


def test_chip_smoke_keys_ptxas_report_of_both_passes():
    """``parse_ptxas`` keys the passes by their template arguments, as phase
    1's no-spill check and the plans' log read them."""
    cs = _chip_smoke()
    report = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121wkv6_bwd_state_kernelILi1ELi32ELi2EEEviif"
        "PKNSt11conditionalIXeqT_Li1EE13__nv_bfloat16fE4typeES6_S6_S6_PKfS8_PS4_PfSA_' for 'sm_90a'\n"
        "ptxas info    : Used 122 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121wkv6_bwd_chunk_kernelILi0EEEviifPKNSt11"
        "conditionalIXeqT_Li1EE13__nv_bfloat16fE4typeES6_S6_S6_PKfS6_S8_S8_PS4_S9_S9_Pf' for 'sm_90a'\n"
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size\n"
    )
    cs.PTXAS.clear()
    cs.parse_ptxas("wkv6_train", report)
    assert cs.PTXAS[("wkv6_train", "wkv6_bwd_state_kernel", (1, 32, 2))] == {"registers": 122}
    assert cs.PTXAS[("wkv6_train", "wkv6_bwd_chunk_kernel", (0,))] == {"spill_bytes": 8, "registers": 128}
    cs.PTXAS.clear()


@pytest.mark.parametrize("chunk_len", [1, 4, 16])
def test_wrapper_refuses_cpu_tensors(chunk_len):
    """K9's wrapper takes CUDA tensors only, at every chunk_len (no floor is
    refused)."""
    xs = [torch.zeros(1, 32, 2, 64) for _ in range(4)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        wkv6_cuda.wkv6_bwd(*xs, torch.zeros(2, 64), torch.zeros(2, 2, 64, 64), xs[0], torch.zeros(1, 2, 64, 64),
                           chunk_len)
