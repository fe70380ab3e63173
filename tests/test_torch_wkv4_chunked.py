"""The chunked scan of the RWKV-4 ("x040") recurrence, kernels K17
``wkv4_fwd`` and K18 ``wkv4_bwd`` (``visualrwkv_torch/csrc/wkv4.cu``), on
the CPU: their algorithm written in torch (``ops/wkv4.py``:
``wkv4_chunked_plain``, ``wkv4_chunked_bwd_plain``) against the JAX
package's ``ops/wkv4.py::wkv4`` and its ``jax.vjp``, and against the
sequential plain versions in float64; then the launch side the CPU reaches:
the chunk plans ``wkv4_cuda.fwd_plan`` / ``bwd_plan``, the wrappers'
refusals before any library is loaded, and how ``chip_smoke.py`` names the
kernels in a profile and in ptxas's report. The kernels themselves run on
the card only: ``chip_smoke.py`` holds them against the plain versions.

Tolerances: fp32 against JAX, relative RMS <= 1e-6 on y and the final
state, <= 1e-5 on each gradient (another order of fp32 sums: ~3e-7 and
~2e-6 are seen); float64 against the sequential walks, max |delta| <= 1e-10
* max |ref| (~1e-14 is seen). With k near 80 on a quarter of the channels,
JAX's scan walks pp ~ 80, where every w + pp rounds on a 7.6e-6 grid, by
the same fraction of it at every step of a channel: its y drifts ~2e-6 and
its dw ~3e-5 from the exact walk at these sizes (the port's sequential fp32
walk does the same; :func:`test_chunked_fp32_is_closer_to_exact_than_the_sequential_walk`).
The recurrence is invariant under k -> k - c, pp -> pp - c on a channel, so
there the oracle is JAX's ``wkv4`` on k - 80 on those channels (exact for k
in [78, 82]) and an initial pp - 80, its final pp shifted back: the same
function, its fp32 walk near pp = 0."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from torch_port_helpers import max_rel, oracle_jit, rel_rms, to_np
from visualrwkv_torch import cuda_build
from visualrwkv_torch.ops import wkv4 as pw
from visualrwkv_torch.ops import wkv4_cuda
from visualrwkv_tpu.ops import wkv4 as jw

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SMEM_LIMIT = 232448  # bytes of shared memory a block can have on an H100
B, C = 2, 64
# (T, chunk): T a multiple of the chunk, ragged, shorter than one chunk, chunk 1
SHAPES = ((24, 4), (23, 4), (3, 4), (17, 1))
CASES = [(T, L, big_k, state) for T, L in SHAPES for big_k in (False, True) for state in (False, True)]
IDS = [f"T{T}-L{L}-{'k80' if big_k else 'k'}-{'state' if state else 'zero'}" for T, L, big_k, state in CASES]


def _inputs(T, seed, big_k, Cn=C):
    rng = np.random.default_rng(seed)
    w = -np.exp(rng.uniform(-5, 3, Cn))
    u = rng.normal(0, 1, Cn)
    k = rng.normal(0, 1, (B, T, Cn))
    v = rng.normal(0, 1, (B, T, Cn))
    if big_k:  # e^80 overflows fp32 once summed: only the max tracking holds it
        k[..., ::4] = rng.uniform(78, 82, (B, T, Cn // 4))
    s0 = np.stack([rng.normal(0, 1, (B, Cn)), rng.uniform(0.5, 2, (B, Cn)), rng.normal(0, 1, (B, Cn))], -1)
    dy = rng.normal(0, 1, (B, T, Cn))
    ds = rng.normal(0, 1, (B, Cn, 3))  # the final pp's cotangent included
    return [x.astype(np.float32) for x in (w, u, k, v, s0, dy, ds)]


def _case(T, L, big_k, state):
    w, u, k, v, s0, dy, ds = _inputs(T, 10 * T + L + 3 * big_k, big_k)
    return w, u, k, v, (s0 if state else None), dy, ds


@pytest.fixture(scope="module")
def oracles():
    """JAX's sequence form and its VJP (with and without an initial state),
    jitted once a module."""

    def vjp(w, u, k, v, s0, dy, ds):
        return jax.vjp(lambda *a: jw.wkv4(*a), w, u, k, v, s0)[1]((dy, ds))

    def vjp_zero(w, u, k, v, dy, ds):
        return jax.vjp(lambda *a: jw.wkv4(*a), w, u, k, v)[1]((dy, ds))

    return oracle_jit(jw.wkv4), oracle_jit(vjp), oracle_jit(vjp_zero)


def _frame(k, s0, big_k):
    """k and the initial state in the frame of c = 80 on the big-k channels
    (0 elsewhere), and c."""
    c = np.zeros(k.shape[-1], np.float32)
    if big_k:
        c[::4] = 80.0
    s = None
    if s0 is not None:
        s = s0.copy()
        s[..., 2] -= c
    return k - c, s, c


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("T,L,big_k,state", CASES, ids=IDS)
def test_chunked_forward_matches_jax(oracles, T, L, big_k, state):
    """The summaries, their scan and the replay: y and the final state
    against JAX's scan in fp32."""
    fwd = oracles[0]
    w, u, k, v, s0, _, _ = _case(T, L, big_k, state)
    ks, ss, c = _frame(k, s0, big_k)
    jy, js = fwd(w, u, ks, v, ss) if state else fwd(w, u, ks, v)
    js = np.asarray(js).copy()
    js[..., 2] += c
    y, s = pw.wkv4_chunked_plain(*map(_t, (w, u, k, v, s0)), L)
    assert y.dtype == s.dtype == torch.float32 and y.shape == (B, T, C) and s.shape == (B, C, 3)
    assert rel_rms(to_np(y), jy) <= 1e-6
    assert rel_rms(to_np(s), js) <= 1e-6


@pytest.mark.parametrize("T,L,big_k,state", CASES, ids=IDS)
def test_chunked_backward_matches_jax_vjp(oracles, T, L, big_k, state):
    """The chunk maps, their reverse scan and the reverse replay: every
    gradient, with cotangents on y and on the whole final state (pp's too),
    against ``jax.vjp`` of JAX's scan in fp32."""
    _, vjp, vjp_zero = oracles
    w, u, k, v, s0, dy, ds = _case(T, L, big_k, state)
    ks, ss, _ = _frame(k, s0, big_k)
    ref = vjp(w, u, ks, v, ss, dy, ds) if state else vjp_zero(w, u, ks, v, dy, ds)
    got = pw.wkv4_chunked_bwd_plain(*map(_t, (w, u, k, v, s0, dy, ds)), L)
    assert (got[4] is None) == (not state)
    got = [g for g in got if g is not None]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and rel_rms(to_np(g), np.asarray(r)) <= 1e-5


@pytest.mark.parametrize("T,L,big_k,state", CASES + [(0, 4, False, True), (0, 4, True, False)],
                         ids=IDS + ["T0-state", "T0-zero"])
def test_chunked_forms_equal_the_sequential_walks_in_float64(T, L, big_k, state):
    """In exact arithmetic the chunked forms are the sequential walks: in
    float64 they agree to rounding, T = 0 included (the entering state out,
    ds0 = ds, zero dw and du)."""
    xs = [None if x is None else torch.from_numpy(x).double() for x in _case(T, L, big_k, state)]
    w, u, k, v, s0, dy, ds = xs
    y, s = pw.wkv4_chunked_plain(w, u, k, v, s0, L)
    y_ref, s_ref = pw.wkv4_plain(w, u, k, v, s0)
    assert y.dtype == torch.float64 and y.shape == y_ref.shape
    if T:
        assert max_rel(y, y_ref) <= 1e-10
    assert max_rel(s, s_ref) <= 1e-10
    got = pw.wkv4_chunked_bwd_plain(w, u, k, v, s0, dy, ds, L)
    ref = pw.wkv4_bwd_plain(w, u, k, v, s0, dy, ds)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if r is not None:
            assert g.dtype == torch.float64 and g.shape == r.shape
            if r.numel() and r.abs().max() > 0:
                assert max_rel(g, r) <= 1e-10
            else:
                assert torch.equal(g, r)


def test_chunked_fp32_is_closer_to_exact_than_the_sequential_walk():
    """Why ``chip_smoke.py`` holds K17 and K18 against the plain walks in
    float64: with k near 80 (T = 256, chunks of 8) the sequential fp32
    walk's final state is 2.6e-5 and its dw 1.3e-4 from the float64 walk
    (every w + pp rounds on pp ~ 80's grid by the same fraction), the
    chunked fp32 forms' 5e-7 and 4e-6 (each chunk walked near pp = 0)."""
    T, L = 256, 8
    w, u, k, v, s0, dy, ds = _inputs(T, 7, True)
    a32 = [torch.from_numpy(x) for x in (w, u, k, v, s0, dy, ds)]
    a64 = [x.double() for x in a32]
    y64, s64 = pw.wkv4_plain(*a64[:5])
    g64 = pw.wkv4_bwd_plain(*a64)
    y, s = pw.wkv4_chunked_plain(*a32[:5], L)
    g = pw.wkv4_chunked_bwd_plain(*a32, L)
    ys, ss = pw.wkv4_plain(*a32[:5])
    gs = pw.wkv4_bwd_plain(*a32)
    e = lambda a, b: rel_rms(to_np(a), to_np(b))
    assert e(y, y64) <= 1e-6 and e(s, s64) <= 1e-6
    assert all(e(a, b) <= 1e-5 for a, b in zip(g, g64))
    assert e(ss, s64) > 10 * e(s, s64) and e(gs[0], g64[0]) > 10 * e(g[0], g64[0])


# ---------------------------------------------------------------------------
# the launch side
# ---------------------------------------------------------------------------

# (B, T, C) -> (slots, chunk, chunks, rounds): the x040 prefill at B=1 and 4,
# the smoke's ragged T, a T shorter than one chunk, T = 0, a long T (several
# rounds), the v4 adapter's B=8 T=64, and C = 2045 (a ragged channel tile)
FWD_PLANS = {
    (1, 1056, 2048): (64, 17, 63, 1), (4, 1056, 2048): (64, 17, 63, 1), (1, 1049, 2048): (64, 17, 62, 1),
    (1, 5, 2048): (2, 3, 2, 1), (1, 0, 2048): (2, 1, 0, 0), (1, 4096, 2048): (64, 22, 187, 3),
    (8, 64, 2048): (8, 8, 8, 1), (2, 1049, 2045): (64, 17, 62, 1), (1, 1, 16): (2, 1, 1, 1),
}
BWD_PLANS = {
    (1, 1056, 2048): (32, 11, 96, 3), (4, 1056, 2048): (32, 11, 96, 3), (1, 1049, 2048): (32, 11, 96, 3),
    (1, 5, 2048): (2, 3, 2, 1), (1, 0, 2048): (2, 1, 0, 0), (1, 4096, 2048): (32, 16, 256, 8),
    (8, 64, 2048): (8, 8, 8, 1), (2, 1049, 2045): (32, 11, 96, 3), (1, 1, 16): (2, 1, 1, 1),
}


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("shape", list(FWD_PLANS), ids=[f"B{b}T{t}C{c}" for b, t, c in FWD_PLANS])
def test_chunk_plans(kind, shape):
    """The chunk slots, chunk length, chunks and rounds at each shape; a
    block a (tile of 16 channels, row); every step in exactly one chunk, only
    the last chunk shorter, only the last round partly empty."""
    Bn, T, Cn = shape
    plan = (wkv4_cuda.fwd_plan if kind == "fwd" else wkv4_cuda.bwd_plan)(Bn, T, Cn)
    want = (FWD_PLANS if kind == "fwd" else BWD_PLANS)[shape]
    assert (plan["slots"], plan["chunk"], plan["chunks"], plan["rounds"]) == want
    assert plan["grid"] == (-(-Cn // 16), Bn) and plan["blocks"] == -(-Cn // 16) * Bn
    assert plan["threads"] == 16 * plan["slots"]
    L, n = plan["chunk"], plan["chunks"]
    assert n * L >= T and (n == 0 or (n - 1) * L < T)
    assert plan["rounds"] * plan["slots"] >= n and (n == 0 or (plan["rounds"] - 1) * plan["slots"] < n)
    if kind == "bwd":  # chunk states only, and only where T takes more than one round
        assert plan["workspace"] == (Bn, n if plan["rounds"] > 1 else 0, 3, Cn)


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plans_fit_a_block(kind, dtype):
    """At every T up to 20,000: the slots a power of 2 within the kernel's
    bound, the chunk within its bound, the block's shared memory within an
    H100 block's 227 KB (the library refuses more)."""
    plan_fn = wkv4_cuda.fwd_plan if kind == "fwd" else wkv4_cuda.bwd_plan
    most, longest = ((wkv4_cuda.FWD_SLOTS, wkv4_cuda.FWD_MAX_CHUNK) if kind == "fwd"
                     else (wkv4_cuda.BWD_SLOTS, wkv4_cuda.BWD_MAX_CHUNK))
    for T in list(range(0, 300)) + list(range(300, 20000, 97)):
        plan = plan_fn(1, T, 2048, dtype)
        slots = plan["slots"]
        assert 2 <= slots <= most and slots & (slots - 1) == 0
        assert 1 <= plan["chunk"] <= longest
        assert plan["smem_bytes"] <= SMEM_LIMIT
        assert plan["smem_bytes"] == wkv4_cuda.smem_bytes(kind, dtype, slots, plan["chunk"])


def test_smem_bytes_by_hand():
    """K17 at B=1 T=1056 fp32: summaries 4 x 16 x 65 fp32, the carry 3 x 16,
    k and v 64 slots x 17 rows x 16 fp32; K18: maps 7 x 16 x 33, the carry,
    dy and three states 32 x 11 x 16 fp32, k and v."""
    assert wkv4_cuda.fwd_plan(1, 1056, 2048)["smem_bytes"] == 4 * 16 * 65 * 4 + 192 + 2 * 64 * 17 * 16 * 4
    bf16 = wkv4_cuda.fwd_plan(1, 1056, 2048, torch.bfloat16)
    assert bf16["smem_bytes"] == 4 * 16 * 65 * 4 + 192 + 2 * 64 * 17 * 16 * 2
    assert wkv4_cuda.bwd_plan(1, 1056, 2048)["smem_bytes"] == 7 * 16 * 33 * 4 + 192 + 32 * 11 * 16 * (16 + 8)


def _streams(T=8, dtype=torch.float32):
    w, u = torch.zeros(C), torch.zeros(C)
    k, v = torch.zeros(B, T, C, dtype=dtype), torch.zeros(B, T, C, dtype=dtype)
    return w, u, k, v


@pytest.mark.parametrize("name", ["wkv4_fwd", "wkv4_bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_wrappers_refuse_cpu_tensors_before_loading(name, dtype):
    """A CPU tensor is refused by the checks, before the library is built or
    loaded (the CPU has no nvcc)."""
    w, u, k, v = _streams(dtype=dtype)
    loaded = "wkv4" in cuda_build._LIBS
    args = (w, u, k, v, None) if name == "wkv4_fwd" else (w, u, k, v, None, torch.zeros(B, 8, C))
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(wkv4_cuda, name)(*args)
    assert ("wkv4" in cuda_build._LIBS) == loaded


def test_wrappers_refuse_mismatched_shapes():
    w, u, k, v = _streams()
    with pytest.raises(ValueError, match=r"one \[B, T, C\]"):
        wkv4_cuda.wkv4_fwd(w, u, k, v[:, :4])
    with pytest.raises(ValueError, match=r"one \[B, T, C\]"):
        wkv4_cuda.wkv4_bwd(w, u, k[0], v[0], None, torch.zeros(8, C))


def _chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("dt", [0, 1])
def test_chip_smoke_names_the_kernels(dt):
    """A profiler's demangled names of K17's and K18's instantiations."""
    cs = _chip_smoke()
    x = "__nv_bfloat16" if dt else "float"
    fwd = (f"void (anonymous namespace)::wkv4_chunk_fwd_kernel<{dt}>(int, int, int, int, float const*, "
           f"float const*, {x} const*, {x} const*, float const*, float*, float*)")
    bwd = f"void (anonymous namespace)::wkv4_chunk_bwd_kernel<{dt}>(int, int, int, int, float const*)"
    assert cs._category(fwd) == "K17 wkv4_fwd"
    assert cs._category(bwd) == "K18 wkv4_bwd"


def test_chip_smoke_keys_ptxas_report_of_k17_k18():
    """``parse_ptxas`` keys K17 / K18 by their dtype code, as phase 1's
    no-spill check and the plans' log read them."""
    cs = _chip_smoke()
    report = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121wkv4_chunk_fwd_kernelILi1EEEviiiiPKfS2_"
        "PK13__nv_bfloat16S5_S2_PfS6_' for 'sm_90a'\n"
        "ptxas info    : Used 40 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121wkv4_chunk_bwd_kernelILi0EEEviiiiPKfS2_"
        "S2_S2_S2_S2_S2_PfS3_S3_S3_S3_S3_' for 'sm_90a'\n"
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers\n"
    )
    cs.PTXAS.clear()
    cs.parse_ptxas("wkv4", report)
    assert cs.PTXAS[("wkv4", "wkv4_chunk_fwd_kernel", (1,))] == {"registers": 40}
    assert cs.PTXAS[("wkv4", "wkv4_chunk_bwd_kernel", (0,))] == {"spill_bytes": 4, "registers": 96}
    cs.PTXAS.clear()
