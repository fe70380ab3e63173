"""WKV7 parity: the port's plain versions (the CPU side of kernels K1 and
K2) against the JAX package's Pallas kernels, run in interpret mode on the
CPU as the JAX package's own tests run them, and against its reference.

Tolerance: max |delta| <= 1e-4 * max |ref| in fp32. Both sides do the same
fp32 arithmetic in a different order (chunked matmuls against a sequential
scan); 1e-4 leaves two orders of magnitude above the fp32 rounding seen."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import max_rel, to_np
from visualrwkv_torch.ops import wkv7 as pw
from visualrwkv_tpu.ops import wkv7_pallas as jp
from visualrwkv_tpu.ops.wkv7 import wkv7_reference as j_reference
from visualrwkv_tpu.ops.wkv7 import wkv7_step as j_step

TOL = 1e-4


def _inputs(B, T, H, N, seed, lead=None):
    """RWKV-7-shaped streams: w_raw soft-clamped below -0.5, a = -kk and
    b = kk * gate with kk unit per head (as tmix_x070 builds them)."""
    rng = np.random.default_rng(seed)
    shp = (B, T, H, N) if lead is None else lead + (H, N)
    r, k, v = (rng.standard_normal(shp) * 0.5 for _ in range(3))
    w_raw = -np.log1p(np.exp(-rng.standard_normal(shp) * 2 - 1)) - 0.5
    kk = rng.standard_normal(shp)
    kk /= np.linalg.norm(kk, axis=-1, keepdims=True)
    gate = rng.uniform(0, 1, shp)
    return [x.astype(np.float32) for x in (r, w_raw, k, v, -kk, kk * gate)]


def _state(B, H, N, seed):
    return (np.random.default_rng(seed).standard_normal((B, H, N, N)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("T", [64, 48])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv7_matches_jax_pallas_and_reference(T, with_state):
    B, H, N = 2, 2, 64
    args = _inputs(B, T, H, N, seed=T)
    s0 = _state(B, H, N, seed=1) if with_state else None
    jargs = [jnp.asarray(x) for x in args]
    js0 = None if s0 is None else jnp.asarray(s0)
    y_pl, s_pl = jp.wkv7_pallas(*jargs, js0, chunk=16)
    y_ref, s_ref = j_reference(*jargs, js0)
    y_pl, s_pl, y_ref, s_ref = (np.asarray(x) for x in (y_pl, s_pl, y_ref, s_ref))
    assert max_rel(y_pl, y_ref) < TOL  # the two JAX sides agree first

    targs = [torch.from_numpy(x) for x in args]
    ts0 = None if s0 is None else torch.from_numpy(s0)
    for name, fn in (("wkv7", pw.wkv7), ("chunked", pw.wkv7_chunked),
                     ("reference", pw.wkv7_reference)):
        y, s = fn(*targs, ts0)
        assert y.dtype == torch.float32 and s.dtype == torch.float32
        for got, ref, what in ((y, y_pl, "y vs pallas"), (s, s_pl, "state vs pallas"),
                               (y, y_ref, "y vs reference"), (s, s_ref, "state vs reference")):
            err = max_rel(to_np(got), ref)
            assert err < TOL, (name, what, err)


def test_adversarial_inputs():
    """tests/test_wkv7_stability.py's worst case for the chunk solve
    (sign-alternating unit kk, slow decay): the sequential reference matches
    JAX's; the chunked form at chunk 8 in bf16 stays within 5% as JAX's does."""
    from test_wkv7_stability import _adversarial_inputs

    args = [x.astype(np.float32) for x in _adversarial_inputs()]
    y_j, s_j = j_reference(*[jnp.asarray(x) for x in args])
    ref = np.asarray(y_j)
    targs = [torch.from_numpy(x) for x in args]
    y, s = pw.wkv7_reference(*targs)
    assert max_rel(to_np(y), ref) < TOL
    assert max_rel(to_np(s), np.asarray(s_j)) < TOL

    y8, _ = pw.wkv7_chunked(*[t.to(torch.bfloat16) for t in targs], chunk=8)
    y8 = to_np(y8)
    assert np.isfinite(y8).all()
    assert max_rel(y8, ref) < 0.05


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_step_matches_jax_pallas(state_dtype):
    """The one-token step against JAX's wkv7_step_pallas (interpret). With
    a bf16 carry both sides start from the same bf16 state and do fp32
    math; the new bf16 states may differ by one bf16 rounding (2^-8
    relative), so that comparison allows 8e-3 * max |ref|."""
    B, H, N = 3, 2, 64
    vecs = _inputs(B, 1, H, N, seed=5, lead=(B,))
    s0 = _state(B, H, N, seed=2)
    jdt = jnp.dtype(state_dtype)
    js0 = jnp.asarray(s0).astype(jdt)
    s_j, y_j = jp.wkv7_step_pallas(js0, *[jnp.asarray(x) for x in vecs])
    s_ref, y_ref = j_step(js0.astype(jnp.float32), *[jnp.asarray(x) for x in vecs])

    tdt = getattr(torch, state_dtype)
    ts0 = torch.from_numpy(np.array(js0.astype(jnp.float32))).to(tdt)
    tvecs = [torch.from_numpy(x) for x in vecs]
    for fn in (pw.wkv7_step, pw.wkv7_step_auto):
        s, y = fn(ts0, *tvecs)
        assert max_rel(to_np(y), np.asarray(y_j)) < TOL
        assert max_rel(to_np(y), np.asarray(y_ref)) < TOL
        assert max_rel(to_np(s), np.asarray(s_ref)) < TOL
        state_tol = TOL if state_dtype == "float32" else 8e-3
        assert max_rel(to_np(s.to(tdt)), np.asarray(s_j.astype(jnp.float32))) < state_tol


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only: CPU tensors go to the
    plain versions through the dispatchers, never into a kernel."""
    from visualrwkv_torch.ops import wkv7_cuda

    args = [torch.from_numpy(x) for x in _inputs(1, 4, 1, 64, seed=0)]
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        wkv7_cuda.wkv7_fwd(*args)


@pytest.mark.parametrize("T", [24, 8])
def test_no_grad_wkv7_at_chunk_8_matches_jax(T):
    """The no-gradient ``ops.wkv7.wkv7`` on the CPU (the plain path that
    stands beside K1, which takes such T with a masked last chunk) against
    the JAX package's ``wkv7`` at ``chunk=8``, with an initial state, at a
    T that is not a multiple of 16 (24) and at one chunk (8): the two agree
    within TOL, and against the float64 sequential scan the port's error is
    no worse than the reference's (at most 1.5 times it, or 1e-6, the fp32
    rounding of both orders)."""
    from visualrwkv_tpu.ops.wkv7 import wkv7 as j_wkv7

    B, H, N = 2, 2, 64
    args = _inputs(B, T, H, N, seed=100 + T)
    s0 = _state(B, H, N, seed=3)
    y_j, s_j = (np.asarray(x) for x in j_wkv7(*[jnp.asarray(x) for x in args], jnp.asarray(s0), chunk=8))
    with torch.no_grad():
        y, s = pw.wkv7(*[torch.from_numpy(x) for x in args], torch.from_numpy(s0), chunk=8)
    y64, s64 = pw.wkv7_reference(*[torch.from_numpy(x).double() for x in args], torch.from_numpy(s0).double())
    y64, s64 = y64.numpy(), s64.numpy()
    for got, jax_side, ref, what in ((y, y_j, y64, "y"), (s, s_j, s64, "state")):
        got = to_np(got)
        assert got.shape == jax_side.shape == ref.shape, what
        assert max_rel(got, jax_side) < TOL, (what, max_rel(got, jax_side))
        err, err_jax = max_rel(got, ref), max_rel(jax_side, ref)
        assert err <= max(1.5 * err_jax, 1e-6), (what, err, err_jax)
