"""The port's WKV6 (``visualrwkv_torch/ops/wkv6.py``: the plain versions of
kernels K7-K10 and their dispatchers) against the JAX package's
``ops/wkv6.py`` and ``ops/wkv6_pallas.py``. The Pallas kernels run in
interpret mode on the CPU, as in the JAX package's own tests.

Inputs are made with numpy from a seed. ``w_raw`` is drawn uniform in
[-3, 2.5], so that ``exp(w_raw)`` crosses the decay floor 80 / 16 = 5 of
the chunked forms (and of K7-K9) on about a fifth of the channels; random
model init never reaches it.

Tolerances, fp32: outputs and states max |delta| <= 1e-5 * max |ref| (the
same arithmetic in another order: a sequential scan against the chunked
matrix form); gradients <= 1e-4 * max |ref| (a per-step adjoint against the
chunk's matrix form)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import max_rel, to_np
from visualrwkv_torch.ops import wkv6 as pw
from visualrwkv_tpu.ops import wkv6_pallas as jp

jw = importlib.import_module("visualrwkv_tpu.ops.wkv6")  # the package exports a function of that name

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
NAMES = ("r", "w_raw", "k", "v", "u", "initial_state")


def _inputs(B, T, H, N=64, seed=0, w_lo=-3.0, w_hi=2.5):
    rng = np.random.default_rng(seed)
    shape = (B, T, H, N)
    r, k, v = ((rng.standard_normal(shape) * 0.5).astype(np.float32) for _ in range(3))
    w_raw = rng.uniform(w_lo, w_hi, shape).astype(np.float32)
    u = (rng.standard_normal((H, N)) * 0.3).astype(np.float32)
    return [r, w_raw, k, v, u]


def _state(B, H, N=64, seed=0):
    return (np.random.default_rng(seed + 50).standard_normal((B, H, N, N)) * 0.3).astype(np.float32)


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


def _j(xs):
    return [jnp.asarray(x) for x in xs]


def test_floor_binds_in_the_drawn_range():
    _, w_raw, *_ = _inputs(1, 64, 2)
    share = float((np.exp(w_raw) > 80.0 / 16).mean())
    assert 0.1 < share < 0.4, share


@pytest.mark.parametrize("state_dtype", [np.float32, "bf16"])
def test_step_matches_jax(state_dtype):
    """One token, no floor: fp32 vectors, an fp32 or bf16 state (math fp32)."""
    B, H = 3, 2
    rng = np.random.default_rng(1)
    r, w_raw, k, v = (rng.standard_normal((B, H, 64)).astype(np.float32) for _ in range(4))
    u = rng.standard_normal((H, 64)).astype(np.float32)
    s0 = _state(B, H, seed=1)
    ts0 = torch.from_numpy(s0)
    js0 = jnp.asarray(s0)
    if state_dtype == "bf16":
        ts0, js0 = ts0.to(torch.bfloat16), js0.astype(jnp.bfloat16)
    s_j, y_j = jw.wkv6_step(js0, *_j([r, w_raw, k, v, u]))
    s, y = pw.wkv6_step_auto(ts0, *_t([r, w_raw, k, v, u]))
    assert s.dtype == y.dtype == torch.float32
    assert max_rel(to_np(y), np.asarray(y_j)) < FWD_TOL
    assert max_rel(to_np(s), np.asarray(s_j)) < FWD_TOL


@pytest.mark.parametrize("with_state", [False, True])
def test_reference_matches_jax_reference(with_state):
    """No chunk argument: the JAX package's floor-less sequential scan."""
    args = _inputs(2, 24, 2, seed=2)
    s0 = _state(2, 2, seed=2) if with_state else None
    y_j, s_j = jw.wkv6_reference(*_j(args), None if s0 is None else jnp.asarray(s0))
    y, s = pw.wkv6_reference(*_t(args), None if s0 is None else torch.from_numpy(s0))
    assert max_rel(to_np(y), np.asarray(y_j)) < FWD_TOL
    assert max_rel(to_np(s), np.asarray(s_j)) < FWD_TOL


@pytest.mark.parametrize("with_state", [False, True])
def test_chunked_and_floored_scan_match_jax_chunked(with_state):
    """The port's chunked form and its sequential scan with the decay floor
    (K7's plain version) against the JAX package's ``wkv6_chunked`` at chunk
    16, the path its models take on the CPU."""
    B, T, H = 2, 48, 2
    args = _inputs(B, T, H, seed=3)
    s0 = _state(B, H, seed=3) if with_state else None
    y_j, s_j = jw.wkv6_chunked(*_j(args), None if s0 is None else jnp.asarray(s0), chunk=16)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    for fn in (pw.wkv6_chunked, pw.wkv6_plain,
               lambda *a, chunk: pw.wkv6_reference(*a, chunk=chunk)):
        y, s = fn(*_t(args), ts0, chunk=16)
        assert max_rel(to_np(y), np.asarray(y_j)) < FWD_TOL
        assert max_rel(to_np(s), np.asarray(s_j)) < FWD_TOL
    # the floor is part of the function: without it the answer differs
    y_nf, _ = pw.wkv6_reference(*_t(args), ts0)
    assert max_rel(to_np(y_nf), np.asarray(y_j)) > 1e-3


def test_plain_matches_jax_pallas():
    """K7's plain version against ``wkv6_pallas`` (interpret mode) at chunk 16."""
    B, T, H = 2, 32, 2
    args = _inputs(B, T, H, seed=4)
    s0 = _state(B, H, seed=4)
    y_j, s_j = jp.wkv6_pallas(*_j(args), jnp.asarray(s0), chunk=16)
    y, s = pw.wkv6_reference(*_t(args), torch.from_numpy(s0), chunk=16)
    assert max_rel(to_np(y), np.asarray(y_j)) < FWD_TOL
    assert max_rel(to_np(s), np.asarray(s_j)) < FWD_TOL


def test_plain_path_takes_any_length():
    """T not a multiple of the chunk: the sequential scan with the floor."""
    args = _inputs(1, 21, 2, seed=5)
    y, s = pw.wkv6(*_t(args), chunk=16)
    y_ref, s_ref = pw.wkv6_reference(*_t(args), chunk=16)
    np.testing.assert_array_equal(to_np(y), to_np(y_ref))
    np.testing.assert_array_equal(to_np(s), to_np(s_ref))
    with pytest.raises(ValueError, match="multiple"):
        pw.wkv6_chunked(*_t(args))


@pytest.mark.parametrize("with_state", [False, True])
def test_fwd_res_matches_jax_pallas(with_state):
    """K8's plain version: y, final state and the saved chunk states (both
    save Z = S^T) against ``wkv6_pallas_fwd_res`` at chunk 16."""
    B, T, H = 2, 48, 2
    args = _inputs(B, T, H, seed=6)
    s0 = _state(B, H, seed=6) if with_state else None
    y_j, s_j, zin_j = jp.wkv6_pallas_fwd_res(*_j(args), None if s0 is None else jnp.asarray(s0),
                                             chunk=16)
    y, s, zin = pw.wkv6_fwd_res_plain(*_t(args), None if s0 is None else torch.from_numpy(s0))
    assert zin.shape == (B * H, T // 16, 64, 64) and zin.dtype == torch.float32
    assert max_rel(to_np(y), np.asarray(y_j)) < FWD_TOL
    assert max_rel(to_np(s), np.asarray(s_j)) < FWD_TOL
    assert max_rel(to_np(zin), np.asarray(zin_j)) < FWD_TOL
    if with_state:
        np.testing.assert_array_equal(to_np(zin[:, 0]), s0.transpose(0, 1, 3, 2).reshape(B * H, 64, 64))
    with pytest.raises(ValueError, match="multiple"):
        pw.wkv6_fwd_res_plain(*_t([x[:, :20] if x.ndim == 4 else x for x in args]))


def _case(B, T, H, seed):
    rng = np.random.default_rng(seed + 100)
    args = _inputs(B, T, H, seed=seed)
    s0 = _state(B, H, seed=seed)
    dy = rng.standard_normal((B, T, H, 64)).astype(np.float32)
    ds = (rng.standard_normal((B, H, 64, 64)) * 0.1).astype(np.float32)
    return args, s0, dy, ds


def test_bwd_matches_jax_pallas_and_autodiff():
    """All six gradients (u summed over the batch), with a non-zero initial
    state, a non-zero cotangent of the final state and the floor binding:
    ``wkv6_bwd_plain`` (K9's plain version) and autograd through the port's
    ``wkv6`` against ``wkv6_pallas_bwd`` (interpret mode) and ``jax.grad`` of
    ``wkv6_chunked``, all at chunk 16."""
    B, T, H = 2, 32, 2
    args, s0, dy, ds = _case(B, T, H, seed=7)
    jargs, js0, jdy, jds = _j(args), jnp.asarray(s0), jnp.asarray(dy), jnp.asarray(ds)
    _, _, zin_j = jp.wkv6_pallas_fwd_res(*jargs, js0, chunk=16)
    g_pallas = [np.asarray(g) for g in jp.wkv6_pallas_bwd(*jargs, zin_j, jdy, jds, chunk=16)]

    def scalar(*xs):
        y, s = jw.wkv6_chunked(*xs[:5], xs[5], chunk=16)
        return (y * jdy).sum() + (s * jds).sum()

    g_ref = [np.asarray(g) for g in jax.grad(scalar, argnums=tuple(range(6)))(*jargs, js0)]
    for name, a, b in zip(NAMES, g_pallas, g_ref):
        assert max_rel(a, b) < GRAD_TOL, name  # the two JAX sides agree first
    assert np.abs(g_ref[1]).max() > 0 and (g_ref[1] == 0).mean() > 0.1  # dw_raw is 0 where the floor binds

    targs, ts0, tdy, tds = _t(args), *_t([s0, dy, ds])
    _, _, zin = pw.wkv6_fwd_res_plain(*targs, ts0)
    plain = pw.wkv6_bwd_plain(*targs, zin, tdy, tds)
    leaves = [t.clone().requires_grad_(True) for t in targs + [ts0]]
    y, s = pw.wkv6(*leaves[:5], leaves[5])
    auto = torch.autograd.grad((y, s), leaves, (tdy, tds))
    for which, got in (("wkv6_bwd_plain", plain), ("autograd through wkv6", auto)):
        for name, g, a, b in zip(NAMES, got, g_pallas, g_ref):
            assert g.dtype == torch.float32 and tuple(g.shape) == a.shape, (which, name)
            assert max_rel(to_np(g), a) < GRAD_TOL, (which, name, "vs pallas bwd")
            assert max_rel(to_np(g), b) < GRAD_TOL, (which, name, "vs jax.grad of wkv6_chunked")
        np.testing.assert_array_equal(to_np(got[1])[g_ref[1] == 0], 0.0)


def test_bwd_plain_casts_to_stream_dtype():
    args, s0, dy, ds = _case(1, 16, 1, seed=8)
    targs = [torch.from_numpy(x).to(torch.bfloat16) for x in args[:4]] + [torch.from_numpy(args[4])]
    _, _, zin = pw.wkv6_fwd_res_plain(*targs, torch.from_numpy(s0))
    grads = pw.wkv6_bwd_plain(*targs, zin, torch.from_numpy(dy).to(torch.bfloat16), torch.from_numpy(ds))
    assert all(g.dtype == torch.bfloat16 for g in grads[:4])
    assert grads[4].dtype == grads[5].dtype == torch.float32


@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_function_matches_autograd(with_state):
    """``WKV6Function`` (K8 forward, K9 backward on the card; their plain
    versions on CPU tensors): its gradients, and the None it returns for an
    absent initial state, against autograd through the floored sequential
    scan. fp32; <= 1e-4."""
    B, T, H = 2, 32, 2
    args, s0, dy, ds = _case(B, T, H, seed=9)
    ins = _t(args) + ([torch.from_numpy(s0)] if with_state else [])
    leaves = [t.clone().requires_grad_(True) for t in ins]
    ref = torch.autograd.grad(pw.wkv6_reference(*leaves[:5], *leaves[5:], chunk=16),
                              leaves, _t([dy, ds]))
    fn_leaves = [t.clone().requires_grad_(True) for t in ins]
    y, s = pw.WKV6Function.apply(*fn_leaves[:5], fn_leaves[5] if with_state else None, 16)
    got = torch.autograd.grad((y, s), fn_leaves, _t([dy, ds]))
    for name, g, r in zip(NAMES, got, ref):
        assert max_rel(to_np(g), to_np(r)) < GRAD_TOL, name
    # the final state unused: its cotangent is None inside the Function
    fn_leaves = [t.clone().requires_grad_(True) for t in ins]
    y, _ = pw.WKV6Function.apply(*fn_leaves[:5], fn_leaves[5] if with_state else None, 16)
    got = torch.autograd.grad(y, fn_leaves, torch.from_numpy(dy))
    ref = torch.autograd.grad(pw.wkv6_reference(*leaves[:5], *leaves[5:], chunk=16)[0], leaves,
                              torch.from_numpy(dy))
    for name, g, r in zip(NAMES, got, ref):
        assert max_rel(to_np(g), to_np(r)) < GRAD_TOL, name


def test_dispatch_validates_shapes():
    args = _t(_inputs(1, 16, 2, seed=10))
    with pytest.raises(ValueError, match="bonus u"):
        pw.wkv6(*args[:4], args[4][:1])
    # a 3-D state is the flat layout [B, N, H*N]; any other 3-D shape is refused
    with pytest.raises(ValueError, match="flat"):
        pw.wkv6_step_auto(torch.zeros(1, 64, 64), *[a[:, 0] for a in args[:4]], args[4])


def test_gradcheck_floored_scan_float64():
    """``torch.autograd.gradcheck`` of the floored sequential scan in float64
    at B=1, T=16, H=1, head size 8, with w_raw kept off the floor's kink."""
    N = 8
    rng = np.random.default_rng(11)
    args = _inputs(1, 16, 1, N, seed=11)
    w = args[1]
    args[1] = np.where(np.abs(np.exp(w) - 5.0) < 0.2, w - 0.2, w).astype(np.float32)
    xs = [torch.from_numpy(x).double().requires_grad_(True) for x in args]
    s0 = torch.from_numpy(rng.standard_normal((1, 1, N, N))).requires_grad_(True)
    fn = lambda *a: pw.wkv6_reference(*a, chunk=16)
    assert torch.autograd.gradcheck(fn, (*xs, s0), eps=1e-6, atol=1e-6, rtol=1e-4)
