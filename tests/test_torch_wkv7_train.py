"""The training side of WKV7 (the CPU side of kernels K5 and K6): the
port's ``wkv7_fwd_res_plain`` against the JAX package's
``wkv7_pallas_fwd_res``, and ``wkv7_bwd_plain`` and autograd through
``wkv7`` against ``wkv7_pallas_bwd`` and ``jax.grad`` of ``wkv7_reference``.
The Pallas kernels run in interpret mode on the CPU, as in the JAX
package's own tests.

Tolerances, fp32: forward (y, final state, saved chunk states) max |delta|
<= 1e-5 * max |ref|; gradients <= 1e-4 * max |ref| (the same arithmetic in
another order: a per-step adjoint against the chunk's matrix form with two
triangular solves)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_wkv7 import _inputs, _state
from torch_port_helpers import max_rel, to_np
from visualrwkv_torch.ops import wkv7 as pw
from visualrwkv_tpu.ops import wkv7_pallas as jp
from visualrwkv_tpu.ops.wkv7 import wkv7_reference as j_reference

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
NAMES = ("r", "w_raw", "k", "v", "a", "b", "initial_state")


def _case(B, T, H, seed):
    rng = np.random.default_rng(seed + 100)
    args = _inputs(B, T, H, 64, seed=seed)
    s0 = _state(B, H, 64, seed=seed + 1)
    dy = rng.standard_normal((B, T, H, 64)).astype(np.float32)
    ds = (rng.standard_normal((B, H, 64, 64)) * 0.1).astype(np.float32)
    return args, s0, dy, ds


@pytest.mark.parametrize("with_state", [False, True])
def test_fwd_res_matches_jax_pallas(with_state):
    B, T, H = 2, 48, 2
    args, s0, _, _ = _case(B, T, H, seed=3)
    if not with_state:
        s0 = None
    y_j, s_j, zin_j = jp.wkv7_pallas_fwd_res(*[jnp.asarray(x) for x in args],
                                             None if s0 is None else jnp.asarray(s0), chunk=16)
    y, s, zin = pw.wkv7_fwd_res_plain(*[torch.from_numpy(x) for x in args],
                                      None if s0 is None else torch.from_numpy(s0))
    assert zin.shape == (B * H, T // 16, 64, 64) and zin.dtype == torch.float32
    assert max_rel(to_np(y), np.asarray(y_j)) < FWD_TOL
    assert max_rel(to_np(s), np.asarray(s_j)) < FWD_TOL
    assert max_rel(to_np(zin), np.asarray(zin_j)) < FWD_TOL  # both save Z = S^T
    if with_state:  # the first saved state is the transposed initial state
        np.testing.assert_array_equal(
            to_np(zin[:, 0]), s0.transpose(0, 1, 3, 2).reshape(B * H, 64, 64))
    with pytest.raises(ValueError, match="multiple"):
        pw.wkv7_fwd_res_plain(*[torch.from_numpy(x[:, :20]) for x in args])


def _jax_grads(args, s0, dy, ds):
    """(Pallas backward kernel, jax.grad of the sequential reference)."""
    jargs = [jnp.asarray(x) for x in args]
    js0, jdy, jds = jnp.asarray(s0), jnp.asarray(dy), jnp.asarray(ds)
    _, _, zin = jp.wkv7_pallas_fwd_res(*jargs, js0, chunk=16)
    g_pallas = jp.wkv7_pallas_bwd(*jargs, zin, jdy, jds, chunk=16)

    def scalar(*xs):
        y, s = j_reference(*xs[:6], xs[6])
        return (y * jdy).sum() + (s * jds).sum()

    g_ref = jax.grad(scalar, argnums=tuple(range(7)))(*jargs, js0)
    return [np.asarray(g) for g in g_pallas], [np.asarray(g) for g in g_ref]


def test_bwd_matches_jax_pallas_and_reference():
    """All seven gradients, with a non-zero initial state and a non-zero
    cotangent of the final state."""
    B, T, H = 2, 48, 2
    args, s0, dy, ds = _case(B, T, H, seed=5)
    g_pallas, g_ref = _jax_grads(args, s0, dy, ds)
    for name, a, b in zip(NAMES, g_pallas, g_ref):
        assert max_rel(a, b) < GRAD_TOL, name  # the two JAX sides agree first

    targs = [torch.from_numpy(x) for x in args]
    ts0, tdy, tds = (torch.from_numpy(x) for x in (s0, dy, ds))
    _, _, zin = pw.wkv7_fwd_res_plain(*targs, ts0)
    plain = pw.wkv7_bwd_plain(*targs, zin, tdy, tds)

    leaves = [t.clone().requires_grad_(True) for t in targs + [ts0]]
    y, s = pw.wkv7(*leaves[:6], leaves[6])
    auto = torch.autograd.grad((y, s), leaves, (tdy, tds))

    for which, got in (("wkv7_bwd_plain", plain), ("autograd through wkv7", auto)):
        for name, g, a, b in zip(NAMES, got, g_pallas, g_ref):
            assert g.dtype == torch.float32
            assert max_rel(to_np(g), a) < GRAD_TOL, (which, name, "vs pallas bwd")
            assert max_rel(to_np(g), b) < GRAD_TOL, (which, name, "vs jax.grad of the reference")


def test_bwd_without_initial_state_and_zero_final_cotangent():
    """The training path: no initial state, and the final state unused."""
    B, T, H = 1, 32, 2
    args, _, dy, _ = _case(B, T, H, seed=9)
    jargs = [jnp.asarray(x) for x in args]
    g_ref = jax.grad(lambda *xs: (j_reference(*xs)[0] * jnp.asarray(dy)).sum(),
                     argnums=tuple(range(6)))(*jargs)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in args]
    y, _ = pw.wkv7(*leaves)
    auto = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    _, _, zin = pw.wkv7_fwd_res_plain(*[l.detach() for l in leaves])
    plain = pw.wkv7_bwd_plain(*[l.detach() for l in leaves], zin, torch.from_numpy(dy),
                              torch.zeros(B, H, 64, 64))
    for name, g, p, ref in zip(NAMES, auto, plain, g_ref):
        assert max_rel(to_np(g), np.asarray(ref)) < GRAD_TOL, name
        assert max_rel(to_np(p), np.asarray(ref)) < GRAD_TOL, name


def test_bwd_plain_casts_to_stream_dtype():
    B, T, H = 1, 16, 1
    args, s0, dy, ds = _case(B, T, H, seed=2)
    targs = [torch.from_numpy(x).to(torch.bfloat16) for x in args]
    _, _, zin = pw.wkv7_fwd_res_plain(*targs, torch.from_numpy(s0))
    grads = pw.wkv7_bwd_plain(*targs, zin, torch.from_numpy(dy).to(torch.bfloat16),
                              torch.from_numpy(ds))
    assert all(g.dtype == torch.bfloat16 for g in grads[:6]) and grads[6].dtype == torch.float32


def test_gradcheck_plain_path_float64():
    """``torch.autograd.gradcheck`` (finite differences against autograd) of
    the sequential plain path in float64 at B=1, T=16, H=1, all seven inputs.
    The head size is cut to 8 so that the 832 input elements stay cheap; the
    plain path takes any head size."""
    N = 8
    args = [torch.from_numpy(x).double().requires_grad_(True) for x in _inputs(1, 16, 1, N, seed=4)]
    s0 = torch.from_numpy(_state(1, 1, N, seed=4)).double().requires_grad_(True)
    assert torch.autograd.gradcheck(pw.wkv7_reference, (*args, s0), eps=1e-6, atol=1e-6, rtol=1e-4)
