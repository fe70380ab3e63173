"""The port at a model ``chunk_len`` below 16, on the code the card runs.

x070: under autograd, ``ops.wkv7.wkv7`` sends every call through
``WKV7Function`` / ``WKV7PackedFunction`` on both devices, whose kernels
(K5 / K6, K12 / K13) take 16-step chunks; a T that is not a multiple of 16
(the models pad T only to ``chunk_len``) is filled with identity steps. Held
here, through that padding code, against the JAX package's ``wkv7`` at chunk
8 (its jnp chunked form, and its fused Pallas pair in interpret mode) and
against ``jax.grad`` of its sequential reference.

x060: K7 / K8 / K9 take the decay floor -80 / ``chunk_len`` of every
``chunk_len >= 1`` (their 16-step chunks pick a factor form for it; below
-10 a step each pair factor is one exp2 of its difference), and under
autograd ``ops.wkv6.wkv6`` sends every call through ``WKV6Function`` on both
devices, which pads T as WKV7Function does. Its CPU side (the plain versions
of K8 and K9 behind that padding) is held at chunk 8, 4 and 1 against the
JAX package's ``wkv6`` (its custom VJP of the jnp chunked form) and
``jax.vjp`` of its ``wkv6_chunked``, and against autograd of the port's
``wkv6_plain``: with the floor binding on every channel, and with a decay
drawn across the floor. The per-pair factor form's arithmetic (written in
torch in ``test_torch_wkv6_chunk_bwd.py``) is held against the JAX package's
``wkv6`` at chunk 4, 2 and 1.

Tolerance: max |delta| <= 1e-4 * max |ref| in fp32 (the same function in
another order: padded 16-step chunks against 8-step chunks or the scan)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_wkv6_chunk_bwd import per_pair_fwd
from test_torch_wkv7 import _inputs, _state
from torch_port_helpers import max_rel, to_np
from visualrwkv_torch.ops import wkv6 as p6
from visualrwkv_torch.ops import wkv6_cuda
from visualrwkv_torch.ops import wkv7 as pw
from visualrwkv_torch.ops.padding import PAD_W_RAW, pad_steps
from visualrwkv_tpu.ops.wkv7 import set_wkv_impl as j_set_wkv_impl
from visualrwkv_tpu.ops.wkv7 import wkv7 as j_wkv7
from visualrwkv_tpu.ops.wkv7 import wkv7_reference as j_reference

jw6 = importlib.import_module("visualrwkv_tpu.ops.wkv6")  # the package exports a function of that name

TOL = 1e-4
NAMES = ("r", "w_raw", "k", "v", "a", "b", "initial_state")


def _case(B, T, H, seed):
    rng = np.random.default_rng(seed + 100)
    args = _inputs(B, T, H, 64, seed=seed)
    s0 = _state(B, H, 64, seed=seed + 1)
    dy = rng.standard_normal((B, T, H, 64)).astype(np.float32)
    ds = (rng.standard_normal((B, H, 64, 64)) * 0.1).astype(np.float32)
    return args, s0, dy, ds


def _jax_vjp(fn, args, s0, dy, ds):
    """(y, final state, the seven gradients) of ``fn`` in JAX."""
    jargs = [jnp.asarray(x) for x in args] + [jnp.asarray(s0)]
    (y, s), vjp = jax.vjp(lambda *xs: fn(*xs[:6], xs[6]), *jargs)
    grads = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    return [np.asarray(x) for x in (y, s, *grads)]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("jax_impl", ["auto", "pallas"])
def test_wkv7_grad_at_t24_chunk8_matches_jax(packed, jax_impl):
    """T = 24 at chunk 8: ``pw.wkv7`` pads to 32 steps inside the Function;
    y, the final state and all seven gradients against the JAX package's
    ``wkv7`` at chunk 8 (``jax_impl`` "auto" is its jnp chunked form on the
    CPU, "pallas" its fused pair at chunk 8 in interpret mode) and against
    ``jax.grad`` of ``wkv7_reference``."""
    B, T, H = 2, 24, 2
    args, s0, dy, ds = _case(B, T, H, seed=7)
    j_set_wkv_impl(jax_impl)
    try:
        want = _jax_vjp(lambda *xs: j_wkv7(*xs, chunk=8), args, s0, dy, ds)
    finally:
        j_set_wkv_impl("auto")
    ref = _jax_vjp(j_reference, args, s0, dy, ds)
    pw.set_wkv_impl("packed" if packed else "auto")
    try:
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in args + [s0]]
        y, s = pw.wkv7(*leaves[:6], leaves[6], chunk=8)
        assert y.grad_fn.name().endswith("WKV7PackedFunctionBackward" if packed else "WKV7FunctionBackward")
        grads = torch.autograd.grad((y, s), leaves, (torch.from_numpy(dy), torch.from_numpy(ds)))
    finally:
        pw.set_wkv_impl("auto")
    assert y.shape == (B, T, H, 64)
    for what, got, a, b in zip(("y", "final state") + NAMES, (y, s, *grads), want, ref):
        assert max_rel(to_np(got), a) < TOL, (what, "vs jax wkv7 at chunk 8")
        assert max_rel(to_np(got), b) < TOL, (what, "vs jax.grad of the reference")


def test_wkv7_padding_steps_are_identities():
    """The padded call (T = 40, 8 identity steps to 48) gives the outputs and
    gradients of the unpadded forms: float64 autograd of the sequential scan
    at T = 40, no initial state, the final state unused."""
    B, T, H = 1, 40, 2
    args, _, dy, _ = _case(B, T, H, seed=11)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in args]
    y, _ = pw.wkv7(*leaves)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    l64 = [torch.from_numpy(x).double().requires_grad_(True) for x in args]
    y64, _ = pw.wkv7_reference(*l64)
    ref = torch.autograd.grad(y64, l64, torch.from_numpy(dy).double())
    assert max_rel(to_np(y), to_np(y64)) < TOL
    for name, g, r in zip(NAMES, grads, ref):
        assert g.shape == (B, T, H, 64)
        assert max_rel(to_np(g), to_np(r)) < TOL, name


def test_pad_steps_keep_the_state():
    """An identity step's decay is exactly 1 in fp32 and bf16, so a padded
    step leaves the state bit for bit."""
    for dt in (torch.float32, torch.bfloat16):
        w = torch.full((4,), PAD_W_RAW, dtype=dt)
        assert torch.equal(torch.exp(-torch.exp(w.float())), torch.ones(4))
    xs = [torch.randn(1, 5, 2, 64) for _ in range(6)]
    padded = pad_steps(xs, 1, 16)
    assert all(x.shape == (1, 16, 2, 64) for x in padded)
    assert all(torch.equal(p[:, :5], x) for p, x in zip(padded, xs))
    assert (padded[1][:, 5:] == PAD_W_RAW).all() and all((p[:, 5:] == 0).all() for i, p in
                                                          enumerate(padded) if i != 1)
    s0 = torch.randn(1, 2, 64, 64, dtype=torch.float64)
    _, s = pw.wkv7_reference(*(p[:, 5:].double() for p in padded), s0)
    assert torch.equal(s, s0)


NAMES6 = ("r", "w_raw", "k", "v", "u", "initial_state")


def _wkv6_case(B, T, H, seed, floored, chunk=8):
    """x060 streams, state and cotangents. ``floored``: w_raw = 3 everywhere
    at chunk 8 (exp(3) = 20 > 10, so the floor binds on every channel),
    ln(80 / chunk) + 0.5 at another chunk; else w_raw uniform in [-3, 2.5] at
    chunk 8 (the floor binds where w_raw > ln 10, on about 4 % of the
    channels), in [-3, ln(80 / chunk) + 0.5] at another (6-8 %)."""
    rng = np.random.default_rng(seed)
    shp = (B, T, H, 64)
    r, k, v = (rng.standard_normal(shp) * 0.5 for _ in range(3))
    top = 2.5 if chunk == 8 else np.log(80.0 / chunk) + 0.5
    w_raw = np.full(shp, 3.0 if chunk == 8 else top) if floored else rng.uniform(-3.0, top, shp)
    u = rng.standard_normal((H, 64)) * 0.3
    s0 = _state(B, H, 64, seed=seed + 1)
    dy = rng.standard_normal(shp)
    ds = rng.standard_normal((B, H, 64, 64)) * 0.1
    return [x.astype(np.float32) for x in (r, w_raw, k, v, u, s0, dy, ds)]


def _check_wkv6_at_chunk8(floored, chunk=8):
    """``pw.wkv6`` with a gradient at T = 24, chunk 8 (WKV6Function pads it
    to 32 steps): y, the final state and the six gradients against the JAX
    package's ``wkv6`` and ``jax.vjp`` of its ``wkv6_chunked``, both at
    chunk 8, and against autograd of the port's ``wkv6_plain(chunk=8)``; or
    the same at another ``chunk`` that divides 24."""
    B, T, H = 2, 24, 2
    *ins, dy, ds = _wkv6_case(B, T, H, seed=3, floored=floored, chunk=chunk)
    cot = (jnp.asarray(dy), jnp.asarray(ds))
    jax_refs = []
    for fn in (jw6.wkv6, jw6.wkv6_chunked):
        out, vjp = jax.vjp(lambda *xs: fn(*xs[:5], xs[5], chunk=chunk), *(jnp.asarray(x) for x in ins))
        jax_refs.append([np.asarray(x) for x in (*out, *vjp(cot))])
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in ins]
    y, s = p6.wkv6(*leaves[:5], leaves[5], chunk=chunk)
    assert y.grad_fn.name().endswith("WKV6FunctionBackward") and y.shape == (B, T, H, 64)
    got = [y, s, *torch.autograd.grad((y, s), leaves, (torch.from_numpy(dy), torch.from_numpy(ds)))]
    leaves_p = [torch.from_numpy(x).requires_grad_(True) for x in ins]
    y_p, s_p = p6.wkv6_plain(*leaves_p[:5], leaves_p[5], chunk=chunk)
    plain = [y_p, s_p, *torch.autograd.grad((y_p, s_p), leaves_p,
                                            (torch.from_numpy(dy), torch.from_numpy(ds)))]
    dw = jax_refs[1][3]
    binds = np.exp(ins[1].astype(np.float64)) > 80.0 / chunk
    if floored:
        assert (dw == 0).all() and binds.all()  # the floor's gradient is zero on every channel
    else:
        assert np.abs(dw).max() > 0 and 0.01 < binds.mean() < 0.1 and (dw[binds] == 0).all()
        if chunk == 8:  # at chunk 1 JAX's fp32 dw also underflows to 0 off the floor (|true| <= 2e-6)
            assert 0.01 < (dw == 0).mean() < 0.1
    for i, what in enumerate(("y", "final state") + NAMES6):
        for ref, which in zip((*jax_refs, to_np(plain[i])), ("jax wkv6", "jax wkv6_chunked", "wkv6_plain")):
            ref = ref[i] if which != "wkv6_plain" else ref
            g = to_np(got[i])
            if np.abs(ref).max() == 0:
                assert (g == 0).all(), (what, which)
            else:
                assert max_rel(g, ref) < TOL, (what, which)


def test_wkv6_function_pads_and_matches_plain_at_chunk8():
    """The decay floor -10 of chunk 8 binding on every channel (w_raw = 3):
    see :func:`_check_wkv6_at_chunk8`."""
    _check_wkv6_at_chunk8(floored=True)


def test_wkv6_grad_at_chunk8_with_decay_across_the_floor():
    """w_raw uniform in [-3, 2.5], so some channels sit on the floor and the
    rest carry a w_raw gradient: see :func:`_check_wkv6_at_chunk8`."""
    _check_wkv6_at_chunk8(floored=False)


@pytest.mark.parametrize("floored", [True, False], ids=["floor on every channel", "across the floor"])
@pytest.mark.parametrize("chunk", [4, 1])
def test_wkv6_grad_at_low_chunk_len_matches_jax(chunk, floored):
    """``chunk_len`` 4 and 1 (decay floors -20 and -80 a step, the per-pair
    factor form of K7 / K8 on the card): see :func:`_check_wkv6_at_chunk8`."""
    _check_wkv6_at_chunk8(floored, chunk)


@pytest.mark.parametrize("tiny_r", [True, False], ids=["floor on every channel, tiny r", "across the floor"])
@pytest.mark.parametrize("chunk", [4, 2, 1])
def test_per_pair_form_matches_jax_wkv6(chunk, tiny_r):
    """K7 / K8's per-pair factor form (each pair factor of A one exp2 of its
    difference, in fp32 over 16-step chunks) against the JAX package's
    ``wkv6(..., chunk)`` at T = 48 with an initial state: the floor binding
    on every channel with |r| <= 1e-3 on every fourth, or the decay drawn
    across the floor; y and the final state max |delta| <= 1e-4 * max |ref|."""
    B, T, H = 1, 48, 2
    r, w_raw, k, v, u, s0, _, _ = _wkv6_case(B, T, H, seed=5, floored=tiny_r, chunk=chunk)
    if tiny_r:
        r[..., ::4] = np.random.default_rng(6).uniform(-1e-3, 1e-3, r[..., ::4].shape).astype(np.float32)
    want = jw6.wkv6(*(jnp.asarray(x) for x in (r, w_raw, k, v, u, s0)), chunk=chunk)
    got = per_pair_fwd(*(torch.from_numpy(x) for x in (r, w_raw, k, v, u, s0)), chunk)
    for what, g, ref in zip(("y", "final state"), got, want):
        assert max_rel(to_np(g), np.asarray(ref)) < TOL, what


@pytest.mark.parametrize("chunk", range(1, 8))
@pytest.mark.parametrize("name", ["wkv6_fwd", "wkv6_fwd_res"])
def test_k7_k8_take_every_chunk_len(name, chunk):
    """chunk_len 1-7 floors the log decay at -80 to -11.4 a step; K7 / K8
    take every such floor (the per-pair factor form), so CPU tensors get as
    far as the device check."""
    xs = [torch.zeros(1, 32, 2, 64) for _ in range(4)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(wkv6_cuda, name)(*xs, torch.zeros(2, 64), None, chunk)
