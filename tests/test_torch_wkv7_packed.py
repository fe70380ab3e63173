"""The head-pair ("packed") WKV7 of the port, the CPU side of kernels K11-K13:
the layout functions, ``wkv7_packed_plain``, ``wkv7_fwd_res_packed_plain`` and
``wkv7_bwd_packed_plain`` against the JAX package's ``wkv7_pallas_packed``,
``wkv7_pallas_fwd_res_packed`` and ``wkv7_pallas_bwd_packed`` (run in
interpret mode on the CPU, as the JAX package's own tests run them), and the
dispatch of ``set_wkv_impl``.

Tolerances, relative RMS: fp32 <= 1e-5 (the same fp32 arithmetic in another
order: a sequential scan against the chunk's matrix form). With bf16
streams each side is held, as the JAX package's own test holds its packed
kernel, to <= 5e-3 of the fp32 scan on the same bf16 inputs, and the two
sides to <= 1e-2 of each other, the sum of those limits: both keep fp32
states but round the output and some intermediates to bf16 at different
places. The dispatch modes give the same values and gradients on the CPU
to <= 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_wkv7 import _inputs, _state
from torch_port_helpers import rel_rms, to_np
from visualrwkv_torch.ops import wkv7 as pw
from visualrwkv_tpu.ops import wkv7_pallas as jp
from visualrwkv_tpu.ops.wkv7 import wkv7_reference as j_reference

FP32_TOL = 1e-5
BF16_TOL = 5e-3  # each side against the fp32 scan
BF16_PAIR_TOL = 2 * BF16_TOL  # the two sides against each other
B, T, H, N = 1, 32, 2, 64


@pytest.fixture(autouse=True)
def _auto_mode():
    """The WKV mode is process-wide, as the JAX package's; leave it at auto."""
    yield
    pw.set_wkv_impl("auto")


def _case(seed, H=H):
    rng = np.random.default_rng(seed + 50)
    args = _inputs(B, T, H, N, seed=seed)
    s0 = _state(B, H, N, seed=seed + 1)
    dy = rng.standard_normal((B, T, H, N)).astype(np.float32)
    ds = (rng.standard_normal((B, H, N, N)) * 0.1).astype(np.float32)
    return args, s0, dy, ds


def test_layouts_equal_jax():
    rng = np.random.default_rng(0)
    Bx, Tx, Hx, Nx = 2, 5, 4, 8
    x = rng.standard_normal((Bx, Tx, Hx, Nx)).astype(np.float32)
    s = rng.standard_normal((Bx, Hx, Nx, Nx)).astype(np.float32)
    packed = pw._pack_stream(torch.from_numpy(x), Bx, Tx, Hx, Nx)
    np.testing.assert_array_equal(to_np(packed), np.asarray(jp._pack_stream(jnp.asarray(x), Bx, Tx, Hx, Nx)))
    np.testing.assert_array_equal(to_np(pw._unpack_stream(packed, Bx, Tx, Hx, Nx)), x)
    np.testing.assert_array_equal(
        to_np(pw._unpack_stream(torch.from_numpy(x.reshape(Bx * Hx // 2, Tx, 2 * Nx)), Bx, Tx, Hx, Nx)),
        np.asarray(jp._unpack_stream(jnp.asarray(x.reshape(Bx * Hx // 2, Tx, 2 * Nx)), Bx, Tx, Hx, Nx)))
    z = pw._pack_state_z(torch.from_numpy(s), Bx, Hx, Nx)
    np.testing.assert_array_equal(to_np(z), np.asarray(jp._pack_state_z(jnp.asarray(s), Bx, Hx, Nx)))
    np.testing.assert_array_equal(to_np(pw._unpack_state_z(z, Bx, Hx, Nx)), s)
    np.testing.assert_array_equal(
        to_np(pw._unpack_state_z(torch.from_numpy(s.reshape(Bx * Hx // 2, Nx, 2 * Nx)), Bx, Hx, Nx)),
        np.asarray(jp._unpack_state_z(jnp.asarray(s.reshape(Bx * Hx // 2, Nx, 2 * Nx)), Bx, Hx, Nx)))
    # element [p, j, h2*N + i] is S_{2p+h2}[i, j]
    assert float(z[1, 3, Nx + 2]) == s[0, 3, 2, 3]


@pytest.mark.parametrize("dtype,with_state", [("float32", False), ("float32", True),
                                              ("bfloat16", True)])
def test_packed_forward_matches_jax(dtype, with_state):
    args, s0, _, _ = _case(seed=1)
    js0 = jnp.asarray(s0) if with_state else None
    ts0 = torch.from_numpy(s0) if with_state else None
    jargs = [jnp.asarray(x).astype(dtype) for x in args]
    y_j, s_j = jp.wkv7_pallas_packed(*jargs, js0, chunk=16)
    y, s = pw.wkv7_packed_plain(*[torch.from_numpy(x).to(getattr(torch, dtype)) for x in args], ts0)
    assert y.dtype == getattr(torch, dtype) and s.dtype == torch.float32
    y, s, y_j, s_j = to_np(y), to_np(s), np.asarray(y_j, np.float32), np.asarray(s_j)
    if dtype == "float32":
        assert rel_rms(y, y_j) < FP32_TOL and rel_rms(s, s_j) < FP32_TOL
        return
    y_ref, s_ref = j_reference(*[x.astype(jnp.float32) for x in jargs], js0)
    for got in ((y, s), (y_j, s_j)):
        assert rel_rms(got[0], np.asarray(y_ref)) < BF16_TOL
        assert rel_rms(got[1], np.asarray(s_ref)) < BF16_TOL
    assert rel_rms(y, y_j) < BF16_PAIR_TOL and rel_rms(s, s_j) < BF16_PAIR_TOL


@pytest.mark.parametrize("with_state", [False, True])
def test_packed_fwd_res_matches_jax(with_state):
    args, s0, _, _ = _case(seed=2)
    js0 = jnp.asarray(s0) if with_state else None
    ts0 = torch.from_numpy(s0) if with_state else None
    y_j, s_j, zin_j = jp.wkv7_pallas_fwd_res_packed(*[jnp.asarray(x) for x in args], js0, chunk=16)
    y, s, zin = pw.wkv7_fwd_res_packed_plain(*[torch.from_numpy(x) for x in args], ts0)
    assert zin.shape == (B * H // 2, T // 16, N, 2 * N) == zin_j.shape and zin.dtype == torch.float32
    assert rel_rms(to_np(y), np.asarray(y_j)) < FP32_TOL
    assert rel_rms(to_np(s), np.asarray(s_j)) < FP32_TOL
    assert rel_rms(to_np(zin), np.asarray(zin_j)) < FP32_TOL
    if with_state:  # the first saved states are the packed initial state
        np.testing.assert_array_equal(to_np(zin[:, 0]), np.asarray(jp._pack_state_z(js0, B, H, N)))


def test_packed_bwd_matches_jax():
    """All seven gradients from the JAX package's own packed ``zin``, with a
    non-zero initial state and a non-zero cotangent of the final state."""
    args, s0, dy, ds = _case(seed=3)
    jargs = [jnp.asarray(x) for x in args]
    _, _, zin_j = jp.wkv7_pallas_fwd_res_packed(*jargs, jnp.asarray(s0), chunk=16)
    g_j = jp.wkv7_pallas_bwd_packed(*jargs, zin_j, jnp.asarray(dy), jnp.asarray(ds), chunk=16)
    g = pw.wkv7_bwd_packed_plain(*[torch.from_numpy(x) for x in args], torch.from_numpy(np.array(zin_j)),
                                 torch.from_numpy(dy), torch.from_numpy(ds))
    for name, a, b in zip(("r", "w_raw", "k", "v", "a", "b", "initial_state"), g, g_j):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert rel_rms(to_np(a), np.asarray(b)) < FP32_TOL, name


def test_packed_functions_reject_odd_heads():
    args, s0, dy, ds = _case(seed=4, H=3)
    t = [torch.from_numpy(x) for x in args]
    with pytest.raises(ValueError, match="even head count"):
        pw.wkv7_packed_plain(*t)
    with pytest.raises(ValueError, match="even head count"):
        pw.wkv7_fwd_res_packed_plain(*t)
    zin = torch.zeros(B * 3, T // 16, N, N)
    with pytest.raises(ValueError, match="even head count"):
        pw.wkv7_bwd_packed_plain(*t, zin, torch.from_numpy(dy), torch.from_numpy(ds))


def test_set_wkv_impl_rejects_unknown_modes():
    with pytest.raises(AssertionError):
        pw.set_wkv_impl("cuda")
    assert pw.get_wkv_impl() == "auto"
    for mode in pw.WKV_IMPLS:
        pw.set_wkv_impl(mode)
        assert pw.get_wkv_impl() == mode


def _value_and_grads(args, s0, dy, ds):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in args + [s0]]
    y, s = pw.wkv7(*leaves[:6], leaves[6])
    grads = torch.autograd.grad((y, s), leaves, (torch.from_numpy(dy), torch.from_numpy(ds)))
    with torch.no_grad():
        y_ng, s_ng = pw.wkv7(*leaves[:6], leaves[6])
    return [y, s, y_ng, s_ng, *grads]


def _counting(monkeypatch, name):
    calls = []
    fn = getattr(pw, name)
    monkeypatch.setattr(pw, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


@pytest.mark.parametrize("mode", ["packed", "pallas", "chunked"])
def test_modes_give_the_values_and_gradients_of_auto(monkeypatch, mode):
    """Every mode computes the same function: values with and without
    autograd and all seven gradients equal auto's to 1e-6. "packed" with
    an even head count runs the packed plain versions."""
    args, s0, dy, ds = _case(seed=5)
    ref = _value_and_grads(args, s0, dy, ds)
    pw.set_wkv_impl(mode)
    calls = {n: _counting(monkeypatch, n) for n in ("wkv7_packed_plain", "wkv7_fwd_res_packed_plain",
                                                     "wkv7_bwd_packed_plain")}
    got = _value_and_grads(args, s0, dy, ds)
    for a, b in zip(got, ref):
        assert rel_rms(to_np(a), to_np(b)) < 1e-6
    assert {n: len(c) for n, c in calls.items()} == dict.fromkeys(calls, 1 if mode == "packed" else 0)


def test_packed_mode_takes_the_head_layout_for_odd_heads(monkeypatch):
    args, s0, dy, ds = _case(seed=6, H=3)
    ref = _value_and_grads(args, s0, dy, ds)
    pw.set_wkv_impl("packed")
    for name in ("wkv7_packed_plain", "wkv7_fwd_res_packed_plain", "wkv7_bwd_packed_plain"):
        monkeypatch.setattr(pw, name, None)  # the packed versions must not be reached
    heads = _counting(monkeypatch, "wkv7_fwd_res_plain")
    got = _value_and_grads(args, s0, dy, ds)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert len(heads) == 1


@pytest.mark.parametrize("name", ["wkv7_fwd_packed", "wkv7_fwd_res_packed", "wkv7_bwd_packed"])
def test_packed_kernel_wrappers_refuse_cpu_tensors(name):
    """K11-K13's wrappers take CUDA tensors only: CPU tensors reach the
    packed plain versions through ``wkv7``, never a kernel or nvcc."""
    from visualrwkv_torch.ops import wkv7_cuda

    args, _, dy, ds = _case(seed=7)
    t = [torch.from_numpy(x) for x in args]
    if name == "wkv7_bwd_packed":
        t += [torch.zeros(B * H // 2, T // 16, N, 2 * N), torch.from_numpy(dy), torch.from_numpy(ds)]
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        getattr(wkv7_cuda, name)(*t)
