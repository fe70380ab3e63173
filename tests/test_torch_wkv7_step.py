"""The decode steps of kernels K2 (head layout) and K4 (flat layout) at the
flagship's head count: the launch plan ``wkv7_cuda.step_plan`` that splits
a head's state over value-row slices, and the port's plain steps (the CPU
side of K2 / K4) against the JAX package's ``wkv7_step_pallas`` and
``wkv7_step_flat_pallas`` (interpret mode on the CPU, as its own tests run
them) at B = 1 and 4, H = 32, N = 64.

Tolerance: max |delta| <= 1e-4 * max |ref| for y and an fp32 state (the
same fp32 sums in another order). With a bf16 carry both sides start from
the same bf16 state and do fp32 math; the new bf16 states may differ by one
bf16 rounding (2^-8 relative), so that comparison allows 8e-3 * max |ref|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_wkv7 import _inputs, _state
from torch_port_helpers import max_rel, to_np
from visualrwkv_torch.ops import wkv7 as pw
from visualrwkv_torch.ops import wkv7_cuda
from visualrwkv_tpu.ops.wkv7 import state_to_flat as j_state_to_flat
from visualrwkv_tpu.ops.wkv7_pallas import wkv7_step_flat_pallas, wkv7_step_pallas

TOL = 1e-4
BF16_STATE_TOL = 8e-3
H, N = 32, 64
DTYPES = (torch.float32, torch.bfloat16)


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("state_dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 2, 4, 32, 64])
def test_step_plan(B, state_dtype, flat):
    """Rows that divide 64; at least 128 blocks (one for about each of the
    H100's 132 multiprocessors) at every batch of the flagship's H=32; 16
    bytes a lane; whole warps of at most ``STEP_THREADS``, a thread taking
    one row or two. K2 (and K4 with a bf16 state) takes the most rows that
    still give those blocks: whole heads once B * H fills the card with a
    bf16 state, 32 rows (two a thread) with fp32; K4 with an fp32 state
    takes 8 rows at every batch."""
    plan = wkv7_cuda.step_plan(B, H, state_dtype, flat)
    rows, lanes = plan["rows"], (16 if state_dtype == torch.float32 else 8)
    assert rows in wkv7_cuda.STEP_ROWS and 64 % rows == 0
    assert plan["blocks"] == B * H * (64 // rows) >= wkv7_cuda.STEP_BLOCKS
    assert plan["lanes_per_row"] == lanes and plan["rows_per_thread"] in (1, 2)
    assert plan["threads"] % 32 == 0 and plan["threads"] <= wkv7_cuda.STEP_THREADS
    assert plan["threads"] * plan["rows_per_thread"] == rows * lanes
    if flat and state_dtype == torch.float32:
        assert rows == 8
    elif B * H >= wkv7_cuda.STEP_BLOCKS:
        assert rows == (64 if state_dtype == torch.bfloat16 else 32) and plan["rows_per_thread"] == 2
    else:  # the most rows that still fill the card
        assert rows < 64 and B * H * (64 // (2 * rows)) < wkv7_cuda.STEP_BLOCKS


@pytest.mark.parametrize("state_dtype", DTYPES)
def test_step_plan_flagship_b1(state_dtype):
    """K2 at the serving path's B=1 H=32: 16 rows, 128 blocks."""
    plan = wkv7_cuda.step_plan(1, H, state_dtype)
    assert plan["blocks"] >= 128 and plan["rows"] == 16


def _case(B, state_dtype, seed):
    vecs = _inputs(B, 1, H, N, seed=seed, lead=(B,))
    jdt = jnp.dtype(str(state_dtype)[6:])
    js0 = jnp.asarray(_state(B, H, N, seed=seed + 1)).astype(jdt)
    ts0 = torch.from_numpy(np.array(js0.astype(jnp.float32))).to(state_dtype)
    return vecs, js0, ts0, [torch.from_numpy(x) for x in vecs]


@pytest.mark.parametrize("state_dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 4])
def test_step_matches_jax_pallas(B, state_dtype):
    vecs, js0, ts0, tvecs = _case(B, state_dtype, seed=10 + B)
    s_j, y_j = wkv7_step_pallas(js0, *[jnp.asarray(x) for x in vecs])
    state_tol = TOL if state_dtype == torch.float32 else BF16_STATE_TOL
    for fn in (pw.wkv7_step, pw.wkv7_step_auto):
        s, y = fn(ts0, *tvecs)
        assert s.shape == (B, H, N, N) and y.shape == (B, H, N)
        assert max_rel(to_np(y), np.asarray(y_j)) < TOL
        assert max_rel(to_np(s.to(state_dtype)), np.asarray(s_j.astype(jnp.float32))) < state_tol


@pytest.mark.parametrize("state_dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 4])
def test_step_flat_matches_jax_pallas(B, state_dtype):
    vecs, js0, ts0, tvecs = _case(B, state_dtype, seed=20 + B)
    jflat = j_state_to_flat(js0)
    s_j, y_j = wkv7_step_flat_pallas(jflat, *[jnp.asarray(x) for x in vecs])
    tflat = pw.state_to_flat(ts0).contiguous()
    state_tol = TOL if state_dtype == torch.float32 else BF16_STATE_TOL
    for fn in (pw.wkv7_step_flat, pw.wkv7_step_auto):
        s, y = fn(tflat, *tvecs)
        assert s.dtype == state_dtype and s.shape == (B, N, H * N) and y.shape == (B, H, N)
        assert max_rel(to_np(y), np.asarray(y_j)) < TOL
        assert max_rel(to_np(s), np.asarray(s_j.astype(jnp.float32))) < state_tol


@pytest.mark.parametrize("fn", [wkv7_cuda.wkv7_step, wkv7_cuda.step_floor])
def test_step_wrappers_refuse_cpu_tensors(fn):
    """K2 and the launch-floor kernel take CUDA tensors only: on the CPU the
    dispatcher runs the plain step, never a kernel."""
    tvecs = [torch.from_numpy(x) for x in _inputs(1, 1, 2, N, seed=0, lead=(1,))]
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        fn(torch.zeros(1, 2, N, N), *tvecs)
