"""The WKV6 decode step of kernel K10 at the 7B's head count: its launch plan
``wkv6_cuda.step_plan`` (K2's kernel body, a head's state split over
value-row slices), and the port's plain step (the CPU side of K10) against
the JAX package's ``wkv6_step_pallas``, run in interpret mode on the CPU as
its own tests run it, at B = 1 and 4, H = 64, N = 64.

Inputs are made with numpy from a seed: fp32 vectors, the bonus u [H, 64],
and an fp32 or bf16 state (the bf16 one rounded once, on the JAX side, and
handed to both).

Tolerance: max |delta| <= 1e-4 * max |ref| for y and an fp32 state (the
same fp32 sums in another order). With a bf16 carry both sides start from
the same bf16 state and do fp32 math; the JAX kernel rounds the new state
to bf16 and the port's plain step keeps it in fp32, so that comparison
allows one bf16 rounding, 8e-3 * max |ref|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import max_rel, to_np
from visualrwkv_torch.ops import wkv6 as pw
from visualrwkv_torch.ops import wkv6_cuda, wkv7_cuda
from visualrwkv_tpu.ops.wkv6_pallas import wkv6_step_pallas

TOL = 1e-4
BF16_STATE_TOL = 8e-3
H, N = 64, 64
DTYPES = (torch.float32, torch.bfloat16)
SMS = 132  # the H100's multiprocessors


@pytest.mark.parametrize("state_dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 2, 4, 32])
def test_step_plan(B, state_dtype):
    """Rows that divide 64, 16 bytes a lane, whole warps of at most
    ``STEP_THREADS``, a thread taking one row or two, and the grid the rows
    imply. An fp32 state takes K2's rows; a bf16 state whole heads."""
    plan = wkv6_cuda.step_plan(B, H, state_dtype)
    rows, lanes = plan["rows"], (16 if state_dtype == torch.float32 else 8)
    assert rows in wkv7_cuda.STEP_ROWS and 64 % rows == 0
    assert plan["blocks"] == B * H * (64 // rows)
    assert plan["lanes_per_row"] == lanes and plan["rows_per_thread"] in (1, 2)
    assert plan["threads"] % 32 == 0 and plan["threads"] <= wkv7_cuda.STEP_THREADS
    assert plan["threads"] * plan["rows_per_thread"] == rows * lanes
    if state_dtype == torch.float32:
        assert plan == wkv7_cuda.step_plan(B, H, state_dtype)
    else:
        assert rows == 64 and plan["rows_per_thread"] == 2


@pytest.mark.parametrize("state_dtype", DTYPES)
def test_step_plan_7b_b1(state_dtype):
    """At the serving path's B=1 H=64: an fp32 state in 128 blocks of 32
    rows, about one for each multiprocessor; a bf16 state in 64 blocks of a
    whole head (8 KiB each), which read faster on the H100 than 128 of 4
    KiB. Either way 256 threads a block, two rows a thread for fp32's 16
    lanes a row, and no block left without a row."""
    plan = wkv6_cuda.step_plan(1, H, state_dtype)
    if state_dtype == torch.float32:
        assert plan["rows"] == 32 and plan["blocks"] == 128 and plan["blocks"] <= SMS
        assert SMS - plan["blocks"] < SMS // 8
    else:
        assert plan["rows"] == 64 and plan["blocks"] == H
    assert plan["threads"] == 256


def _case(B, state_dtype, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, N)).astype(np.float32) * 0.5 for _ in range(3))
    w_raw = rng.uniform(-3.0, 2.5, (B, H, N)).astype(np.float32)
    u = (rng.standard_normal((H, N)) * 0.3).astype(np.float32)
    jdt = jnp.dtype(str(state_dtype)[6:])
    js0 = jnp.asarray((rng.standard_normal((B, H, N, N)) * 0.3).astype(np.float32)).astype(jdt)
    ts0 = torch.from_numpy(np.array(js0.astype(jnp.float32))).to(state_dtype)
    vecs = [r, w_raw, k, v, u]
    return vecs, js0, ts0, [torch.from_numpy(x) for x in vecs]


@pytest.mark.parametrize("state_dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 4])
def test_step_matches_jax_pallas(B, state_dtype):
    """y from the old state with the bonus, the new state with no decay
    floor: the port's plain step and its dispatcher on the CPU against the
    Pallas step kernel in interpret mode."""
    vecs, js0, ts0, tvecs = _case(B, state_dtype, seed=30 + B)
    s_j, y_j = wkv6_step_pallas(js0, *[jnp.asarray(x) for x in vecs])
    state_tol = TOL if state_dtype == torch.float32 else BF16_STATE_TOL
    for fn in (pw.wkv6_step, pw.wkv6_step_auto):
        s, y = fn(ts0, *tvecs)
        assert s.shape == (B, H, N, N) and y.shape == (B, H, N)
        assert max_rel(to_np(y), np.asarray(y_j)) < TOL
        assert max_rel(to_np(s.float()), np.asarray(s_j.astype(jnp.float32))) < state_tol


@pytest.mark.parametrize("fn", [wkv6_cuda.wkv6_step, wkv6_cuda.step_floor])
def test_step_wrappers_refuse_cpu_tensors(fn):
    """K10 and the launch-floor kernel on K10's grid take CUDA tensors only:
    on the CPU the dispatcher runs the plain step, never a kernel."""
    vecs, _, ts0, tvecs = _case(1, torch.float32, seed=0)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        fn(ts0, *tvecs)
