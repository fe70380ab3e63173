"""The chunk-batched WKV7 forward of the port (``ops.wkv7.wkv7_v2``; on the
CPU its plain version ``wkv7_v2_plain``, the CPU side of kernel K16)
against the JAX package's ``wkv7_pallas_v2``, run in interpret mode as its
own test runs it, and its stability on the adversarial construction of
``tests/test_wkv7_stability.py``.

Tolerance: norm-relative error <= 1e-5 in fp32, the JAX package's own
limit for ``wkv7_pallas_v2`` against its reference (both sides compute the
chunk-32 form in fp32; the port solves each chunk's system by length-16
block substitution where the Pallas kernel forms the whole inverse)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_wkv7 import _inputs, _state
from test_wkv7_stability import _adversarial_inputs
from visualrwkv_torch.ops import wkv7 as pw
from visualrwkv_tpu.ops.wkv7 import wkv7_reference as j_reference
from visualrwkv_tpu.ops.wkv7_pallas import wkv7_pallas_v2

TOL = 1e-5


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / (np.linalg.norm(ref) + 1e-30))


@pytest.mark.parametrize("t_block,g_heads", [(64, 2), (128, 4)])
def test_wkv7_v2_matches_jax_pallas_v2(t_block, g_heads):
    B, T, H, N = 2, 256, 4, 16
    args = _inputs(B, T, H, N, seed=t_block)
    s0 = _state(B, H, N, seed=9)
    y_j, s_j = wkv7_pallas_v2(*(jnp.asarray(x) for x in args), initial_state=jnp.asarray(s0),
                              chunk=32, t_block=t_block, g_heads=g_heads)
    y, s = pw.wkv7_v2(*(torch.from_numpy(x) for x in args), torch.from_numpy(s0), chunk=32,
                      t_block=t_block, g_heads=g_heads)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    assert _rel(y, y_j) < TOL and _rel(s, s_j) < TOL
    # and both against the sequential scan
    y_r, s_r = j_reference(*(jnp.asarray(x) for x in args), initial_state=jnp.asarray(s0))
    assert _rel(y, y_r) < TOL and _rel(s, s_r) < TOL


def test_wkv7_v2_raises_where_the_reference_does():
    args = [torch.from_numpy(x) for x in _inputs(1, 96, 2, 16, seed=1)]
    for kw in ({"t_block": 64}, {"t_block": 48, "chunk": 32}, {"g_heads": 0}):
        with pytest.raises(ValueError):
            pw.wkv7_v2(*args, **kw)
    jargs = [jnp.asarray(x.numpy()) for x in args]
    for kw in ({"t_block": 64}, {"t_block": 48, "chunk": 32}):
        with pytest.raises(ValueError):
            wkv7_pallas_v2(*jargs, **kw)
    pw.wkv7_v2(*args, t_block=96)  # 96 = 3 chunks of 32 tiles T = 96


def test_g_heads_does_not_change_the_result():
    args = [torch.from_numpy(x) for x in _inputs(1, 128, 4, 16, seed=2)]
    outs = [pw.wkv7_v2(*args, t_block=128, g_heads=g) for g in (1, 3, 4, 64)]
    for y, s in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(s, outs[0][1])


def test_v2_plain_in_bf16_errs_like_the_chunk16_form():
    """On the sign-alternating adversarial inputs in bf16, the chunk-32 form
    with length-16 block solves errs no more than twice what the port's
    chunk-16 form errs against the fp32 sequential scan (the envelope of
    the solve length, docs/wkv_chunk_stability.md)."""
    args = _adversarial_inputs()
    f32 = [torch.tensor(x, dtype=torch.float32) for x in args]
    bf = [x.to(torch.bfloat16) for x in f32]
    ref = pw.wkv7_reference(*f32)[0]
    scale = float(ref.abs().max())
    err16 = float((pw.wkv7_chunked(*bf, chunk=16)[0].float() - ref).abs().max()) / scale
    y32 = pw.wkv7_v2_plain(*bf)[0].float()
    assert torch.isfinite(y32).all()
    err32 = float((y32 - ref).abs().max()) / scale
    assert err32 <= 2 * err16, (err32, err16)


def test_k16_wrapper_refuses_cpu_tensors():
    from visualrwkv_torch.ops import wkv7_cuda

    args = [torch.from_numpy(x) for x in _inputs(1, 64, 2, 64, seed=3)]
    with pytest.raises(ValueError):
        wkv7_cuda.wkv7_fwd_v2(*args)


SM_SMEM = 228 * 1024  # shared memory of an H100 multiprocessor, bytes
BLOCK_RESERVED = 1024  # what the card keeps a resident block besides its own


@pytest.mark.parametrize("B,T,H,dtype", [(8, 512, 32, torch.bfloat16), (1, 1024, 32, torch.bfloat16),
                                         (1, 1024, 32, torch.float32), (2, 64, 3, torch.bfloat16)])
def test_k16_launch_plan(B, T, H, dtype):
    """K16's two launches (``wkv7_cuda.v2_plan``, computed in Python; the
    card's run holds it equal to the library's own numbers). Phase 1: a
    block a (b, h, 32-step chunk); with bf16 streams three of them share a
    multiprocessor's shared memory. Phase 2: a block a (b, h, slice of value
    columns of Z), the columns a multiple of 8 (an m16n8 tile) that divides
    64, every slice's shared memory within a block's limit. The scratch is
    q_eff, y_loc, bta and h_loc a chunk in the stream dtype and p_last in
    fp32."""
    from visualrwkv_torch.ops import wkv7_cuda

    plan = wkv7_cuda.v2_plan(B, T, H, dtype)
    nc = T // 32
    p1, p2 = plan["chunk"], plan["state"]
    assert p1["blocks"] == B * H * nc and p1["threads"] == 128
    cols = p2["cols"]
    assert cols % 8 == 0 and 64 % cols == 0 and p2["blocks"] == B * H * (64 // cols)
    assert p2["threads"] == 128 and p2["stages"] >= 1
    assert max(p1["smem_bytes"], p2["smem_bytes"]) <= 232448
    esz = 2 if dtype == torch.bfloat16 else 4
    assert plan["scratch_bytes"] == B * H * nc * ((2 * 32 * 64 + 2 * 64 * 64) * esz + 64 * 4)
    if dtype == torch.bfloat16:
        assert 3 * (p1["smem_bytes"] + BLOCK_RESERVED) <= SM_SMEM
        # the widest slices that still give wkv7_cuda.V2_BLOCKS blocks, else the narrowest
        wider = [n for n in wkv7_cuda.V2_COLS if n > cols]
        assert p2["blocks"] >= wkv7_cuda.V2_BLOCKS or cols == min(wkv7_cuda.V2_COLS)
        assert all(B * H * (64 // n) < wkv7_cuda.V2_BLOCKS for n in wider)


def test_k16_phase2_slices_fill_the_card():
    """At one prefill's B=1 H=32 the bf16 phase 2 runs 128 blocks (four
    slices of 16 columns a head), about one for each of the H100's 132
    multiprocessors, where a block a head ran 32; at the reference's B=8
    H=32 whole heads already give 256 blocks."""
    from visualrwkv_torch.ops import wkv7_cuda

    b1 = wkv7_cuda.v2_plan(1, 1024, 32, torch.bfloat16)["state"]
    b8 = wkv7_cuda.v2_plan(8, 512, 32, torch.bfloat16)["state"]
    assert (b1["cols"], b1["blocks"]) == (16, 128) and (b8["cols"], b8["blocks"]) == (64, 256)
