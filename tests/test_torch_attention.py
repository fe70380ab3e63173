"""Attention parity: the port's plain versions (the CPU side of kernel K3)
against the JAX package's Pallas flash kernels, run in interpret mode on
the CPU, and against its references.

Tolerance: relative RMS <= 1e-5 in fp32. Softmax and the two products are
summed in a different order (key blocks against one pass); the JAX
package's own flash tests see ~1e-6 between its kernel and reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import rel_rms, to_np
from visualrwkv_torch.vision import flash as pf
from visualrwkv_tpu.vision import flash as jf

TOL = 1e-5


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("G,H,W,hd", [(3, 16, 16, 32), (2, 12, 12, 32), (1, 6, 8, 32)],
                         ids=["16x16", "12x12", "6x8"])
def test_sam_attention_matches_jax_flash_and_reference(G, H, W, hd):
    """16 x 16: one Pallas block of ``sam_flash_attention`` (interpret mode).
    12 x 12 and 6 x 8: grids narrower than 16 and not multiples of it,
    whose key tile K3 pads to 16 keys and masks ("rows"); ``sam_flash_attention``
    does not take them (``sam_flash_supported``), so the reference is the
    JAX package's ``sam_attend_reference``."""
    N = H * W
    rng = np.random.default_rng(3)
    q, k, v = _qkv((G, N, hd), seed=1)
    rel_h = rng.standard_normal((G, N, H)).astype(np.float32)
    rel_w = rng.standard_normal((G, N, W)).astype(np.float32)
    scale = hd**-0.5
    j = [jnp.asarray(x) for x in (q, k, v, rel_h, rel_w)]
    refs = [np.asarray(jf.sam_attend_reference(*j, scale))]
    if jf.sam_flash_supported(N, W):
        refs.append(np.asarray(jf.sam_flash_attention(*j, scale)))
    assert len(refs) == (2 if H == 16 else 1)

    t = [torch.from_numpy(x) for x in (q, k, v, rel_h, rel_w)]
    for fn in (pf.sam_attention, pf.sam_attend_reference):
        out = to_np(fn(*t, scale))
        for ref in refs:
            assert rel_rms(out, ref) < TOL
    # query blocks that do not divide N give the same answer
    out_blk = to_np(pf.sam_attend_reference(*t, scale, block=100))
    assert rel_rms(out_blk, refs[0]) < TOL
    # the bias matters: without it the answer moves
    zero = to_np(pf.sam_attention(t[0], t[1], t[2], torch.zeros_like(t[3]),
                                  torch.zeros_like(t[4]), scale))
    assert rel_rms(zero, refs[0]) > 1e-3


@pytest.mark.parametrize("N,hd", [(133, 32), (256, 32), (133, 72)])
def test_mha_matches_jax_flash_mha(N, hd):
    """133: a ragged tail, masked in K3; hd 72: SigLIP-so400m's head dim,
    which K3 zero-pads to 80 for its 16-wide tensor-core tiles."""
    B, h = 2, 2
    q, k, v = _qkv((B, N, h, hd), seed=N)
    j = [jnp.asarray(x) for x in (q, k, v)]
    out_flash = np.asarray(jf.flash_mha(*j))
    import jax

    out_ref = np.asarray(jax.nn.dot_product_attention(*j))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    for fn in (pf.mha, pf.mha_reference):
        out = to_np(fn(*t))
        assert out.shape == (B, N, h, hd)
        assert rel_rms(out, out_flash) < TOL
        assert rel_rms(out, out_ref) < TOL


@pytest.mark.parametrize("layout", ["sam", "mha"])
def test_attention_fwd_plain_lse_is_logsumexp(layout):
    """The lse output of K3's plain version (what K14 / K15 recompute p from)
    is the natural log-sum-exp of each query row's logits, bias included,
    over query blocks that do not divide N."""
    scale = 32**-0.5
    if layout == "sam":
        G, H, W = 2, 12, 12
        N = H * W
        q, k, v = (torch.from_numpy(x) for x in _qkv((G, N, 32), seed=7))
        rng = np.random.default_rng(7)
        rel_h = torch.from_numpy(rng.standard_normal((G, N, H)).astype(np.float32))
        rel_w = torch.from_numpy(rng.standard_normal((G, N, W)).astype(np.float32))
        qg, kg = q, k
        bias = (rel_h[:, :, :, None] + rel_w[:, :, None, :]).reshape(G, N, N)
    else:
        B, N, h = 2, 133, 2
        q, k, v = (torch.from_numpy(x) for x in _qkv((B, N, h, 32), seed=8))
        rel_h = rel_w = None
        qg, kg = (x.permute(0, 2, 1, 3).reshape(B * h, N, 32) for x in (q, k))
        bias = 0.0
    o, lse = pf.attention_fwd_plain(q, k, v, rel_h, rel_w, scale, layout, block=50)
    logits = (qg * scale) @ kg.transpose(-1, -2) + bias
    want = torch.logsumexp(logits, dim=-1)
    assert lse.shape == want.shape and lse.dtype == torch.float32
    assert rel_rms(to_np(lse), to_np(want)) < 1e-6
    # and the output is the softmax-weighted values it normalises
    o_full, _ = pf.attention_fwd_plain(q, k, v, rel_h, rel_w, scale, layout)
    assert rel_rms(to_np(o), to_np(o_full)) < TOL


# (hd, Hk, Wk) -> K3's (path, key tile): the cases of chip_smoke.py's
# check_attention (SAM-B at 1024, 768 and 512 pixels; DINOv2-L, SigLIP,
# CLIP-L without a bias) and of its ATTN_FWD_PATH_CASES, and the edge of
# the "rows" path's height limit
_FWD_PLANS = {
    (64, 64, 64): ("rows", 64),
    (64, 48, 48): ("rows", 48),
    (64, 32, 32): ("rows", 32),
    (64, 0, 0): ("mha", 64),
    (72, 0, 0): ("mha", 64),
    (64, 12, 12): ("rows", 16),
    (64, 6, 9): ("rows", 16),
    (64, 80, 80): ("general", 64),
    (72, 16, 16): ("general", 64),
    (64, 300, 4): ("general", 64),
    (64, 256, 4): ("rows", 16),
}


@pytest.mark.parametrize("hd,Hk,Wk", list(_FWD_PLANS), ids=[f"{a}-{b}x{c}" for a, b, c in _FWD_PLANS])
def test_fwd_plan(hd, Hk, Wk):
    """``fwd_plan``, the Python side of K3's ``make_plan``: with a bias, head
    dim 64 and a grid at most 64 wide and ``FWD_ROWS_MAX_HK`` tall, a key
    tile is one grid row padded to a multiple of 16; otherwise 64-key
    tiles. ``chip_smoke.py`` holds it equal to the compiled library's plan
    on the card."""
    plan = pf.fwd_plan(hd, Hk, Wk)
    assert (plan["path"], plan["key_tile"]) == _FWD_PLANS[hd, Hk, Wk]
    assert plan["block_rows"] == (64 if plan["path"] == "mha" and hd == 64 else 128)
    if plan["path"] == "rows":
        assert plan["key_tile"] % 16 == 0 and plan["key_tile"] >= Wk > plan["key_tile"] - 16
        assert Hk <= pf.FWD_ROWS_MAX_HK
    # K14 tiles keys the same way on the towers' grids
    if Hk and Hk <= pf.FWD_ROWS_MAX_HK:
        bwd = pf.bwd_plan(hd, Hk, Wk)
        assert (bwd["dq_path"], bwd["dq_key_tile"]) == (plan["path"], plan["key_tile"])
