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


def test_sam_attention_matches_jax_flash_and_reference():
    G, H, W, hd = 3, 16, 16, 32
    N = H * W
    rng = np.random.default_rng(3)
    q, k, v = _qkv((G, N, hd), seed=1)
    rel_h = rng.standard_normal((G, N, H)).astype(np.float32)
    rel_w = rng.standard_normal((G, N, W)).astype(np.float32)
    scale = hd**-0.5
    j = [jnp.asarray(x) for x in (q, k, v, rel_h, rel_w)]
    assert jf.sam_flash_supported(N, W)
    out_flash = np.asarray(jf.sam_flash_attention(*j, scale))
    out_ref = np.asarray(jf.sam_attend_reference(*j, scale))

    t = [torch.from_numpy(x) for x in (q, k, v, rel_h, rel_w)]
    for fn in (pf.sam_attention, pf.sam_attend_reference):
        out = to_np(fn(*t, scale))
        assert rel_rms(out, out_flash) < TOL
        assert rel_rms(out, out_ref) < TOL
    # query blocks that do not divide N give the same answer
    out_blk = to_np(pf.sam_attend_reference(*t, scale, block=100))
    assert rel_rms(out_blk, out_ref) < TOL
    # the bias matters: without it the answer moves
    zero = to_np(pf.sam_attention(t[0], t[1], t[2], torch.zeros_like(t[3]),
                                  torch.zeros_like(t[4]), scale))
    assert rel_rms(zero, out_ref) > 1e-3


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
