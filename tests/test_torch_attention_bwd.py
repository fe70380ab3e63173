"""The attention backward of the port (the CPU side of kernels K14 / K15:
``attention_bwd_plain`` under ``AttentionFunction``) against the JAX
package: the custom VJP of ``sam_flash_attention`` (its two-pass Pallas
backward in interpret mode), ``jax.grad`` of ``jax.nn.dot_product_attention``
for the no-bias MHA (the stock TPU kernel's backward does not run on the
CPU backend), and the gradients of whole towers.

Tolerances, in fp32: norm-relative error <= 1e-5 for the attention
gradients (the JAX package's own flash-gradient tests), <= 1e-4 of each
parameter gradient's norm for the towers (the forward parity tests'
limit; the towers sum over more terms in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import port_tower_cfg, rel_rms, to_np
from visualrwkv_torch.convert.from_jax import _np_tree, _tower_to_jax, tower_params_from_jax
from visualrwkv_torch.train.optim import tree_leaves, tree_map
from visualrwkv_torch.vision import flash as pf
from visualrwkv_torch.vision import sam as psam
from visualrwkv_torch.vision import vit as pvit
from visualrwkv_tpu.vision import flash as jf
from visualrwkv_tpu.vision import sam as jsam
from visualrwkv_tpu.vision import vit as jvit

TOL = 1e-5
TOWER_TOL = 1e-4


def _sam_inputs(G, H, W, hd, seed):
    rng = np.random.default_rng(seed)
    N = H * W
    q, k, v = (rng.standard_normal((G, N, hd)).astype(np.float32) for _ in range(3))
    rel_h = (0.1 * rng.standard_normal((G, N, H))).astype(np.float32)
    rel_w = (0.1 * rng.standard_normal((G, N, W))).astype(np.float32)
    return q, k, v, rel_h, rel_w


def _port_grads(fn, xs):
    """Gradients of sum(sin(fn(*xs))) with respect to every tensor of xs."""
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    out = fn(*ts)
    assert out.grad_fn is not None  # the gradient is not dropped
    torch.sin(out).sum().backward()
    return [to_np(t.grad) for t in ts]


@pytest.mark.parametrize("G,H,W,hd", [(1, 16, 16, 16), (1, 32, 32, 16)],
                         ids=["one_block", "several_blocks"])
def test_sam_attention_gradients_match_jax_flash(G, H, W, hd):
    """N = 256 is one Pallas block; N = 1024 is two query and two key
    blocks of 512, so the cross-block sums of dq, the tables (pass 1) and
    dk / dv (pass 2) are held too."""
    xs = _sam_inputs(G, H, W, hd, seed=H)
    scale = hd**-0.5
    assert jf.sam_flash_supported(H * W, W)

    def loss(q, k, v, rh, rw):
        return jnp.sum(jnp.sin(jf.sam_flash_attention(q, k, v, rh, rw, scale)))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(x) for x in xs))
    got = _port_grads(lambda *t: pf.sam_attention(*t, scale), xs)
    for name, g, r in zip(("q", "k", "v", "rel_h", "rel_w"), got, ref):
        assert g.shape == r.shape
        assert rel_rms(g, r) < TOL, (name, rel_rms(g, r))


@pytest.mark.parametrize("G,H,W,hd", [(2, 12, 12, 16), (1, 6, 8, 16)], ids=["12x12", "6x8"])
def test_sam_attention_gradients_narrow_grids_match_jax(G, H, W, hd):
    """Grids narrower than 64, whose width is not a multiple of 16: K14 pads
    a key tile of one grid row to 16 keys and masks the rest, K15 stages a
    block's rel_h columns over several grid rows. N = 144 and 48 are not
    multiples of 128, which ``sam_flash_attention`` needs, so the reference
    is ``jax.grad`` of the JAX package's chunked ``sam_attend_reference``."""
    xs = _sam_inputs(G, H, W, hd, seed=H * W)
    scale = hd**-0.5
    assert not jf.sam_flash_supported(H * W, W)

    def loss(q, k, v, rh, rw):
        return jnp.sum(jnp.sin(jf.sam_attend_reference(q, k, v, rh, rw, scale)))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(x) for x in xs))
    got = _port_grads(lambda *t: pf.sam_attention(*t, scale), xs)
    for name, g, r in zip(("q", "k", "v", "rel_h", "rel_w"), got, ref):
        assert g.shape == r.shape
        assert rel_rms(g, r) < TOL, (name, rel_rms(g, r))


# (hd, Hk, Wk) -> what K14 / K15 launch: the cases of chip_smoke.py's
# check_attention_bwd (SAM-B at 1024, 768 and 512 pixels; DINOv2-L, SigLIP,
# CLIP-L without a bias) and of its ATTN_BWD_PATH_CASES
_PLANS = {
    (64, 64, 64): ("rows", 64, 3, "tma", 64 * (12 + 64) * 4),
    (64, 48, 48): ("rows", 48, 4, "tma", 64 * (12 + 48) * 4),
    (64, 32, 32): ("rows", 32, 5, "tma", 64 * (12 + 32) * 4),
    (64, 0, 0): ("mha", 64, 0, "none", 0),
    (72, 0, 0): ("mha", 64, 0, "none", 0),
    (64, 12, 12): ("rows", 16, 12, "tma", 64 * (20 + 12) * 4),
    (64, 6, 9): ("rows", 16, 6, "loads", 64 * (6 + 9) * 4),
    (64, 80, 80): ("general", 64, 3, "tma", 64 * (12 + 80) * 4),
    (72, 16, 16): ("general", 64, 9, "tma", 64 * (12 + 16) * 4),
}


@pytest.mark.parametrize("hd,Hk,Wk", list(_PLANS), ids=[f"{a}-{b}x{c}" for a, b, c in _PLANS])
def test_bwd_plan(hd, Hk, Wk):
    """``bwd_plan``, the Python side of the kernels' ``make_plan``: with a
    bias and a grid at most 64 wide, a K14 key tile is one grid row padded
    to a multiple of 16; a K15 block of 128 keys stages the rel_h columns of
    the grid rows its keys can span (TMA from a column rounded down to a
    multiple of 4, at least 3 more, 4 mod 8) and all of rel_w. ``chip_smoke.py`` holds it
    equal to the compiled library's plan on the card."""
    plan = pf.bwd_plan(hd, Hk, Wk)
    path, tile, hspan, tables, nbytes = _PLANS[hd, Hk, Wk]
    assert (plan["dq_path"], plan["dq_key_tile"], plan["dkv_hspan"], plan["dkv_tables"],
            plan["dkv_table_bytes"]) == (path, tile, hspan, tables, nbytes)
    if Hk:  # every grid row a block's 128 keys touch lies in its span
        for k0 in range(0, Hk * Wk, pf.BWD_BLOCK_ROWS):
            last = min(Hk * Wk, k0 + pf.BWD_BLOCK_ROWS) - 1
            assert last // Wk - k0 // Wk < hspan
        assert path != "rows" or tile >= Wk > tile - 16


@pytest.mark.parametrize("N,hd", [(256, 32), (133, 32), (256, 72), (133, 72)])
def test_mha_gradients_match_jax(N, hd):
    """133: a ragged tail, masked in K14 / K15; hd 72: SigLIP-so400m's head
    dim, zero-padded to 80 in the kernels."""
    B, h = 2, 2
    rng = np.random.default_rng(N + hd)
    xs = [rng.standard_normal((B, N, h, hd)).astype(np.float32) for _ in range(3)]

    def loss(q, k, v):
        return jnp.sum(jnp.sin(jax.nn.dot_product_attention(q, k, v)))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in xs))
    got = _port_grads(pf.mha, xs)
    for name, g, r in zip("qkv", got, ref):
        assert rel_rms(g, r) < TOL, (name, rel_rms(g, r))


def test_bwd_plain_matches_autograd_of_reference_and_bias_matters():
    """``attention_bwd_plain`` from the forward's lse equals autograd through
    the plain forward, with query blocks that do not divide N; and the bias
    gradient matters: zeroing rel_h changes dq."""
    q, k, v, rel_h, rel_w = (torch.from_numpy(x) for x in _sam_inputs(2, 8, 12, 16, seed=7))
    scale = 16**-0.5
    do = torch.from_numpy(np.random.default_rng(8).standard_normal(q.shape).astype(np.float32))
    o, lse = pf.attention_fwd_plain(q, k, v, rel_h, rel_w, scale, "sam")
    got = pf.attention_bwd_plain(q, k, v, rel_h, rel_w, o, lse, do, scale, "sam", block=40)
    ts = [x.clone().requires_grad_(True) for x in (q, k, v, rel_h, rel_w)]
    pf.sam_attend_reference(*ts, scale).backward(do)
    for g, t in zip(got, ts):
        assert rel_rms(g, t.grad) < TOL
    o0, lse0 = pf.attention_fwd_plain(q, k, v, torch.zeros_like(rel_h), rel_w, scale, "sam")
    dq0 = pf.attention_bwd_plain(q, k, v, torch.zeros_like(rel_h), rel_w, o0, lse0, do, scale,
                                 "sam")[0]
    assert rel_rms(dq0, got[0]) > 1e-3


def test_no_grad_path_is_unchanged():
    """Without a gradient the entry points run the plain forward, as before;
    with one they go through AttentionFunction and give the same output."""
    q, k, v, rel_h, rel_w = (torch.from_numpy(x) for x in _sam_inputs(1, 8, 8, 16, seed=9))
    out = pf.sam_attention(q, k, v, rel_h, rel_w, 0.25)
    assert out.grad_fn is None
    with_grad = pf.sam_attention(q.requires_grad_(True), k, v, rel_h, rel_w, 0.25)
    assert with_grad.grad_fn is not None and torch.equal(with_grad.detach(), out)


def _seeded_tree(jcfg, seed):
    """A tower's JAX parameter tree with seeded numpy leaves (normal, 0.05;
    LayerNorm weights 1 + that): every leaf carries signal, and no JAX
    random op is compiled."""
    init = jsam.init_sam_params if isinstance(jcfg, jsam.SAMConfig) else jvit.init_vit_params
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        x = 0.05 * rng.standard_normal(s.shape)
        keys = [getattr(k, "key", "") for k in path]
        if keys[-1] == "weight" and str(keys[-2]).startswith("ln"):
            x += 1.0
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _tower_grads_close(jcfg, jfeat, pfeat, seed, img):
    """Gradients of <features, seeded cotangent> with respect to every
    parameter of one tower, JAX against the port, on the same weights.
    Leaves the features do not reach (a ViT's final norm) have a zero
    gradient in JAX and none in the port."""
    jp = _seeded_tree(jcfg, seed)
    pcfg = port_tower_cfg(jcfg)
    pp = tower_params_from_jax(jp, pcfg, device="cpu")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, img, img, 3)).astype(np.float32)
    for t in tree_leaves(pp):
        t.requires_grad_(True)
    out = pfeat(pp, pcfg, torch.from_numpy(x))
    cot = rng.standard_normal(tuple(out.shape)).astype(np.float32)
    (out * torch.from_numpy(cot)).sum().backward()
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(jfeat(p, jcfg, jnp.asarray(x)) * cot)))(
        jax.tree_util.tree_map(jnp.asarray, jp))  # one compile, not one a primitive

    pgrads = _tower_to_jax(
        _np_tree(tree_map(lambda t: torch.zeros_like(t) if t.grad is None else t.grad, pp)), pcfg)
    flat_j = jax.tree_util.tree_leaves_with_path(jgrads)
    flat_p = jax.tree_util.tree_leaves_with_path(pgrads)
    assert len(flat_j) == len(flat_p)
    reached = 0
    for (path, a), (_, b) in zip(flat_p, flat_j):
        b = np.asarray(b)
        if not np.abs(b).max() > 0:
            assert not np.abs(a).max() > 0, jax.tree_util.keystr(path)
            continue
        reached += 1
        assert rel_rms(a, b) < TOWER_TOL, (jax.tree_util.keystr(path), rel_rms(a, b))
    assert reached >= len(flat_j) - 2


def test_sam_features_gradient_matches_jax(monkeypatch):
    """A 16 x 16 grid with the dense limit lowered to 128 tokens: the global
    block (N = 256) takes the streaming branch on both sides (the port's
    AttentionFunction; JAX's flash kernel and its two-pass backward, in
    interpret mode); the windowed block runs the plain attention. Every
    parameter's gradient, the rel-pos tables of both blocks included."""
    jcfg = jsam.SAMConfig(img_size=128, patch_size=8, width=32, depth=2, heads=2, mlp_dim=64,
                          out_chans=16, window_size=4, global_attn_indexes=(1,),
                          compute_dtype="float32")
    monkeypatch.setattr(jsam, "_MAX_DENSE_TOKENS", 128)
    monkeypatch.setattr(psam, "MAX_DENSE_TOKENS", 128)
    assert psam.global_blocks(port_tower_cfg(jcfg)) == 1
    with jf.vision_flash("on"):
        _tower_grads_close(jcfg, jsam.sam_features, psam.sam_features, seed=11, img=128)


def test_vit_features_gradient_matches_jax():
    """261 tokens (256 patches, cls, 4 registers): the port's MHA takes
    AttentionFunction with a ragged tail; JAX's plain path is the oracle,
    as its stock flash kernel's backward does not run on the CPU."""
    jcfg = jvit.ViTConfig(img_size=128, patch_size=8, width=64, depth=2, heads=2, mlp_dim=128,
                          use_cls=True, num_reg=4, layerscale=True, compute_dtype="float32",
                          feature_layer=-1)
    with jf.vision_flash("off"):
        _tower_grads_close(jcfg, jvit.vit_features, pvit.vit_features, seed=12, img=128)


def test_kernel_wrappers_refuse_cpu_tensors():
    """K3 with lse, K14 and K15 take CUDA tensors only: the CPU path goes
    through the plain versions, never through a wrapper."""
    q, k, v, rel_h, rel_w = (torch.from_numpy(x) for x in _sam_inputs(1, 8, 8, 64, seed=3))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    lse = torch.zeros(1, 64)
    with pytest.raises(ValueError):
        pf._attention_cuda(q, k, v, rel_h, rel_w, 0.125, "sam", with_lse=True)
    with pytest.raises(ValueError):
        pf.attention_bwd_dq_cuda(q, k, v, rel_h, rel_w, q, lse, q, 0.125, "sam")
    with pytest.raises(ValueError):
        pf.attention_bwd_dkv_cuda(q, k, v, rel_h, rel_w, q, lse, lse, 0.125, "sam")
