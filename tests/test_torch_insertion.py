"""v6.0's leftpad insertion and the bidirectional image span against the
JAX package: the host plan and the device insert (head-keep and tail-keep
truncation, image-free rows, two images rejected), ``bidirectional_forward``
with a shared and a per-row span start (and the STOP-token left pad), and
``vlm_forward_leftpad`` / ``training_loss_leftpad`` for x070 and x060, with
and without the bidirectional span; the scatter path's bidirectional
``vlm_forward`` and its dense loss.

The model: 2 LM layers, 128 wide (two heads of 64), vocabulary 2048, fp32
on both sides (the JAX package's x060 bf16 forward does not run on this CPU
backend), behind a tiny CLIP (56 px, patch 14, width 64, 3 blocks, the CLS
token kept: ``grid_size=-1`` gives 17 image features a sample, the flip span
16) and a linear projector.

Tolerances: the insert (gathers and masks) bit-equal; logits max |delta| <=
1e-4 * max |ref|; loss <= 1e-5 relative; gradients <= 1e-4 * max |ref| (the
same arithmetic in another order: the chunked WKV, a convolution)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_grads_match, grads_numpy, max_rel, np_tree, perturbed, port_cfg, to_np
from visualrwkv_torch.convert.from_jax import params_from_jax
from visualrwkv_torch.models import lm as plm
from visualrwkv_torch.models import visualrwkv as pm
from visualrwkv_torch.multimodal import insertion as pins
from visualrwkv_tpu import config as jcfg_mod
from visualrwkv_tpu.data.conversation import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from visualrwkv_tpu.models import visualrwkv as jm
from visualrwkv_tpu.models.visualrwkv import init_visualrwkv_params
from visualrwkv_tpu.multimodal import insertion as jins
from visualrwkv_tpu.vision import vit as jvit

TOL = 1e-4
N_IMG = 17
CLIP = dataclasses.replace(jvit.CLIP_L_336, img_size=56, width=64, depth=3, heads=4, mlp_dim=128,
                           compute_dtype="float32")


def _jax_cfg(version, **kw):
    return jcfg_mod.VLMConfig(
        rwkv=jcfg_mod.RWKVConfig(n_layer=2, n_embd=128, vocab_size=2048, head_size=64,
                                 version=version, compute_dtype="float32", ctx_len=48),
        vision=jcfg_mod.VisionConfig(towers=("clip",), clip_dim=64,
                                     tower_config_overrides={"clip": CLIP}),
        proj_type="linear", num_token_per_image=N_IMG, grid_size=-1, **kw)


@pytest.fixture(scope="module", params=["x070", "x060"])
def model(request):
    jcfg = _jax_cfg(request.param)
    tree = perturbed(np_tree(init_visualrwkv_params(jax.random.PRNGKey(3), jcfg)), seed=21)
    return jcfg, tree


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# the plan and the insert
# ---------------------------------------------------------------------------

V, C = 50, 8


def _batch(positions, T_in=12, L=5, seed=0):
    """Token ids with the image token at ``positions`` (None: no image), and
    features [B, L, C]."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, V, (len(positions), T_in)).astype(np.int64)
    for i, p in enumerate(positions):
        if p is not None:
            ids[i, p] = IMAGE_TOKEN_INDEX
    return ids, None, rng.normal(size=(len(positions), L, C)).astype(np.float32)


# name: (batch, ctx_len, labels masked from the start of each row)
INSERT_CASES = {
    "mixed": (dict(positions=[3, 7, None, 0]), 64, 4),
    "head_keep": (dict(positions=[2, 10], T_in=40, L=16), 32, 1),
    "tail_keep": (dict(positions=[10, 4], T_in=40, L=16), 32, 30),
    "image_free": (dict(positions=[None, None], T_in=20), 32, 6),
}


@pytest.mark.parametrize("case", sorted(INSERT_CASES))
def test_plan_and_insert_match_jax(case):
    """The plan equal to JAX's; embeddings, labels and the tail-keep offsets
    bit-equal. Both truncation cases cut rows longer than ctx_len; in the
    tail-keep case no kept head position holds a valid label, so the tail
    is kept and the offset is not 0."""
    kw, ctx, masked = INSERT_CASES[case]
    ids, labels, feats = _batch(**kw)
    labels = np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids)
    labels[:, :masked] = IGNORE_INDEX
    table = np.random.default_rng(1).normal(size=(V, C)).astype(np.float32)
    jplan = jins.leftpad_plan(ids, feats.shape[1], ctx)
    plan = pins.leftpad_plan(torch.from_numpy(ids), feats.shape[1], ctx)
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    j_emb, j_lab, j_off = jins.leftpad_insert(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(labels),
                                              jnp.asarray(feats), jplan)
    emb, lab, off = pins.leftpad_insert(torch.from_numpy(table), torch.from_numpy(ids),
                                        torch.from_numpy(labels), torch.from_numpy(feats), plan)
    assert emb.shape == (len(ids), plan.T_out, C)
    np.testing.assert_array_equal(to_np(emb), np.asarray(j_emb))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(j_lab))
    np.testing.assert_array_equal(off.numpy(), np.asarray(j_off))
    assert (case == "tail_keep") == bool((off > 0).any())
    if case.endswith("keep"):
        assert plan.T_out == ctx and (plan.max_idx + kw["L"] + kw["T_in"] - np.array(kw["positions"]) - 1
                                      > ctx).all()


def test_two_images_in_a_sample_rejected():
    ids, _, _ = _batch([3])
    ids[0, 5] = IMAGE_TOKEN_INDEX
    with pytest.raises(ValueError, match="Too many images"):
        pins.leftpad_plan(ids, 5, 64)


# ---------------------------------------------------------------------------
# the bidirectional span
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("start", ["shared", "per_row"])
def test_bidirectional_forward_matches_jax(model, start):
    """Logits over random embeddings of T = 37 (11 STOP-token embeddings of
    left pad to a multiple of 16), the 9-token span at 6, or at 4, -30 and
    33 per row (as JAX's dynamic slice takes them: -30 counts from the end,
    and 33 + 9 > 37 is clamped to 28); the flipped span changes the
    logits."""
    jcfg, tree = model
    pcfg = port_cfg(jcfg)
    params = params_from_jax(tree, pcfg, device="cpu")
    x = np.random.default_rng(5).standard_normal((3, 37, 128)).astype(np.float32)
    s = np.int32(6) if start == "shared" else np.array([4, -30, 33], np.int32)
    fwd = jax.jit(lambda p, x, s: jm.bidirectional_forward(p, jcfg, x, s, 9))
    ref = np.asarray(fwd(_jtree(tree), jnp.asarray(x), jnp.asarray(s)))
    out = to_np(pm.bidirectional_forward(params, pcfg, torch.from_numpy(x), torch.from_numpy(np.asarray(s)), 9))
    assert out.shape == ref.shape == (3, 37, 2048)
    assert max_rel(out, ref) < TOL
    plain, _ = plm.lm_forward(params["rwkv"], pcfg.rwkv, torch.from_numpy(x))
    assert max_rel(to_np(plain), ref) > 1e-3


def test_vlm_forward_bidirectional_and_dense_loss_match_jax(model):
    """The scatter path with ``bidirectional_image``: the span of
    ``num_token_per_image`` at row 0's first image token; the training loss
    is the dense one (the bidirectional forward gives logits only), with
    checkpointing: loss and every LM and projector gradient."""
    jcfg, tree = model
    jcfg = dataclasses.replace(jcfg, bidirectional_image=True)
    pcfg = port_cfg(jcfg)
    rng = np.random.default_rng(7)
    ids = rng.integers(10, 2000, (2, 40)).astype(np.int64)
    ids[:, 5:5 + N_IMG] = IMAGE_TOKEN_INDEX
    labels = np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids)
    images = {"clip": rng.integers(0, 256, (2, 56, 56, 3)).astype(np.uint8)}
    jimg = {k: jnp.asarray(v) for k, v in images.items()}
    params = params_from_jax(tree, pcfg, device="cpu")
    ref = np.asarray(jax.jit(lambda p: jm.vlm_forward(p, jcfg, jnp.asarray(ids), jimg))(_jtree(tree)))
    assert max_rel(to_np(pm.vlm_forward(params, pcfg, ids, images, device="cpu")), ref) < TOL
    j_loss, j_grads = jax.jit(jax.value_and_grad(lambda p: jm.training_loss(
        p, jcfg, jnp.asarray(ids), jnp.asarray(labels), jimg, grad_cp=True, ce_chunk_t=8)))(_jtree(tree))
    loss, grads = grads_numpy(params, lambda p: pm.training_loss(
        p, pcfg, ids, labels, images, grad_cp=True, ce_chunk_t=8, device="cpu"), pcfg)
    assert abs(loss - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    assert_grads_match(grads, j_grads, ("rwkv", "proj"), TOL)


# ---------------------------------------------------------------------------
# the leftpad forward and loss
# ---------------------------------------------------------------------------


def _leftpad_batch(seed=9, ctx_cut=False):
    """Three samples of 24 tokens, one un-expanded image token each at 3 and
    9, none in the third. With ``ctx_cut`` the first sample's head holds no
    valid label, so under a ctx_len of 32 its tail is kept (its span moves)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, 2000, (3, 24)).astype(np.int64)
    ids[0, 3] = ids[1, 9] = IMAGE_TOKEN_INDEX
    labels = np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids)
    labels[:, :2] = IGNORE_INDEX
    if ctx_cut:
        labels[0, :20] = IGNORE_INDEX
    images = {"clip": rng.integers(0, 256, (3, 56, 56, 3)).astype(np.uint8)}
    return ids, labels, images


@pytest.mark.parametrize("bidirectional", [False, True], ids=["unidirectional", "bidirectional"])
def test_vlm_forward_leftpad_matches_jax(model, bidirectional):
    """Logits and the realigned labels, same plan (T_out 48 = 9 + 17 + 20
    rounded up to 16)."""
    jcfg, tree = model
    jcfg = dataclasses.replace(jcfg, insertion_mode="leftpad", bidirectional_image=bidirectional)
    pcfg = port_cfg(jcfg)
    ids, labels, images = _leftpad_batch()
    j_plan = jins.leftpad_plan(ids, N_IMG, jcfg.rwkv.ctx_len)
    ref, j_labels = jax.jit(lambda p: jm.vlm_forward_leftpad(
        p, jcfg, jnp.asarray(ids), jnp.asarray(labels), {k: jnp.asarray(v) for k, v in images.items()},
        plan=j_plan)[:2])(_jtree(tree))
    out, new_labels, plan = pm.vlm_forward_leftpad(params_from_jax(tree, pcfg, device="cpu"), pcfg, ids,
                                                   labels, images, device="cpu")
    assert dataclasses.asdict(plan) == dataclasses.asdict(j_plan) and plan.T_out == 48
    np.testing.assert_array_equal(new_labels.numpy(), np.asarray(j_labels))
    assert out.shape == np.asarray(ref).shape == (3, 48, 2048)
    assert max_rel(to_np(out), np.asarray(ref)) < TOL


def test_training_loss_leftpad_matches_jax(model):
    """VisualRWKV-6's published training path: leftpad insertion and the
    bidirectional span, under a ctx_len that tail-keeps the first sample
    (its span flipped at ``max_idx - off``), with checkpointing; the loss
    and every LM and projector gradient."""
    jcfg, tree = model
    jcfg = dataclasses.replace(jcfg, insertion_mode="leftpad", bidirectional_image=True,
                               rwkv=dataclasses.replace(jcfg.rwkv, ctx_len=32))
    pcfg = port_cfg(jcfg)
    ids, labels, images = _leftpad_batch(seed=11, ctx_cut=True)
    plan = jins.leftpad_plan(ids, N_IMG, 32)
    jimg = {k: jnp.asarray(v) for k, v in images.items()}
    j_loss, j_grads = jax.jit(jax.value_and_grad(lambda p: jm.training_loss_leftpad(
        p, jcfg, jnp.asarray(ids), jnp.asarray(labels), jimg, plan=plan, grad_cp=True)))(_jtree(tree))
    params = params_from_jax(tree, pcfg, device="cpu")
    _, _, off = pins.leftpad_insert(params["rwkv"]["emb"]["weight"], torch.from_numpy(ids),
                                    torch.from_numpy(labels), torch.zeros(3, N_IMG, 128),
                                    pins.leftpad_plan(ids, N_IMG, 32))
    assert int(off[0]) > 0 and int(off[1]) == 0
    loss, grads = grads_numpy(params, lambda p: pm.training_loss_leftpad(
        p, pcfg, ids, labels, images, grad_cp=True, device="cpu"), pcfg)
    assert abs(loss - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    assert_grads_match(grads, j_grads, ("rwkv", "proj"), TOL)
