"""The training loss of the port against the JAX package's, value and
gradients, on the tiny triple-tower VisualRWKV-7 (two RWKV layers) with JAX
weights carried across by ``params_from_jax``: the dense loss and the
chunked head + cross-entropy, ``IGNORE_INDEX`` spans, an image, an
out-of-range label, activation checkpointing on and off.

Tolerances, fp32 on both sides: loss |delta| <= 1e-5 * |ref|; every
gradient leaf max |delta| <= 1e-4 * max |ref| (the same arithmetic in
another order through two towers, the projector and two RWKV layers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vlm import _cfgs, _inputs
from torch_port_helpers import max_rel, np_tree, perturbed, to_np
from visualrwkv_torch.config import IGNORE_INDEX
from visualrwkv_torch.convert.from_jax import params_from_jax, params_to_numpy
from visualrwkv_torch.models import visualrwkv as pm
from visualrwkv_torch.train.optim import tree_leaves, tree_leaves_with_path
from visualrwkv_tpu.models import visualrwkv as jm
from visualrwkv_tpu.models.visualrwkv import init_visualrwkv_params

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
T = 48
CHUNK_T = 16


@pytest.fixture(scope="module")
def case():
    jcfg, pcfg = _cfgs("float32")
    tree = perturbed(np_tree(init_visualrwkv_params(jax.random.PRNGKey(0), jcfg)), seed=11)
    ids, images = _inputs(B=2, T=T, seed=9)
    labels = ids.astype(np.int64)
    labels[ids == 65535] = IGNORE_INDEX  # image tokens
    labels[0, 25:31] = IGNORE_INDEX      # a masked human turn
    labels[1, 40:] = IGNORE_INDEX        # padding at the end
    ids[1, 36] = 65000                   # within the vocabulary, near its end
    return jcfg, pcfg, tree, ids, labels, images


def _jax_loss_and_grads(case, chunked):
    jcfg, _, tree, ids, labels, images = case
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jimages = {k: jnp.asarray(v) for k, v in images.items()}

    def f(p):
        return jm.training_loss(p, jcfg, jnp.asarray(ids), jnp.asarray(labels), jimages,
                                grad_cp=True, chunked_ce=chunked, ce_chunk_t=CHUNK_T)

    loss, grads = jax.value_and_grad(f)(jparams)
    return float(loss), np_tree(grads)


def _port_loss_and_grads(case, chunked, grad_cp):
    _, pcfg, tree, ids, labels, images = case
    params = params_from_jax(tree, pcfg, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = pm.training_loss(params, pcfg, ids, labels, images, grad_cp=grad_cp,
                            chunked_ce=chunked, ce_chunk_t=CHUNK_T, device="cpu")
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(grads)
    gtree = jax.tree_util.tree_map(lambda _: next(it), _sorted(params))
    return float(loss.detach()), gtree, params


def _sorted(tree):
    """The tree with dict keys in sorted order (the order of ``tree_leaves``)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    return tree


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked_ce", "dense_ce"])
def test_training_loss_and_gradients_match_jax(case, chunked):
    _, pcfg, _, _, _, _ = case
    j_loss, j_grads = _jax_loss_and_grads(case, chunked)
    p_loss, p_grads, params = _port_loss_and_grads(case, chunked, grad_cp=True)
    assert abs(p_loss - j_loss) <= LOSS_TOL * abs(j_loss), (p_loss, j_loss)

    # the towers are frozen: no gradient reaches any of their leaves
    for path, g in tree_leaves_with_path(p_grads["vit"]):
        assert g is None, path
    # every other leaf, carried back to the JAX layout
    zeros = jax.tree_util.tree_map(lambda g, p: torch.zeros_like(p) if g is None else g,
                                   _sorted(p_grads), _sorted(params), is_leaf=lambda x: x is None)
    back = params_to_numpy(zeros, pcfg)
    for part in ("rwkv", "proj"):
        flat_p = jax.tree_util.tree_leaves_with_path(back[part])
        flat_j = jax.tree_util.tree_leaves_with_path(j_grads[part])
        assert len(flat_p) == len(flat_j)
        for (path, g), (_, ref) in zip(flat_p, flat_j):
            assert np.abs(ref).max() > 0, path  # every trainable leaf carries signal
            assert max_rel(g, ref) < GRAD_TOL, (part, jax.tree_util.keystr(path))
    for _, ref in jax.tree_util.tree_leaves_with_path(j_grads["vit"]):
        assert not np.any(ref)  # JAX agrees: stop_gradient


def test_grad_cp_does_not_change_the_gradients(case):
    l_on, g_on, _ = _port_loss_and_grads(case, chunked=True, grad_cp=True)
    l_off, g_off, _ = _port_loss_and_grads(case, chunked=True, grad_cp=False)
    assert l_on == l_off
    for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)):
        assert (a is None) == (b is None)
        if a is not None:
            assert max_rel(to_np(a), to_np(b)) < 1e-6


def test_chunked_equals_dense_and_clamps_labels(case):
    """The chunked loss equals the dense one on the same hidden states, and a
    label beyond the vocabulary is clamped to the last id, as in JAX
    (``mode="clip"``), not an error."""
    rng = np.random.default_rng(0)
    B, V, C = 2, 50, 8
    hidden = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32)).requires_grad_(True)
    head = torch.from_numpy(rng.standard_normal((V, C)).astype(np.float32)).requires_grad_(True)
    labels = rng.integers(0, V, (B, T))
    labels[0, :7] = IGNORE_INDEX
    labels[1, 10] = V + 5  # out of range
    tl = torch.from_numpy(labels)
    dense = pm._dense_ce_l2wrap(hidden @ head.t(), tl)
    chunked = pm.chunked_ce_l2wrap(CHUNK_T, head, hidden, tl)
    g_d = torch.autograd.grad(dense, (head, hidden))
    g_c = torch.autograd.grad(chunked, (head, hidden))
    assert abs(float(dense.detach()) - float(chunked.detach())) < 1e-6
    for a, b in zip(g_c, g_d):
        assert max_rel(to_np(a), to_np(b)) < 1e-5
    j = jm.chunked_ce_l2wrap(CHUNK_T, jnp.asarray(to_np(head)).T, jnp.asarray(to_np(hidden)),
                             jnp.asarray(labels))
    assert abs(float(chunked.detach()) - float(j)) <= LOSS_TOL * abs(float(j))
    with pytest.raises(ValueError, match="multiple"):
        pm.chunked_ce_l2wrap(CHUNK_T, head, hidden[:, :40], tl[:, :40])


def test_l2wrap_gradient_is_not_scaled_by_the_cotangent():
    """The L2Wrap gradient is max_logit * 1e-4 / (B * T) on each position's
    argmax whatever the upstream cotangent, as in the reference and in JAX."""
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((2, 6, 11)).astype(np.float32)).requires_grad_(True)
    loss = torch.zeros((), requires_grad=True)
    (g,) = torch.autograd.grad(pm.l2wrap(loss, logits) * 7.0, logits)
    jg = jax.grad(lambda lg: jm.l2wrap(jnp.zeros(()), lg) * 7.0)(jnp.asarray(to_np(logits)))
    np.testing.assert_allclose(to_np(g), np.asarray(jg), rtol=1e-6, atol=0)
    assert np.count_nonzero(to_np(g)) == 12


def test_unported_grad_cp_policies_raise(case):
    _, pcfg, tree, ids, labels, images = case
    params = params_from_jax(tree, pcfg, device="cpu")
    for policy in ("dots", "wkv"):
        with pytest.raises(NotImplementedError):
            pm.training_loss(params, pcfg, ids, labels, images, grad_cp=policy, device="cpu")
