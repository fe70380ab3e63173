"""The slice as a whole: the port's ``vlm_forward`` and ``InferenceEngine``
against the JAX package on the tiny triple-tower VisualRWKV-7 of
``__graft_entry__._tiny_vlm_cfg(triple=True)`` (DINOv2-reg4 + SigLIP + SAM
-> gated-MLP projector -> RWKV-7), on JAX weights carried across by
``params_from_jax``, plus the committed golden logits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_vlm_cfg
from torch_port_helpers import max_rel, np_tree, oracle_jit, perturbed, port_cfg, rel_rms, to_np
from visualrwkv_torch.convert.from_jax import params_from_jax
from visualrwkv_torch.infer.engine import InferenceEngine
from visualrwkv_torch.models import lm as plm
from visualrwkv_torch.models.visualrwkv import prepare_embeddings, vlm_forward
from visualrwkv_tpu.config import VLMConfig as JVLMConfig
from visualrwkv_tpu.data.conversation import IMAGE_TOKEN_INDEX
from visualrwkv_tpu.infer.engine import InferenceEngine as JEngine
from visualrwkv_tpu.models.visualrwkv import init_visualrwkv_params
from visualrwkv_tpu.models.visualrwkv import vlm_forward as j_vlm_forward

N_LAYER = 2


def _cfgs(compute_dtype):
    j = _tiny_vlm_cfg(n_layer=N_LAYER, triple=True)
    j = dataclasses.replace(j, rwkv=dataclasses.replace(j.rwkv, compute_dtype=compute_dtype))
    assert isinstance(j, JVLMConfig)
    return j, port_cfg(j)


@pytest.fixture(scope="module")
def model():
    """JAX parameters (numpy leaves, perturbed so that zero-initialised
    projections carry signal) and the port's fp32 copy."""
    jcfg, pcfg = _cfgs("float32")
    tree = perturbed(np_tree(init_visualrwkv_params(jax.random.PRNGKey(0), jcfg)), seed=11)
    return tree, params_from_jax(tree, pcfg, device="cpu")


def _inputs(B=2, T=40, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, 60000, (B, T)).astype(np.int32)
    ids[:, 3:19] = IMAGE_TOKEN_INDEX  # 16 image tokens per row
    images = {
        "dino": rng.integers(0, 256, (B, 64, 64, 3)).astype(np.uint8),
        "siglip": rng.integers(0, 256, (B, 64, 64, 3)).astype(np.uint8),
        "sam": rng.integers(0, 256, (B, 128, 128, 3)).astype(np.uint8),
    }
    return ids, images


def _jax_logits(tree, jcfg, ids, images):
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    out = oracle_jit(lambda p, ids, images: j_vlm_forward(p, jcfg, ids, images))(
        jp, jnp.asarray(ids), {k: jnp.asarray(v) for k, v in images.items()})
    return np.asarray(out.astype(jnp.float32))


def test_vlm_forward_logits_fp32(model):
    """fp32: max |delta| <= 1e-3 * max |ref|. The same arithmetic in another
    order (chunked WKV, convolution patch embedding) through two towers
    and two RWKV layers; ~7e-7 is seen."""
    tree, pparams = model
    jcfg, pcfg = _cfgs("float32")
    ids, images = _inputs()
    ref = _jax_logits(tree, jcfg, ids, images)
    out = to_np(vlm_forward(pparams, pcfg, ids, images, device="cpu"))
    assert out.shape == ref.shape == (2, 40, 65536)
    assert max_rel(out, ref) < 1e-3


def test_vlm_forward_logits_bf16(model):
    """bf16 matmuls on both sides: relative RMS <= 3e-2. bf16 keeps 8 bits
    (~4e-3 relative per rounding); the two frameworks round at different
    places through ~20 matmuls; ~5e-3 is seen."""
    tree, pparams = model
    jcfg, pcfg = _cfgs("bfloat16")
    ids, images = _inputs(seed=1)
    ref = _jax_logits(tree, jcfg, ids, images)
    out = to_np(vlm_forward(pparams, pcfg, ids, images, device="cpu"))
    assert np.isfinite(out).all()
    assert rel_rms(out, ref) < 3e-2


def test_vlm_forward_matches_golden():
    """The committed golden logits (tests/golden/vlm_logits.npz, the JAX
    forward of tests/test_golden_logits.py::_build). fp32 with head size
    32; relative RMS <= 1e-4, for the same reason as the fp32 test."""
    from test_golden_logits import GOLDEN, _build

    jcfg, jparams, ids, images = _build()
    pcfg = port_cfg(jcfg)
    pparams = params_from_jax(np_tree(jparams), pcfg, device="cpu")
    out = to_np(vlm_forward(pparams, pcfg, ids, images, device="cpu"))
    ref = np.load(GOLDEN)["logits"]
    assert out.shape == ref.shape
    assert rel_rms(out, ref) < 1e-4


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_generate_greedy_ids_match_jax(model, state_dtype):
    """16 greedy tokens after a prompt with an image: the same ids as JAX's
    InferenceEngine. Stop tokens are disabled so all 16 steps run."""
    tree, pparams = model
    jcfg, pcfg = _cfgs("float32")
    ids, images = _inputs(B=1, T=37, seed=2)
    kw = dict(max_new_tokens=16, stop_tokens=(-1,))
    jres = JEngine(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, state_dtype=state_dtype).generate(
        jnp.asarray(ids), {k: jnp.asarray(v) for k, v in images.items()}, **kw)
    pres = InferenceEngine(pparams, pcfg, state_dtype=state_dtype, device="cpu").generate(
        ids, images, **kw)
    np.testing.assert_array_equal(pres.tokens, jres.tokens)
    np.testing.assert_array_equal(pres.lengths, jres.lengths)
    np.testing.assert_allclose(pres.logits, jres.logits, rtol=1e-3, atol=1e-3 * np.abs(jres.logits).max())


def test_prefill_then_decode_equals_full_forward(model):
    """Stateless prefill of 32 tokens, a stateful prefill of 21 (one chunk
    plus five one-token steps), then 11 decode steps give the logits of one
    forward over all 64 tokens (no EOS padding anywhere: 64 and 32 are
    chunk multiples). fp32; max |delta| <= 1e-4 * max |ref|."""
    _, pparams = model
    _, pcfg = _cfgs("float32")
    ids, images = _inputs(B=2, T=64, seed=3)
    eng = InferenceEngine(pparams, pcfg, device="cpu")
    full = to_np(vlm_forward(pparams, pcfg, ids, images, device="cpu"))

    logits, st = eng.prefill_ids(ids[:, :32], images)
    assert max_rel(to_np(logits), full[:, 31]) < 1e-4
    logits, st = eng.prefill_ids(ids[:, 32:53], states=st)
    assert max_rel(to_np(logits), full[:, 52]) < 1e-4
    for t in range(53, 64):
        logits, st = plm.lm_decode_step(pparams["rwkv"], pcfg.rwkv, torch.from_numpy(ids[:, t]).long(), st)
        assert max_rel(to_np(logits), full[:, t]) < 1e-4, t


def test_image_state_cache(model):
    """compute_image_state caches by content and equals a stateful prefill of
    the image embeddings alone."""
    _, pparams = model
    _, pcfg = _cfgs("float32")
    _, images = _inputs(B=1, seed=4)
    eng = InferenceEngine(pparams, pcfg, device="cpu")
    st = eng.compute_image_state(images)
    assert eng.compute_image_state(images) is st
    ids = np.full((1, 16), IMAGE_TOKEN_INDEX, np.int64)
    x = prepare_embeddings(pparams, pcfg, torch.from_numpy(ids),
                           {k: torch.from_numpy(v) for k, v in images.items()})
    _, ref = plm.lm_forward(pparams["rwkv"], pcfg.rwkv, x, states=plm.init_lm_state(pcfg.rwkv, 1, "cpu"))
    for a, b in zip(st, ref):
        assert max_rel(to_np(a.wkv), to_np(b.wkv)) < 1e-5
