"""The flat-state decode step (the CPU side of kernel K4): the port's
``wkv7_step_flat`` against the JAX package's ``wkv7_step_flat`` and its
``wkv7_step_flat_pallas`` (interpret mode on the CPU), the layout round
trip, and the engine with ``state_layout="flat"``.

Tolerance: max |delta| <= 1e-4 * max |ref| in fp32 (the same fp32 sums in
another order). With a bf16 carry the two new bf16 states may differ by one
bf16 rounding (2^-8 relative): 8e-3 * max |ref|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vlm import _cfgs, _inputs as _vlm_inputs
from test_torch_wkv7 import _inputs, _state
from torch_port_helpers import max_rel, np_tree, perturbed, to_np
from visualrwkv_torch.convert.from_jax import params_from_jax
from visualrwkv_torch.infer.engine import InferenceEngine
from visualrwkv_torch.ops import wkv7 as pw
from visualrwkv_tpu.infer.engine import InferenceEngine as JEngine
from visualrwkv_tpu.models.visualrwkv import init_visualrwkv_params
from visualrwkv_tpu.ops.wkv7 import state_to_flat as j_state_to_flat
from visualrwkv_tpu.ops.wkv7 import wkv7_step_flat as j_step_flat
from visualrwkv_tpu.ops.wkv7_pallas import wkv7_step_flat_pallas

TOL = 1e-4


def test_flat_layout_round_trip():
    s = torch.from_numpy(_state(3, 4, 64, seed=0))
    flat = pw.state_to_flat(s)
    assert flat.shape == (3, 64, 4 * 64)
    # element [b, i, h*N + j] is S[b, h, i, j]
    assert flat[1, 5, 2 * 64 + 7] == s[1, 2, 5, 7]
    np.testing.assert_array_equal(to_np(flat), np.asarray(j_state_to_flat(jnp.asarray(to_np(s)))))
    assert torch.equal(pw.state_from_flat(flat, 4), s)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_step_flat_matches_jax(state_dtype):
    B, H, N = 3, 2, 64
    vecs = _inputs(B, 1, H, N, seed=7, lead=(B,))
    jdt = jnp.dtype(state_dtype)
    js0 = j_state_to_flat(jnp.asarray(_state(B, H, N, seed=3))).astype(jdt)
    jvecs = [jnp.asarray(x) for x in vecs]
    s_j, y_j = j_step_flat(js0, *jvecs)
    s_p, y_p = wkv7_step_flat_pallas(js0, *jvecs)
    assert s_j.dtype == jdt and s_p.dtype == jdt

    tdt = getattr(torch, state_dtype)
    ts0 = torch.from_numpy(np.array(js0.astype(jnp.float32))).to(tdt)
    tvecs = [torch.from_numpy(x) for x in vecs]
    state_tol = TOL if state_dtype == "float32" else 8e-3
    for fn in (pw.wkv7_step_flat, pw.wkv7_step_auto):
        s, y = fn(ts0, *tvecs)
        assert s.dtype == tdt and s.shape == ts0.shape and y.shape == (B, H, N)
        for s_ref, y_ref in ((s_j, y_j), (s_p, y_p)):
            assert max_rel(to_np(y), np.asarray(y_ref)) < TOL
            assert max_rel(to_np(s), np.asarray(s_ref.astype(jnp.float32))) < state_tol
    # and the head-layout step on the same state
    s_h, y_h = pw.wkv7_step(pw.state_from_flat(ts0, H), *tvecs)
    assert max_rel(to_np(y), to_np(y_h)) < TOL
    assert max_rel(to_np(pw.state_from_flat(s, H)), to_np(s_h)) < state_tol


def test_step_auto_rejects_other_3d_states():
    vecs = [torch.from_numpy(x) for x in _inputs(2, 1, 2, 64, seed=0, lead=(2,))]
    with pytest.raises(ValueError, match="flat"):
        pw.wkv7_step_auto(torch.zeros(2, 128, 3), *vecs)


def test_cuda_wrappers_refuse_cpu_tensors():
    from visualrwkv_torch.ops import wkv7_cuda

    vecs = [torch.from_numpy(x) for x in _inputs(1, 1, 2, 64, seed=0, lead=(1,))]
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        wkv7_cuda.wkv7_step_flat(torch.zeros(1, 64, 128), *vecs)


@pytest.fixture(scope="module")
def model():
    jcfg, pcfg = _cfgs("float32")
    tree = perturbed(np_tree(init_visualrwkv_params(jax.random.PRNGKey(0), jcfg)), seed=11)
    return tree, params_from_jax(tree, pcfg, device="cpu")


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_generate_flat_ids_match_head_and_jax(model, state_dtype):
    """16 greedy tokens with the flat decode carry: the ids of the head
    layout and of the JAX engine with ``state_layout="flat"``."""
    tree, pparams = model
    jcfg, pcfg = _cfgs("float32")
    ids, images = _vlm_inputs(B=2, T=37, seed=5)
    kw = dict(max_new_tokens=16, stop_tokens=(-1,))
    flat = InferenceEngine(pparams, pcfg, state_dtype=state_dtype, state_layout="flat",
                           device="cpu").generate(ids, images, **kw)
    head = InferenceEngine(pparams, pcfg, state_dtype=state_dtype, device="cpu").generate(
        ids, images, **kw)
    jres = JEngine(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, state_dtype=state_dtype,
                   state_layout="flat").generate(
        jnp.asarray(ids), {k: jnp.asarray(v) for k, v in images.items()}, **kw)
    np.testing.assert_array_equal(flat.tokens, head.tokens)
    np.testing.assert_array_equal(flat.tokens, jres.tokens)
    np.testing.assert_allclose(flat.logits, jres.logits, rtol=1e-3,
                               atol=1e-3 * np.abs(jres.logits).max())


def test_flat_state_reenters_prefill(model):
    """A flat bf16 decode carry handed back to ``prefill_ids`` is relaid to
    the head layout: the logits equal those from the head-layout carry."""
    _, pparams = model
    _, pcfg = _cfgs("float32")
    ids, images = _vlm_inputs(B=1, T=32, seed=6)
    eng = InferenceEngine(pparams, pcfg, device="cpu")
    _, st = eng.prefill_ids(ids, images)
    flat = [s._replace(wkv=pw.state_to_flat(s.wkv)) for s in st]
    more = np.random.default_rng(0).integers(10, 60000, (1, 19))
    a, _ = eng.prefill_ids(more, states=st)
    b, _ = eng.prefill_ids(more, states=flat)
    assert max_rel(to_np(b), to_np(a)) < 1e-6
