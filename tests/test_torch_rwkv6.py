"""The port's RWKV-6 ("x060") language model (``visualrwkv_torch/models/
rwkv6.py`` through ``models/lm.py``) against the JAX package's
``models/rwkv6.py`` on the same weights: 2 layers, 128 wide (two heads of
64), vocabulary 1024, JAX parameters perturbed so that the zero-initialised
projections carry signal, carried across by ``params_from_jax``.

Tolerances: fp32 logits max |delta| <= 1e-4 * max |ref| (the same
arithmetic in another order: chunked WKV, ``F.linear`` against ``matmul``;
~1e-6 is seen); bf16 compute against fp32 relative RMS <= 3e-2 (bf16 keeps
8 bits)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import max_rel, np_tree, oracle_jit, perturbed, rel_rms, to_np
from visualrwkv_torch import config as pcfg
from visualrwkv_torch.convert.from_jax import params_from_jax, params_to_numpy
from visualrwkv_torch.models import lm as plm
from visualrwkv_torch.models import rwkv6 as p6
from visualrwkv_tpu import config as jcfg
from visualrwkv_tpu.models import lm as jlm
from visualrwkv_tpu.models import rwkv6 as j6

FWD_TOL = 1e-4


def _cfgs(compute_dtype="float32", n_embd=128):
    kw = dict(n_layer=2, n_embd=n_embd, vocab_size=1024, head_size=64, version="x060",
              compute_dtype=compute_dtype, ctx_len=64)
    return jcfg.RWKVConfig(**kw), pcfg.RWKVConfig(**kw)


def _vlm(rcfg):
    return pcfg.VLMConfig(rwkv=rcfg, vision=pcfg.VisionConfig(towers=()))


@pytest.fixture(scope="module")
def model():
    jc, pc = _cfgs()
    tree = perturbed(np_tree(j6.init_rwkv6_params(jax.random.PRNGKey(0), jc)), seed=5)
    return tree, params_from_jax({"rwkv": tree}, _vlm(pc), device="cpu")["rwkv"]


def _ids(B, T, seed=0):
    return np.random.default_rng(seed).integers(0, 1024, (B, T)).astype(np.int64)


def _jax_forward(tree, jc, ids, grad_cp=False):
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    logits, states = jlm.lm_forward(jp, jc, j6.embed(jp, jnp.asarray(ids)), grad_cp=grad_cp)
    return np.asarray(logits, np.float32), states


def test_config_geometry():
    """x060's FFN is 3.5x rounded to 32, as in the JAX package; the published
    7B and 1.6B geometries."""
    for C, ffn in ((4096, 14336), (2048, 7168), (128, 448)):
        j = jcfg.RWKVConfig(n_embd=C, version="x060")
        p = pcfg.RWKVConfig(n_embd=C, version="x060")
        assert p.dim_ffn == j.dim_ffn == ffn
    assert pcfg.RWKVConfig(n_embd=2048).dim_ffn == 8192  # x070 stays 4x


@pytest.mark.parametrize("n_embd", [128, 4096])
def test_init_matches_jax_tree(n_embd):
    """The port's init has the JAX init's leaves, shapes and (where they are
    set by formula, not drawn) values, in the port's layouts. The 4096-wide
    case checks the wider LoRA widths (64 / 128) on one layer's shapes."""
    jc, pc = _cfgs(n_embd=n_embd)
    if n_embd > 128:  # shapes only: build one block of each without drawing a 7B model
        jb = jax.eval_shape(lambda: j6.init_tmix_x060(jax.random.PRNGKey(0), jc, 1))
        pb = p6.init_tmix_x060(torch.Generator(), pc, 1, "cpu")
        assert pb["time_maa_w1"].shape == jb["time_maa_w1"].shape == (4096, 320)
        assert pb["time_decay_w1"].shape == jb["time_decay_w1"].shape == (4096, 128)
        assert pb["receptance"]["weight"].shape == jb["receptance"]["weight"].shape[::-1]
        return
    gen = torch.Generator()
    gen.manual_seed(0)
    ours = params_to_numpy({"rwkv": plm.init_lm_params(gen, pc, "cpu")}, _vlm(pc))["rwkv"]
    ref = np_tree(j6.init_rwkv6_params(jax.random.PRNGKey(0), jc))
    flat_o, tree_o = jax.tree_util.tree_flatten_with_path(ours)
    flat_r, tree_r = jax.tree_util.tree_flatten_with_path(ref)
    assert tree_o == tree_r
    for (path, a), (_, b) in zip(flat_o, flat_r):
        assert a.shape == b.shape, path
        name = jax.tree_util.keystr(path)
        drawn = any(s in name for s in ("'weight'", "maa_w2", "decay_w2")) and "ln" not in name
        if not drawn:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("grad_cp", [False, True])
def test_forward_matches_jax(model, grad_cp):
    """T = 40: left-padded with EOS to 48 on both sides; fp32."""
    tree, params = model
    jc, pc = _cfgs()
    ids = _ids(2, 40)
    ref, _ = _jax_forward(tree, jc, ids, grad_cp)
    x = p6.embed(params, torch.from_numpy(ids))
    out, states = plm.lm_forward(params, pc, x, grad_cp=grad_cp)
    assert out.shape == (2, 40, 1024) and len(states) == 2
    assert max_rel(to_np(out), ref) < FWD_TOL


def test_forward_bf16_near_jax_fp32(model):
    """bf16 compute (the serving dtype) against the JAX package's fp32
    logits: relative RMS <= 3e-2. (The JAX package's x060 bf16 forward does
    not run on this CPU backend: XLA has no BF16 x BF16 = F32 dot here.)"""
    tree, _ = model
    jc, _ = _cfgs()
    _, pc = _cfgs("bfloat16")
    params = params_from_jax({"rwkv": tree}, _vlm(pc), device="cpu")["rwkv"]
    ids = _ids(1, 48, seed=1)
    ref, _ = _jax_forward(tree, jc, ids)
    out, _ = plm.lm_forward(params, pc, p6.embed(params, torch.from_numpy(ids)))
    assert np.isfinite(to_np(out)).all()
    assert rel_rms(to_np(out), ref) < 3e-2


def test_hidden_and_states_match_jax(model):
    """``return_hidden`` and the per-layer states (shift carries fp32, WKV
    state fp32) of a chunk-aligned stateful forward."""
    tree, params = model
    jc, pc = _cfgs()
    ids = _ids(2, 32, seed=2)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    j_states = jlm.init_lm_state(jc, 2)
    j_hidden, j_new = jlm.lm_forward(jp, jc, j6.embed(jp, jnp.asarray(ids)), j_states,
                                     return_hidden=True)
    hidden, new = plm.lm_forward(params, pc, p6.embed(params, torch.from_numpy(ids)),
                                 plm.init_lm_state(pc, 2, "cpu"), return_hidden=True)
    assert max_rel(to_np(hidden), np.asarray(j_hidden)) < FWD_TOL
    for a, b in zip(new, j_new):
        for x, y in zip(a, b):
            assert max_rel(to_np(x), np.asarray(y)) < FWD_TOL


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
def test_decode_step_matches_jax(model, state_dtype):
    """Three decode steps from a prefilled state, the carry in fp32 or bf16."""
    tree, params = model
    jc, pc = _cfgs()
    ids = _ids(2, 35, seed=3)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jdt = jnp.float32 if state_dtype == torch.float32 else jnp.bfloat16
    _, j_st = jlm.lm_forward(jp, jc, j6.embed(jp, jnp.asarray(ids[:, :32])), jlm.init_lm_state(jc, 2))
    j_st = [s._replace(wkv=s.wkv.astype(jdt)) for s in j_st]
    _, st = plm.lm_forward(params, pc, p6.embed(params, torch.from_numpy(ids[:, :32])),
                           plm.init_lm_state(pc, 2, "cpu"))
    st = [s._replace(wkv=s.wkv.to(state_dtype)) for s in st]
    for t in range(32, 35):
        j_logits, j_st = jlm.lm_decode_step(jp, jc, jnp.asarray(ids[:, t]), j_st)
        logits, st = plm.lm_decode_step(params, pc, torch.from_numpy(ids[:, t]), st)
        assert st[0].wkv.dtype == state_dtype
        assert max_rel(to_np(logits), np.asarray(j_logits)) < FWD_TOL, t


def test_decode_after_prefill_equals_one_pass(model):
    """A stateless prefill of 32 tokens, then 16 one-token steps, gives the
    logits of one forward over all 48 (no padding: 32 and 48 are chunk
    multiples); fp32, max |delta| <= 1e-4 * max |ref|."""
    _, params = model
    _, pc = _cfgs()
    ids = torch.from_numpy(_ids(2, 48, seed=4))
    full, _ = plm.lm_forward(params, pc, p6.embed(params, ids))
    logits, st = plm.lm_forward(params, pc, p6.embed(params, ids[:, :32]))
    assert max_rel(to_np(logits), to_np(full[:, :32])) < FWD_TOL
    for t in range(32, 48):
        step, st = plm.lm_decode_step(params, pc, ids[:, t], st)
        assert max_rel(to_np(step), to_np(full[:, t])) < FWD_TOL, t


def test_gradients_match_jax(model):
    """d(sum of logits * seeded weights) / d(every leaf) of a 48-token
    forward with checkpointing, against ``jax.grad`` of the same; fp32,
    max |delta| <= 1e-3 * max |ref| per leaf (the chunked WKV's backward
    in two frameworks)."""
    tree, params = model
    jc, pc = _cfgs()
    ids = _ids(1, 48, seed=6)
    cot = np.random.default_rng(7).standard_normal((1, 48, 1024)).astype(np.float32)

    def j_loss(p):
        logits, _ = jlm.lm_forward(p, jc, j6.embed(p, jnp.asarray(ids)), grad_cp=True)
        return (logits * cot).sum()

    j_grads = np_tree(oracle_jit(jax.grad(j_loss))(jax.tree_util.tree_map(jnp.asarray, tree)))
    leaves = {k: v for k, v in params.items()}
    leaves = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), leaves)
    flat = jax.tree_util.tree_leaves(leaves)
    logits, _ = plm.lm_forward(leaves, pc, p6.embed(leaves, torch.from_numpy(ids)), grad_cp=True)
    grads = torch.autograd.grad((logits * torch.from_numpy(cot)).sum(), flat)
    g_tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(leaves), list(grads))
    ours = params_to_numpy({"rwkv": g_tree}, _vlm(pc))["rwkv"]
    flat_o, _ = jax.tree_util.tree_flatten_with_path(ours)
    flat_r = jax.tree_util.tree_leaves(j_grads)
    for (path, a), b in zip(flat_o, flat_r):
        assert max_rel(a, b) < 1e-3, jax.tree_util.keystr(path)


def test_converter_round_trip(model):
    """``params_from_jax`` then ``params_to_numpy`` gives the JAX tree back
    bit for bit; ``att.gate`` and ``ffn.receptance`` are transposed on the
    way in, the LoRA factors and ``time_faaaa`` are not."""
    tree, params = model
    _, pc = _cfgs()
    blk, jblk = params["blocks"][1], tree["blocks"][1]
    np.testing.assert_array_equal(to_np(blk["att"]["gate"]["weight"]), jblk["att"]["gate"]["weight"].T)
    np.testing.assert_array_equal(to_np(blk["ffn"]["receptance"]["weight"]),
                                  jblk["ffn"]["receptance"]["weight"].T)
    for name in ("time_maa_w2", "time_decay_w1", "time_decay_w2", "time_faaaa"):
        np.testing.assert_array_equal(to_np(blk["att"][name]), jblk["att"][name])
    back = params_to_numpy({"rwkv": params}, _vlm(pc))["rwkv"]
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                            jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
