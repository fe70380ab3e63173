"""Image-as-state with state tuning (``visualrwkv_torch/multimodal/
image_as_state.py``), the v6.21-v6.23 hybrids (``multimodal/hybrid.py``)
and the contrastive losses (``multimodal/contrastive.py``) against the JAX
package: forwards and gradients for x070 and x060, the image-as-state
``time_states`` gradient of every layer against ``jax.grad`` of both JAX
layouts (the list of blocks and the stacked scan), ``mean_multi_image``,
the inits' trees, the memory-read mix, the cross-attention block, the
interleaved stack's placement, and the InfoNCE losses with their
gradients.

The LMs: 2 layers, 64 wide (two heads of 32), vocabulary 512, fp32 on both
sides (the JAX package's x060 bf16 forward does not run on this CPU
backend), the JAX parameters perturbed so that the zero-initialised
projections carry signal; ``time_states`` random and not symmetric, so
that a transposed state would show.

Tolerances: logits and mixes max |delta| <= 1e-4 * max |ref|; losses
<= 1e-5 relative; gradients <= 1e-4 * max |ref| (the same arithmetic in
another order: the chunked WKV); placements, gathers and zero states
exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_grads_match, grads_numpy, max_rel, np_tree, oracle_jit, perturbed, to_np
from visualrwkv_torch import config as pcfg
from visualrwkv_torch.convert.from_jax import params_from_jax, params_to_numpy
from visualrwkv_torch.models import lm as plm
from visualrwkv_torch.multimodal import contrastive as pc_
from visualrwkv_torch.multimodal import hybrid as ph
from visualrwkv_torch.multimodal import image_as_state as ps
from visualrwkv_tpu import config as jcfg
from visualrwkv_tpu.models import rwkv7 as j7
from visualrwkv_tpu.multimodal import contrastive as jc_
from visualrwkv_tpu.multimodal import hybrid as jh
from visualrwkv_tpu.multimodal import image_as_state as js

TOL = 1e-4
B, T_TXT, T_IMG, N_IMG = 2, 13, 10, 3  # text padded by 3, images by 6
jt = lambda t: jax.tree_util.tree_map(jnp.asarray, t)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small models: their eager loops
    launch many tiny operations, which a pool of threads a process slows
    when test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(version):
    kw = dict(n_layer=2, n_embd=64, vocab_size=512, head_size=32, version=version, compute_dtype="float32",
              ctx_len=64)
    jr, pr = jcfg.RWKVConfig(**kw), pcfg.RWKVConfig(**kw)
    return (jcfg.VLMConfig(rwkv=jr, vision=jcfg.VisionConfig(towers=())),
            pcfg.VLMConfig(rwkv=pr, vision=pcfg.VisionConfig(towers=())))


@functools.lru_cache(maxsize=None)
def lm_case(version):
    """The LM in JAX's layout (the port's seeded init carried across by
    ``params_to_numpy``, then perturbed: numpy), the port's copy of it, and
    the inputs."""
    jv, pv = _cfgs(version)
    fresh = plm.init_lm_params(torch.Generator().manual_seed(0), pv.rwkv, "cpu")
    tree = perturbed(params_to_numpy({"rwkv": fresh}, pv)["rwkv"], seed=3)
    port = params_from_jax({"rwkv": tree}, pv, device="cpu")
    rng = np.random.default_rng(4)
    r = jv.rwkv
    return dict(jv=jv, pv=pv, tree=tree, port=port,
                text=rng.normal(0, 0.5, (B, T_TXT, 64)).astype(np.float32),
                image=rng.normal(0, 0.5, (B, T_IMG, 64)).astype(np.float32),
                images=rng.normal(0, 0.5, (N_IMG, T_IMG, 64)).astype(np.float32),
                ts=(0.1 * rng.normal(0, 1, (r.n_layer, r.n_head, r.head_size, r.head_size))).astype(np.float32),
                R=rng.normal(0, 1, (B, T_TXT, 512)).astype(np.float32))


# ---------------------------------------------------------------------------
# image-as-state and state tuning
# ---------------------------------------------------------------------------


def test_time_states_and_wkv_only_state_as_jax():
    jv, pv = _cfgs("x070")
    ts = ps.init_time_states(pv, device="cpu")
    ref = js.init_time_states(jv)
    assert ts.shape == ref.shape == (2, 2, 32, 32) and ts.dtype == torch.float32 and not ts.any()
    wkv = np.random.default_rng(0).normal(size=(3, 2, 32, 32)).astype(np.float32)
    got, want = ps._wkv_only_state(pv, 3, torch.from_numpy(wkv)), js._wkv_only_state(jv, 3, jnp.asarray(wkv))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))


@functools.lru_cache(maxsize=None)
def state_oracle(version):
    """JAX's image-as-state results on ``lm_case(version)``, one jitted
    program: for the list layout and the stacked scan, the loss on the
    random projection ``R`` of the logits, the logits, and the gradient
    with respect to ``time_states``; for x070 also those of three images'
    mean state (``mean_multi_image``), and the logits without
    ``time_states``."""
    c = lm_case(version)
    text, image, images = (jnp.asarray(c[k]) for k in ("text", "image", "images"))

    def vg(p, imgs, **kw):
        def loss(ts):
            logits = js.image_as_state_forward(p, c["jv"], text, imgs, time_states=ts, **kw)
            return (logits * c["R"]).sum(), logits

        return jax.value_and_grad(loss, has_aux=True)

    def oracle(tree, ts):
        out = {"list": vg({"rwkv": tree}, image)(ts),
               "stacked": vg({"rwkv": j7.stack_blocks(tree)}, image)(ts)}
        if version == "x070":
            out["mean"] = vg({"rwkv": tree}, images, mean_multi_image=True)(ts)
            out["zero_state"] = js.image_as_state_forward({"rwkv": tree}, c["jv"], text, image)
        return out

    return oracle_jit(oracle)(jt(c["tree"]), jnp.asarray(c["ts"]))


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("version", ["x070", "x060"])
def test_state_tuning_gradients_match_jax(version, stacked):
    """Logits and every layer's ``time_states`` gradient (the WKV
    kernels' initial-state gradient, through the image pass and the text
    pass) against ``jax.grad`` of the JAX list layout and of its stacked
    scan; the port's under activation checkpointing too."""
    c = lm_case(version)
    (jl, jlog), jg = state_oracle(version)["stacked" if stacked else "list"]
    for grad_cp in (False, True):
        ts = torch.from_numpy(c["ts"]).clone().requires_grad_(True)
        logits = ps.image_as_state_forward(c["port"], c["pv"], torch.from_numpy(c["text"]),
                                           torch.from_numpy(c["image"]), grad_cp=grad_cp, time_states=ts)
        assert max_rel(to_np(logits), jlog) <= TOL
        loss = (logits * torch.from_numpy(c["R"])).sum()
        assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
        (g,) = torch.autograd.grad(loss, [ts])
        for layer in range(c["pv"].rwkv.n_layer):
            assert np.abs(np.asarray(jg[layer])).max() > 0
            assert max_rel(to_np(g[layer]), jg[layer]) <= TOL, (layer, max_rel(to_np(g[layer]), jg[layer]))


def test_image_as_state_forward_matches_jax():
    """x070 without ``time_states`` (the image pass from a zero state), and
    with ``mean_multi_image``: three images whose states average into one
    row, broadcast to the batch, with every layer's ``time_states``
    gradient through the average."""
    c = lm_case("x070")
    (jl, jlog), jg = state_oracle("x070")["mean"]
    ref = state_oracle("x070")["zero_state"]
    got = ps.image_as_state_forward(c["port"], c["pv"], torch.from_numpy(c["text"]), torch.from_numpy(c["image"]))
    assert got.shape == (B, T_TXT, 512) and max_rel(to_np(got), ref) <= TOL
    ts = torch.from_numpy(c["ts"]).clone().requires_grad_(True)
    logits = ps.image_as_state_forward(c["port"], c["pv"], torch.from_numpy(c["text"]), torch.from_numpy(c["images"]),
                                       mean_multi_image=True, time_states=ts)
    assert max_rel(to_np(logits), jlog) <= TOL
    loss = (logits * torch.from_numpy(c["R"])).sum()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    (g,) = torch.autograd.grad(loss, [ts])
    assert all(np.abs(np.asarray(jg[i])).max() > 0 for i in range(2)) and max_rel(to_np(g), jg) <= TOL


# ---------------------------------------------------------------------------
# the hybrids
# ---------------------------------------------------------------------------


def test_cross_block_indices_and_lora_width_as_jax():
    for args in ((24, 6, 4), (2, 2, 2), (4, 3, 1), (3, 1, 9)):
        assert ph.get_cross_block_indices(*args) == jh.get_cross_block_indices(*args)
    with pytest.raises(ValueError):
        ph.get_cross_block_indices(2, 2, 9)
    for C in (2048, 4096):
        assert ph._d_mix_lora(pcfg.RWKVConfig(n_embd=C)) == jh._d_mix_lora(jcfg.RWKVConfig(n_embd=C))


def _same_tree(port_tree, jax_tree, deterministic=()):
    """Leaf names and shapes equal; the named leaves' values too."""
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax_tree))
    flat_p = dict(jax.tree_util.tree_leaves_with_path(port_tree))
    assert flat_j.keys() == flat_p.keys()
    for path, ref in flat_j.items():
        assert np.shape(flat_p[path]) == np.shape(ref), path
        if jax.tree_util.keystr(path) in deterministic:
            np.testing.assert_allclose(flat_p[path], ref, rtol=1e-6, atol=1e-7)


def test_inits_as_jax():
    """The memory-read, cross-attention, cross-block and hybrid inits:
    leaf names and shapes through the carrier, formula-set values equal."""
    jv, pv = _cfgs("x060")
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    mem = params_to_numpy({"memory_read": [ph.init_memory_read_params(gen, pv.rwkv, 1, "cpu")]}, pv)
    _same_tree(mem["memory_read"][0], np_tree(jax.jit(lambda k: jh.init_memory_read_params(k, jv.rwkv, 1))(key)),
               ("['time_mem_r']", "['time_mem_g']", "['time_mem_w1']"))
    hyb = params_to_numpy({"rwkv": ph.init_hybrid_rwkv_params(gen, pv.rwkv, 3, "cpu")}, pv)["rwkv"]
    _same_tree(hyb, jax.eval_shape(lambda: jh.init_hybrid_rwkv_params(key, jv.rwkv, 3)))
    for blk in hyb["cross_blocks"]:  # zero-init output projections, unit norms
        assert not blk["att"]["output"]["weight"].any() and not blk["ffn"]["c_proj"]["weight"].any()
        assert (blk["ln1"]["weight"] == 1).all() and (blk["ln2"]["bias"] == 0).all()
    att = ph.init_cross_attention_params(gen, pv.rwkv, "cpu")
    assert att["query"]["weight"].shape == (64, 64) and not att["output"]["weight"].any()


def test_memory_read_mix_matches_jax():
    """v6.21's mix on an x060 TimeMix's parameters, and its gradients with
    respect to the memory-read leaves, the input and the image state."""
    jv, pv = _cfgs("x060")
    rng = np.random.default_rng(5)
    ddd = np.arange(64, dtype=np.float32) / 64
    tmix = {"time_maa_x": 1.0 - ddd**0.5}  # the only TimeMix leaf the mix reads
    fresh = [ph.init_memory_read_params(torch.Generator().manual_seed(1), pv.rwkv, 1, "cpu")]
    mem = perturbed(params_to_numpy({"memory_read": fresh}, pv)["memory_read"][0], seed=7)
    x, wkv_out = (rng.normal(0, 1, (B, 7, 64)).astype(np.float32) for _ in range(2))
    s_img = rng.normal(0, 1, (B, 2, 32, 32)).astype(np.float32)

    def jf(m, x, s):
        out = jh.memory_read_mix(jt(tmix), m, jv.rwkv, x, jnp.asarray(wkv_out), s)
        return (out * out).sum(), out

    (jl, jout), jg = oracle_jit(jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True))(
        jt(mem), jnp.asarray(x), jnp.asarray(s_img))
    pmem = params_from_jax({"memory_read": [mem]}, pv, device="cpu")["memory_read"][0]
    leaves = [pmem["mem_read"]["weight"], pmem["mem_gate"]["weight"], pmem["time_mem_w1"], pmem["time_mem_w2"],
              pmem["time_mem_r"], pmem["time_mem_g"]]
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (x, s_img)]
    for t in leaves:
        t.requires_grad_(True)
    ptmix = {"time_maa_x": torch.from_numpy(tmix["time_maa_x"])}
    out = ph.memory_read_mix(ptmix, pmem, pv.rwkv, xs[0], torch.from_numpy(wkv_out), xs[1])
    assert max_rel(to_np(out), jout) <= TOL
    g = torch.autograd.grad((out * out).sum(), leaves + xs)
    jmg = jg[0]
    refs = [jmg["mem_read"]["weight"].T, jmg["mem_gate"]["weight"].T, jmg["time_mem_w1"], jmg["time_mem_w2"],
            jmg["time_mem_r"], jmg["time_mem_g"], jg[1], jg[2]]
    for a, r in zip(g, refs):
        assert max_rel(to_np(a), r) <= TOL


def hybrid_case(version):
    """``lm_case(version)``'s LM with 3 cross blocks (the port's seeded init
    carried to JAX's layout, perturbed), the port's copy, and image
    features."""
    c = lm_case(version)
    gen = torch.Generator().manual_seed(2)
    cross = [ph.init_cross_block_params(gen, c["pv"].rwkv, "cpu") for _ in range(3)]
    cross = params_to_numpy({"rwkv": dict(c["port"]["rwkv"], cross_blocks=cross)}, c["pv"])["rwkv"]["cross_blocks"]
    hyb = dict(c["tree"], cross_blocks=[perturbed(blk, seed=9 + i) for i, blk in enumerate(cross)])
    port = params_from_jax({"rwkv": hyb}, c["pv"], device="cpu")["rwkv"]
    return hyb, port, np.random.default_rng(8).normal(0, 1, (B, 5, 64)).astype(np.float32)


def _hybrid_logits(port, c, feats, **kw):
    return ph.hybrid_rwkv_forward(port, c["pv"].rwkv, torch.from_numpy(c["text"]), torch.from_numpy(feats),
                                  cross_layer_interval=2, **kw)


def test_hybrid_x070_forward_matches_jax():
    """x070 under v6.23's stack: 2 RWKV blocks and 3 cross blocks at
    interval 2 (positions 4, 2, 0: a cross block first, then ``v_first``
    carried across the cross block between the RWKV blocks), and one cross
    block alone."""
    c = lm_case("x070")
    hyb, port, feats = hybrid_case("x070")

    def jf(p):
        logits = jh.hybrid_rwkv_forward(p, c["jv"].rwkv, jnp.asarray(c["text"]), jnp.asarray(feats),
                                        cross_layer_interval=2)
        return logits, jh.cross_attention_block(p["cross_blocks"][1], c["jv"].rwkv, jnp.asarray(c["text"]),
                                                jnp.asarray(feats))

    jlog, jb = oracle_jit(jf)(jt(hyb))
    pb = ph.cross_attention_block(port["cross_blocks"][1], c["pv"].rwkv, torch.from_numpy(c["text"]),
                                  torch.from_numpy(feats))
    assert max_rel(to_np(pb), jb) <= TOL
    assert max_rel(to_np(_hybrid_logits(port, c, feats)), jlog) <= TOL


def test_hybrid_x060_forward_and_gradients_match_jax():
    """v6.23 on x060 (its published family), the stack as above: logits and
    every gradient (RWKV blocks, cross blocks, embedding, head) against
    ``jax.grad``, with and without activation checkpointing."""
    c = lm_case("x060")
    hyb, port, feats = hybrid_case("x060")

    def jloss(p):
        logits = jh.hybrid_rwkv_forward(p, c["jv"].rwkv, jnp.asarray(c["text"]), jnp.asarray(feats),
                                        cross_layer_interval=2)
        return (logits * c["R"]).sum(), logits

    (jl, jlog), jg = oracle_jit(jax.value_and_grad(jloss, has_aux=True))(jt(hyb))
    with torch.no_grad():
        assert max_rel(to_np(_hybrid_logits(port, c, feats)), jlog) <= TOL
    for grad_cp in (False, True):
        loss_fn = lambda p: (_hybrid_logits(p["rwkv"], c, feats, grad_cp=grad_cp) * torch.from_numpy(c["R"])).sum()
        loss, g = grads_numpy({"rwkv": port}, loss_fn, c["pv"])
        assert abs(loss - float(jl)) <= 1e-5 * abs(float(jl))
        assert_grads_match(g, {"rwkv": jg}, ["rwkv"], TOL)


# ---------------------------------------------------------------------------
# the contrastive losses
# ---------------------------------------------------------------------------


def test_contrastive_losses_match_jax():
    rng = np.random.default_rng(10)
    hidden = rng.normal(0, 1, (4, 9, 16)).astype(np.float32)
    tpos, ipos = np.array([8, 3, 5, 0]), np.array([2, 7, 1, 4])
    np.testing.assert_array_equal(to_np(pc_.gather_positions(torch.from_numpy(hidden), torch.from_numpy(tpos))),
                                  np.asarray(jc_.gather_positions(jnp.asarray(hidden), jnp.asarray(tpos))))
    t, v = hidden[:, 0], hidden[:, 1]
    jf = lambda h: (jc_.contrastive_alignment_loss(h, tpos, ipos, 0.1),
                    jc_.in_batch_contrastive_loss(jnp.asarray(t), jnp.asarray(v)))
    (jl, want), jg = oracle_jit(jax.value_and_grad(jf, has_aux=True))(jnp.asarray(hidden))
    h = torch.from_numpy(hidden).requires_grad_(True)
    loss = pc_.contrastive_alignment_loss(h, torch.from_numpy(tpos), torch.from_numpy(ipos), 0.1)
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    (g,) = torch.autograd.grad(loss, [h])
    assert max_rel(to_np(g), jg) <= TOL
    got = pc_.in_batch_contrastive_loss(torch.from_numpy(t), torch.from_numpy(v))
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
