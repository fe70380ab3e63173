"""The v4 adapter (``visualrwkv_torch/multimodal/adapter_v4.py``) and the
gradient of x040's recurrence (``ops/wkv4.py``: ``wkv4_bwd_plain``, the
plain version of kernel K18, and ``WKV4Function``) against the JAX package:
the adapter's init, queries, losses and gradients behind a frozen LM of 2
layers, 64 wide (two heads of 32), vocabulary 512, fp32 on both sides: x040,
the reference's RWKV-4; the JAX parameters perturbed so that the
zero-initialised projections carry signal.

Tolerances: the recurrence's gradient in float64 against autograd of
``wkv4_plain`` max |delta| <= 1e-10 * max |ref| (the same operations: ~4e-16
is seen), and in fp32 against ``jax.grad`` of JAX's scan <= 1e-4 * max |ref|
(another order of fp32 sums over T: ~1e-6 is seen); the losses <= 1e-5
relative; the adapter's gradients <= 1e-4 * max |ref| (the same arithmetic
in another order). Kernel K18 itself runs on the card only:
``chip_smoke.py`` holds it against ``wkv4_bwd_plain``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import max_rel, np_tree, oracle_jit, perturbed, to_np
from visualrwkv_torch import config as pcfg
from visualrwkv_torch.convert.from_jax import params_from_jax, params_to_numpy
from visualrwkv_torch.models import lm as plm
from visualrwkv_torch.multimodal import adapter_v4 as pa
from visualrwkv_torch.ops import wkv4 as pw
from visualrwkv_torch.train.optim import tree_map_with_path
from visualrwkv_tpu import config as jcfg
from visualrwkv_tpu.multimodal import adapter_v4 as ja
from visualrwkv_tpu.ops import wkv4 as jw

TOL = 1e-4
B, S, T = 3, 10, 7


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small models: their eager loops
    launch many tiny operations, which a pool of threads a process slows
    when test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wkv4_inputs(Bn, Tn, C, seed, big_k):
    rng = np.random.default_rng(seed)
    w = -np.exp(rng.uniform(-5, 3, C))
    u = rng.normal(0, 1, C)
    k = rng.normal(0, 1, (Bn, Tn, C))
    v = rng.normal(0, 1, (Bn, Tn, C))
    if big_k:  # the sums would overflow fp32 without the max tracking
        k[..., ::4] = rng.uniform(78, 82, (Bn, Tn, C // 4))
    s0 = np.stack([rng.normal(0, 1, (Bn, C)), rng.uniform(0.5, 2, (Bn, C)), rng.normal(0, 1, (Bn, C))], -1)
    dy = rng.normal(0, 1, (Bn, Tn, C))
    ds = rng.normal(0, 1, (Bn, C, 3))
    return w, u, k, v, s0, dy, ds


@pytest.mark.parametrize("big_k", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv4_bwd_plain_matches_autograd_float64(big_k, with_state):
    """The reverse walk against autograd of the plain loop in float64, with
    cotangents on y and on every part of the final state (pp included)."""
    w, u, k, v, s0, dy, ds = _wkv4_inputs(2, 9, 16, 3, big_k)
    xs = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in (w, u, k, v, s0)]
    if not with_state:
        xs[4] = None
    y, s = pw.wkv4_plain(*xs)
    dy, ds = torch.tensor(dy), torch.tensor(ds)
    ref = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), [x for x in xs if x is not None])
    got = pw.wkv4_bwd_plain(*(None if x is None else x.detach() for x in xs), dy, ds)
    assert (got[4] is None) == (not with_state)
    got = [g for g in got if g is not None]
    assert all(g.dtype == torch.float64 for g in got)
    for g, r in zip(got, ref):
        assert max_rel(g, r) <= 1e-10


@pytest.mark.parametrize("big_k", [False, True])
def test_wkv4_function_matches_jax_grad(big_k):
    """``ops.wkv4.wkv4`` under autograd runs ``WKV4Function`` (on the CPU
    its backward is ``wkv4_bwd_plain``): every gradient, the initial
    state's too, against ``jax.grad`` of the JAX package's scan in fp32."""
    w, u, k, v, s0, dy, ds = (x.astype(np.float32) for x in _wkv4_inputs(2, 20, 64, 5, big_k))

    def jloss(w, u, k, v, s0):
        y, s = jw.wkv4(w, u, k, v, initial_state=s0)
        return (y * dy).sum() + (s * ds).sum()

    jg = oracle_jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, (w, u, k, v, s0)))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (w, u, k, v, s0)]
    y, s = pw.wkv4(*xs)
    assert y.grad_fn is not None and "WKV4Function" in type(y.grad_fn).__name__
    g = torch.autograd.grad((y * torch.from_numpy(dy)).sum() + (s * torch.from_numpy(ds)).sum(), xs)
    for a, r in zip(g, jg):
        assert a.dtype == torch.float32 and max_rel(to_np(a), r) <= TOL


def test_wkv4_function_gradcheck():
    """``WKV4Function`` on the CPU passes a finite-difference check in
    float64, the initial state's gradient included; under ``no_grad``,
    ``wkv4`` builds no graph."""
    w, u, k, v, s0, _, _ = _wkv4_inputs(1, 4, 4, 4, False)
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (w, u, k, v, s0)]
    assert torch.autograd.gradcheck(lambda *a: pw.WKV4Function.apply(*a), xs, eps=1e-6, atol=1e-5)
    with torch.no_grad():
        y, _ = pw.wkv4(*xs)
    assert y.grad_fn is None


# ---------------------------------------------------------------------------
# the adapter
# ---------------------------------------------------------------------------


def _cfgs(version):
    kw = dict(n_layer=2, n_embd=64, vocab_size=512, head_size=32, version=version,
              compute_dtype="float32", ctx_len=64)
    return jcfg.RWKVConfig(**kw), pcfg.RWKVConfig(**kw)


@pytest.fixture(scope="module")
def adapter_case():
    """x040: the trees in JAX's layout (the port's seeded inits carried
    across by ``params_to_numpy``, then perturbed: numpy), the port's copies,
    the inputs, and JAX's queries, losses and adapter gradients (one jitted
    value-and-grad)."""
    jc, pc = _cfgs("x040")
    acfg = ja.AdapterConfig(num_task_embeddings=8, feature_size=16, n_adapter_layers=2)
    vc = pcfg.VLMConfig(rwkv=pc, vision=pcfg.VisionConfig(towers=()))
    gen = torch.Generator().manual_seed(0)
    fresh = params_to_numpy({"rwkv": plm.init_lm_params(gen, pc, "cpu"),
                             "adapter": pa.init_adapter_params(gen, pc, pa.AdapterConfig(**vars(acfg)), "cpu")}, vc)
    lm_tree, a_tree = perturbed(fresh["rwkv"], seed=5), perturbed(fresh["adapter"], seed=6)
    rng = np.random.default_rng(7)
    feats = rng.normal(0, 1, (B, S, 64)).astype(np.float32)
    ids = rng.integers(1, 512, (B, T))
    mask = np.arange(T)[None, :] < np.array([T, 4, 1])[:, None]
    ids = np.where(mask, ids, 0)

    def loss(ap, lp):
        total, parts = ja.adapter_pretrain_losses(ap, lp, jc, jnp.asarray(feats), jnp.asarray(ids),
                                                  jnp.asarray(mask))
        return total, (parts, ja.adapter_queries(ap, jc, jnp.asarray(feats)))

    jt = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    (total, (parts, queries)), grads = oracle_jit(jax.value_and_grad(loss, has_aux=True))(jt(a_tree), jt(lm_tree))
    port = params_from_jax({"rwkv": lm_tree, "adapter": a_tree}, vc, device="cpu")
    return dict(jc=jc, pc=pc, vc=vc, acfg=acfg, a_tree=a_tree, port=port, feats=feats, ids=ids, mask=mask,
                queries=np.asarray(queries), total=float(total), parts={k: float(v) for k, v in parts.items()}, grads=np_tree(grads))


def test_adapter_config_and_init_as_jax():
    """The config's defaults, the init's tree (leaf names and shapes through
    the carrier, the deterministic leaves' values) as the JAX package's."""
    assert pa.AdapterConfig() == pa.AdapterConfig(**vars(ja.AdapterConfig()))
    jc, pc = _cfgs("x040")
    acfg = pa.AdapterConfig()
    init = lambda: ja.init_adapter_params(jax.random.PRNGKey(0), jc, ja.AdapterConfig())
    jtree = jax.eval_shape(init)  # traced for its shapes; the deterministic leaves compiled alone
    jvals = np_tree(oracle_jit(lambda: (lambda t: (t["ln_vision"]["weight"], t["itm_head"]["bias"]))(init()))())
    gen = torch.Generator().manual_seed(0)
    ptree = pa.init_adapter_params(gen, pc, acfg, device="cpu")
    back = params_to_numpy({"adapter": ptree}, pcfg.VLMConfig(rwkv=pc))["adapter"]
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jtree))
    flat_p = dict(jax.tree_util.tree_leaves_with_path(back))
    assert flat_j.keys() == flat_p.keys()
    for path, ref in flat_j.items():
        assert np.shape(flat_p[path]) == np.shape(ref), path
    np.testing.assert_array_equal(back["ln_vision"]["weight"], jvals[0])
    np.testing.assert_array_equal(back["itm_head"]["bias"], jvals[1])
    assert float(back["temperature"]) == pytest.approx(0.07)
    assert back["blocks"][0]["att"]["output"]["weight"].max() == 0  # zero-init output projection


def test_adapter_queries_match_jax(adapter_case):
    c = adapter_case
    q = pa.adapter_queries(c["port"]["adapter"], c["pc"], torch.from_numpy(c["feats"]))
    assert q.shape == (B, 8, 64) and max_rel(to_np(q), c["queries"]) <= TOL


def test_adapter_losses_and_gradients_match_jax(adapter_case):
    """ITC, ITM and LM losses and every adapter gradient against
    ``jax.grad``; the LM's weights, marked trainable, take no gradient
    (the queries' gradient runs through ``WKV4Function``)."""
    c = adapter_case
    port = c["port"]
    leaves, lm_leaves = [], []
    mark = lambda out: lambda path, t: (t.requires_grad_(True), out.append(t))[0]
    tree_map_with_path(mark(leaves), port["adapter"])
    tree_map_with_path(mark(lm_leaves), port["rwkv"])
    total, parts = pa.adapter_pretrain_losses(port["adapter"], port["rwkv"], c["pc"],
                                              torch.from_numpy(c["feats"]), torch.from_numpy(c["ids"]),
                                              torch.from_numpy(c["mask"]))
    assert abs(float(total.detach()) - c["total"]) <= 1e-5 * abs(c["total"])
    for k, v in parts.items():
        assert abs(float(v.detach()) - c["parts"][k]) <= 1e-5 * abs(c["parts"][k]), k
    grads = torch.autograd.grad(total, leaves + lm_leaves, allow_unused=True)
    assert all(g is None for g in grads[len(leaves):]), "an LM weight took a gradient"
    it = iter(grads)
    gtree = tree_map_with_path(lambda path, t: (lambda g: torch.zeros_like(t) if g is None else g)(next(it)),
                               port["adapter"])
    got = params_to_numpy({"adapter": gtree}, c["vc"])["adapter"]
    ref = dict(jax.tree_util.tree_leaves_with_path(c["grads"]))
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        r = np.asarray(ref[path])
        if not np.abs(r).max():  # the ITM head's bias: carried and never added, on both sides
            assert not np.abs(g).max(), jax.tree_util.keystr(path)
            continue
        assert max_rel(g, r) <= TOL, (jax.tree_util.keystr(path), max_rel(g, r))
    for p in leaves + lm_leaves:
        p.requires_grad_(False)
