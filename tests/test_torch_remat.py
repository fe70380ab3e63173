"""What the port keeps across the forward pass: the activation-checkpoint
policies ``grad_cp`` False, True, "dots" and "wkv"
(``models/rwkv7.py::_remat_context``) against the JAX package's
(``models/rwkv7.py::_remat_policy``), what each one recomputes, x060 under
every policy (the JAX package gives x060 the full per-block checkpoint for
any of them), and the token-shift carries of the stateful forward.

Tolerances: against JAX, ``test_torch_loss.py``'s (fp32: loss |delta| <=
1e-5 * |ref|, every gradient leaf max |delta| <= 1e-4 * max |ref|) and, for
x060, ``test_torch_rwkv6.py``'s gradient limit (1e-3 * max |ref|). The
policies change what is kept, not what is computed: among themselves the
port's gradients agree to 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_loss import _jax_loss_and_grads, _port_loss_and_grads, assert_matches_jax, case  # noqa: F401
from test_torch_rwkv6 import _cfgs as _cfgs6
from test_torch_rwkv6 import _ids, _vlm, model  # noqa: F401
from torch_port_helpers import max_rel, to_np
from visualrwkv_torch import config as pcfg
from visualrwkv_torch.convert.from_jax import params_to_numpy
from visualrwkv_torch.models import lm as plm
from visualrwkv_torch.ops import wkv7 as pw
from visualrwkv_tpu.models import lm as jlm
from visualrwkv_tpu.models import rwkv6 as j6

POLICIES = [False, True, "dots", "wkv"]
N_LAYER = 2


@pytest.fixture(autouse=True)
def _auto_mode():
    yield
    pw.set_wkv_impl("auto")


@pytest.mark.parametrize("grad_cp", POLICIES)
def test_policies_match_jax(case, grad_cp):  # noqa: F811
    """``training_loss`` of the tiny triple-tower VisualRWKV-7 (two RWKV
    layers) under each policy against the JAX package's under the same."""
    assert_matches_jax(_port_loss_and_grads(case, True, grad_cp),
                       _jax_loss_and_grads(case, True, grad_cp), case[1])


def _lm(version="x070", B=2, T=32, seed=0):
    cfg = pcfg.RWKVConfig(n_layer=N_LAYER, n_embd=128, vocab_size=256, head_size=64,
                          version=version, compute_dtype="float32", ctx_len=64)
    gen = torch.Generator().manual_seed(seed)
    params = plm.init_lm_params(gen, cfg, "cpu")
    for leaf in jax.tree_util.tree_leaves(params):
        leaf.add_(torch.randn(leaf.shape, generator=gen) * 0.02).requires_grad_(True)
    x = torch.randn(B, T, cfg.n_embd, generator=gen)
    return cfg, params, x


class _CountMM(TorchDispatchMode):
    """Counts the matrix products that actually run."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _grads_counting(monkeypatch, cfg, params, x, grad_cp):
    """(gradients, WKV training forwards run, products run in the backward)."""
    calls = []
    fwd = pw.wkv7_fwd_res_plain
    monkeypatch.setattr(pw, "wkv7_fwd_res_plain", lambda *a, **k: calls.append(1) or fwd(*a, **k))
    leaves = jax.tree_util.tree_leaves({k: v for k, v in params.items() if k != "emb"})  # x is given
    logits, _ = plm.lm_forward(params, cfg, x, grad_cp=grad_cp)
    loss = (logits * torch.linspace(-1, 1, logits.shape[-1])).sum()
    with _CountMM() as mm:
        grads = torch.autograd.grad(loss, leaves)
    return grads, len(calls), mm.n


@pytest.mark.parametrize("impl", ["auto", "packed"])
def test_recompute_counts(monkeypatch, impl):
    """The plain WKV training forward (the CPU side of K5, or of K12 when
    packed) runs once a layer without checkpointing, twice under True and
    "dots" (the block's recompute runs it again) and once under "wkv"
    (its outputs are kept). "dots" keeps the products: its backward runs
    fewer of them than True's, whose recompute runs them all again; "wkv"
    recomputes them as True does."""
    pw.set_wkv_impl(impl)
    cfg, params, x = _lm()
    runs, mms, grads = {}, {}, {}
    for policy in POLICIES:
        grads[policy], runs[policy], mms[policy] = _grads_counting(monkeypatch, cfg, params, x, policy)
    assert runs == {False: N_LAYER, True: 2 * N_LAYER, "dots": 2 * N_LAYER, "wkv": N_LAYER}
    assert mms["dots"] < mms[True] == mms["wkv"]
    assert mms[False] == mms["dots"]
    for policy in POLICIES[1:]:
        for a, b in zip(grads[policy], grads[False]):
            assert max_rel(to_np(a), to_np(b)) < 1e-6, policy


def test_unknown_policy_raises():
    cfg, params, x = _lm()
    with pytest.raises(ValueError, match="grad_cp"):
        plm.lm_forward(params, cfg, x, grad_cp="wvk")
    with pytest.raises(ValueError, match="grad_cp"):
        pcfg.TrainConfig(grad_cp="selective")


@pytest.mark.parametrize("grad_cp", ["dots", "wkv"])
def test_x060_policies_are_the_full_checkpoint(model, grad_cp):  # noqa: F811
    """x060 under "dots" and "wkv" against ``jax.grad`` of the JAX
    package's x060 forward, which checkpoints every block whole for any
    truthy ``grad_cp``; and equal to the port's own ``grad_cp=True``."""
    tree, params = model
    jc, pc = _cfgs6()
    ids = _ids(1, 48, seed=8)
    cot = np.random.default_rng(9).standard_normal((1, 48, 1024)).astype(np.float32)

    def j_loss(p):
        logits, _ = jlm.lm_forward(p, jc, j6.embed(p, jnp.asarray(ids)), grad_cp=grad_cp)
        return (logits * cot).sum()

    j_grads = jax.tree_util.tree_leaves(jax.grad(j_loss)(jax.tree_util.tree_map(jnp.asarray, tree)))

    def port(policy):
        leaves = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), dict(params))
        flat = jax.tree_util.tree_leaves(leaves)
        x = leaves["emb"]["weight"][torch.from_numpy(ids)]
        logits, _ = plm.lm_forward(leaves, pc, x, grad_cp=policy)
        grads = torch.autograd.grad((logits * torch.from_numpy(cot)).sum(), flat)
        g_tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(leaves), list(grads))
        return jax.tree_util.tree_flatten_with_path(params_to_numpy({"rwkv": g_tree}, _vlm(pc))["rwkv"])[0]

    ours, full = port(grad_cp), port(True)
    assert len(ours) == len(j_grads)
    for (path, a), (_, f), b in zip(ours, full, j_grads):
        assert max_rel(a, np.asarray(b)) < 1e-3, jax.tree_util.keystr(path)
        assert max_rel(a, f) < 1e-6, jax.tree_util.keystr(path)


@pytest.mark.parametrize("version", ["x070", "x060"])
@pytest.mark.parametrize("stateful", [False, True])
def test_token_shift_carries_own_their_storage(version, stateful):
    """Each layer's returned ``att_shift`` and ``ffn_shift`` hold B*C floats
    of their own: a view of the last row would keep the layer's whole fp32
    [B, T, C] block input alive with the state."""
    B, T = 2, 32
    cfg, params, x = _lm(version, B=B, T=T)
    states = plm.init_lm_state(cfg, B, "cpu") if stateful else None
    with torch.no_grad():
        _, new = plm.lm_forward(params, cfg, x, states)
    assert len(new) == N_LAYER
    for st in new:
        for carry in (st.att_shift, st.ffn_shift):
            assert carry.shape == (B, cfg.n_embd)
            assert carry.untyped_storage().nbytes() == B * cfg.n_embd * carry.element_size()
