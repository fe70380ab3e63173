"""Context parallelism of the port on 2 gloo ranks of the CPU (seq = 2): the
WKV7 / WKV6 rings (``ops/wkv_sp.py``), the context-parallel forwards, the
sequence-parallel loss and the L2Wrap injection, against the port's
one-process functions and the JAX package's ``shard_map`` versions on
``make_mesh(n_data=1, n_seq=2)``.

One process group serves the whole file: the ranks
(``tests/torch_parallel_worker.py``, suite ``seq``) run every case once and
write their results; the cases here read them. fp32; the relative errors
are max |x - ref| / max |ref|, the tolerances are stated at each test."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_parallel_worker as W
from torch_port_helpers import max_rel, np_tree, oracle_jit, port_cfg, start_ranks
from visualrwkv_torch.convert.from_jax import params_from_jax, params_to_numpy
from visualrwkv_torch.models import rwkv7 as p7
from visualrwkv_torch.models.lm import lm_forward
from visualrwkv_torch.models.visualrwkv import chunked_ce_l2wrap, training_loss
from visualrwkv_torch.ops.wkv6 import wkv6
from visualrwkv_torch.ops.wkv7 import wkv7
from visualrwkv_torch.train.optim import tree_leaves_with_path, tree_map
from tests.test_train import tiny_vlm_cfg
from visualrwkv_tpu.models.visualrwkv import training_loss_seq as j_training_loss_seq
from visualrwkv_tpu.ops.wkv_sp import wkv6_seq_shard as j_wkv6_seq_shard
from visualrwkv_tpu.ops.wkv_sp import wkv7_seq_shard as j_wkv7_seq_shard
from visualrwkv_tpu.parallel.mesh import make_mesh


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_loss_seq):
    finish = start_ranks("seq", 2, tmp_path_factory.mktemp("seq"))
    for version in ("x070", "x060"):  # compile JAX's oracles while the ranks run
        jax_loss_seq[version](*_loss_seq_args(version))
    return finish()


def _cat(ranks, key, axis=1):
    return np.concatenate([r[key] for r in ranks], axis)


def _summed(ranks, key):
    return sum(r[key] for r in ranks)


def _jax_cfg(version):
    jcfg = tiny_vlm_cfg()
    return jcfg.replace(rwkv=dataclasses.replace(jcfg.rwkv, ctx_len=W.SEQ_T, version=version, dim_att=0,
                                                 dim_ffn=0))


def test_worker_configs_mirror_the_jax_tests():
    """The ranks' tiny model is ``tests/test_train.py``'s at T = 64."""
    for version in ("x070", "x060"):
        assert port_cfg(_jax_cfg(version)) == W.seq_cfg(version)


def _ring_jax(family, ins, cot):
    """JAX's ``wkv*_seq_shard`` under ``shard_map`` (seq = 2): y, the final
    state and the gradients of sum(y * cy) + sum(s * cs)."""
    order = W.RING_ORDER[family]
    fn = j_wkv7_seq_shard if family == "wkv7" else j_wkv6_seq_shard
    xs = P(None, "seq", None, None)
    specs = tuple(P() if k == "u" else xs for k in order) + ((P(),) if ins["s0"] is not None else ())
    smapped = jax.shard_map(lambda *a: fn(*a, chunk=16), mesh=make_mesh(n_data=1, n_seq=2),
                            in_specs=specs, out_specs=(xs, P()))
    args = [jnp.asarray(ins[k].numpy()) for k in order]
    if ins["s0"] is not None:
        args.append(jnp.asarray(ins["s0"].numpy()))
    cy, cs = jnp.asarray(cot["y"].numpy()), jnp.asarray(cot["s"].numpy())

    def loss(*a):
        y, s = smapped(*a)
        return (y * cy).sum() + (s * cs).sum(), (y, s)

    (_, (y, s)), grads = oracle_jit(jax.value_and_grad(loss, argnums=tuple(range(len(args))),
                                                       has_aux=True))(*args)
    names = list(order) + (["s0"] if ins["s0"] is not None else [])
    return np.asarray(y), np.asarray(s), {k: np.asarray(g) for k, g in zip(names, grads)}


@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "initial_state"])
@pytest.mark.parametrize("family", ["wkv7", "wkv6"])
def test_wkv_ring_matches_whole_sequence_and_jax(ranks, family, with_state):
    """``wkv7_seq_shard`` / ``wkv6_seq_shard`` on 2 seq ranks against the
    port's whole-sequence op and JAX's ring under ``shard_map``: y and the
    final state (on both ranks) within 1e-5, the input and initial-state
    gradients (a rank's range; ``u`` and the state summed over the ranks)
    within 1e-4."""
    ins, cot = W.ring_inputs(family, with_state)
    order = W.RING_ORDER[family]
    leaves = {k: ins[k].clone().requires_grad_(True) for k in order}
    s0 = None if ins["s0"] is None else ins["s0"].clone().requires_grad_(True)
    y, s = (wkv7 if family == "wkv7" else wkv6)(*(leaves[k] for k in order), initial_state=s0,
                                                 chunk=16)
    ((y * cot["y"]).sum() + (s * cot["s"]).sum()).backward()
    whole = {k: x.grad.numpy() for k, x in leaves.items()}
    if s0 is not None:
        whole["s0"] = s0.grad.numpy()
    jy, js, jgrads = _ring_jax(family, ins, cot)

    tag = f"ring_{family}_{int(with_state)}"
    y_sp = _cat(ranks, f"{tag}/y")
    for ref in (y.detach().numpy(), jy):
        assert max_rel(y_sp, ref) < 1e-5
    for r in ranks:
        for ref in (s.detach().numpy(), js):
            assert max_rel(r[f"{tag}/s"], ref) < 1e-5
    for k in whole:
        g = _summed(ranks, f"{tag}/d{k}") if k in ("u", "s0") else _cat(ranks, f"{tag}/d{k}")
        assert max_rel(g, whole[k]) < 1e-4, (k, max_rel(g, whole[k]))
        assert max_rel(g, jgrads[k]) < 1e-4, (k, max_rel(g, jgrads[k]))


@pytest.mark.parametrize("grad_cp", [False, True], ids=["no_cp", "grad_cp"])
@pytest.mark.parametrize("version", ["x070", "x060"])
def test_forward_seq_matches_whole_forward(ranks, version, grad_cp):
    """``rwkv7_forward_seq`` / ``rwkv6_forward_seq`` (halo token shift + WKV
    ring) against ``lm_forward`` on the whole sequence: the hidden states
    and the logits within 1e-5; the gradients of sum(hidden * c), summed
    over the ranks (under ``grad_cp`` through the recomputed halos and
    rings), within 1e-4 of every leaf's."""
    cfg = W.seq_cfg(version)
    params = tree_map(lambda t: t.clone().requires_grad_(True), W.model_params(cfg)["rwkv"])
    ids = torch.from_numpy(W.text_batch(3, 2, W.SEQ_T)["input_ids"])
    c = torch.from_numpy(np.random.default_rng(5).standard_normal((2, W.SEQ_T, cfg.rwkv.n_embd))).float()
    hidden, _ = lm_forward(params, cfg.rwkv, p7.embed(params, ids), grad_cp=grad_cp, return_hidden=True)
    (hidden * c).sum().backward()
    tag = f"fwd_{version}_{int(grad_cp)}"
    assert max_rel(_cat(ranks, f"{tag}/hidden"), hidden.detach().numpy()) < 1e-5
    with torch.no_grad():
        logits = p7.linear(params["head"], hidden, cfg.rwkv.dtype)[..., :512].numpy()
    assert max_rel(_cat(ranks, f"{tag}/logits"), logits) < 1e-5
    for path, p in tree_leaves_with_path(params):
        key = f"{tag}/grad/" + "/".join(map(str, path))
        if p.grad is None:  # the head: the hidden states do not reach it
            assert key not in ranks[0]
            continue
        assert max_rel(_summed(ranks, key), p.grad.numpy()) < 1e-4, key


@pytest.fixture(scope="module")
def jax_loss_seq():
    """JAX's ``training_loss_seq`` under ``shard_map`` on (data 1, seq 2),
    and its gradient, jitted once a version."""
    out = {}
    for version in ("x070", "x060"):
        jcfg = _jax_cfg(version)
        smapped = jax.shard_map(
            lambda p, i, l, jcfg=jcfg: j_training_loss_seq(p, jcfg, i, l, grad_cp=False, ce_chunk_t=16),
            mesh=make_mesh(n_data=1, n_seq=2), in_specs=(P(), P("data", "seq"), P("data", "seq")),
            out_specs=P(), axis_names=frozenset({"data", "seq"}))
        out[version] = oracle_jit(jax.value_and_grad(smapped))
    return out


def _loss_seq_args(version):
    """JAX's arguments of the loss case: the LM in JAX's layout, the ids and
    the pre-shifted labels."""
    from visualrwkv_torch.train.trainer import shift_labels

    cfg = W.seq_cfg(version)
    b = W.text_batch(4, 4, W.SEQ_T)
    lm = {"rwkv": W.model_params(cfg)["rwkv"]}
    return (jax.tree_util.tree_map(jnp.asarray, params_to_numpy(lm, cfg)), jnp.asarray(b["input_ids"]),
            jnp.asarray(shift_labels(b["labels"])))


@pytest.mark.parametrize("version", ["x070", "x060"])
def test_training_loss_seq_matches_one_process_and_jax(ranks, jax_loss_seq, version):
    """``training_loss_seq`` on 2 seq ranks (labels pre-shifted on the host)
    against the port's ``training_loss`` on the whole batch and JAX's
    ``training_loss_seq`` on ``make_mesh(n_data=1, n_seq=2)``: the loss at
    rtol 1e-5 on both ranks; the LM gradients summed over the ranks at rtol
    1e-4, atol 1e-5 (the JAX test's tolerances)."""
    cfg = W.seq_cfg(version)
    params = W.model_params(cfg)
    b = W.text_batch(4, 4, W.SEQ_T)
    lm = {"rwkv": tree_map(lambda t: t.clone().requires_grad_(True), params["rwkv"])}
    loss = training_loss(dict(params, **lm), cfg, b["input_ids"], b["labels"], grad_cp=False,
                         ce_chunk_t=16, device="cpu")
    loss.backward()
    jloss, jgrads = jax_loss_seq[version](*_loss_seq_args(version))
    jgrads = params_from_jax(np_tree(jgrads), cfg, device="cpu")["rwkv"]
    tag = f"loss_{version}"
    for r in ranks:
        np.testing.assert_allclose(float(r[f"{tag}/loss"]), float(loss.detach()), rtol=1e-5)
        np.testing.assert_allclose(float(r[f"{tag}/loss"]), float(jloss), rtol=1e-5)
    for (path, p), (_, jg) in zip(tree_leaves_with_path(lm["rwkv"]), tree_leaves_with_path(jgrads)):
        g = _summed(ranks, f"{tag}/grad/" + "/".join(map(str, path)))
        np.testing.assert_allclose(g, p.grad.numpy(), rtol=1e-4, atol=1e-5, err_msg=str(path))
        np.testing.assert_allclose(g, jg.numpy(), rtol=1e-4, atol=1e-5, err_msg=str(path))


def test_l2wrap_alone_on_two_seq_ranks(ranks):
    """Every label ignored, so the CE term is 0 and only the L2Wrap injection
    is left: the head's gradient (summed over the seq ranks) and each rank's
    hidden-state gradient equal the one-process ones within 1e-5. A factor
    counted once a rank (or a local T in it) would be off by 2."""
    hidden, head, labels = W.l2_inputs()
    h, w = hidden.clone().requires_grad_(True), head.clone().requires_grad_(True)
    chunked_ce_l2wrap(16, w, h, torch.from_numpy(labels)).backward()
    assert np.abs(w.grad.numpy()).max() > 0
    for r in ranks:
        assert max_rel(r["l2/dhead"], w.grad.numpy()) < 1e-5
    assert max_rel(_cat(ranks, "l2/dhidden"), h.grad.numpy()) < 1e-5
