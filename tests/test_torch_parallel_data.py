"""Data parallelism of the port's trainer on 2 gloo ranks of the CPU
(data = 2): two steps at ``zero_stage`` 1 and 3 with
``accumulate_grad_batches=2`` on an image batch (the dp+zero1 and zero3 legs
of ``__graft_entry__.run_dryrun_legs``), the parts each rank keeps, the
checkpoints and the L2Wrap injection. Held against the port's one-process
trainer on the concatenated batch and the JAX package's
``Trainer(mesh=make_mesh(n_data=2))``.

One process group serves the whole file (``tests/torch_parallel_worker.py``,
suite ``data``). The model is ``__graft_entry__._tiny_vlm_cfg(n_layer=2,
n_embd=128)`` in fp32 at T = 64; tolerances at each test."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from torch_port_helpers import max_rel, np_tree, port_cfg, start_ranks
from visualrwkv_torch.convert.from_jax import params_from_jax, params_to_numpy
from visualrwkv_torch.models.visualrwkv import chunked_ce_l2wrap
from visualrwkv_torch.train.optim import tree_leaves, tree_leaves_with_path
from visualrwkv_torch.train.trainer import Trainer
from visualrwkv_tpu import config as jcfg_mod
from visualrwkv_tpu.parallel.mesh import make_mesh, zero_sharding
from visualrwkv_tpu.train.trainer import Trainer as JTrainer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import __graft_entry__ as graft  # noqa: E402

ZERO = [1, 3]


def _jax_cfg():
    jcfg = graft._tiny_vlm_cfg(n_layer=2, n_embd=128)
    rwkv = jcfg.rwkv.__class__(**{**vars(jcfg.rwkv), "compute_dtype": "float32", "ctx_len": W.TRAIN_T})
    return jcfg.replace(rwkv=rwkv)


def _name(path):
    return "/".join(map(str, path))


@pytest.fixture(scope="module")
def batches():
    return [W.image_batch(20 + s, 4, W.train_cfg()) for s in range(2)]


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    out = tmp_path_factory.mktemp("data")
    return out, start_ranks("data", 2, out)


@pytest.fixture(scope="module")
def run(started, one_process, jax_runs):
    """The ranks' results, waited for after the references are made."""
    out, finish = started
    return out, finish()


@pytest.fixture(scope="module")
def one_process(tmp_path_factory, started, batches):
    """The one-process trainer on the whole batch (micro-batches of 2 rows:
    the 2 ranks' 1 row each): the first step's gradients, then 2 steps."""
    cfg = W.train_cfg()
    tr = Trainer(cfg, W.trainer_cfg(1, micro_bsz=2), W.model_params(cfg), device="cpu",
                 proj_dir=str(tmp_path_factory.mktemp("one")))
    _, grads = tr.loss_and_reduced_grads(batches[0])
    names = [_name(p) for (p, _), t in zip(tree_leaves_with_path(tr.params), tree_leaves(tr.opt.train_mask)) if t]
    losses = [float(tr.train_step(b)) for b in batches]
    params = {_name(p): t.detach().numpy() for p, t in tree_leaves_with_path(tr.params)}
    return {"grads": dict(zip(names, (g.numpy() for g in grads))), "losses": losses, "params": params}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory, started, batches):
    """JAX's trainer on ``make_mesh(n_data=2)`` at both ZeRO stages: the 2
    losses and the parameters (in the port's layout)."""
    jcfg, pcfg = _jax_cfg(), W.train_cfg()
    tree = params_to_numpy(W.model_params(pcfg), pcfg)
    out = {}
    for zero in ZERO:
        t = W.trainer_cfg(zero)
        tcfg = jcfg_mod.TrainConfig(**{k: getattr(t, k) for k in (
            "lr_init", "lr_final", "warmup_steps", "weight_decay", "epoch_steps", "epoch_count",
            "micro_bsz", "accumulate_grad_batches", "grad_cp", "grad_clip", "ce_chunk_t",
            "zero_stage")})
        tr = JTrainer(jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), mesh=make_mesh(n_data=2),
                      proj_dir=str(tmp_path_factory.mktemp(f"jax{zero}")), log_every=1)
        tr.run_epoch(lambda s: batches[s], epoch=0)
        params = params_from_jax(np_tree(tr.state.params), pcfg, device="cpu")
        out[zero] = {"losses": [h["loss"] for h in tr.history],
                     "params": {_name(p): t.numpy() for p, t in tree_leaves_with_path(params)}}
    return out


def test_worker_config_mirrors_the_dryrun_legs():
    assert port_cfg(_jax_cfg()) == W.train_cfg()


@pytest.mark.parametrize("zero", ZERO)
def test_first_step_gradients_match_one_process(run, one_process, zero):
    """The first step's gradients, reduced over the 2 ranks (ZeRO-3: each
    rank's reduce-scattered part, gathered), against the one-process
    gradients on the concatenated batch: rtol 1e-5, atol 1e-7, on both
    ranks."""
    _, ranks = run
    for r in ranks:
        for name, ref in one_process["grads"].items():
            np.testing.assert_allclose(r[f"zero{zero}/grad1/{name}"], ref, rtol=1e-5, atol=1e-7,
                                       err_msg=name)


@pytest.mark.parametrize("zero", ZERO)
def test_two_steps_match_one_process_and_jax(run, one_process, jax_runs, zero):
    """The losses of 2 steps (the mean over the data ranks, the same on
    both) against the one-process run at rtol 1e-5 and JAX's mesh trainer at
    rtol 2e-4; the parameters after them within JAX's tolerances, rtol 5e-3
    and atol 3e-4, of both."""
    _, ranks = run
    for r in ranks:
        np.testing.assert_allclose(r[f"zero{zero}/losses"], one_process["losses"], rtol=1e-5)
        np.testing.assert_allclose(r[f"zero{zero}/losses"], jax_runs[zero]["losses"], rtol=2e-4)
    for name, ref in one_process["params"].items():
        got = ranks[0][f"zero{zero}/params/{name}"]
        np.testing.assert_allclose(got, ref, rtol=5e-3, atol=3e-4, err_msg=name)
        np.testing.assert_allclose(got, jax_runs[zero]["params"][name], rtol=5e-3, atol=3e-4, err_msg=name)
        np.testing.assert_array_equal(got, ranks[1][f"zero{zero}/params/{name}"])


@pytest.mark.parametrize("zero", ZERO)
def test_zero_parts_follow_the_jax_rule(run, zero):
    """The leaves a rank keeps a part of are exactly those JAX's
    ``zero_sharding`` splits over ``data`` (the ffn's 512 x 128 leaves, the
    embedding and the head here); ZeRO-1 splits the optimizer state only
    (the worker asserts each leaf's and moment's shape), ZeRO-3 the
    parameters too, also between steps."""
    _, ranks = run
    cfg = W.train_cfg()
    specs = zero_sharding(params_to_numpy(W.model_params(cfg), cfg), make_mesh(n_data=2))
    want = {_name(getattr(k, "key", getattr(k, "idx", None)) for k in path)
            for path, s in jax.tree_util.tree_leaves_with_path(specs, is_leaf=lambda x: hasattr(x, "spec"))
            if "data" in tuple(s.spec)}
    assert want and any("blocks" in n for n in want)
    for r in ranks:
        assert set(r[f"zero{zero}/split"].tolist()) == want
        assert r[f"zero{zero}/shapes_after"].all()


def test_log_comes_from_rank_0_only(run):
    _, ranks = run
    for zero in ZERO:
        assert ranks[0][f"zero{zero}/logged"][0] and not ranks[1][f"zero{zero}/logged"][0]


@pytest.mark.parametrize("zero", ZERO)
def test_checkpoint_resumes_and_loads_in_one_process(run, batches, tmp_path, zero):
    """A checkpoint that 2 ranks saved after step 1 and a fresh 2-rank
    trainer resumed takes step 2 to exactly (``torch.equal``) the
    parameters of the run that never stopped. The one file is in the
    one-process format: a one-process trainer loads it (its parameters and
    moments equal the file's) and takes step 2 within rtol 5e-3, atol 3e-4
    of the 2-rank run."""
    out, ranks = run
    assert all(bool(r[f"zero{zero}/resumed_equal"]) for r in ranks)
    cfg = W.train_cfg()
    path = os.path.join(str(out), f"zero{zero}.pth")
    saved = torch.load(path, weights_only=True)
    tr = Trainer(cfg, W.trainer_cfg(zero, micro_bsz=2), W.model_params(cfg, seed=9), device="cpu",
                 proj_dir=str(tmp_path))
    tr.load_checkpoint(path)
    assert tr.state.step == 1 and tr.state.opt_state.count == 1
    for a, b in zip(tree_leaves(tr.params), tree_leaves(saved["params"])):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(tr.state.opt_state.mu), tree_leaves(saved["opt_state"]["mu"])):
        assert (a is None and b is None) or torch.equal(a, b)
    tr.train_step(batches[1])
    for path_, t in tree_leaves_with_path(tr.params):
        np.testing.assert_allclose(t.detach().numpy(), ranks[0][f"zero{zero}/params/{_name(path_)}"],
                                   rtol=5e-3, atol=3e-4)


def test_l2wrap_alone_on_two_data_ranks(run):
    """Every label ignored: only the L2Wrap injection is left. The head's
    gradient, averaged over the 2 data ranks, and each rank's hidden-state
    gradient over the data size (the average every parameter gradient
    takes) equal the one-process ones within 1e-5."""
    _, ranks = run
    hidden, head, labels = W.l2_inputs()
    h, w = hidden.clone().requires_grad_(True), head.clone().requires_grad_(True)
    chunked_ce_l2wrap(16, w, h, torch.from_numpy(labels)).backward()
    assert np.abs(w.grad.numpy()).max() > 0
    for r in ranks:
        assert max_rel(r["l2/dhead"], w.grad.numpy()) < 1e-5
    dh = np.concatenate([r["l2/dhidden"] for r in ranks], 0) / len(ranks)
    assert max_rel(dh, h.grad.numpy()) < 1e-5


@pytest.mark.parametrize("zero", ZERO)
def test_bf16_sr_parts_round_as_the_whole_leaf(run, zero):
    """Under ``optim_precision="bf16_sr"`` (bf16 parameters, no masters) a
    ZeRO part draws its rounding bits as that part of the whole leaf: after
    one step of one micro-batch the parameters at ``zero_stage`` 1 and 3
    equal, bit for bit, those of the same 2 ranks without ZeRO (the same
    reduced gradients and moments; a part drawing its own bits would move
    about half its elements by one bf16 step). The split bf16 leaves are those of the
    rule, and the step moved them."""
    _, ranks = run
    for r in ranks:
        split = set(r[f"sr{zero}/split"].tolist())
        assert split == set(r[f"zero{zero}/split"].tolist())
        init = {_name(p): t.bfloat16().float().numpy()
                for p, t in tree_leaves_with_path(W.model_params(W.train_cfg()))}
        names = [k[len("sr0/params/"):] for k in r if k.startswith("sr0/params/")]
        assert set(names) == set(init)
        for name in names:
            np.testing.assert_array_equal(r[f"sr{zero}/params/{name}"], r[f"sr0/params/{name}"],
                                          err_msg=name)
        assert all(not np.array_equal(r[f"sr0/params/{n}"], init[n]) for n in split)
