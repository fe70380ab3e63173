"""Both axes at once: the port's trainer on 4 gloo ranks of the CPU, data = 2
x seq = 2, two steps on an image batch at ``zero_stage`` 1 and 3 with
``accumulate_grad_batches=2``. Sub-group mistakes (a gradient summed where
it should be averaged, a reduction over the wrong group) show only here.
Held against the port's one-process trainer on the whole batch and the JAX
package's ``Trainer(mesh=make_mesh(n_data=2, n_seq=2))``.

One process group serves the file (``tests/torch_parallel_worker.py``, suite
``mesh4``); the model of ``tests/test_torch_parallel_data.py``."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_worker as W
from torch_port_helpers import np_tree, start_ranks
from visualrwkv_torch.convert.from_jax import params_from_jax, params_to_numpy
from visualrwkv_torch.train.optim import tree_leaves, tree_leaves_with_path
from visualrwkv_torch.train.trainer import Trainer
from visualrwkv_tpu import config as jcfg_mod
from visualrwkv_tpu.parallel.mesh import make_mesh
from visualrwkv_tpu.train.trainer import Trainer as JTrainer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import __graft_entry__ as graft  # noqa: E402

ZERO = [1, 3]


def _name(path):
    return "/".join(map(str, path))


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """Start the 4 ranks, then make the one-process and JAX runs while they
    work; returns (ranks, one-process, JAX) results."""
    finish = start_ranks("mesh4", 4, tmp_path_factory.mktemp("mesh4"))
    pcfg = W.train_cfg()
    batches = [W.image_batch(20 + s, 4, pcfg) for s in range(2)]
    tr = Trainer(pcfg, W.trainer_cfg(1, micro_bsz=2), W.model_params(pcfg), device="cpu",
                 proj_dir=str(tmp_path_factory.mktemp("one")))
    _, grads = tr.loss_and_reduced_grads(batches[0])
    names = [_name(p) for (p, _), t in zip(tree_leaves_with_path(tr.params), tree_leaves(tr.opt.train_mask)) if t]
    one = {"grads": {n: g.numpy() for n, g in zip(names, grads)},
           "losses": [float(tr.train_step(b)) for b in batches],
           "params": {_name(p): t.detach().numpy() for p, t in tree_leaves_with_path(tr.params)}}
    jcfg = graft._tiny_vlm_cfg(n_layer=2, n_embd=128)
    jcfg = jcfg.replace(rwkv=jcfg.rwkv.__class__(**{**vars(jcfg.rwkv), "compute_dtype": "float32",
                                                     "ctx_len": W.TRAIN_T}))
    tree = params_to_numpy(W.model_params(pcfg), pcfg)
    jax_out = {}
    for zero in ZERO:
        t = W.trainer_cfg(zero)
        tcfg = jcfg_mod.TrainConfig(**{k: getattr(t, k) for k in (
            "lr_init", "lr_final", "warmup_steps", "weight_decay", "epoch_steps", "epoch_count",
            "micro_bsz", "accumulate_grad_batches", "grad_cp", "grad_clip", "ce_chunk_t",
            "zero_stage")})
        jt = JTrainer(jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                      mesh=make_mesh(n_data=2, n_seq=2),
                      proj_dir=str(tmp_path_factory.mktemp(f"jax{zero}")), log_every=1)
        jt.run_epoch(lambda s: batches[s], epoch=0)
        params = params_from_jax(np_tree(jt.state.params), pcfg, device="cpu")
        jax_out[zero] = {"losses": [h["loss"] for h in jt.history],
                         "params": {_name(p): t.numpy() for p, t in tree_leaves_with_path(params)}}
    return finish(), one, jax_out


@pytest.mark.parametrize("zero", ZERO)
def test_data2_x_seq2_trainer_matches_one_process_and_jax(references, zero):
    """The 4 ranks' losses (the same on each) against the one-process run at
    rtol 1e-5 and JAX's data 2 x seq 2 trainer at rtol 2e-4; the first
    step's reduced gradients against the one-process step's at rtol 1e-5,
    atol 1e-7, and equal on the 4 ranks; the parameters after 2 steps within
    rtol 5e-3, atol 3e-4 of both references, and equal on the 4 ranks."""
    ranks, one, jx = references
    tag = f"mesh4_zero{zero}"
    for r in ranks:
        np.testing.assert_allclose(r[f"{tag}/losses"], one["losses"], rtol=1e-5)
        np.testing.assert_allclose(r[f"{tag}/losses"], jx[zero]["losses"], rtol=2e-4)
    for name, ref in one["params"].items():
        got = ranks[0][f"{tag}/params/{name}"]
        np.testing.assert_allclose(got, ref, rtol=5e-3, atol=3e-4, err_msg=name)
        np.testing.assert_allclose(got, jx[zero]["params"][name], rtol=5e-3, atol=3e-4, err_msg=name)
        for r in ranks[1:]:
            np.testing.assert_array_equal(got, r[f"{tag}/params/{name}"])
    for name, ref in one["grads"].items():
        got = ranks[0][f"{tag}/grad1/{name}"]
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7, err_msg=name)
        for r in ranks[1:]:
            np.testing.assert_array_equal(got, r[f"{tag}/grad1/{name}"])
