"""The host-offloaded optimizer (``train/offload.py``) and its trainer
wiring: three ``Trainer`` steps offloaded against resident, bit-equal
(parameters, moments, masters); against the JAX package's offloaded
trainer; with leftpad batches; the checkpoint round trip of the offloaded
state; ``bf16_sr`` with offload raising; a partial layer freeze keeping the
resident optimizer; non-uniform block masks refused.

The model: x070 (x060 where it says so), 3 LM layers (so that blocks
1..L-1 are two groups), 64 wide (two heads of 32), vocabulary 2048, fp32 compute, behind a
tiny DINOv2-style tower (16 px, patch 8: 4 image tokens) and a linear
projector. Here on the CPU the groups stream through the same two slots
without pinning, synchronously.

Tolerances: offloaded against resident bit-equal; against JAX the JAX
tests' own, losses and every parameter within rtol=2e-4, atol=2e-5."""

import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import np_tree, perturbed, port_cfg
from visualrwkv_torch import config as pcfg_mod
from visualrwkv_torch.config import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from visualrwkv_torch.convert.from_jax import params_from_jax, params_to_numpy
from visualrwkv_torch.train import optim as popt
from visualrwkv_torch.train.offload import StreamedOffloadOptimizer
from visualrwkv_torch.train.trainer import Trainer
from visualrwkv_tpu import config as jcfg_mod
from visualrwkv_tpu.models.visualrwkv import init_visualrwkv_params
from visualrwkv_tpu.parallel.mesh import make_mesh
from visualrwkv_tpu.train.trainer import Trainer as JTrainer
from visualrwkv_tpu.vision.vit import ViTConfig

T = 32


def _jax_cfg(version="x070", **kw):
    tower = ViTConfig(img_size=16, patch_size=8, width=32, depth=1, heads=2, mlp_dim=64, use_cls=False,
                      num_reg=0, layerscale=False, compute_dtype="float32")
    return jcfg_mod.VLMConfig(
        rwkv=jcfg_mod.RWKVConfig(n_layer=3, n_embd=64, vocab_size=2048, head_size=32, version=version,
                                 compute_dtype="float32", ctx_len=T),
        vision=jcfg_mod.VisionConfig(towers=("dino",), image_size=16, dino_dim=32,
                                     tower_config_overrides={"dino": tower}),
        proj_type="linear", num_token_per_image=4, **kw)


@functools.lru_cache(maxsize=None)
def _model(version):
    jcfg = _jax_cfg(version)
    tree = perturbed(np_tree(init_visualrwkv_params(jax.random.PRNGKey(0), jcfg)), seed=5)
    return jcfg, tree


@pytest.fixture
def model():
    return _model("x070")


def _batch(seed, leftpad=False, bsz=4):
    """Scatter batches: 4 image tokens at 2; leftpad: one image token a
    sample at 2, 5 or 9, none in the last sample."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 2000, (bsz, T)).astype(np.int64)
    if leftpad:
        for i, p in enumerate((2, 5, 9, None)[:bsz]):
            if p is not None:
                ids[i, p] = IMAGE_TOKEN_INDEX
    else:
        ids[:, 2:6] = IMAGE_TOKEN_INDEX
    labels = np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids)
    images = {"dino": rng.integers(0, 256, (bsz, 16, 16, 3)).astype(np.uint8)}
    return {"input_ids": ids, "labels": labels, "images": images}


def _kw(**kw):
    base = dict(lr_init=1e-2, lr_final=1e-3, warmup_steps=2, weight_decay=0.01, epoch_steps=3,
                epoch_count=1, micro_bsz=4, grad_cp=False, grad_clip=1.0, zero_stage=0)
    base.update(kw)
    return base


def _port(model, proj_dir, jcfg=None, **kw):
    jcfg = jcfg or model[0]
    pcfg = port_cfg(jcfg)
    return Trainer(pcfg, pcfg_mod.TrainConfig(**_kw(**kw)), params_from_jax(model[1], pcfg, device="cpu"),
                   device="cpu", proj_dir=str(proj_dir), log_every=1)


def _state_equal(a: Trainer, b: Trainer):
    for x, y in zip(popt.tree_leaves(a.params), popt.tree_leaves(b.params)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for name in ("mu", "nu", "master"):
        for x, y in zip(popt.tree_leaves(getattr(a.state.opt_state, name)),
                        popt.tree_leaves(getattr(b.state.opt_state, name))):
            assert (x is None and y is None) or torch.equal(x, y), name
    assert a.state.opt_state.count == b.state.opt_state.count


@pytest.mark.parametrize("version,param_dtype", [("x070", "float32"), ("x070", "bfloat16"),
                                                  ("x060", "bfloat16")])
def test_offloaded_steps_bit_equal_to_resident(version, param_dtype, tmp_path):
    """Three steps (warm-up, weight decay, the global clip) from one tree:
    parameters, both moments and the fp32 masters bit-equal. The state sits
    in the host buffers, one a group: block 0, blocks 1 and 2, the rest."""
    model = _model(version)
    batches = [_batch(s) for s in range(3)]
    res = _port(model, tmp_path, param_dtype=param_dtype)
    off = _port(model, tmp_path, param_dtype=param_dtype, offload_optimizer=True)
    assert res._streamed is None and isinstance(off._streamed, StreamedOffloadOptimizer)
    assert len(off._streamed.groups) == 4
    for t in (res, off):
        t.run_epoch(lambda s: batches[s], epoch=0)
    assert [h["loss"] for h in res.history] == [h["loss"] for h in off.history]
    _state_equal(res, off)
    st = off._streamed
    host = {b.data_ptr() for b in st._host}
    views = [x for x in popt.tree_leaves(st.state.mu) if x is not None]
    assert views and all(x.untyped_storage().data_ptr() in host for x in views)
    per_param = 12 if param_dtype == "bfloat16" else 8
    n_train = sum(p.numel() for p in off.leaves)
    assert n_train * per_param <= st.pinned_bytes < n_train * per_param + 16 * 4 * 3 * len(off.leaves)


def test_offloaded_trainer_matches_jax_offload(model, tmp_path):
    """The JAX trainer with ``offload_optimizer`` (its streamed per-group
    optimizer) and the port's, three steps on the same tree and batches."""
    jcfg, tree = model
    batches = [_batch(10 + s) for s in range(3)]
    jt = JTrainer(jcfg, jcfg_mod.TrainConfig(**_kw(offload_optimizer=True)), jax.tree_util.tree_map(
        jnp.asarray, tree), mesh=make_mesh(n_data=1), proj_dir=str(tmp_path), log_every=1)
    assert jt._streamed is not None
    jt.run_epoch(lambda s: batches[s], epoch=0)
    pt = _port(model, tmp_path, offload_optimizer=True)
    pt.run_epoch(lambda s: batches[s], epoch=0)
    np.testing.assert_allclose([h["loss"] for h in pt.history], [h["loss"] for h in jt.history],
                               rtol=2e-4, atol=2e-5)
    back = params_to_numpy(pt.params, port_cfg(jcfg))
    flat_j = jax.tree_util.tree_leaves(np_tree(jt.state.params))
    flat_p = jax.tree_util.tree_leaves_with_path(back)
    assert len(flat_p) == len(flat_j)
    for (path, a), b in zip(flat_p, flat_j):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5, err_msg=jax.tree_util.keystr(path))


def test_offload_with_leftpad_batches(tmp_path):
    """VisualRWKV-6's leftpad insertion (x060) with offload: bit-equal to
    the resident optimizer on the same leftpad batches (one plan a batch,
    made on the host), and the losses of JAX's offloaded leftpad trainer."""
    model = _model("x060")
    jcfg = dataclasses.replace(model[0], insertion_mode="leftpad")
    batches = [_batch(20 + s, leftpad=True) for s in range(3)]
    res = _port(model, tmp_path, jcfg)
    off = _port(model, tmp_path, jcfg, offload_optimizer=True)
    for t in (res, off):
        t.run_epoch(lambda s: batches[s], epoch=0)
    _state_equal(res, off)
    jt = JTrainer(jcfg, jcfg_mod.TrainConfig(**_kw(offload_optimizer=True)), jax.tree_util.tree_map(
        jnp.asarray, model[1]), mesh=make_mesh(n_data=1), proj_dir=str(tmp_path), log_every=1)
    jt.run_epoch(lambda s: batches[s], epoch=0)
    np.testing.assert_allclose([h["loss"] for h in off.history], [h["loss"] for h in jt.history],
                               rtol=2e-4, atol=2e-5)


def test_offloaded_checkpoint_round_trip(model, tmp_path):
    """Two steps, save, wipe the host state, load: the third step equals an
    uninterrupted run's, bit for bit, and the restored state is the saved."""
    batches = [_batch(30 + s) for s in range(3)]
    a = _port(model, tmp_path, param_dtype="bfloat16", offload_optimizer=True)
    for s in range(3):
        a.train_step(batches[s])
    b = _port(model, tmp_path, param_dtype="bfloat16", offload_optimizer=True)
    for s in range(2):
        b.train_step(batches[s])
    path = str(tmp_path / "ckpt.pt")
    b.save_checkpoint(path)
    saved = [x.clone() for x in b._streamed._host]
    for buf in b._streamed._host:
        buf.zero_()
    b._streamed.state.count = 0
    b.load_checkpoint(path)
    assert all(torch.equal(x, y) for x, y in zip(saved, b._streamed._host))
    assert b.state.step == 2 and b.state.opt_state.count == 2
    b.train_step(batches[2])
    _state_equal(a, b)


def test_offload_options_as_the_jax_trainer_takes_them(model, caplog, tmp_path):
    """``bf16_sr`` with offload raises; a partial layer freeze keeps the
    resident optimizer and says so on one line; built directly on such a
    tree the offloaded optimizer refuses its non-uniform block masks."""
    with pytest.raises(NotImplementedError):
        pcfg_mod.TrainConfig(offload_optimizer=True, optim_precision="bf16_sr")
    with caplog.at_level(logging.INFO, logger="visualrwkv_torch.train.trainer"):
        tr = _port(model, tmp_path, offload_optimizer=True, freeze_rwkv_layers=2)
    assert tr._streamed is None
    assert any("partial layer freeze keeps the resident optimizer" in r.message for r in caplog.records)
    pcfg = port_cfg(model[0])
    with pytest.raises(ValueError, match="uniform block masks"):
        StreamedOffloadOptimizer(pcfg_mod.TrainConfig(**_kw(offload_optimizer=True, freeze_rwkv_layers=2)),
                                 pcfg, tr.params, 3, device="cpu")
    whole = _port(model, tmp_path, offload_optimizer=True, freeze_rwkv_layers=3)  # every LM block frozen: uniform
    assert whole._streamed is not None and [len(g) for g in whole._streamed.groups] == [len(whole.leaves)]
