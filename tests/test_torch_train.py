"""The port's trainer against the JAX package's: schedules, masks, k = 3
train steps from the same numpy parameters and batches, gradient
accumulation, the skip of non-finite steps, stochastic rounding, the
master-less ``bf16_sr`` mode and checkpoint resume.

The model is 2 RWKV-7 layers, 128 wide, with the tiny towers of the CLI's
``--dummy`` run, fp32 compute. Tolerances are stated at each test."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import max_rel, np_tree, perturbed, port_cfg
from visualrwkv_torch import config as pcfg_mod
from visualrwkv_torch.config import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from visualrwkv_torch.convert.from_jax import params_from_jax, params_to_numpy
from visualrwkv_torch.train import optim as popt
from visualrwkv_torch.train import schedule as psched
from visualrwkv_torch.train.trainer import Trainer
from visualrwkv_tpu import config as jcfg_mod
from visualrwkv_tpu.models.visualrwkv import init_visualrwkv_params
from visualrwkv_tpu.parallel.mesh import make_mesh
from visualrwkv_tpu.train import optim as jopt
from visualrwkv_tpu.train import schedule as jsched
from visualrwkv_tpu.train.trainer import Trainer as JTrainer
from visualrwkv_tpu.vision.sam import SAMConfig
from visualrwkv_tpu.vision.vit import ViTConfig

T = 48


def _jax_cfg():
    overrides = {
        "dino": ViTConfig(img_size=64, patch_size=8, width=64, depth=2, heads=4,
                          mlp_dim=128, use_cls=True, num_reg=4, layerscale=True),
        "siglip": ViTConfig(img_size=64, patch_size=8, width=64, depth=2, heads=4,
                            mlp_dim=128, act="gelu_tanh", use_cls=False),
        "sam": SAMConfig(img_size=128, patch_size=8, width=64, depth=2, heads=4,
                         mlp_dim=128, out_chans=32, window_size=4, global_attn_indexes=(1,)),
    }
    return jcfg_mod.VLMConfig(
        rwkv=jcfg_mod.RWKVConfig(n_layer=2, n_embd=128, vocab_size=2048, head_size=64,
                                 compute_dtype="float32", ctx_len=T),
        vision=jcfg_mod.VisionConfig(
            towers=("dino", "siglip", "sam"), image_size=64, sam_image_size=128,
            dino_dim=64, siglip_dim=64, sam_dim=128, tower_config_overrides=overrides),
        proj_type="mlp", num_token_per_image=16,
    )


def _batch(seed, bsz=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, 2000, (bsz, T)).astype(np.int64)
    ids[:, 2:18] = IMAGE_TOKEN_INDEX
    labels = np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids)
    labels[:, 18:24] = IGNORE_INDEX
    images = {"dino": rng.integers(0, 256, (bsz, 64, 64, 3)).astype(np.uint8),
              "siglip": rng.integers(0, 256, (bsz, 64, 64, 3)).astype(np.uint8),
              "sam": rng.integers(0, 256, (bsz, 128, 128, 3)).astype(np.uint8)}
    return {"input_ids": ids, "labels": labels, "images": images}


@pytest.fixture(scope="module")
def model():
    jcfg = _jax_cfg()
    tree = perturbed(np_tree(init_visualrwkv_params(jax.random.PRNGKey(0), jcfg)), seed=3)
    return jcfg, port_cfg(jcfg), tree


def _tcfg(mod, **kw):
    base = dict(lr_init=1e-3, lr_final=1e-4, warmup_steps=2, weight_decay=0.01,
                epoch_steps=3, epoch_count=1, micro_bsz=2, grad_cp=True, grad_clip=1.0,
                ce_chunk_t=16, zero_stage=0)
    base.update(kw)
    return mod.TrainConfig(**base)


def _port_trainer(model, proj_dir, **kw):
    _, pcfg, tree = model
    return Trainer(pcfg, _tcfg(pcfg_mod, **kw), params_from_jax(tree, pcfg, device="cpu"),
                   device="cpu", proj_dir=str(proj_dir), log_every=1)


def test_schedules_match_jax():
    """Ten steps of the learning-rate and weight-decay schedules, with and
    without warm-up: |delta| <= 1e-7, and within two float32 ulps (2.4e-7
    relative) of each other: both evaluate in float32, and numpy's and XLA's
    ``exp`` and ``cos`` round the last bits differently."""
    def close(a, b):
        return abs(a - b) <= 1e-7 and abs(a - b) <= 2.4e-7 * abs(b)

    for warmup in (0, 4):
        for step in range(10):
            a = psched.cosine_warmup_lr(step, 6e-4, 1e-5, warmup, 10)
            b = float(jsched.cosine_warmup_lr(step, 6e-4, 1e-5, warmup, 10))
            assert close(a, b), (warmup, step, a, b)
            a = psched.wd_schedule(step, 0.1, 0.01, warmup, 10)
            b = float(jsched.wd_schedule(step, 0.1, 0.01, warmup, 10))
            assert close(a, b), (warmup, step, a, b)
    assert psched.cosine_warmup_lr(3, 1e-3, 1e-3, 0, 10) == pytest.approx(1e-3, rel=1e-7)
    assert psched.wd_schedule(3, 0.1, -1.0, 0, 10) == pytest.approx(0.1, rel=1e-7)


@pytest.mark.parametrize("freeze", [{}, {"freeze_rwkv_layers": 1, "freeze_emb": True},
                                    {"freeze_proj": True, "freeze_rwkv_layers": 2}],
                         ids=["none", "layer0_emb", "proj_all_layers"])
def test_masks_match_jax_leaf_by_leaf(model, freeze):
    jcfg, pcfg, tree = model
    params = params_from_jax(tree, pcfg, device="cpu")
    # a mask as a tree of constant tensors, so that it can be carried to the JAX layout
    as_np = lambda mask: params_to_numpy(
        popt.tree_map(lambda m, p: torch.full_like(p, float(m)), mask, params), pcfg)
    j_train = jopt.trainable_mask(tree, jcfg_mod.TrainConfig(**freeze), jcfg.rwkv.n_layer)
    p_train = as_np(popt.trainable_mask(params, pcfg_mod.TrainConfig(**freeze), pcfg.rwkv.n_layer))
    j_wd = jopt.weight_decay_mask(tree)
    p_wd = as_np(popt.weight_decay_mask(params))
    for j, p in ((j_train, p_train), (j_wd, p_wd)):
        flat_j = jax.tree_util.tree_leaves_with_path(j)
        flat_p = jax.tree_util.tree_leaves_with_path(p)
        assert len(flat_j) == len(flat_p)
        for (path, a), (_, b) in zip(flat_j, flat_p):
            assert bool(a) == bool(np.all(b)) == bool(np.any(b)), jax.tree_util.keystr(path)


def _jax_run(model, tmp_path, batches, **kw):
    jcfg, _, tree = model
    tr = JTrainer(jcfg, _tcfg(jcfg_mod, **kw), jax.tree_util.tree_map(jnp.asarray, tree),
                  mesh=make_mesh(n_data=1), proj_dir=str(tmp_path), log_every=1)
    tr.run_epoch(lambda s: batches[s], epoch=0)
    return [h["loss"] for h in tr.history], np_tree(tr.state.params)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16", "float16"])
def test_three_trainer_steps_match_jax(model, tmp_path, param_dtype):
    """k = 3 steps (warm-up, weight decay, clipping, fp32 masters for bf16
    and fp16 parameters) from the same parameters and batches. fp32: losses
    within 1e-4 relative and every updated leaf within 1e-4 * max |ref|.
    With bf16 parameters the two frameworks round the forward at different
    places: losses within 2e-2 relative, and updated leaves within 2 bf16
    ulps of the leaf's largest value (2^-7 relative) plus the 3 steps'
    travel. fp16 storage (8 times finer than bf16) is held to the bf16
    limits."""
    _, pcfg, _ = model
    batches = [_batch(s) for s in range(3)]
    j_losses, j_params = _jax_run(model, tmp_path, batches, param_dtype=param_dtype)
    tr = _port_trainer(model, tmp_path, param_dtype=param_dtype)
    tr.run_epoch(lambda s: batches[s], epoch=0)
    p_losses = [h["loss"] for h in tr.history]
    back = params_to_numpy(tr.params, pcfg)
    fp32 = param_dtype == "float32"
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-4 if fp32 else 2e-2)
    flat_p = jax.tree_util.tree_leaves_with_path(back)
    flat_j = jax.tree_util.tree_leaves_with_path(j_params)
    assert len(flat_p) == len(flat_j)
    tol = 1e-4 if fp32 else 2.0**-6
    for (path, a), (_, b) in zip(flat_p, flat_j):
        assert max_rel(a, b) < tol, jax.tree_util.keystr(path)
    if not fp32:
        leaves = popt.tree_leaves(tr.params)
        assert all(p.dtype == getattr(torch, param_dtype) for p in leaves)
        masters = [m for m in popt.tree_leaves(tr.state.opt_state.master) if m is not None]
        assert masters and all(m.dtype == torch.float32 for m in masters)


def test_frozen_leaves_do_not_change_and_trainable_do(model, tmp_path):
    _, pcfg, tree = model
    tr = _port_trainer(model, tmp_path, freeze_rwkv_layers=1)
    before = popt.tree_map(lambda p: p.detach().clone(), tr.params)
    tr.run_epoch(lambda s: _batch(s), epoch=0)
    mask = tr.opt.train_mask
    for (path, t), a, b in zip(popt.tree_leaves_with_path(mask), popt.tree_leaves(before),
                               popt.tree_leaves(tr.params)):
        assert torch.equal(a, b) != t, path
        assert t == (path[0] != "vit" and path[:3] != ("rwkv", "blocks", 0)), path


def test_accumulation_2x1_equals_1x2(model, tmp_path):
    """Two micro-batches of one sample accumulate to the step of one
    micro-batch of two: the loss is normalised per sample, so the means
    agree. fp32, max |delta| <= 1e-5 * max |ref| after 2 steps."""
    big = _batch(7, bsz=2)
    a = _port_trainer(model, tmp_path, micro_bsz=2, accumulate_grad_batches=1, epoch_steps=2)
    b = _port_trainer(model, tmp_path, micro_bsz=1, accumulate_grad_batches=2, epoch_steps=2)
    la = a.run_epoch(lambda s: big, epoch=0)
    lb = b.run_epoch(lambda s: big, epoch=0)
    assert abs(la - lb) <= 1e-5 * abs(la)
    for x, y in zip(popt.tree_leaves(a.params), popt.tree_leaves(b.params)):
        assert max_rel(y.detach().numpy(), x.detach().numpy()) < 1e-5


@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_nonfinite_gradient_skips_the_step(bad):
    """A non-finite gradient anywhere zeroes every clipped gradient, as the
    JAX package's ``clip_by_global_norm_f32`` does, and leaves finite
    parameters and moments behind."""
    grads = [torch.full((4,), bad), torch.ones(2)]
    out = popt.clip_by_global_norm_f32(grads, 1.0)
    assert all(torch.equal(g, torch.zeros_like(g)) for g in out)
    jout, _ = jopt.clip_by_global_norm_f32(1.0).update(
        {"w": jnp.full((4,), bad), "b": jnp.ones((2,))}, None)
    assert all((np.asarray(x) == 0).all() for x in jax.tree_util.tree_leaves(jout))
    ok = popt.clip_by_global_norm_f32([torch.ones(4) * 3, torch.ones(2)], 1.0)
    jok, _ = jopt.clip_by_global_norm_f32(1.0).update(
        {"w": jnp.ones((4,)) * 3, "b": jnp.ones((2,))}, None)
    np.testing.assert_allclose(ok[0].numpy(), np.asarray(jok["w"]), rtol=1e-6)

    params = {"w": torch.ones(3, 5)}
    opt = popt.make_optimizer(pcfg_mod.TrainConfig(lr_init=1e-2, lr_final=1e-2, warmup_steps=0),
                              params, total_steps=10, n_layer=0)
    state = opt.init(params)
    opt.step(params, [torch.full((3, 5), bad)], state, step=0)
    assert torch.equal(params["w"], torch.ones(3, 5))  # zero gradient, zero moments
    assert all(torch.isfinite(m).all() for m in popt.tree_leaves(state.mu) + popt.tree_leaves(state.nu))


def test_sr_round_bf16_unbiased():
    """The statistic of the JAX package's test: the mean over 2^16 roundings
    of a value 1/8 of the way between two bf16 neighbours lands on the value;
    non-finite inputs pass through."""
    gen = torch.Generator().manual_seed(0)
    x = torch.full((1 << 16,), 1.0 + 2.0**-10)
    out = popt.sr_round_bf16(x, gen).float()
    vals = set(np.unique(out.numpy()).tolist())
    assert vals <= {1.0, 1.0 + 2.0**-7}, vals  # bf16 ulp at 1.0 is 2^-7
    # sd of the mean ~ 2^-7 * sqrt(7/64) / 256 ~ 1e-5: a ten-sigma budget
    assert abs(float(out.mean()) - (1.0 + 2.0**-10)) < 1e-4
    bad = popt.sr_round_bf16(torch.tensor([np.inf, -np.inf, np.nan]), gen).float().numpy()
    assert bad[0] == np.inf and bad[1] == -np.inf and np.isnan(bad[2])
    neg = popt.sr_round_bf16(torch.full((1 << 16,), -(1.0 + 2.0**-10)), gen).float()
    assert abs(float(neg.mean()) + (1.0 + 2.0**-10)) < 1e-4


def test_bf16_sr_accumulates_tiny_updates():
    """No masters, bf16 moments, and updates far below a bf16 ulp still
    advance in expectation (the JAX package's test, same numbers)."""
    params = {"w": torch.full((8, 128), 1.0, dtype=torch.bfloat16)}
    tcfg = pcfg_mod.TrainConfig(lr_init=1e-4, lr_final=1e-4, warmup_steps=0, grad_clip=0.0,
                                optim_precision="bf16_sr")
    opt = popt.make_optimizer(tcfg, params, total_steps=1000, n_layer=0)
    state = opt.init(params)
    assert popt.tree_leaves(state.master) == [None]
    assert popt.tree_leaves(state.mu)[0].dtype == torch.bfloat16
    for i in range(100):  # |update| ~ lr = 1e-4 << ulp at 1.0 = 2^-8
        opt.step(params, [torch.ones(8, 128, dtype=torch.bfloat16)], state, step=i)
    drift = 1.0 - float(params["w"].float().mean())
    assert 5e-3 < drift < 2e-2, drift  # E[drift] ~ 100 * 1e-4


def test_bf16_sr_training_tracks_fp32(model, tmp_path):
    """The master-less bf16 mode over 20 steps on a fixed batch: the loss
    falls and lands within 0.25 of the fp32 run, the band of the JAX
    package's test. PyTorch's and JAX's random streams differ, so the mode
    is held in distribution against the port's own fp32 run, not bit for bit
    against JAX."""
    fixed = _batch(5, bsz=4)
    final = {}
    for pd, mode in (("float32", "master_fp32"), ("bfloat16", "bf16_sr")):
        tr = _port_trainer(model, tmp_path, lr_init=1e-2, lr_final=1e-2, warmup_steps=0, weight_decay=0.0,
                           epoch_steps=20, micro_bsz=4, param_dtype=pd, optim_precision=mode)
        tr.run_epoch(lambda s: fixed, epoch=0)
        final[mode] = [h["loss"] for h in tr.history]
        if mode == "bf16_sr":
            assert all(m is None for m in popt.tree_leaves(tr.state.opt_state.master))
            assert popt.tree_leaves(tr.params)[0].dtype == torch.bfloat16
    sr = final["bf16_sr"]
    assert sr[-1] < sr[0], sr
    assert abs(sr[-1] - final["master_fp32"][-1]) < 0.25, final


@pytest.mark.parametrize("param_dtype,mode", [("float32", "master_fp32"), ("bfloat16", "master_fp32"),
                                              ("bfloat16", "bf16_sr")])
def test_checkpoint_resume_takes_the_same_next_step(model, tmp_path, param_dtype, mode):
    batches = [_batch(s) for s in range(3)]
    kw = dict(param_dtype=param_dtype, optim_precision=mode)
    a = _port_trainer(model, tmp_path, **kw)
    for s in range(2):
        a.train_step(batches[s])
    path = str(tmp_path / "ckpt.pth")
    a.save_checkpoint(path)
    loss_a = float(a.train_step(batches[2]))

    b = _port_trainer(model, tmp_path, **kw)
    b.load_checkpoint(path)
    assert b.state.step == 2 and b.state.opt_state.count == 2
    loss_b = float(b.train_step(batches[2]))
    assert loss_a == loss_b
    for x, y in zip(popt.tree_leaves(a.params), popt.tree_leaves(b.params)):
        assert torch.equal(x, y)


def test_unported_train_options_raise():
    # the host-offloaded optimizer is ported (tests/test_torch_offload.py);
    # with bf16_sr it raises, as the JAX trainer does
    pcfg_mod.TrainConfig(offload_optimizer=True)
    with pytest.raises(NotImplementedError):
        pcfg_mod.TrainConfig(offload_optimizer=True, optim_precision="bf16_sr")
    # accepted and ignored: they shape the TPU compilation, not the result
    pcfg_mod.TrainConfig(split_step=True, opt_partition_mb=128, stacked_layers=True)
    # accepted and ignored as the reference does on one device: stage 3 is
    # the replicated layout there (= stage 1), and the reference reads
    # enable_state_tuning nowhere
    pcfg_mod.TrainConfig(zero_stage=3, enable_state_tuning=True)
    pcfg_mod.TrainConfig(param_dtype="float16")
    with pytest.raises(ValueError):
        pcfg_mod.TrainConfig(param_dtype="float64")
    names = lambda c: {f.name for f in dataclasses.fields(c)}
    assert names(pcfg_mod.TrainConfig) == names(jcfg_mod.TrainConfig)
