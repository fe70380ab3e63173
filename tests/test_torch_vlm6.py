"""The VisualRWKV-6 slice as a whole: a CLIP tower (``CLIP_L_336``'s options
at a tiny size), grid pooling, a linear projector and the RWKV-6 LM, against
the JAX package on JAX weights carried across by ``params_from_jax``:
``vit_features``, ``grid_pooling``, ``vlm_forward`` logits, greedy
``generate`` ids, the training loss and its gradients, three trainer steps,
and the converter's round trip.

The assembly: x060 with 2 layers, 128 wide, vocabulary 2048; CLIP with
patch 14 at 56 px (a 4 x 4 grid), width 64, 4 heads, 3 blocks (2 run:
``feature_layer=-2``), pre-LN, quick GELU, no patch bias, LN eps 1e-5, the
CLS token kept; ``grid_size=-1`` (16 patches, then CLS: 17 image tokens).
fp32 on both sides: the JAX package's x060 bf16 forward does not run on
this CPU backend.

Tolerances: features and logits max |delta| <= 1e-4 * max |ref|, loss
<= 1e-5 relative, gradients <= 1e-4 * max |ref| (the same arithmetic in
another order: a convolution for the patch embedding, the chunked WKV)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_loss import _sorted
from torch_port_helpers import max_rel, np_tree, oracle_jit, perturbed, port_cfg, port_tower_cfg, to_np
from visualrwkv_torch import config as pcfg_mod
from visualrwkv_torch.convert.from_jax import params_from_jax, params_to_numpy, tower_params_from_jax
from visualrwkv_torch.infer.engine import InferenceEngine
from visualrwkv_torch.models import visualrwkv as pm
from visualrwkv_torch.multimodal.projector import grid_pooling
from visualrwkv_torch.train.optim import tree_leaves
from visualrwkv_torch.train.trainer import Trainer
from visualrwkv_torch.vision import backbone as pb
from visualrwkv_torch.vision import vit as pvit
from visualrwkv_tpu import config as jcfg_mod
from visualrwkv_tpu.data.conversation import IMAGE_TOKEN_INDEX
from visualrwkv_tpu.infer.engine import InferenceEngine as JEngine
from visualrwkv_tpu.models import visualrwkv as jm
from visualrwkv_tpu.models.visualrwkv import init_visualrwkv_params
from visualrwkv_tpu.multimodal.projector import grid_pooling as j_grid_pooling
from visualrwkv_tpu.parallel.mesh import make_mesh
from visualrwkv_tpu.train.trainer import Trainer as JTrainer
from visualrwkv_tpu.vision import vit as jvit
from visualrwkv_tpu.vision.flash import vision_flash

TOL = 1e-4
N_IMG = 17  # 16 patches + CLS
T = 48

CLIP = dataclasses.replace(jvit.CLIP_L_336, img_size=56, width=64, depth=3, heads=4, mlp_dim=128,
                           compute_dtype="float32")


def _jax_cfg(grid_size=-1):
    return jcfg_mod.VLMConfig(
        rwkv=jcfg_mod.RWKVConfig(n_layer=2, n_embd=128, vocab_size=2048, head_size=64,
                                 version="x060", compute_dtype="float32", ctx_len=T),
        vision=jcfg_mod.VisionConfig(towers=("clip",), clip_dim=64,
                                     tower_config_overrides={"clip": CLIP}),
        proj_type="linear", num_token_per_image=N_IMG, grid_size=grid_size,
    )


@pytest.fixture(scope="module")
def model():
    jcfg = _jax_cfg()
    tree = perturbed(np_tree(init_visualrwkv_params(jax.random.PRNGKey(1), jcfg)), seed=13)
    pcfg = port_cfg(jcfg)
    assert pcfg.rwkv.version == "x060" and pcfg.grid_size == -1 and pcfg.vision.towers == ("clip",)
    return jcfg, pcfg, tree, params_from_jax(tree, pcfg, device="cpu")


def _inputs(B=2, T=T, seed=0, img_at=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, 2000, (B, T)).astype(np.int64)
    ids[:, img_at:img_at + N_IMG] = IMAGE_TOKEN_INDEX
    images = {"clip": rng.integers(0, 256, (B, 56, 56, 3)).astype(np.uint8)}
    return ids, images


def _j(images):
    return {k: jnp.asarray(v) for k, v in images.items()}


def test_clip_l_336_geometry():
    """The port's CLIP_L_336 is the JAX package's, field for field, and the
    backbone's default "clip" tower."""
    assert port_tower_cfg(jvit.CLIP_L_336) == pvit.CLIP_L_336
    tc = pb.tower_configs(pcfg_mod.VisionConfig(towers=("clip",)))["clip"]
    assert tc == pvit.CLIP_L_336 and tc.num_patches + 1 == 577 and pvit.blocks_run(tc) == 23
    assert pcfg_mod.VisionConfig(towers=("clip",)).embed_dim == 1024


@pytest.mark.parametrize("img", [56, 224])
def test_vit_features_clip_match_jax(img):
    """[cls, patches] after pre-LN and quick-GELU blocks. At 224 px the 257
    tokens take the port's MHA dispatch (kernel K3 on a card) and JAX's flash
    kernel (forced on, interpret mode), with a ragged tail past 256."""
    jcfg = dataclasses.replace(CLIP, img_size=img)
    jp = perturbed(np_tree(jvit.init_vit_params(jax.random.PRNGKey(img), jcfg)), seed=img)
    assert "bias" not in jp["patch_embed"] and "pre_ln" in jp
    pp = tower_params_from_jax(jp, port_tower_cfg(jcfg), device="cpu")
    x = np.random.default_rng(img).standard_normal((2, img, img, 3)).astype(np.float32)
    with vision_flash("on"):
        ref = np.asarray(jvit.vit_features(jax.tree_util.tree_map(jnp.asarray, jp), jcfg, jnp.asarray(x)))
    out = to_np(pvit.vit_features(pp, port_tower_cfg(jcfg), torch.from_numpy(x)))
    assert out.shape == ref.shape == (2, (img // 14) ** 2 + 1, 64)
    assert max_rel(out, ref) < TOL


@pytest.mark.parametrize("grid_size", [-1, 0, 1, 2, 4])
def test_grid_pooling_matches_jax(grid_size):
    x = np.random.default_rng(grid_size + 5).standard_normal((3, 17, 8)).astype(np.float32)
    ref = np.asarray(j_grid_pooling(jnp.asarray(x), grid_size))
    out = to_np(grid_pooling(torch.from_numpy(x), grid_size))
    want = {-1: 17, 0: 1, 1: 2, 2: 5, 4: 17}[grid_size]
    assert out.shape == ref.shape == (3, want, 8)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    if grid_size == -1:  # the patches, then the CLS token
        np.testing.assert_array_equal(out[:, -1], x[:, 0])


def test_grid_pooling_rejects_a_grid_that_does_not_divide():
    with pytest.raises(ValueError):
        grid_pooling(torch.zeros(1, 17, 8), 3)


@pytest.mark.parametrize("grid_size", [-1, 2])
def test_vlm_forward_logits_match_jax(model, grid_size):
    """fp32 logits over a prompt with one image a row (left-padded to 48
    with EOS inside the LM); grid 2 puts 5 image tokens in the prompt."""
    jcfg, pcfg, tree, params = model
    jcfg, pcfg = dataclasses.replace(jcfg, grid_size=grid_size), pcfg.replace(grid_size=grid_size)
    ids, images = _inputs(T=40)
    if grid_size == 2:
        ids[:, 8:3 + N_IMG] = 77  # 5 image tokens remain
    ref = np.asarray(jm.vlm_forward(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                                    jnp.asarray(ids), _j(images)))
    out = to_np(pm.vlm_forward(params, pcfg, ids, images, device="cpu"))
    assert out.shape == ref.shape == (2, 40, 2048)
    assert max_rel(out, ref) < TOL


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_generate_greedy_ids_match_jax(model, state_dtype):
    """16 greedy tokens after a 37-token prompt with an image; stop tokens
    off so every step runs. The state is carried in fp32 or bf16."""
    jcfg, pcfg, tree, params = model
    ids, images = _inputs(B=1, T=37, seed=2)
    kw = dict(max_new_tokens=16, stop_tokens=(-1,))
    jres = JEngine(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, state_dtype=state_dtype).generate(
        jnp.asarray(ids), _j(images), **kw)
    pres = InferenceEngine(params, pcfg, state_dtype=state_dtype, device="cpu").generate(ids, images, **kw)
    np.testing.assert_array_equal(pres.tokens, jres.tokens)
    np.testing.assert_allclose(pres.logits, jres.logits, rtol=1e-3, atol=1e-3 * np.abs(jres.logits).max())


def test_prefill_then_decode_equals_full_forward(model):
    """The image prompt of 32 tokens prefilled, then 16 one-token steps,
    against one forward over all 48; fp32, max |delta| <= 1e-4 * max |ref|."""
    _, pcfg, _, params = model
    ids, images = _inputs(B=2, T=48, seed=3)
    full = to_np(pm.vlm_forward(params, pcfg, ids, images, device="cpu"))
    eng = InferenceEngine(params, pcfg, device="cpu")
    logits, st = eng.prefill_ids(ids[:, :32], images)
    assert max_rel(to_np(logits), full[:, 31]) < TOL
    from visualrwkv_torch.models import lm as plm

    for t in range(32, 48):
        logits, st = plm.lm_decode_step(params["rwkv"], pcfg.rwkv, torch.from_numpy(ids[:, t]), st)
        assert max_rel(to_np(logits), full[:, t]) < TOL, t


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked_ce", "dense_ce"])
def test_training_loss_and_gradients_match_jax(model, chunked):
    """Loss and the gradient of every LM and projector leaf, with
    checkpointing; the towers get none."""
    jcfg, pcfg, tree, _ = model
    ids, images = _inputs(seed=4)
    labels = np.where(ids == IMAGE_TOKEN_INDEX, -100, ids)
    labels[0, 30:34] = -100

    def f(p):
        return jm.training_loss(p, jcfg, jnp.asarray(ids), jnp.asarray(labels), _j(images),
                                grad_cp=True, chunked_ce=chunked, ce_chunk_t=16)

    j_loss, j_grads = oracle_jit(jax.value_and_grad(f))(jax.tree_util.tree_map(jnp.asarray, tree))
    j_grads = np_tree(j_grads)
    params = params_from_jax(tree, pcfg, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = pm.training_loss(params, pcfg, ids, labels, images, grad_cp=True, chunked_ce=chunked,
                            ce_chunk_t=16, device="cpu")
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert abs(float(loss.detach()) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    it = iter(grads)
    g_tree = jax.tree_util.tree_map(lambda _: next(it), _sorted(params))
    assert all(g is None for g in jax.tree_util.tree_leaves(g_tree["vit"], is_leaf=lambda x: x is None))
    back = params_to_numpy({"rwkv": g_tree["rwkv"], "proj": g_tree["proj"],
                            "vit": params["vit"]}, pcfg)
    for part in ("rwkv", "proj"):
        flat_p = jax.tree_util.tree_leaves_with_path(back[part])
        flat_j = jax.tree_util.tree_leaves(j_grads[part])
        assert len(flat_p) == len(flat_j)
        for (path, g), ref in zip(flat_p, flat_j):
            assert np.abs(ref).max() > 0, path
            assert max_rel(g, ref) < 1e-4, (part, jax.tree_util.keystr(path))


def test_three_trainer_steps_match_jax(model, tmp_path):
    """k = 3 trainer steps (warm-up, weight decay, clipping, checkpointing,
    the chunked loss) from the same parameters and batches; fp32: losses
    within 1e-4 relative, every leaf within 1e-4 * max |ref|."""
    jcfg, pcfg, tree, _ = model
    batches = []
    for s in range(3):
        ids, images = _inputs(seed=10 + s)
        labels = np.where(ids == IMAGE_TOKEN_INDEX, -100, ids)
        batches.append({"input_ids": ids, "labels": labels, "images": images})
    kw = dict(lr_init=1e-3, lr_final=1e-4, warmup_steps=2, weight_decay=0.01, epoch_steps=3,
              epoch_count=1, micro_bsz=2, grad_cp=True, grad_clip=1.0, ce_chunk_t=16, zero_stage=0)
    jt = JTrainer(jcfg, jcfg_mod.TrainConfig(**kw), jax.tree_util.tree_map(jnp.asarray, tree),
                  mesh=make_mesh(n_data=1), proj_dir=str(tmp_path), log_every=1)
    jt.run_epoch(lambda s: batches[s], epoch=0)
    pt = Trainer(pcfg, pcfg_mod.TrainConfig(**kw), params_from_jax(tree, pcfg, device="cpu"),
                 device="cpu", proj_dir=str(tmp_path / "port"), log_every=1)
    pt.run_epoch(lambda s: batches[s], epoch=0)
    np.testing.assert_allclose([h["loss"] for h in pt.history], [h["loss"] for h in jt.history],
                               rtol=1e-4)
    back = params_to_numpy(pt.params, pcfg)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree_util.tree_leaves(np_tree(jt.state.params))):
        assert max_rel(a, b) < 1e-4, jax.tree_util.keystr(path)


def test_converter_round_trip(model):
    """``params_to_numpy`` inverts ``params_from_jax`` bit for bit on the
    x060 + CLIP + linear tree; the CLIP patch embedding becomes a bias-free
    convolution weight."""
    _, pcfg, tree, params = model
    assert params["vit"]["clip"]["patch_embed"]["weight"].shape == (64, 3, 14, 14)
    assert "bias" not in params["vit"]["clip"]["patch_embed"]
    back = params_to_numpy(params, pcfg)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    flat_t = jax.tree_util.tree_leaves_with_path(tree)
    assert [jax.tree_util.keystr(p) for p, _ in flat_b] == [jax.tree_util.keystr(p) for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_b, flat_t):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
