"""The published variants' modules against the JAX package: the v7.03
visual token compressor (its forward, its init from the LM), v5.1 patch
scanning (the seven orders, ``apply_scanning``) and v5.2's tiny attention,
UHD tile fusion (``fuse_image_features``, ``uhd_image_to_tiles``,
``extract_features_to_disk``), every function of ``data/tiling.py``, and the
configurations that select them (``n_vtc_layer``, ``image_scanning``,
``uhd_fusion``) built and held against the JAX package's forward and loss.

The assembly: an x070 LM of 2 layers, 128 wide, vocabulary 2048, fp32 on
both sides, behind two tiny towers (a DINOv2-style ViT with CLS and four
registers and a SigLIP-style ViT, 32 px, patch 8: 16 patches each, 64 wide)
and the gated-MLP projector; 16 image tokens a sample.

Tolerances: orders, tiles and images exact; features, logits, compressor
outputs and attention max |delta| <= 1e-4 * max |ref|; loss <= 1e-5
relative; gradients <= 1e-4 * max |ref| (the same arithmetic in another
order); files written in fp16 equal to the fp16 rounding of the same
features (1e-3 relative)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_helpers import assert_grads_match, grads_numpy, max_rel, np_tree, perturbed, port_cfg, to_np
from visualrwkv_torch.convert.from_jax import params_from_jax, tiny_attention_from_jax
from visualrwkv_torch.data import tiling as ptil
from visualrwkv_torch.models import visualrwkv as pm
from visualrwkv_torch.multimodal import scanning as pscan
from visualrwkv_torch.multimodal import uhd as puhd
from visualrwkv_torch.multimodal import vtc as pvtc
from visualrwkv_tpu import config as jcfg_mod
from visualrwkv_tpu.data import tiling as jtil
from visualrwkv_tpu.data.conversation import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from visualrwkv_tpu.models import visualrwkv as jm
from visualrwkv_tpu.models.visualrwkv import init_visualrwkv_params
from visualrwkv_tpu.multimodal import scanning as jscan
from visualrwkv_tpu.multimodal import uhd as juhd
from visualrwkv_tpu.multimodal import vtc as jvtc
from visualrwkv_tpu.vision.vit import ViTConfig

TOL = 1e-4
T = 40
STRATEGIES = ("unidirection", "bidirection", "multidirection", "rotation", "spiral", "snake", "zigzag")


def _jax_cfg(**kw):
    towers = {
        "dino": ViTConfig(img_size=32, patch_size=8, width=64, depth=2, heads=4, mlp_dim=128,
                          use_cls=True, num_reg=4, layerscale=True, compute_dtype="float32"),
        "siglip": ViTConfig(img_size=32, patch_size=8, width=64, depth=2, heads=4, mlp_dim=128,
                            act="gelu_tanh", use_cls=False, compute_dtype="float32"),
    }
    return jcfg_mod.VLMConfig(
        rwkv=jcfg_mod.RWKVConfig(n_layer=2, n_embd=128, vocab_size=2048, head_size=64,
                                 compute_dtype="float32", ctx_len=T),
        vision=jcfg_mod.VisionConfig(towers=("dino", "siglip"), image_size=32, dino_dim=64,
                                     siglip_dim=64, tower_config_overrides=towers),
        proj_type="mlp", num_token_per_image=16, **kw)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _model(seed, **kw):
    jcfg = _jax_cfg(**kw)
    tree = init_visualrwkv_params(jax.random.PRNGKey(seed), jcfg)
    if jcfg.n_vtc_layer:
        tree["vtc"] = jvtc.init_vtc_params(jax.random.PRNGKey(seed + 1), jcfg.rwkv, jcfg.n_vtc_layer)
    return jcfg, perturbed(np_tree(tree), seed=seed + 2)


def _images(n, views=1, seed=0):
    rng = np.random.default_rng(seed)
    return {t: rng.integers(0, 256, (n * views, 32, 32, 3)).astype(np.uint8) for t in ("dino", "siglip")}


# ---------------------------------------------------------------------------
# the configurations, whole
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("option", ["vtc", "snake", "uhd"])
def test_configuration_forward_and_loss_match_jax(option):
    """Each configuration builds in the port, and its logits, loss and every
    gradient of the LM, the projector (and the compressor) match the JAX
    package's on the same weights and batch. ``vtc``: two compressor blocks
    (both directions) after the projector, in place of the adaptive pooling;
    ``snake``: the 16 tokens in boustrophedon order; ``uhd``: five views an
    image a tower, fused: the projector's input doubles (256 = 2 x 128)."""
    kw = {"vtc": {"n_vtc_layer": 2}, "snake": {"image_scanning": "snake"},
          "uhd": {"uhd_fusion": True}}[option]
    jcfg, tree = _model(4, **kw)
    pcfg = port_cfg(jcfg)
    assert pcfg.projector_in_dim == jcfg.projector_in_dim == (256 if option == "uhd" else 128)
    params = params_from_jax(tree, pcfg, device="cpu")
    rng = np.random.default_rng(8)
    ids = rng.integers(10, 2000, (2, T)).astype(np.int64)
    ids[:, 3:19] = IMAGE_TOKEN_INDEX
    labels = np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids)
    images = _images(2, 5 if option == "uhd" else 1, seed=9)
    jimg = {k: jnp.asarray(v) for k, v in images.items()}
    ref = np.asarray(jax.jit(lambda p: jm.vlm_forward(p, jcfg, jnp.asarray(ids), jimg))(_jtree(tree)))
    out = to_np(pm.vlm_forward(params, pcfg, ids, images, device="cpu"))
    assert out.shape == ref.shape == (2, T, 2048)
    assert max_rel(out, ref) < TOL
    j_loss, j_grads = jax.jit(jax.value_and_grad(lambda p: jm.training_loss(
        p, jcfg, jnp.asarray(ids), jnp.asarray(labels), jimg, grad_cp=True, ce_chunk_t=8)))(_jtree(tree))
    loss, grads = grads_numpy(params, lambda p: pm.training_loss(
        p, pcfg, ids, labels, images, grad_cp=True, ce_chunk_t=8, device="cpu"), pcfg)
    assert abs(loss - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    assert_grads_match(grads, j_grads, ("rwkv", "proj") + (("vtc",) if option == "vtc" else ()), TOL)


# ---------------------------------------------------------------------------
# the token compressor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_layer", [1, 2, 3])
def test_vtc_forward_matches_jax(n_layer):
    """[2, 20, 128] tokens (12 zero vectors of left pad to 32), 1-3 blocks
    (the second runs reversed); the last token reaches earlier outputs only
    through a reversed block."""
    jcfg, _ = _model(0)
    tree = perturbed(np_tree(jvtc.init_vtc_params(jax.random.PRNGKey(n_layer), jcfg.rwkv, n_layer)),
                     seed=n_layer)
    pcfg = port_cfg(jcfg)
    vtc = params_from_jax({"rwkv": _model(0)[1]["rwkv"], "vtc": tree}, pcfg, device="cpu")["vtc"]
    x = np.random.default_rng(n_layer).standard_normal((2, 20, 128)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: jvtc.vtc_forward(p, jcfg.rwkv, x))(_jtree(tree), jnp.asarray(x)))
    out = to_np(pvtc.vtc_forward(vtc, pcfg.rwkv, torch.from_numpy(x)))
    assert out.shape == ref.shape == x.shape
    assert max_rel(out, ref) < TOL
    x2 = x.copy()
    x2[:, -1] += np.random.default_rng(0).standard_normal(128).astype(np.float32)  # not a constant: ln0 removes one
    out2 = to_np(pvtc.vtc_forward(vtc, pcfg.rwkv, torch.from_numpy(x2)))
    moved = np.abs(out2[:, :-1] - out[:, :-1]).max()
    assert moved > 1e-3 if n_layer >= 2 else moved == 0.0, moved


def test_vtc_init_and_init_from_lm():
    """``init_vtc_from_lm`` copies the LM's first blocks and ``ln_out`` (new
    tensors, equal values, as JAX's); ``init_vtc_params`` has JAX's tree
    and shapes, block 0 with ``ln0``."""
    jcfg, tree = _model(0)
    pcfg = port_cfg(jcfg)
    params = params_from_jax(tree, pcfg, device="cpu")
    vtc = pvtc.init_vtc_from_lm(params["rwkv"], 2)
    jv = jvtc.init_vtc_from_lm(_jtree(tree)["rwkv"], 2)
    back = params_from_jax({"rwkv": tree["rwkv"], "vtc": np_tree(jv)}, pcfg, device="cpu")["vtc"]
    for (a, b, c) in zip(_flat(vtc), _flat(back), _flat({"blocks": params["rwkv"]["blocks"][:2],
                                                         "ln_out": params["rwkv"]["ln_out"]})):
        assert torch.equal(a, b) and torch.equal(a, c) and a.data_ptr() != c.data_ptr()
    fresh = pvtc.init_vtc_params(torch.Generator().manual_seed(0), pcfg.rwkv, 3, device="cpu")
    jfresh = params_from_jax({"rwkv": tree["rwkv"], "vtc": np_tree(jvtc.init_vtc_params(
        jax.random.PRNGKey(0), jcfg.rwkv, 3))}, pcfg, device="cpu")["vtc"]
    assert [sorted(b) for b in fresh["blocks"]] == [sorted(b) for b in jfresh["blocks"]]
    assert "ln0" in fresh["blocks"][0] and "ln0" not in fresh["blocks"][1]
    assert [a.shape for a in _flat(fresh)] == [a.shape for a in _flat(jfresh)]


def _flat(tree):
    from visualrwkv_torch.train.optim import tree_leaves

    return tree_leaves(tree)


# ---------------------------------------------------------------------------
# scanning and tiny attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_scan_orders_and_apply_scanning_match_jax(strategy):
    """Each order a permutation equal to JAX's at n = 1..6; the features
    reordered (and concatenated, for several orders) exactly as JAX's."""
    for n in range(1, 7):
        mine, ref = pscan.scan_orders(n, strategy), jscan.scan_orders(n, strategy)
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a, b)
            assert sorted(a.tolist()) == list(range(n * n))
    x = np.random.default_rng(1).standard_normal((2, 16, 8)).astype(np.float32)
    out = pscan.apply_scanning(torch.from_numpy(x), strategy).numpy()
    np.testing.assert_array_equal(out, np.asarray(jscan.apply_scanning(jnp.asarray(x), strategy)))
    assert out.shape[1] == 16 * {"bidirection": 2, "multidirection": 4}.get(strategy, 1)


def test_scanning_rejects_a_grid_that_is_not_square():
    with pytest.raises(ValueError):
        pscan.apply_scanning(torch.zeros(1, 15, 4), "snake")
    with pytest.raises(ValueError):
        pscan.scan_orders(4, "diagonal")


@pytest.mark.parametrize("causal,mem", [(True, 8), (False, 12)])
def test_tiny_attention_matches_jax(causal, mem):
    """v5.2's layer on JAX's parameters (a random output projection so that
    it is not the identity), causal over its own length or over a memory of
    another length; and the port's init starts as the identity."""
    jp = jscan.init_tiny_attention_params(jax.random.PRNGKey(0), 64, 16)
    jp["out"]["weight"] = jax.random.normal(jax.random.PRNGKey(1), (64, 64)) * 0.1
    rng = np.random.default_rng(mem)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    x_emb = rng.standard_normal((2, mem, 64)).astype(np.float32)
    ref = np.asarray(jscan.tiny_attention(jp, jnp.asarray(x), jnp.asarray(x_emb), causal=causal,
                                          dtype=jnp.float32))
    pp = tiny_attention_from_jax(np_tree(jp), device="cpu")
    out = to_np(pscan.tiny_attention(pp, torch.from_numpy(x), torch.from_numpy(x_emb), causal=causal,
                                     dtype=torch.float32))
    assert max_rel(out, ref) < TOL and np.abs(out - x).max() > 1e-4
    fresh = pscan.init_tiny_attention_params(torch.Generator().manual_seed(0), 64, 16, device="cpu")
    assert {k: tuple(v["weight"].shape) for k, v in fresh.items()} == \
        {k: tuple(v["weight"].shape) for k, v in pp.items()}
    same = pscan.tiny_attention(fresh, torch.from_numpy(x), torch.from_numpy(x_emb), causal=causal,
                                dtype=torch.float32)
    assert torch.equal(same, torch.from_numpy(x))


# ---------------------------------------------------------------------------
# UHD
# ---------------------------------------------------------------------------


def test_fuse_image_features_matches_jax():
    """Three towers of different widths, [2, 5, 16, D]: the global views'
    features, then each tower's four half-pooled tiles reassembled."""
    rng = np.random.default_rng(3)
    tiles = [rng.standard_normal((2, 5, 16, d)).astype(np.float32) for d in (8, 12, 4)]
    ref = np.asarray(juhd.fuse_image_features([jnp.asarray(t) for t in tiles]))
    out = puhd.fuse_image_features([torch.from_numpy(t) for t in tiles]).numpy()
    assert out.shape == ref.shape == (2, 16, 48)
    assert max_rel(out, ref) < 1e-6
    np.testing.assert_array_equal(out[:, :, :8], tiles[0][:, 0])
    # the top-left tile's 2x2 pool lands in the top-left quarter of the grid
    np.testing.assert_allclose(out[:, 0, 24:32], tiles[0][:, 1].reshape(2, 2, 2, 2, 2, 8)
                               .mean(axis=(2, 4))[:, 0, 0], rtol=1e-6)


def _picture(w, h, seed=0):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(np.uint8))


def test_uhd_image_to_tiles_matches_jax():
    img = _picture(60, 44)
    mine, ref = puhd.uhd_image_to_tiles(img), juhd.uhd_image_to_tiles(img)
    assert len(mine) == len(ref) == 5 and mine[1].size == (30, 22)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_extract_features_to_disk_matches_jax(tmp_path):
    """Three images (one in a subfolder) through the UHD encoder of the
    ``uhd`` configuration in batches of two: one fp16 ``.npz`` an image at
    its relative path, equal to JAX's files from JAX's encoder."""
    jcfg, tree = _model(6, uhd_fusion=True)
    pcfg = port_cfg(jcfg)
    params = params_from_jax(tree, pcfg, device="cpu")
    (tmp_path / "img" / "sub").mkdir(parents=True)
    names = ["a.jpg", "sub/b.png", "c.png"]
    for i, n in enumerate(names):
        _picture(48 + 8 * i, 40, seed=i).save(tmp_path / "img" / n)
    sizes = {"dino": 32, "siglip": 32}
    port_enc = lambda imgs: pm.encode_images(params, pcfg, {k: torch.from_numpy(v) for k, v in imgs.items()})
    jax_enc = jax.jit(lambda imgs: jm.encode_images(_jtree(tree), jcfg, imgs))
    mine = puhd.extract_features_to_disk(port_enc, names, str(tmp_path / "img"), str(tmp_path / "port"),
                                         sizes, batch_size=2)
    ref = juhd.extract_features_to_disk(jax_enc, names, str(tmp_path / "img"), str(tmp_path / "jax"),
                                        sizes, batch_size=2)
    assert [p.relative_to(tmp_path / "port") for p in mine] == [p.relative_to(tmp_path / "jax") for p in ref]
    for a, b in zip(mine, ref):
        fa, fb = np.load(a)["features"], np.load(b)["features"]
        assert fa.dtype == np.float16 and fa.shape == fb.shape == (16, 128)
        np.testing.assert_allclose(fa.astype(np.float32), fb.astype(np.float32), rtol=1e-3,
                                   atol=1e-3 * np.abs(fb).max())


# ---------------------------------------------------------------------------
# tiling
# ---------------------------------------------------------------------------


SIZES = [(100, 100), (1000, 400), (400, 1000), (1400, 500), (500, 1400), (2000, 2000), (700, 650),
         (900, 900)]


def test_tiling_functions_match_jax(tmp_path):
    """``select_best_resolution``, ``n_tiles_for_size``,
    ``single_to_multi_images``, ``split_into_tiles``, ``image_to_regions``,
    ``gpt4v_crop`` (low and high, wide and tall), ``sample_video_frames``
    and ``load_video_frame_paths``: the same values, the same pixels."""
    assert ptil.POSSIBLE_RESOLUTIONS == jtil.POSSIBLE_RESOLUTIONS
    for size in SIZES:
        assert ptil.select_best_resolution(size) == jtil.select_best_resolution(size)
        assert ptil.n_tiles_for_size(size) == jtil.n_tiles_for_size(size)
    same = lambda a, b: len(a) == len(b) and all(np.array_equal(np.asarray(x), np.asarray(y))
                                                 for x, y in zip(a, b))
    for i, (w, h) in enumerate([(90, 60), (60, 90), (50, 50), (140, 50)]):
        img = _picture(w, h, seed=i)
        assert same(ptil.split_into_tiles(img, 2, 3), jtil.split_into_tiles(img, 2, 3))
        assert same(ptil.single_to_multi_images(img), jtil.single_to_multi_images(img))
        assert same(ptil.image_to_regions(img, 448), jtil.image_to_regions(img, 448))
        for detail in ("low", "high"):
            assert same(ptil.gpt4v_crop(img, detail, crop_size=24), jtil.gpt4v_crop(img, detail, crop_size=24))
    big = _picture(1500, 500)
    assert len(ptil.single_to_multi_images(big)) == 1 + 3 == ptil.n_tiles_for_size(big.size)
    frames = [f"f{i:03d}.jpg" for i in range(20)]
    for k in (1, 4, 20, 25):
        assert ptil.sample_video_frames(frames, k) == jtil.sample_video_frames(frames, k)
    for name in ("b/2.jpg", "a/1.jpg", "c.jpg", "d.png"):
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / name).write_bytes(b"")
    assert ptil.load_video_frame_paths(tmp_path) == jtil.load_video_frame_paths(tmp_path)
    assert [p.name for p in ptil.load_video_frame_paths(tmp_path)] == ["1.jpg", "2.jpg", "c.jpg"]


@pytest.mark.parametrize("uhd", [False, True], ids=["concat", "uhd"])
def test_encode_images_from_tower_features(uhd):
    """``encode_images`` given the towers' features (``tower_features``)
    equals the same call that runs the towers, bit for bit."""
    from visualrwkv_torch.vision.backbone import backbone_tower_features

    jcfg, tree = _model(12, uhd_fusion=uhd, n_vtc_layer=2)
    pcfg = port_cfg(jcfg)
    params = params_from_jax(tree, pcfg, device="cpu")
    images = {k: torch.from_numpy(v) for k, v in _images(2, 5 if uhd else 1, seed=13).items()}
    tower = backbone_tower_features(params["vit"], pcfg.vision, images, pcfg.rwkv.compute_dtype)
    assert {k: tuple(v.shape) for k, v in tower.items()} == {"dino": (10 if uhd else 2, 16, 64),
                                                              "siglip": (10 if uhd else 2, 16, 64)}
    ref = pm.encode_images(params, pcfg, images)
    assert torch.equal(pm.encode_images({k: v for k, v in params.items() if k != "vit"}, pcfg, None,
                                        tower_features=tower), ref)
