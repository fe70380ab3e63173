"""Vision-tower parity: the port's DINOv2-reg4 / SigLIP ViTs, the SAM-B
encoder and the triple-tower backbone against the JAX package, at the tiny
geometry of ``__graft_entry__._tiny_vlm_cfg(triple=True)``, in fp32, on
weights carried across by ``params_from_jax``.

Tolerance: max |delta| <= 1e-4 * max |ref|. Both sides run the same fp32
arithmetic; the patch embedding is a convolution here and a matmul in JAX,
and the attention sums keys in another order, which moves the result by
~1e-6 relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_vlm_cfg
from torch_port_helpers import max_rel, np_tree, perturbed, port_cfg, port_tower_cfg, to_np
from visualrwkv_torch.convert.from_jax import tower_params_from_jax
from visualrwkv_torch.vision import backbone as pb
from visualrwkv_torch.vision import sam as psam
from visualrwkv_torch.vision import vit as pvit
from visualrwkv_tpu.vision import backbone as jb
from visualrwkv_tpu.vision import sam as jsam
from visualrwkv_tpu.vision import vit as jvit
from visualrwkv_tpu.vision.flash import vision_flash

TOL = 1e-4
_OVERRIDES = _tiny_vlm_cfg(triple=True).vision.tower_config_overrides


def _pixels(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tower_pair(jcfg, seed):
    """(JAX params, the port's params) of one tower, perturbed so that the
    zero-initialised leaves (biases, rel-pos tables, cls) carry signal."""
    init = jsam.init_sam_params if isinstance(jcfg, jsam.SAMConfig) else jvit.init_vit_params
    jp = perturbed(np_tree(init(jax.random.PRNGKey(seed), jcfg)), seed)
    pp = tower_params_from_jax(jp, port_tower_cfg(jcfg), device="cpu")
    return jax.tree_util.tree_map(jnp.asarray, jp), pp


@pytest.mark.parametrize("tower,img", [("dino", 64), ("siglip", 64), ("dino", 128)])
def test_vit_features_match_jax(tower, img):
    """img 128 gives 261 tokens (256 patches + cls + 4 registers): the port
    takes its MHA dispatch (kernel K3 on a card) and JAX its flash kernel
    (forced on, interpret mode), with a ragged tail past 256."""
    jcfg = dataclasses.replace(_OVERRIDES[tower], img_size=img, compute_dtype="float32")
    jp, pp = _tower_pair(jcfg, seed=img)
    x = _pixels((2, img, img, 3), seed=1)
    with vision_flash("on"):
        ref = np.asarray(jvit.vit_features(jp, jcfg, jnp.asarray(x)))
    out = to_np(pvit.vit_features(pp, port_tower_cfg(jcfg), torch.from_numpy(x)))
    assert out.shape == ref.shape
    assert max_rel(out, ref) < TOL


def test_sam_features_global_block_takes_flash_branch():
    """A 48x48 grid: the global block has N = 2304 > 2048 tokens, so the port
    takes its streaming branch (kernel K3 on a card, the plain
    sam_attend_reference here) and JAX its flash kernel (interpret mode)."""
    jcfg = dataclasses.replace(_OVERRIDES["sam"], img_size=384, compute_dtype="float32")
    assert jcfg.grid**2 > psam.MAX_DENSE_TOKENS and psam.global_blocks(port_tower_cfg(jcfg)) == 1
    jp, pp = _tower_pair(jcfg, seed=3)
    x = _pixels((1, 384, 384, 3), seed=2)
    with vision_flash("on"):
        ref = np.asarray(jsam.sam_features(jp, jcfg, jnp.asarray(x)))
    out = to_np(psam.sam_features(pp, port_tower_cfg(jcfg), torch.from_numpy(x)))
    assert out.shape == ref.shape == (1, 24 * 24, jcfg.output_dim)
    assert max_rel(out, ref) < TOL


def test_backbone_features_triple_tower():
    """uint8 images through the per-tower normalisation and all three towers."""
    jvis = _tiny_vlm_cfg(triple=True).vision
    pvis = port_cfg(_tiny_vlm_cfg(triple=True)).vision
    jp = perturbed(np_tree(jb.init_backbone_params(jax.random.PRNGKey(5), jvis, "float32")), 5)
    tcfgs = pb.tower_configs(pvis, "float32")
    pp = {t: tower_params_from_jax(jp[t], tcfgs[t], device="cpu") for t in tcfgs}
    rng = np.random.default_rng(4)
    images = {
        "dino": rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8),
        "siglip": rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8),
        "sam": rng.integers(0, 256, (2, 128, 128, 3)).astype(np.uint8),
    }
    ref = np.asarray(jb.backbone_features(
        jax.tree_util.tree_map(jnp.asarray, jp), jvis,
        {k: jnp.asarray(v) for k, v in images.items()}, "float32",
    ))
    out = to_np(pb.backbone_features(pp, pvis, {k: torch.from_numpy(v) for k, v in images.items()},
                                     "float32"))
    assert out.shape == ref.shape == (2, 64, 384)
    assert max_rel(out, ref) < TOL
