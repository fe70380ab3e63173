"""The port's vision-tower importers (``convert/vision_import.py``) and the
combined-checkpoint import against the JAX package's: tiny seeded HF SigLIP,
CLIP, DINOv2-with-registers and SAM towers (built as tests/test_vision.py
builds them) and the timm / vendored-SAM layouts import to the same
parameters, leaf for leaf; the bicubic position resize is JAX's; and the
reference combined checkpoint that JAX's exporters write serves the golden
logits through the port."""

import os

import numpy as np
import pytest
import torch
from test_combined_import import make_vit_weights, to_timm
from test_torch_pth_import import assert_same_tree
from torch_port_helpers import np_tree, port_cfg, port_tower_cfg, rel_rms, to_np

from visualrwkv_tpu.convert import vision_import as jvi
from visualrwkv_torch.convert import vision_import as pvi
from visualrwkv_torch.convert.from_jax import tower_params_from_jax
from visualrwkv_torch.vision.sam import SAMConfig
from visualrwkv_torch.vision.vit import ViTConfig


# transformers would import TensorFlow too (~5 s here); the towers are torch modules
os.environ.setdefault("USE_TF", "0")


def _hf(kind):
    """(state dict, port tower config) of a tiny seeded HF tower, 2 layers."""
    torch.manual_seed({"siglip": 0, "dino": 1, "sam": 2, "clip": 3}[kind])
    vit = dict(img_size=32, patch_size=8, width=64, depth=2, heads=4, mlp_dim=128)
    if kind == "siglip":
        from transformers import SiglipVisionConfig, SiglipVisionModel

        hf = SiglipVisionModel(SiglipVisionConfig(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            image_size=32, patch_size=8, hidden_act="gelu_pytorch_tanh"))
        tcfg = ViTConfig(**vit, act="gelu_tanh", use_cls=False)
    elif kind == "clip":
        from transformers import CLIPVisionConfig, CLIPVisionModel

        hf = CLIPVisionModel(CLIPVisionConfig(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            image_size=32, patch_size=8, hidden_act="quick_gelu"))
        tcfg = ViTConfig(**vit, act="quick_gelu", pre_ln=True, patch_bias=False, keep_cls_feature=True)
    elif kind == "dino":
        from transformers import Dinov2WithRegistersConfig, Dinov2WithRegistersModel

        hf = Dinov2WithRegistersModel(Dinov2WithRegistersConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=4, mlp_ratio=2, image_size=32,
            patch_size=8, num_register_tokens=4, hidden_act="gelu"))
        tcfg = ViTConfig(**vit, num_reg=4, layerscale=True)
    else:
        from transformers import SamConfig, SamModel, SamVisionConfig

        hf = SamModel(SamConfig(vision_config=SamVisionConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=4, image_size=32, patch_size=8,
            window_size=2, global_attn_indexes=[1], output_channels=16, mlp_ratio=2,
            use_rel_pos=True, use_abs_pos=True)))
        tcfg = SAMConfig(img_size=32, patch_size=8, width=64, depth=2, heads=4, mlp_dim=128,
                         out_chans=16, window_size=2, global_attn_indexes=(1,))
        return {k: v for k, v in hf.state_dict().items() if k.startswith("vision_encoder.")}, tcfg
    return hf.state_dict(), tcfg


_IMPORTERS = {"siglip": "import_siglip_vision", "clip": "import_clip_vision",
              "dino": "import_dinov2_vision"}


@pytest.mark.parametrize("kind", ["siglip", "clip", "dino", "sam"])
def test_hf_towers_import_as_jax(kind):
    """Each HF tower, imported by both packages: the port's parameters equal
    the JAX parameters carried into the port's layout, leaf for leaf (max
    abs 0): Conv2d patch weights, OIHW necks, [out, in] linears, fused qkv."""
    sd, tcfg = _hf(kind)
    if kind == "sam":
        got, ref = pvi.import_sam_vision(sd), jvi.import_sam_vision(sd)
    else:
        got = getattr(pvi, _IMPORTERS[kind])(sd, tcfg.grid)
        ref = getattr(jvi, _IMPORTERS[kind])(sd, tcfg.grid)
    assert_same_tree(got, tower_params_from_jax(np_tree(ref), tcfg, device="cpu"))


def test_timm_layout_import_export():
    """The timm layout (the towers inside combined checkpoints): the JAX
    import equals the port's, and export_timm_vit gives the dict back."""
    sd = to_timm(make_vit_weights())
    tcfg = ViTConfig(img_size=16, patch_size=8, width=32, depth=2, heads=2, mlp_dim=64, num_reg=2,
                     layerscale=True)
    got = pvi.import_timm_vit(sd, dst_grid=2)
    assert_same_tree(got, tower_params_from_jax(np_tree(jvi.import_timm_vit(sd, dst_grid=2)), tcfg,
                                                device="cpu"))
    back = pvi.export_timm_vit(got)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    no_cls = dict(sd, pos_embed=sd["pos_embed"][:, 1:])  # timm no_embed_class: a zero cls row
    assert not pvi.import_timm_vit(no_cls, dst_grid=2)["pos_embed"][0].any()


def test_sam_vendored_layout_round_trip():
    """HF SAM imports as the vendored layout exported from it (Sequential
    neck, mlp.lin1 / lin2), with and without Meta's ``image_encoder.`` prefix."""
    sd, _ = _hf("sam")
    params = pvi.import_sam_vision(sd)
    vendored = pvi.export_sam_vision(params)
    assert_same_tree(pvi.import_sam_vision(vendored), params)
    assert_same_tree(pvi.import_sam_vision({f"image_encoder.{k}": v for k, v in vendored.items()}), params)
    assert "neck.3.bias" in vendored and "blocks.1.mlp.lin2.weight" in vendored


@pytest.mark.parametrize("src,dst", [(5, 7), (37, 32), (4, 2), (6, 6)])
def test_interpolate_pos_embed_as_jax(src, dst):
    """JAX's bicubic resize (Keys a = -0.5, antialiased when shrinking),
    growing and shrinking: max abs <= 1e-5."""
    pos = np.random.default_rng(src * 100 + dst).standard_normal((src * src, 48)).astype(np.float32)
    ref = jvi.interpolate_pos_embed(pos, src, dst)
    got = pvi.interpolate_pos_embed(pos, src, dst)
    assert tuple(got.shape) == (dst * dst, 48)
    assert float(np.abs(to_np(got) - ref).max()) <= 1e-5


def test_resize_differs_from_torch_bicubic():
    """The reason for resize_matrix: torch's bicubic (a = -0.75, no
    antialiasing) is another function when shrinking."""
    pos = np.random.default_rng(0).standard_normal((37 * 37, 8)).astype(np.float32)
    ours = pvi.interpolate_pos_embed(pos, 37, 32)
    t = torch.nn.functional.interpolate(torch.from_numpy(pos).reshape(1, 37, 37, 8).permute(0, 3, 1, 2),
                                        size=(32, 32), mode="bicubic", align_corners=False)
    assert float((ours - t.permute(0, 2, 3, 1).reshape(-1, 8)).abs().max()) > 1e-2


def test_combined_checkpoint_matches_golden_logits():
    """JAX's exporters write the golden model (tests/test_golden_logits.py) in
    the reference combined layout; the port's import_visualrwkv_checkpoint and
    vlm_forward meet tests/golden/vlm_logits.npz at relative RMS <= 1e-4; and
    the port's export_visualrwkv_checkpoint writes the same dict back."""
    from test_golden_logits import GOLDEN, _build

    from visualrwkv_tpu.convert.pth_import import export_rwkv_state_dict
    from visualrwkv_torch.convert.pth_import import export_visualrwkv_checkpoint, import_visualrwkv_checkpoint
    from visualrwkv_torch.models.visualrwkv import vlm_forward

    jcfg, params, ids, images = _build()
    sd = export_rwkv_state_dict(params["rwkv"], prefix="rwkv.")
    sd["proj.gate.weight"] = np.asarray(params["proj"]["gate"]["weight"]).T
    sd["proj.o_proj.weight"] = np.asarray(params["proj"]["o_proj"]["weight"]).T
    sd["proj.ln_v.weight"] = np.asarray(params["proj"]["ln_v"]["weight"])
    sd["proj.ln_v.bias"] = np.asarray(params["proj"]["ln_v"]["bias"])
    for k, v in jvi.export_timm_vit(params["vit"]["dino"]).items():
        sd["vit.dino_featurizer." + k] = v

    loaded = import_visualrwkv_checkpoint(sd, dst_grid=4)
    out = to_np(vlm_forward(loaded, port_cfg(jcfg), ids, images, device="cpu"))
    ref = np.load(GOLDEN)["logits"]
    assert out.shape == ref.shape
    assert rel_rms(out, ref) <= 1e-4
    back = export_visualrwkv_checkpoint(loaded)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    assert port_tower_cfg(jcfg.vision.tower_config_overrides["dino"]).grid == 4
