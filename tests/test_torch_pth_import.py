"""The port's reference-checkpoint import (``convert/pth_import.py``)
against the JAX package's: the same state dicts give the same parameters,
leaf for leaf, in the port's layouts; the export inverts the import; version
detection agrees; and the training CLI's ``--model_path`` loads a ``.pth``."""

import json

import numpy as np
import pytest
import torch
from test_golden_generate import _build as golden_build
from torch_port_helpers import np_tree, port_cfg

from visualrwkv_tpu.convert import pth_import as jpth
from visualrwkv_torch.convert import pth_import as ppth
from visualrwkv_torch.convert.from_jax import params_from_jax


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def assert_same_tree(got, ref):
    g, r = dict(_leaves(got)), dict(_leaves(ref))
    assert set(g) == set(r), sorted(set(g) ^ set(r))
    for path, t in r.items():
        assert tuple(g[path].shape) == tuple(t.shape), path
        assert torch.equal(g[path], t), (path, float((g[path] - t).abs().max()))


@pytest.fixture(scope="module", params=["x070", "x060"])
def lm_sd(request):
    """A tiny seeded LM of each version written out in the reference layout
    by the JAX exporter, with its port configuration."""
    jcfg, jparams = golden_build(request.param)
    return jpth.export_rwkv_state_dict(jparams["rwkv"]), port_cfg(jcfg)


def test_import_matches_jax(lm_sd):
    """import_rwkv_state_dict equals params_from_jax of the JAX import, leaf
    for leaf (max abs 0): the port keeps the checkpoint's [out, in] linears
    where the JAX importer transposes them; a combined ``rwkv.`` prefix and
    tensor values import the same."""
    sd, pcfg = lm_sd
    ref = params_from_jax(np_tree({"rwkv": jpth.import_rwkv_state_dict(sd)}), pcfg, device="cpu")["rwkv"]
    assert_same_tree(ppth.import_rwkv_state_dict(sd), ref)
    combined = {f"rwkv.{k}": torch.tensor(v) for k, v in sd.items()}
    assert_same_tree(ppth.import_rwkv_state_dict(combined), ref)


def test_export_round_trip(lm_sd):
    """export_rwkv_state_dict inverts the import: the same keys, shapes
    ((1, 1, C) mixing vectors back) and values as the reference dict."""
    sd, _ = lm_sd
    out = ppth.export_rwkv_state_dict(ppth.import_rwkv_state_dict(sd), prefix="rwkv.")
    assert set(out) == {f"rwkv.{k}" for k in sd}
    for k, v in sd.items():
        np.testing.assert_array_equal(out[f"rwkv.{k}"].numpy(), v, err_msg=k)


def test_import_rejects_unknown_keys_and_gaps(lm_sd):
    sd, _ = lm_sd
    with pytest.raises(KeyError, match="unrecognized"):
        ppth.import_rwkv_state_dict({**sd, "extra.weight": np.zeros(3, np.float32)})
    gap = {k: v for k, v in sd.items() if not k.startswith("blocks.0.")}
    with pytest.raises(ValueError, match="missing layers"):
        ppth.import_rwkv_state_dict(gap)


def _key_sets():
    """The version signatures of tests/test_rwkv5_model.py (x040, x052, x060,
    x070, a combined checkpoint, an out-of-order x052)."""
    z = lambda *s: np.zeros(s, np.float32)
    return {
        "x052": {"emb.weight": z(512, 128), "blocks.0.att.time_decay": z(2, 64),
                 "blocks.0.att.time_faaaa": z(2, 64), "blocks.0.att.gate.weight": z(128, 128),
                 "blocks.0.att.ln_x.weight": z(128), "blocks.1.att.time_decay": z(2, 64)},
        "x060": {"rwkv.emb.weight": z(512, 128), "rwkv.blocks.0.att.time_maa_x": z(1, 1, 128),
                 "rwkv.blocks.0.att.time_faaaa": z(2, 64), "rwkv.blocks.0.att.ln_x.weight": z(128),
                 "rwkv.blocks.0.att.gate.weight": z(128, 128)},
        "x070": {"emb.weight": z(512, 128), "blocks.0.att.r_k": z(2, 64), "blocks.0.att.w0": z(1, 1, 128),
                 "blocks.0.att.ln_x.weight": z(128), "blocks.3.att.r_k": z(2, 64)},
        "x040": {"emb.weight": z(512, 128), "blocks.0.att.time_decay": z(128),
                 "blocks.0.att.time_first": z(128)},
        "combined": {"rwkv.emb.weight": z(512, 128), "rwkv.blocks.0.att.r_k": z(2, 64),
                     "rwkv.blocks.0.att.w0": z(1, 1, 128), "rwkv.blocks.1.att.r_k": z(2, 64),
                     "vit.dino_featurizer.blocks.11.attn.qkv.weight": z(96, 32),
                     "proj.o_proj.weight": z(128, 320)},
        "x052_reordered": {"blocks.0.att.time_decay": z(2, 64), "blocks.0.att.time_faaaa": z(2, 64),
                           "blocks.0.att.gate.weight": z(128, 128), "blocks.0.att.ln_x.weight": z(128),
                           "emb.weight": z(512, 128)},
    }


@pytest.mark.parametrize("name", list(_key_sets()))
def test_detect_rwkv_version_as_jax(name):
    sd = _key_sets()[name]
    got = ppth.detect_rwkv_version(sd)
    assert got == jpth.detect_rwkv_version(sd)
    assert got == ppth.detect_rwkv_version({k: torch.tensor(v) for k, v in sd.items()})
    assert got["version"] == {"combined": "x070"}.get(name, name.split("_")[0])


def test_detect_rejects_non_rwkv_dicts():
    with pytest.raises(ValueError, match="no RWKV LM keys"):
        ppth.detect_rwkv_version({"vit.x.weight": np.zeros(2)})
    with pytest.raises(NotImplementedError, match="legacy"):
        ppth.detect_rwkv_version({"emb.weight": np.zeros((4, 8)), "blocks.0.att.ln_x.weight": np.zeros(8)})


def test_load_pth(tmp_path, lm_sd):
    sd, _ = lm_sd
    path = tmp_path / "lm.pth"
    torch.save({k: torch.tensor(v).to(torch.bfloat16) for k, v in sd.items()}, path)
    got = ppth.load_pth(str(path))
    ref = jpth.load_pth(str(path))
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == torch.float32 and np.array_equal(got[k].numpy(), v), k


def test_cli_model_path(tmp_path, monkeypatch):
    """``--model_path`` on a reference .pth: the CLI's LM is the checkpoint's
    (each leaf equal, in the model's dtype), the run trains; a checkpoint of
    another geometry raises before training."""
    from visualrwkv_torch.config import RWKVConfig
    from visualrwkv_torch.models.lm import init_lm_params
    from visualrwkv_torch.train import cli as pcli
    from visualrwkv_torch.train import trainer as ptrainer

    gen = torch.Generator()
    gen.manual_seed(7)
    rcfg = RWKVConfig(n_layer=2, n_embd=128, vocab_size=1024, head_size=64)
    lm = init_lm_params(gen, rcfg, "cpu")
    path = tmp_path / "lm.pth"
    torch.save(ppth.export_rwkv_state_dict(lm), path)
    seen = []  # the LM the CLI hands to the trainer
    init = ptrainer.Trainer.__init__

    def spy(self, cfg, tcfg, params, *a, **k):
        seen.append([(p, t.clone()) for p, t in _leaves(params["rwkv"])])
        init(self, cfg, tcfg, params, *a, **k)

    monkeypatch.setattr(ptrainer.Trainer, "__init__", spy)
    data = tmp_path / "text.json"
    data.write_text(json.dumps([{"id": str(i), "conversations": [
        {"from": "human", "value": f"Count to {i + 2}."}, {"from": "gpt", "value": f"Up to {i + 2}."}]}
        for i in range(4)]))
    flags = ["--device", "cpu", "--proj_dir", str(tmp_path), "--data_file", str(data), "--n_layer", "2",
             "--n_embd", "128", "--vocab_size", "1024", "--ctx_len", "64", "--micro_bsz", "1",
             "--epoch_steps", "1", "--epoch_count", "1", "--vision_towers", ""]
    trainer = pcli.main(flags + ["--model_path", str(path)])
    assert [p for p, _ in seen[0]] == [p for p, _ in _leaves(lm)]
    assert all(torch.equal(t, dict(_leaves(lm))[p]) for p, t in seen[0])
    assert np.isfinite([h["loss"] for h in trainer.history]).all() and trainer.state.step == 1

    deeper = init_lm_params(gen, RWKVConfig(n_layer=3, n_embd=128, vocab_size=1024, head_size=64), "cpu")
    torch.save(ppth.export_rwkv_state_dict(deeper), path)
    with pytest.raises(ValueError, match="the checkpoint has 3 entries"):
        pcli.main(flags + ["--model_path", str(path)])
