"""The port's serving path against the JAX package: int8 weights
(``infer/quant.py``), strategy strings (``infer/strategy.py``), the engine's
``decode_text``, the continuous-batching server (``infer/server.py``), the
demo's UI and the serve / export apps, and the committed greedy-id goldens
``tests/golden/generate_ids.npz`` (tests/test_golden_generate.py), all on
the CPU with tiny seeded models."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_golden_generate import GOLDEN, N_NEW, PATHS, PROMPT
from test_golden_generate import _build as golden_build
from torch_port_helpers import np_tree, port_cfg

from visualrwkv_torch.convert.from_jax import params_from_jax
from visualrwkv_torch.infer import quant as pquant
from visualrwkv_torch.infer import strategy as pstrategy
from visualrwkv_torch.infer.engine import InferenceEngine
from visualrwkv_torch.infer.server import BatchedServer


@pytest.fixture(scope="module")
def models():
    """The goldens' two models (x070, x060): JAX tree, port config, port parameters."""
    out = {}
    for version in ("x070", "x060"):
        jcfg, jparams = golden_build(version)
        pcfg = port_cfg(jcfg)
        out[version] = (jcfg, jparams, pcfg, params_from_jax(np_tree(jparams), pcfg, device="cpu"))
    return out


def _port_generate(pcfg, pparams, path):
    """The port's counterpart of test_golden_generate._generate."""
    kw, params = {}, pparams
    if path == "int8":
        params = dict(pparams, rwkv=pquant.quantize_lm_params(pparams["rwkv"], min_size=64 * 64))
    elif path == "s16":
        kw["state_dtype"] = "bfloat16"
    elif path == "flat":
        kw["state_layout"] = "flat"
    engine = InferenceEngine(params, pcfg, device="cpu", **kw)
    if path == "server":
        server = BatchedServer(engine, max_batch=2, stop_tokens=(-1,))
        server.submit(PROMPT[0].tolist(), max_new_tokens=N_NEW)
        server.submit(PROMPT[0][::-1].tolist(), max_new_tokens=N_NEW)
        return np.asarray(server.run()[0], np.int32)
    res = engine.generate(PROMPT, max_new_tokens=N_NEW, stop_tokens=(-1,))
    return np.asarray(res.tokens[0][:N_NEW], np.int32)


@pytest.mark.parametrize("version", ("x070", "x060"))
@pytest.mark.parametrize("path", PATHS)
def test_greedy_ids_match_golden(models, version, path):
    """fp32, int8 weights, the bf16 state carry, the flat state (x060: the
    flat step, K10's plain version) and the server: the port's greedy ids
    equal the JAX package's committed goldens exactly."""
    _, _, pcfg, pparams = models[version]
    want = np.load(GOLDEN)[f"{version}_{path}"]
    np.testing.assert_array_equal(_port_generate(pcfg, pparams, path), want)


def test_quantize_weight_equals_jax():
    """The same int8 values and scales as JAX's quantize_weight (half-to-even
    rounding on both sides), on a weight with exact .5 quotients."""
    from visualrwkv_tpu.infer.quant import quantize_weight as jq

    rng = np.random.default_rng(3)
    w = rng.standard_normal((96, 80)).astype(np.float32)  # the port's [out, in]
    w[:, 0] = 127.0  # a scale of exactly 1 a row:
    w[:4, 1:5] = [[0.5, 1.5, 2.5, -2.5]] * 4  # ties round to even
    got = pquant.quantize_weight(torch.from_numpy(w))
    ref = jq(jnp.asarray(w.T))
    np.testing.assert_array_equal(got["weight_q"].numpy(), np.asarray(ref["weight_q"]).T)
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(ref["scale"]))
    assert got["weight_q"].dtype == torch.int8
    deq = pquant.dequantize_weight(got, torch.float32)
    assert float((deq - torch.from_numpy(w)).abs().max()) <= float(got["scale"].max()) / 2 + 1e-6


def test_quantize_lm_params_and_linear_any(models):
    """quantize_lm_params quantizes the same leaves as JAX's (int8 values
    equal, transposed), and linear_any / the LM's linear compute the same
    product as JAX's linear_any on them."""
    from visualrwkv_tpu.infer.quant import linear_any as jlinear, quantize_lm_params as jquant

    _, jparams, _, pparams = models["x070"]
    jtree = jquant(jparams["rwkv"], min_size=64 * 64)
    ptree = pquant.quantize_lm_params(pparams["rwkv"], min_size=64 * 64)
    jleaves = jax.tree_util.tree_flatten_with_path(jtree)[0]
    pnames = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            pnames[path] = node

    walk(ptree, ())
    n_q = 0
    for jpath, leaf in jleaves:
        key = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in jpath)
        got = pnames.pop(key)
        if key[-1] == "weight_q":
            n_q += 1
            np.testing.assert_array_equal(got.numpy(), np.asarray(leaf).T)
        elif key[-1] == "scale":
            np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    assert not pnames and n_q > 0
    x = np.random.default_rng(1).standard_normal((3, 64)).astype(np.float32)
    ref = jlinear(jtree["head"], jnp.asarray(x), jnp.float32)
    got = pquant.linear_any(ptree["head"], torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", ["tpu bf16", "gpu bf16i8", "cpu fp32", "tpu bf16 *int8",
                               "gpu bf16i8 s16", "tpu bf16i8 flat", "gpu fp16 s32"])
def test_parse_strategy_as_jax(s):
    from visualrwkv_tpu.infer.strategy import parse_strategy as jparse

    got, ref = pstrategy.parse_strategy(s), jparse(s)
    assert got.device == ref.device
    assert got.dtype_name == ref.dtype_name
    assert (got.int8_weights, got.state_dtype, got.state_layout) == (
        ref.int8_weights, ref.state_dtype, ref.state_layout)
    assert got.torch_device == ("cpu" if s.startswith("cpu") else "cuda")


def test_parse_strategy_rejects():
    with pytest.raises(ValueError, match="bad strategy"):
        pstrategy.parse_strategy("cuda fp16 *20+ -> cpu fp32")


def test_apply_strategy_as_jax(models):
    """"cpu bf16i8": the same leaves quantized (int8 values equal), every
    float leaf (the scales too) in bf16, equal to JAX's apply_strategy bit
    for bit; make_engine serves it with the strategy's state carry."""
    from visualrwkv_tpu.infer.strategy import apply_strategy as japply, parse_strategy as jparse

    _, jparams, pcfg, pparams = models["x060"]
    jtree = japply(jparams, jparse("cpu bf16i8"))
    ptree = pstrategy.apply_strategy(pparams, pstrategy.parse_strategy("cpu bf16i8"))
    head_j, head_p = jtree["rwkv"]["head"], ptree["rwkv"]["head"]
    np.testing.assert_array_equal(head_p["weight_q"].numpy(), np.asarray(head_j["weight_q"]).T)
    assert head_p["scale"].dtype == torch.bfloat16
    np.testing.assert_array_equal(head_p["scale"].float().numpy(),
                                  np.asarray(head_j["scale"].astype(jnp.float32)))
    ln_j = np.asarray(jtree["rwkv"]["blocks"][1]["att"]["time_faaaa"].astype(jnp.float32))
    assert ptree["rwkv"]["blocks"][1]["att"]["time_faaaa"].dtype == torch.bfloat16
    np.testing.assert_array_equal(ptree["rwkv"]["blocks"][1]["att"]["time_faaaa"].float().numpy(), ln_j)
    engine = pstrategy.make_engine(pparams, pcfg, "cpu fp32i8 s16 flat")
    assert engine.device.type == "cpu" and engine.state_dtype == torch.bfloat16
    assert engine.state_layout == "flat" and "weight_q" in engine.params["rwkv"]["head"]
    res = engine.generate(PROMPT, max_new_tokens=4, stop_tokens=(-1,))
    assert res.tokens.shape == (1, 4)


def test_int8_towers_raise_clearly():
    """A tree quantized whole (towers and projector too, as the JAX
    package's apply_strategy does) serves text; an image request raises a
    clear error in the port (the JAX towers fail on the missing weight)."""
    from visualrwkv_torch.config import RWKVConfig, VisionConfig, VLMConfig
    from visualrwkv_torch.models.visualrwkv import init_visualrwkv_params
    from visualrwkv_torch.vision.vit import ViTConfig

    dino = ViTConfig(img_size=32, patch_size=8, width=64, depth=1, heads=4, mlp_dim=128,
                     use_cls=True, num_reg=4, layerscale=True)
    cfg = VLMConfig(rwkv=RWKVConfig(n_layer=1, n_embd=64, vocab_size=512, head_size=32,
                                    compute_dtype="float32"),
                    vision=VisionConfig(towers=("dino",), image_size=32, dino_dim=64,
                                        tower_config_overrides={"dino": dino}),
                    proj_type="linear", num_token_per_image=4)
    params = init_visualrwkv_params(cfg, seed=0, device="cpu")
    tree = pstrategy.apply_strategy(params, pstrategy.Strategy(device="cpu", compute_dtype=torch.float32,
                                                               int8_weights=True))
    tree = dict(tree, vit={"dino": pquant.quantize_lm_params(tree["vit"]["dino"], min_size=1)})
    engine = InferenceEngine(tree, cfg, device="cpu")
    assert engine.generate([[5, 6, 7]], max_new_tokens=2).tokens.shape == (1, 2)
    images = {"dino": np.zeros((1, 32, 32, 3), np.uint8)}
    with pytest.raises(ValueError, match="int8 weights"):
        engine.generate([[65535] * 4 + [5]], images, max_new_tokens=2)


def test_decode_text_as_jax(models):
    from visualrwkv_tpu.infer.engine import InferenceEngine as JEngine

    from visualrwkv_torch.data.tokenizer import get_tokenizer

    jcfg, jparams, pcfg, pparams = models["x070"]
    tok = get_tokenizer()
    engine = InferenceEngine(pparams, pcfg, device="cpu")
    res = engine.generate(PROMPT, max_new_tokens=6)
    res = res._replace(tokens=np.array([[33, 44, 261, 0, 0, 0], [55, 66, 77, 88, 99, 0]]),
                       lengths=np.array([3, 5]))
    got = engine.decode_text(res, tok)
    from visualrwkv_tpu.data.tokenizer import get_tokenizer as jtok

    ref = JEngine.decode_text(None, res, jtok())
    assert got == ref and got[0] == tok.decode([33, 44])
    assert engine.decode_text(res, tok, strip_stop=False)[0] == tok.decode([33, 44, 261])


def test_server_retires_and_refills(models):
    """Five requests on two slots with budgets 1-6: every request answered,
    each with the greedy ids of generate() for it alone; a callable supplies
    images lazily."""
    _, _, pcfg, pparams = models["x060"]
    engine = InferenceEngine(pparams, pcfg, state_dtype="bfloat16", device="cpu")
    server = BatchedServer(engine, max_batch=2, stop_tokens=(-1,))
    prompts = [[11 + i, 22, 33 + 2 * i, 44] for i in range(5)]
    budgets = [3, 1, 6, 2, 4]
    calls = []
    rids = [server.submit(p, images=(lambda: calls.append(1)) if i == 0 else None, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, budgets))]
    out = server.run()
    assert sorted(out) == rids and calls == [1] and server.pending == 0
    for rid, p, n in zip(rids, prompts, budgets):
        alone = engine.generate(np.asarray([p]), max_new_tokens=n, stop_tokens=(-1,)).tokens[0]
        assert out[rid] == alone.tolist(), rid
    with pytest.raises(ValueError, match="ONE request"):
        server.submit(np.zeros((2, 3), np.int64))


def test_server_samples_from_its_generator(models):
    """Sampling (temperature 1) is reproducible from the server's generator."""
    from visualrwkv_torch.infer.sampling import SamplingParams

    _, _, pcfg, pparams = models["x070"]
    engine = InferenceEngine(pparams, pcfg, device="cpu")
    outs = []
    for _ in range(2):
        gen = torch.Generator()
        gen.manual_seed(5)
        server = BatchedServer(engine, max_batch=2, sp=SamplingParams(temperature=1.0, top_p=0.9),
                               stop_tokens=(-1,), generator=gen)
        server.submit(PROMPT[0], max_new_tokens=5)
        outs.append(server.run()[0])
    assert outs[0] == outs[1] and len(outs[0]) == 5


def test_demo_build_ui_and_text_tab(models):
    """build_ui with a fake gradio module (the UI is only built), and the
    raw-generation tab's respond function on the port's engine."""
    from visualrwkv_torch.apps import demo
    from visualrwkv_torch.data.tokenizer import get_tokenizer

    calls = []

    class FakeComponent:
        def __init__(self, kind):
            self.kind = kind

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def click(self, fn, inputs, outputs):
            calls.append(("click", fn, len(inputs)))

    class FakeGr:
        def __getattr__(self, name):
            def make(*a, **k):
                calls.append((name, a, k))
                return FakeComponent(name)

            return make

    respond, respond_text = (lambda *a: "img"), (lambda *a: "text")
    ui = demo.build_ui(FakeGr(), respond, respond_text)
    kinds = [c[0] for c in calls]
    assert ui.kind == "Blocks" and kinds.count("Tab") == 2 and kinds.count("click") == 2
    clicks = [c for c in calls if c[0] == "click"]
    assert clicks[0][1] is respond_text and clicks[1][1] is respond and clicks[0][2] == clicks[1][2] == 6
    assert demo.generate_prompt("Summarize.", "x") == "Instruction: Summarize.\nInput: x\nResponse:"
    from visualrwkv_tpu.apps.demo import GEN_PROMPT, generate_prompt

    assert demo.GEN_PROMPT == GEN_PROMPT and demo.generate_prompt("hello") == generate_prompt("hello")
    _, _, pcfg, pparams = models["x070"]
    out = demo.text_fn(InferenceEngine(pparams, pcfg, device="cpu"), get_tokenizer())(
        "User: hi\nAssistant:", max_new_tokens=3)
    assert isinstance(out, str)


def _tiny_lm_pth(tmp_path, seed=0):
    """A 1-layer x070 LM written as a reference .pth; returns (path, its params)."""
    from visualrwkv_torch.config import RWKVConfig
    from visualrwkv_torch.convert.pth_import import export_rwkv_state_dict
    from visualrwkv_torch.models.lm import init_lm_params

    gen = torch.Generator()
    gen.manual_seed(seed)
    cfg = RWKVConfig(n_layer=1, n_embd=64, head_size=64, vocab_size=65536)
    params = init_lm_params(gen, cfg, "cpu")
    path = tmp_path / "lm.pth"
    torch.save(export_rwkv_state_dict(params), path)
    return path, params


def test_serve_app_jsonl(tmp_path):
    """apps/serve.py: a .pth LM, two text requests from a jsonl file, one
    answer line each, greedy under a strategy string."""
    from visualrwkv_torch.apps import serve

    path, _ = _tiny_lm_pth(tmp_path)
    reqs = tmp_path / "in.jsonl"
    reqs.write_text(json.dumps({"id": "a", "text": "hi"}) + "\n\n"
                    + json.dumps({"id": 7, "text": "what?", "max_new_tokens": 2}) + "\n")
    out = tmp_path / "out.jsonl"
    serve.main(["--input", str(reqs), "--output", str(out), "--model_path", str(path),
                "--n_layer", "1", "--n_embd", "64", "--vision_towers", "", "--max_batch", "2",
                "--max_new_tokens", "3", "--strategy", "cpu fp32i8 s16"])
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [x["id"] for x in lines] == ["a", 7] and all(isinstance(x["text"], str) for x in lines)


def test_export_app_split(tmp_path):
    """apps/export.py: a reference combined .pth splits into its LM half
    (prefix removed) and visual half, in fp16; a Trainer checkpoint
    (``{"params", "step"}``) is exported to the reference layout first."""
    from visualrwkv_torch.apps import export
    from visualrwkv_torch.convert.pth_import import export_rwkv_state_dict

    assert export.split_state_dict({"rwkv.emb.weight": 1, "proj.weight": 2}) == (
        {"emb.weight": 1}, {"proj.weight": 2})
    _, lm = _tiny_lm_pth(tmp_path)
    proj = torch.randn(64, 32)
    ckpt = tmp_path / "rwkv-0.pth"
    torch.save({"params": {"rwkv": lm, "proj": {"weight": proj}}, "step": 3}, ckpt)
    export.main([str(ckpt), "--out_prefix", str(tmp_path / "m")])
    rwkv = torch.load(tmp_path / "m_rwkv.pth", weights_only=True)
    visual = torch.load(tmp_path / "m_visual.pth", weights_only=True)
    want = export_rwkv_state_dict(lm)
    assert set(rwkv) == set(want) and all(v.dtype == torch.float16 for v in rwkv.values())
    assert torch.equal(rwkv["blocks.0.att.x_r"], want["blocks.0.att.x_r"].half())
    assert set(visual) == {"proj.weight"} and torch.equal(visual["proj.weight"], proj.half())
