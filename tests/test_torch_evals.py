"""The port's evaluation suite (``visualrwkv_torch.evals.{runner,cli,hfds,
rank,lm_harness,loaders}``) against the JAX package's, on the same seeded
weights carried across by ``params_from_jax``, on the CPU.

The model is the tiny one of tests/test_evals.py (2 RWKV-7 layers 64 wide,
one 1-deep 32-wide dino tower, a linear projector, 4 image tokens, fp32),
with a 14-pixel patch on a 28-pixel image (the grid 2 that
``image_size // 14`` gives the CLI's combined-checkpoint import) and every
weight perturbed, so that zero-initialised projections carry signal. The
JAX oracles are built once per module."""

import dataclasses
import functools
import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_port_helpers import np_tree, perturbed, port_cfg

from visualrwkv_torch.convert.from_jax import params_from_jax
from visualrwkv_torch.data.tokenizer import get_tokenizer as port_tokenizer
from visualrwkv_torch.evals import cli as pcli
from visualrwkv_torch.evals import hfds as phfds
from visualrwkv_torch.evals import lm_harness as plm
from visualrwkv_torch.evals import rank as prank
from visualrwkv_torch.evals import runner as prunner
from visualrwkv_torch.infer.engine import InferenceEngine as PortEngine
from visualrwkv_tpu.config import RWKVConfig, VisionConfig, VLMConfig
from visualrwkv_tpu.data.tokenizer import get_tokenizer as jax_tokenizer
from visualrwkv_tpu.evals import hfds as jhfds
from visualrwkv_tpu.evals import lm_harness as jlm
from visualrwkv_tpu.evals import rank as jrank
from visualrwkv_tpu.evals import runner as jrunner
from visualrwkv_tpu.infer.engine import InferenceEngine as JaxEngine
from visualrwkv_tpu.vision.vit import ViTConfig

NEW_TOKENS = 4


def tiny_cfg(**kw):
    tiny_vit = ViTConfig(img_size=28, patch_size=14, width=32, depth=1, heads=2,
                         mlp_dim=64, use_cls=False, num_reg=0, layerscale=False)
    return VLMConfig(
        rwkv=RWKVConfig(n_layer=2, n_embd=64, vocab_size=66000, head_size=32,
                        compute_dtype="float32", ctx_len=256),
        vision=VisionConfig(towers=("dino",), image_size=28, dino_dim=32,
                            tower_config_overrides={"dino": tiny_vit}),
        proj_type="linear", num_token_per_image=4, **kw,
    )


@pytest.fixture(scope="module")
def model():
    """(JAX config, JAX engine, port config, port engine, JAX tokenizer, port tokenizer)."""
    from visualrwkv_tpu.models.visualrwkv import init_visualrwkv_params

    jcfg = tiny_cfg()
    tree = perturbed(np_tree(init_visualrwkv_params(jax.random.PRNGKey(0), jcfg)), seed=20)
    jeng = JaxEngine(jax.tree_util.tree_map(jnp.asarray, tree), jcfg)
    pcfg = port_cfg(jcfg)
    peng = PortEngine(params_from_jax(tree, pcfg, device="cpu"), pcfg, device="cpu")
    return jcfg, jeng, pcfg, peng, jax_tokenizer(), port_tokenizer()


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    """Images of each strategy's shapes: two small ones, a square one (one
    tile), a wide one (three tiles) and a large one (five), and two frame
    folders."""
    root = tmp_path_factory.mktemp("eval_images")
    rng = np.random.default_rng(7)
    for name, (w, h) in {"a.jpg": (64, 48), "b.jpg": (48, 64), "square.png": (500, 500),
                         "wide.png": (1000, 400), "big.png": (1200, 1100)}.items():
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(root / name)
    for vid, n in (("vid3", 3), ("vid5", 5)):
        (root / vid).mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(root / vid / f"f{i}.jpg")
    return root


QUESTIONS = {
    "single": [{"question_id": 1, "image": "a.jpg", "text": "<image>\nWhat color?"},
               {"question_id": 2, "image": "b.jpg", "text": "<image>\nDescribe this image please.",
                "metadata": {"split": "val"}},
               {"question_id": 3, "image": "a.jpg", "text": "Is it red?"},
               {"question_id": 4, "image": "b.jpg", "text": "<image>\nCount the objects."},
               {"question_id": 5, "text": "a question without an image is skipped"}],
    "multi": [{"question_id": "m1", "image": "wide.png", "text": "<image>\nWhat is on the left?"},
              {"question_id": "m2", "image": "big.png", "text": "<image>\nRead the sign."},
              {"question_id": "m3", "image": "square.png", "text": "<image>\nWhat is it?"},
              {"question_id": "m4", "image": "wide.png", "text": "<image>\nAnd on the right?"}],
    "video": [{"question_id": "v1", "video": "vid3", "text": "<image>" * 8 + "\nWhat happens?"},
              {"question_id": "v2", "video": "vid5", "text": "<image>" * 4 + "\nWho moves?"},
              {"question_id": "v3", "video": "vid3", "text": "<image><image>\nWhat is shown?"}],
    "uhd": [{"question_id": "u1", "image": "big.png", "text": "<image>\nDescribe the scene."},
            {"question_id": "u2", "image": "a.jpg", "text": "<image>\nWhat color?"},
            {"question_id": "u3", "image": "wide.png", "text": "<image>\nWhat is written?"}],
}


def _read(path):
    return [json.loads(line) for line in open(path)]


def _assert_same_records(port, ref):
    """The reference's fields equal (the model's name aside), the two
    averages within the 0.001 of their rounding."""
    assert [r["question_id"] for r in port] == [r["question_id"] for r in ref]
    for p, r in zip(port, ref):
        assert set(p) == set(r) == {"question_id", "prompt", "text", "avg_logit", "avg_prob",
                                    "model_id", "metadata"}
        for k in ("question_id", "prompt", "text", "metadata"):
            assert p[k] == r[k], (k, p[k], r[k])
        for k in ("avg_logit", "avg_prob"):
            assert abs(float(p[k]) - float(r[k])) <= 1e-3 + 1e-9, (k, p[k], r[k])
            assert math.isfinite(float(p[k]))


@pytest.mark.parametrize("batch_size", (1, 3))
@pytest.mark.parametrize("strategy", ("single", "multi", "video", "uhd"))
def test_run_eval_matches_jax(model, image_folder, tmp_path, strategy, batch_size):
    """Each strategy at batch 1 and 3: the same answers in question order,
    the averages within 0.001, and batch 3 grouped by (bucketed length,
    images a question)."""
    jcfg, jeng, pcfg, peng, jtok, ptok = model
    questions = QUESTIONS[strategy]
    kw = dict(image_strategy=strategy, max_new_tokens=NEW_TOKENS, progress=False, batch_size=batch_size)
    ref = jrunner.run_eval(jeng, jtok, questions, str(image_folder), str(tmp_path / "j.jsonl"), **kw)
    got = prunner.run_eval(peng, ptok, questions, str(image_folder), str(tmp_path / "p.jsonl"), **kw)
    _assert_same_records(got, ref)
    assert _read(tmp_path / "p.jsonl") == got  # the file, rewritten in question order
    want_ids = [q["question_id"] for q in questions if "image" in q or "video" in q]
    assert [r["question_id"] for r in got] == want_ids
    assert all(r["model_id"] == "visualrwkv_torch" for r in got)


def test_eval_batch_ids_match_jax_generate(model, image_folder):
    """The per-batch step on three single-image questions of one bucket:
    the generated ids equal JAX's ``generate`` on the same batch, and each
    record's averages come from them."""
    jcfg, jeng, pcfg, peng, jtok, ptok = model
    sizes = prunner.tower_image_sizes(pcfg)
    lines = [q for q in QUESTIONS["single"] if q["question_id"] in (1, 3, 4)]
    items = [prunner.prepare_question(q, ptok, pcfg, 1) for q in lines]
    ids = np.stack([prunner.bucket_pad_ids(it["input_ids"], 32) for it in items])
    images = {t: np.concatenate([prunner.build_image_dict(q, image_folder, sizes)[t] for q in lines])
              for t in sizes}
    recs, res = prunner.eval_batch(peng, ptok, ids, images, lines, [it["input_text"] for it in items],
                                   max_new_tokens=NEW_TOKENS)
    ref = jeng.generate(ids, images=images, max_new_tokens=NEW_TOKENS, do_sample=False,
                        stop_tokens=(0, 261))
    np.testing.assert_array_equal(res.lengths, ref.lengths)
    for row in range(len(lines)):
        n = int(ref.lengths[row])
        np.testing.assert_array_equal(res.tokens[row, :n], ref.tokens[row, :n])
        np.testing.assert_allclose(res.logits[row, :n], ref.logits[row, :n], rtol=1e-4, atol=1e-4)
    assert [r["question_id"] for r in recs] == [1, 3, 4]


@pytest.mark.parametrize("strategy", ("single", "multi", "video", "uhd"))
def test_build_image_dict_bit_equal(model, image_folder, strategy):
    _, _, pcfg, _, _, _ = model
    sizes = {"dino": 28, "sam": 32}
    for line in QUESTIONS[strategy]:
        if "image" not in line and "video" not in line:
            continue
        got = prunner.build_image_dict(line, image_folder, sizes, strategy)
        ref = jrunner.build_image_dict(line, image_folder, sizes, strategy)
        assert set(got) == set(ref) == set(sizes)
        for t in sizes:
            assert got[t].dtype == np.uint8
            np.testing.assert_array_equal(got[t], ref[t])
        assert got["dino"].shape[0] == prunner.n_images_for_strategy(line, image_folder, strategy)


def test_bucket_pad_and_image_counts(image_folder):
    rng = np.random.default_rng(1)
    for T, bucket in ((1, 16), (16, 16), (17, 16), (70, 64), (64, 64), (130, 64)):
        ids = rng.integers(1, 60000, T).astype(np.int64)
        got = prunner.bucket_pad_ids(ids, bucket)
        np.testing.assert_array_equal(got, jrunner.bucket_pad_ids(ids, bucket))
        assert got.shape[-1] % bucket == 0 and (got[:got.shape[-1] - T] == 261).all()
    batch = rng.integers(1, 60000, (2, 20)).astype(np.int64)
    np.testing.assert_array_equal(prunner.bucket_pad_ids(batch, 16), jrunner.bucket_pad_ids(batch, 16))
    for strategy, lines in QUESTIONS.items():
        for line in lines:
            if "image" not in line and "video" not in line:
                continue
            n = prunner.n_images_for_strategy(line, image_folder, strategy)
            assert n == jrunner.n_images_for_strategy(line, image_folder, strategy)
    # the video clamp: 8 tags, 3 frames on disk -> 3; more frames than tags -> the tags
    assert prunner.n_images_for_strategy(QUESTIONS["video"][0], image_folder, "video") == 3
    assert prunner.n_images_for_strategy(QUESTIONS["video"][1], image_folder, "video") == 4
    assert [prunner.n_images_for_strategy(q, image_folder, "multi") for q in QUESTIONS["multi"]] == [3, 5, 1, 3]
    with pytest.raises(ValueError):
        prunner.n_images_for_strategy({"video": "vid3", "text": "no tags"}, image_folder, "video")


@pytest.mark.parametrize("position", ("first", "middle", "last"))
def test_image_position_ids(model, position):
    """``VLMConfig.image_position`` places the images as JAX's does: the
    same prompt text and ids."""
    jcfg, _, pcfg, _, jtok, ptok = model
    jc = dataclasses.replace(jcfg, image_position=position)
    pc = pcfg.replace(image_position=position)
    for line, n in ((QUESTIONS["single"][1], 1), (QUESTIONS["video"][1], 4),
                    ({"question_id": 9, "conversations": [{"value": "<image>\nWhich one?\nA. x\nB. y"}]}, 1)):
        got = prunner.prepare_question(line, ptok, pc, n, dataset_name="scienceqa")
        ref = jrunner.prepare_question(line, jtok, jc, n, dataset_name="scienceqa")
        assert got["input_text"] == ref["input_text"]
        np.testing.assert_array_equal(got["input_ids"], ref["input_ids"])
        np.testing.assert_array_equal(got["labels"], ref["labels"])
        assert (got["input_ids"] == 65535).sum() == 4 * n
    with pytest.raises(ValueError):
        pcfg.replace(image_position="top")


def test_rank_candidates_matches_jax(model, image_folder):
    """The same best candidate; every top-k candidate's first-token
    probability and CE within 1e-5 relative."""
    jcfg, jeng, pcfg, peng, jtok, ptok = model
    line = QUESTIONS["single"][0]
    item = prunner.prepare_question(line, ptok, pcfg, 1)
    ids = prunner.bucket_pad_ids(item["input_ids"], 16)[None, :]
    images = prunner.build_image_dict(line, image_folder, prunner.tower_image_sizes(pcfg))
    cands = ["cat", "dog", "a small bird", "fish", "Red and green"]
    best, ranked = prank.rank_candidates(peng, ptok, ids, images=images, candidates=cands, k=3)
    jbest, jranked = jrank.rank_candidates(jeng, jtok, ids, images=images, candidates=cands, k=3)
    assert best == jbest
    assert [r[0] for r in ranked] == [r[0] for r in jranked] and len(ranked) == 3
    for (_, p, ce), (_, jp, jce) in zip(ranked, jranked):
        assert abs(p - jp) <= 1e-5 * abs(jp) and abs(ce - jce) <= 1e-5 * abs(jce), (p, jp, ce, jce)
    assert prank.normalize_candidates([" yes ", "NO"]) == jrank.normalize_candidates([" yes ", "NO"])


def test_loglikelihood_and_perplexity_match_jax(model):
    jcfg, jeng, pcfg, peng, jtok, ptok = model
    jscore = jlm.RWKVLoglikelihood(jeng.params["rwkv"], jcfg.rwkv, jtok)
    pscore = plm.RWKVLoglikelihood(peng.params["rwkv"], pcfg.rwkv, ptok)
    for ctx, cont in (("The capital of France is", " Paris"), ("", " hello world"),
                      ("1 2 3 4", " 5 6 7 8 9")):
        ll, greedy = pscore.loglikelihood(ctx, cont)
        jll, jgreedy = jscore.loglikelihood(ctx, cont)
        assert abs(ll - jll) <= 1e-4 and greedy == jgreedy, (ctx, ll, jll, greedy, jgreedy)
    # the greedy flag's other side: the continuation the model itself predicts
    ctx = ptok.encode("Once upon a time")
    logits = plm._forward_logits(peng.params["rwkv"], pcfg.rwkv, ctx)
    cont = [int(logits[-1].argmax())]
    assert pscore.loglikelihood_tokens(ctx, cont)[1] and jscore.loglikelihood_tokens(ctx, cont)[1]
    # an empty continuation: JAX's loop does not run and gives (0.0, True)
    assert jscore.loglikelihood_tokens([1, 2, 3], []) == (0.0, True)
    for got in (pscore.loglikelihood_tokens([1, 2, 3], []), pscore.loglikelihood("1 2 3", "")):
        assert got == (0.0, True) and type(got[0]) is float, got
    text = "hello world, this is a test of a few windows of text. " * 3
    for stride in (8, 1024):  # ragged windows, and one window
        ppl = plm.perplexity(peng.params["rwkv"], pcfg.rwkv, ptok, text, stride=stride)
        jppl = jlm.perplexity(jeng.params["rwkv"], jcfg.rwkv, jtok, text, stride=stride)
        assert abs(ppl - jppl) <= 1e-4 * jppl and ppl > 1, (stride, ppl, jppl)
    with pytest.raises(ImportError):
        plm.make_lm_eval_adapter(peng.params["rwkv"], pcfg.rwkv, ptok)


def _save_combined(peng, path):
    from visualrwkv_torch.convert.pth_import import export_visualrwkv_checkpoint

    torch.save(export_visualrwkv_checkpoint(peng.params), path)


def _tiny_cli(monkeypatch, pcfg):
    """The CLI's configuration with the tiny tower and fp32 compute: the
    flags carry neither a tower's architecture nor the compute dtype."""
    monkeypatch.setattr(pcli, "VisionConfig", lambda towers: pcfg.vision)
    monkeypatch.setattr(pcli, "RWKVConfig", functools.partial(type(pcfg.rwkv), compute_dtype="float32"))


TINY_FLAGS = ["--device", "cpu", "--vision_towers", "dino", "--proj_type", "linear",
              "--num_token_per_image", "4", "--ctx_len", "256", "--max_new_tokens", str(NEW_TOKENS)]


def test_cli_main_matches_jax_run_eval(model, image_folder, tmp_path, monkeypatch):
    """``cli.main --device cpu`` on a combined .pth and a question file
    (its second chunk of two, two questions a batch) writes the jsonl that
    JAX's ``run_eval`` writes for that chunk on the same weights."""
    jcfg, jeng, pcfg, peng, jtok, _ = model
    _save_combined(peng, tmp_path / "m.pth")
    questions = QUESTIONS["single"][:4] + QUESTIONS["multi"][:2]
    qfile = tmp_path / "q.jsonl"
    qfile.write_text("".join(json.dumps(q) + "\n" for q in questions))
    _tiny_cli(monkeypatch, pcfg)
    got = pcli.main(["--model_path", str(tmp_path / "m.pth"), "--question_file", str(qfile),
                     "--image_folder", str(image_folder), "--output_file", str(tmp_path / "out/p.jsonl"),
                     "--num_chunks", "2", "--chunk_idx", "1", "--eval_batch", "2", *TINY_FLAGS])
    ref = jrunner.run_eval(jeng, jtok, questions[3:], str(image_folder), str(tmp_path / "j.jsonl"),
                           max_new_tokens=NEW_TOKENS, progress=False, batch_size=2)
    _assert_same_records(_read(tmp_path / "out/p.jsonl"), ref)
    assert got == _read(tmp_path / "out/p.jsonl")


def test_cli_build_engine_bare_lm_and_options(model, tmp_path, monkeypatch, caplog):
    """A bare-LM .pth: its geometry detected, a stray key dropped with a
    warning, the LM loaded bit for bit; ``--quant int8`` quantizes the LM
    only; ``--state_dtype`` / ``--state_layout`` reach the engine."""
    from visualrwkv_torch.convert.pth_import import export_rwkv_state_dict

    _, _, pcfg, peng, _, _ = model
    sd = export_rwkv_state_dict(peng.params["rwkv"])
    sd["model.extra_head.weight"] = torch.zeros(3)
    torch.save(sd, tmp_path / "lm.pth")
    _tiny_cli(monkeypatch, pcfg)
    argv = ["--model_path", str(tmp_path / "lm.pth"), "--question_file", "q", "--output_file", "o", *TINY_FLAGS]
    with caplog.at_level("WARNING"):
        eng, cfg = pcli.build_engine(pcli.build_argparser().parse_args(argv))
    assert "model.extra_head.weight" in caplog.text
    assert (cfg.rwkv.n_layer, cfg.rwkv.n_embd, cfg.rwkv.vocab_size, cfg.rwkv.head_size) == (2, 64, 66000, 32)
    assert eng.device.type == "cpu" and eng.state_layout == "head"
    torch.testing.assert_close(eng.params["rwkv"]["blocks"][1]["att"]["key"]["weight"],
                               peng.params["rwkv"]["blocks"][1]["att"]["key"]["weight"], rtol=0, atol=0)
    eng, _ = pcli.build_engine(pcli.build_argparser().parse_args(
        argv + ["--quant", "int8", "--state_dtype", "bfloat16", "--state_layout", "flat"]))
    assert eng.state_layout == "flat" and eng.state_dtype == torch.bfloat16
    assert eng.params["rwkv"]["emb"]["weight"].dtype == torch.float32
    # the head (66000 x 64) is the LM's one linear past the quantizer's size floor
    assert "weight_q" in eng.params["rwkv"]["head"] and "weight" in eng.params["proj"]


def test_rank_main(model, image_folder, tmp_path, monkeypatch):
    """``rank.main --device cpu`` writes each question's best candidate and
    its top-k, as ``rank_candidates`` ranks them with JAX's engine."""
    jcfg, jeng, pcfg, peng, jtok, _ = model
    _save_combined(peng, tmp_path / "m.pth")
    questions = QUESTIONS["single"][:2]
    (tmp_path / "q.jsonl").write_text("".join(json.dumps(q) + "\n" for q in questions))
    cands = ["yes", "no", "maybe"]
    (tmp_path / "c.json").write_text(json.dumps(cands))
    _tiny_cli(monkeypatch, pcfg)
    prank.main(["--model_path", str(tmp_path / "m.pth"), "--question_file", str(tmp_path / "q.jsonl"),
                "--image_folder", str(image_folder), "--output_file", str(tmp_path / "r.jsonl"),
                "--candidates_file", str(tmp_path / "c.json"), "--topk", "2", *TINY_FLAGS])
    out = _read(tmp_path / "r.jsonl")
    sizes = prunner.tower_image_sizes(pcfg)
    for rec, line in zip(out, questions):
        item = jrunner.prepare_question(line, jtok, jcfg, 1)
        ids = jrunner.bucket_pad_ids(item["input_ids"], 16)[None, :]
        best, ranked = jrank.rank_candidates(jeng, jtok, ids, jrunner.build_image_dict(line, image_folder, sizes),
                                             cands, k=2)
        assert rec["question_id"] == line["question_id"] and rec["prompt"] == item["input_text"]
        assert rec["text"] == best and [c["text"] for c in rec["candidates"]] == [r[0] for r in ranked]
        for c, (_, p, ce) in zip(rec["candidates"], ranked):
            assert abs(c["first_prob"] - p) <= 1e-5 * p and abs(c["ce"] - ce) <= 1e-5 * ce


def test_hfds_on_a_list_of_records_matches_jax(model, tmp_path):
    """``run_hfds_eval`` over a plain list of records whose images come as a
    PIL image, PNG bytes and a ``{"bytes": ...}`` dict writes JAX's jsonl."""
    jcfg, jeng, pcfg, peng, jtok, ptok = model
    rng = np.random.default_rng(5)
    imgs = [Image.fromarray(rng.integers(0, 256, (40, 30, 3), dtype=np.uint8)) for _ in range(3)]

    def png(img):
        buf = io.BytesIO()
        img.save(buf, format="PNG")
        return buf.getvalue()

    records = [{"question_id": "h0", "question": "What color?", "image": imgs[0]},
               {"question_id": "h1", "question": "Describe it.", "image": png(imgs[1])},
               {"question": "How many?", "image": {"bytes": png(imgs[2])}}]
    got = phfds.run_hfds_eval(peng, ptok, records, str(tmp_path / "p.jsonl"), max_new_tokens=NEW_TOKENS)
    ref = jhfds.run_hfds_eval(jeng, jtok, records, str(tmp_path / "j.jsonl"), max_new_tokens=NEW_TOKENS)
    assert [r["question_id"] for r in got] == ["h0", "h1", 2]
    for p, r in zip(_read(tmp_path / "p.jsonl"), _read(tmp_path / "j.jsonl")):
        assert set(p) == set(r) == {"question_id", "prompt", "text", "model_id"}
        assert {k: p[k] for k in ("question_id", "prompt", "text")} == {k: r[k] for k in ("question_id", "prompt",
                                                                                         "text")}
    sizes = {"dino": 28}
    for rec in records:
        np.testing.assert_array_equal(phfds.record_to_images(rec, sizes)["dino"],
                                      jhfds.record_to_images(rec, sizes)["dino"])


def test_eval_entry_points_default_to_cuda(tmp_path):
    """Without ``--device cpu`` every eval entry point asks for the card."""
    if torch.cuda.is_available():
        return  # a card is present: the default device works
    (tmp_path / "t.txt").write_text("text")
    for main, argv in ((pcli.main, ["--question_file", "q", "--output_file", "o"]),
                       (prank.main, ["--question_file", "q", "--output_file", "o", "--candidates_file",
                                     str(tmp_path / "c.json")]),
                       (plm.main, ["--text_file", str(tmp_path / "t.txt")]),
                       (phfds.main, ["--dataset_path", "d", "--output_file", "o"])):
        (tmp_path / "c.json").write_text("[]")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
