"""The port's tooling against the JAX package's: the throughput meter and the
training log (``utils/observability.py``) and the ``Trainer``'s run log, the
kernel bench on the CPU, the context-length analyzer, the hyperparameter
scan, the dataset tools, the native tokenizer behind ``use_native`` and the
image transforms. Each JAX oracle runs once a module (fixtures); the
tolerances are stated at each test."""

import json
import math
import re
import sys
import types
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as helpers
from visualrwkv_torch import config as pcfg_mod
from visualrwkv_torch.convert.from_jax import params_from_jax
from visualrwkv_torch.data import tokenizer as ptok
from visualrwkv_torch.data import tools as ptools
from visualrwkv_torch.data import transforms as ptr
from visualrwkv_torch.native import fast_tokenizer as pfast
from visualrwkv_torch.ops import kernel_bench
from visualrwkv_torch.train.trainer import Trainer
from visualrwkv_torch.utils import calc_ctxlen as pctx
from visualrwkv_torch.utils import observability as pobs
from visualrwkv_torch.utils import scan_hyperparameter as pscan
from visualrwkv_tpu import config as jcfg_mod
from visualrwkv_tpu.data import tokenizer as jtok
from visualrwkv_tpu.data import tools as jtools
from visualrwkv_tpu.data import transforms as jtr
from visualrwkv_tpu.models.visualrwkv import init_visualrwkv_params
from visualrwkv_tpu.parallel.mesh import make_mesh
from visualrwkv_tpu.train.trainer import Trainer as JTrainer
from visualrwkv_tpu.utils import calc_ctxlen as jctx
from visualrwkv_tpu.utils import observability as jobs
from visualrwkv_tpu.utils import scan_hyperparameter as jscan

STAMP = re.compile(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d")


def masked_lines(path):
    return [STAMP.sub("<time>", line) for line in open(path).read().splitlines()]


# --------------------------------------------------------------------------
# observability


def test_throughput_meter_matches_jax():
    """The same keys and the same totals; the rates are the host clock's."""
    jm, pm = jobs.ThroughputMeter(), pobs.ThroughputMeter()
    for bsz, tokens in ((2, 64), (3, 96), (1, 32)):
        j, p = jm.step(bsz, tokens), pm.step(bsz, tokens)
        assert list(p) == list(j) == ["it/s", "sample/s", "token/s", "Ksamples"]
        assert p["Ksamples"] == j["Ksamples"]
        assert all(math.isfinite(v) and v > 0 for v in p.values())
        assert p["token/s"] == pytest.approx(p["it/s"] * tokens) == pytest.approx(p["sample/s"] * tokens / bsz)
    assert (pm.total_samples, pm.total_tokens) == (jm.total_samples, jm.total_tokens) == (6, 192)


def test_train_log_writer_matches_jax(tmp_path):
    """Line for line the JAX writer's file, timestamps masked: the NEW RUN
    header, the run configuration as one JSON line (a non-JSON value by its
    str), the epoch lines (exp(loss) capped at exp(20)), and a second run
    appended to the same file."""
    config = {"train": {"lr_init": 1e-3, "grad_cp": "wkv", "split_step": None, "path": tmp_path}}
    for mod, where in ((jobs, tmp_path / "jax"), (pobs, tmp_path / "port")):
        w = mod.TrainLogWriter(str(where), run_config=config)
        w.log_step({"loss": 1.0})  # no wandb: nothing to do
        w.log_epoch(0, 1.5, 1e-4)
        w.log_epoch(1, 25.0, 3.125e-5)
        mod.TrainLogWriter(str(where)).log_epoch(2, 0.25, 0.0)
    port, ref = masked_lines(tmp_path / "port" / "train_log.txt"), masked_lines(tmp_path / "jax" / "train_log.txt")
    assert port[0] == "NEW RUN <time>" and port[2].startswith("0 1.500000 4.4817 0.00010000 ")
    assert port[:1] + port[2:] == ref[:1] + ref[2:]
    assert json.loads(port[1]) == json.loads(ref[1].replace("jax", "port"))


def test_wandb_missing_takes_the_warning_branch(tmp_path, monkeypatch, caplog):
    """``wandb_project`` set and wandb not importable: both writers warn the
    same words and log to the file only."""
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb -> ImportError
    warnings = []
    for mod in (jobs, pobs):
        caplog.clear()
        with caplog.at_level("WARNING", logger=mod.__name__):
            w = mod.TrainLogWriter(str(tmp_path / mod.__name__), run_config={"a": 1}, wandb_project="p")
        assert w.wandb is None
        w.log_step({"loss": 1.0})
        warnings.append([r.getMessage() for r in caplog.records if r.name == mod.__name__])
    assert warnings[0] == warnings[1] == ["wandb not installed; metrics go to train_log.txt only"]


def test_device_memory_and_profile_trace_on_the_cpu(tmp_path):
    """``device_memory`` raises where CUDA is asked for and absent, and
    gives {} for the CPU; ``profile_trace`` writes a Chrome trace that
    names the ops run under it."""
    if torch.cuda.is_available():
        assert all(isinstance(v, int) for v in pobs.device_memory().values())
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pobs.device_memory()
    assert pobs.device_memory("cpu") == {}
    with pobs.profile_trace(str(tmp_path / "trace")):
        torch.ones(4, 4) @ torch.ones(4, 4)
    (trace,) = (tmp_path / "trace").glob("trace_*.json")
    names = {e.get("name") for e in json.load(open(trace))["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names, sorted(n for n in names if n)[:20]


# --------------------------------------------------------------------------
# the Trainer's run log against JAX's Trainer

T = 32


def _train_cfg(mod, **kw):
    return mod.TrainConfig(lr_init=1e-3, lr_final=1e-4, warmup_steps=1, epoch_steps=2, epoch_count=1,
                           micro_bsz=2, grad_cp=False, ce_chunk_t=16, zero_stage=0,
                           wandb_project="tooling", **kw)


def _batches():
    out = []
    for s in range(2):
        ids = np.random.default_rng(s).integers(1, 256, (2, T)).astype(np.int64)
        out.append({"input_ids": ids, "labels": ids.copy()})
    return out


class FakeWandb(types.ModuleType):
    """A stand-in ``wandb`` that records ``init`` and ``log``."""

    def __init__(self):
        super().__init__("wandb")
        self.inits, self.logged = [], []

    def init(self, project, config):
        self.inits.append((project, config))

    def log(self, metrics):
        self.logged.append(dict(metrics))


def _run_trainer(make, proj_dir):
    fake = FakeWandb()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "wandb", fake)
        trainer = make(str(proj_dir))
        batches = _batches()
        trainer.run_epoch(lambda s: batches[s], epoch=0)
    return trainer, fake


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """Two logged steps of a 2-layer, 64-wide x070 without towers (fp32),
    from the same perturbed parameters and batches, through JAX's Trainer
    and the port's."""
    jcfg = jcfg_mod.VLMConfig(
        rwkv=jcfg_mod.RWKVConfig(n_layer=2, n_embd=64, vocab_size=256, head_size=32,
                                 compute_dtype="float32", ctx_len=T),
        vision=jcfg_mod.VisionConfig(towers=()))
    pcfg = helpers.port_cfg(jcfg)
    tree = helpers.perturbed(helpers.np_tree(init_visualrwkv_params(jax.random.PRNGKey(0), jcfg)), seed=3)
    root = tmp_path_factory.mktemp("train_log")
    jax_run = _run_trainer(lambda d: JTrainer(jcfg, _train_cfg(jcfg_mod), jax.tree_util.tree_map(jnp.asarray, tree),
                                              mesh=make_mesh(n_data=1), proj_dir=d, log_every=1), root / "jax")
    port_run = _run_trainer(lambda d: Trainer(pcfg, _train_cfg(pcfg_mod), params_from_jax(tree, pcfg, device="cpu"),
                                              device="cpu", proj_dir=d, log_every=1), root / "port")
    return jax_run, port_run, root


def test_trainer_writes_the_jax_train_log(tiny_runs):
    """``<proj_dir>/train_log.txt``: JAX's header and configuration line
    (every key and value both ``TrainConfig``s have equal), and one epoch
    line whose loss is within 1e-4 relative of JAX's, as
    tests/test_torch_train.py holds fp32 losses, and equal to the port's
    last logged loss; the learning rate within two float32 ulps (2.4e-7
    relative), as that file holds the schedules."""
    (jt, _), (pt, _), root = tiny_runs
    port, ref = masked_lines(root / "port" / "train_log.txt"), masked_lines(root / "jax" / "train_log.txt")
    assert len(port) == len(ref) == 3 and port[0] == ref[0] == "NEW RUN <time>"
    pconf, jconf = json.loads(port[1])["train"], json.loads(ref[1])["train"]
    common = set(pconf) & set(jconf)
    assert "wandb_project" in common and {k: pconf[k] for k in common} == {k: jconf[k] for k in common}
    (pe, pl, px, plr, pt_), (je, jl, jx, jlr, jt_) = port[2].split(), ref[2].split()
    assert pt_ == jt_ == "<time>"
    assert pe == je == "0"
    assert float(pl) == pytest.approx(float(jl), rel=1e-4) and float(px) == pytest.approx(float(jx), rel=1e-4)
    assert float(pl) == pytest.approx(pt.history[-1]["loss"], abs=5e-7)
    assert float(plr) == pytest.approx(float(jlr), rel=2.4e-7)
    assert [h["loss"] for h in pt.history] == pytest.approx([h["loss"] for h in jt.history], rel=1e-4)


def test_trainer_mirrors_the_meter_to_wandb(tiny_runs):
    """``wandb_project`` is read: wandb gets the run configuration, and each
    logged step's loss and the meter's rates reach ``log_step``, with JAX's
    keys and sample counts."""
    (_, jfake), (_, pfake), _ = tiny_runs
    assert [p for p, _ in pfake.inits] == [p for p, _ in jfake.inits] == ["tooling"]
    assert set(pfake.inits[0][1]["train"]) == set(jfake.inits[0][1]["train"])
    assert len(pfake.logged) == len(jfake.logged) == 2
    for p, j in zip(pfake.logged, jfake.logged):
        assert list(p) == list(j) == ["loss", "it/s", "sample/s", "token/s", "Ksamples"]
        assert p["Ksamples"] == j["Ksamples"] and p["loss"] == pytest.approx(j["loss"], rel=1e-4)
        assert p["token/s"] == pytest.approx(p["sample/s"] * T)


# --------------------------------------------------------------------------
# the kernel bench on the CPU


def test_kernel_bench_plain_rows_on_the_cpu(capsys):
    """B=1 T=32 H=2 N=64 fp32: every plain row's errors finite and under
    1e-5 against the sequential scan; chunk 64 does not divide T=32 and
    prints a FAILED row, as JAX's bench does, without failing the run."""
    rows = kernel_bench.main(["all", "--B", "1", "--T", "32", "--H", "2", "--N", "64",
                              "--dtype", "float32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "device=cpu: the plain PyTorch versions only" in out and "cuda" not in {r["impl"] for r in rows}
    by = {(r["family"], r["impl"]): r for r in rows}
    assert set(by) == {("wkv7", "chunked16"), ("wkv7", "chunked64"), ("wkv7", "dispatch grads"),
                       ("wkv6", "chunked16"), ("wkv6", "dispatch grads")}
    assert "must be a multiple of chunk=64" in by["wkv7", "chunked64"]["error"] and "FAILED" in out
    errs = [by[k][e] for k in (("wkv7", "chunked16"), ("wkv6", "chunked16")) for e in ("y_err", "s_err")]
    errs += [v for f in ("wkv7", "wkv6") for v in by[f, "dispatch grads"]["grad_err"].values()]
    assert len(errs) == 4 + 6 + 5 and all(math.isfinite(e) and e < 1e-5 for e in errs), rows


# --------------------------------------------------------------------------
# the context-length analyzer and the hyperparameter scan

RECORDS = [
    {"id": "a", "conversations": [{"from": "human", "value": "hi"}, {"from": "gpt", "value": "hello!"}]},
    {"id": "b", "image": "x.jpg", "conversations": [
        {"from": "human", "value": "<image>\nwhat is in the picture?"}, {"from": "gpt", "value": "a cat"},
        {"from": "human", "value": "and its colour?"}, {"from": "gpt", "value": "black " * 40}]},
    {"id": "c", "image": ["x.jpg", "y.jpg"], "conversations": [
        {"from": "human", "value": "<image>\n<image>\ncompare"}, {"from": "gpt", "value": "same"}]},
    {"id": "d", "image": "z.jpg", "conversations": [
        {"from": "human", "value": "<image>\n" + "long question " * 30}, {"from": "gpt", "value": "cut"}]},
]


def test_calc_ctxlen_matches_jax(tmp_path, capsys):
    """``analyze`` and the CLI's report equal to JAX's on the same file, in
    debug mode, with a record cut by ``ctx_len`` to no valid label."""
    f = tmp_path / "d.json"
    f.write_text(json.dumps(RECORDS))
    port, ref = pctx.analyze(str(f), 4, 64, debug=True), jctx.analyze(str(f), 4, 64, debug=True)
    assert port == ref and port["zero_valid_label_samples"] == 1 and port["zero_valid_ids"] == ["d"]
    argv = ["--data_file", str(f), "--num_token_per_image", "4", "--ctx_len", "96"]
    pctx.main(argv)
    port_out = capsys.readouterr().out
    jctx.main(argv)
    assert port_out == capsys.readouterr().out


def test_scan_hyperparameter_matches_jax(monkeypatch, capsys):
    """The same cross product of eval commands as JAX's, on the port's eval
    CLI."""
    argv = ["--tasks", "vqa=q.jsonl:imgs,gqa=g.jsonl:imgs2", "--param", "num_token_per_image",
            "--values", "64,256", "--model_path", "m.pth", "--extra", "--device cpu"]
    cmds = {}
    for mod in (jscan, pscan):
        runs = cmds.setdefault(mod, [])
        monkeypatch.setattr(mod.subprocess, "run", lambda cmd, check, runs=runs: runs.append(cmd))
        mod.main(argv)
    assert len(cmds[pscan]) == 4 and cmds[pscan][0][1:3] == ["-m", "visualrwkv_torch.evals.cli"]
    assert [[a.replace("visualrwkv_tpu", "visualrwkv_torch") for a in c] for c in cmds[jscan]] == cmds[pscan]
    assert cmds[pscan][-1][-2:] == ["--device", "cpu"]


# --------------------------------------------------------------------------
# the dataset tools

LONG = {"id": "r", "image": "coco/x.jpg", "conversations": [
    t for i in range(5) for t in (
        {"from": "human", "value": ("<image>\n" if i == 0 else "") + f"q{i}"
         + ("\nAnswer the question using a single word or phrase." if i == 0 else "")},
        {"from": "gpt", "value": f"a{i}" if i != 3 else ""})]}
TOOL_RECORDS = [
    LONG,
    {"id": "ok", "image": "gqa/sub/x.jpg", "conversations": [
        {"from": "user", "value": "<image>\nq"}, {"from": "bot", "value": "<image> a"},
        {"from": "human", "value": "dangling"}]},
    {"id": "pad", "image": ["coco/x.jpg", "coco/y.jpg"], "conversations": [
        {"from": "human", "value": "q"}, {"from": "gpt", "value": "a"}]},
    {"id": "bad", "image": "coco/x.jpg", "conversations": [
        {"from": "human", "value": "<image><image>q"}, {"from": "gpt", "value": "a"}]},
    {"id": "s1", "image": "coco/x.jpg", "conversations": [
        {"from": "human", "value": "<image>\nq1"}, {"from": "gpt", "value": "a1"}]},
    {"id": "s1", "image": "coco/x.jpg", "conversations": [
        {"from": "human", "value": "<image>\nq1"}, {"from": "gpt", "value": "a1"}]},
    {"id": "t", "conversations": [{"from": "human", "value": "q"}, {"from": "gpt", "value": "a"}]},
]
RECORD_TOOLS = {
    "cauldron_to_llava": lambda m: m.cauldron_to_llava(
        [{"id": "c1", "image": "i.jpg", "texts": [{"user": "what?", "assistant": "that"},
                                                   {"user": "<image> and?", "assistant": "this"}]},
         {"images": ["a.jpg"], "texts": []}], image_prefix="p/"),
    "split_multiround_to_single": lambda m: m.split_multiround_to_single(TOOL_RECORDS[:1]),
    "correct_conversation_format": lambda m: m.correct_conversation_format(TOOL_RECORDS),
    "image_set_distribution": lambda m: dict(m.image_set_distribution(TOOL_RECORDS)),
    "extract_by_image_set": lambda m: m.extract_by_image_set(TOOL_RECORDS, ["gqa"]),
    "to_image_dir_format": lambda m: m.to_image_dir_format(TOOL_RECORDS[1:2] + TOOL_RECORDS[4:]),
    "clean_missing_responses": lambda m: m.clean_missing_responses(TOOL_RECORDS),
    "split_long_conversations": lambda m: m.split_long_conversations(
        m.clean_missing_responses(TOOL_RECORDS), max_rounds=2),
    "merge_to_multi_round": lambda m: m.merge_to_multi_round(TOOL_RECORDS[4:] + TOOL_RECORDS[:1], max_rounds=3),
}


@pytest.mark.parametrize("name", sorted(RECORD_TOOLS))
def test_record_tools_match_jax(name):
    """Each function on records returns JAX's records."""
    port, ref = RECORD_TOOLS[name](ptools), RECORD_TOOLS[name](jtools)
    assert port == ref and port


@pytest.fixture()
def image_tree(tmp_path):
    """An image folder (one good and one unreadable jpg, one unused) and
    records in both layouts."""
    from PIL import Image

    root = tmp_path / "imgs"
    (root / "coco").mkdir(parents=True)
    Image.new("RGB", (8, 8), (10, 20, 30)).save(root / "coco" / "a.jpg")
    Image.new("RGB", (8, 8)).save(root / "coco" / "unused.jpg")
    (root / "coco" / "broken.jpg").write_bytes(b"not a jpeg")
    flat = [{"id": 1, "image": "coco/a.jpg"}, {"id": 2, "image": "coco/broken.jpg"},
            {"id": 3, "image": ["coco/a.jpg", "coco/gone.jpg"]}, {"id": 4}, {"id": 1, "image": "coco/a.jpg"}]
    dirs = [{"id": i, "image_dir": "coco", "conversations": [
        {"from": "human", "value": "<image>\nq", "image": [name]}, {"from": "gpt", "value": "a"}]}
        for i, name in enumerate(("a.jpg", "missing.jpg", "broken.jpg"))] + [{"id": 9}]
    (tmp_path / "flat.json").write_text(json.dumps(flat))
    (tmp_path / "dirs.json").write_text(json.dumps(dirs))
    (tmp_path / "vm.json").write_text(json.dumps([
        {"video_id": "v1", "questions": [{"question_id": "q1", "question": "What?",
                                          "options": ["A. x", "B. y"], "answer": "A"}]},
        {"videoID": "v2", "question": "Who?", "id": "q2"}]))
    return tmp_path


FILE_TOOLS = {
    "find_invalid_images": lambda m, d: m.find_invalid_images(str(d / "flat.json"), str(d / "imgs")),
    "fix_invalid_images": lambda m, d: (m.fix_invalid_images(str(d / "flat.json"), str(d / "imgs"),
                                                             str(d / f"{m.__name__}.json")),
                                        json.load(open(d / f"{m.__name__}.json"))),
    "merge_and_shuffle": lambda m, d: (m.merge_and_shuffle([str(d / "flat.json"), str(d / "dirs.json")],
                                                           str(d / f"{m.__name__}.json"), seed=7),
                                       json.load(open(d / f"{m.__name__}.json"))),
    "videomme_to_questions": lambda m, d: m.videomme_to_questions(str(d / "vm.json"), num_frames=3),
    "check_duplicates": lambda m, d: m.check_duplicates(str(d / "flat.json")),
    "check_image_folder": lambda m, d: m.check_image_folder(str(d / "dirs.json"), str(d / "imgs"), try_open=True),
    "dataset_stats": lambda m, d: m.dataset_stats([str(d / "flat.json"), str(d / "dirs.json")]),
}


@pytest.mark.parametrize("name", sorted(FILE_TOOLS))
def test_file_tools_match_jax(name, image_tree):
    """Each function on files returns (and writes) what JAX's does."""
    port, ref = FILE_TOOLS[name](ptools, image_tree), FILE_TOOLS[name](jtools, image_tree)
    assert port == ref and port


def test_zip_subdirs_matches_jax(image_tree):
    """The same store-only archives, member for member."""
    (image_tree / "imgs" / "gqa").mkdir()
    (image_tree / "imgs" / "gqa" / "b.txt").write_text("b")
    archives = {}
    for mod in (jtools, ptools):
        files = mod.zip_subdirs(str(image_tree / "imgs"), str(image_tree / mod.__name__), workers=2)
        archives[mod] = {f.split("/")[-1]: [(i.filename, i.compress_type, zipfile.ZipFile(f).read(i))
                                            for i in zipfile.ZipFile(f).infolist()] for f in files}
    assert archives[ptools] == archives[jtools] and set(archives[ptools]) == {"coco.zip", "gqa.zip"}


def test_hfds_to_llava_jsonl_matches_jax(tmp_path):
    """An on-disk HF dataset of two images: the same jsonl and the same
    jpg files (``datasets`` imported lazily)."""
    import datasets
    from PIL import Image

    ds = datasets.Dataset.from_dict({
        "image": [Image.new("RGB", (6, 4), (200, 10, 10)), Image.new("RGB", (4, 6), (10, 200, 10))],
        "q": ["colour?", "shape?"], "a": ["red ", "tall"]}, features=datasets.Features({
            "image": datasets.Image(), "q": datasets.Value("string"), "a": datasets.Value("string")}))
    ds.save_to_disk(str(tmp_path / "shapes"))
    out = {}
    for mod in (jtools, ptools):
        root = tmp_path / mod.__name__
        n = mod.hfds_to_llava_jsonl(str(tmp_path / "shapes"), str(root), lambda s: s["q"], lambda s: s["a"])
        out[mod] = (n, (root / "shapes.jsonl").read_text(),
                    {p.name: p.read_bytes() for p in sorted((root / "shapes").iterdir())})
    assert out[ptools] == out[jtools] and out[ptools][0] == 2


@pytest.mark.parametrize("cmd", ["correct-format", "reformat", "to-multi-round", "extract", "stats",
                                 "dup-report", "to-image-dir", "merge-shuffle"])
def test_tools_cli_matches_jax(cmd, tmp_path, capsys):
    """``_cli``: the same printed lines and the same written file for each
    subcommand, run on copies of one file."""
    results = []
    for mod in (jtools, ptools):
        d = tmp_path / mod.__name__
        d.mkdir()
        f = d / "d.json"
        f.write_text(json.dumps(TOOL_RECORDS))
        argv = {"correct-format": [str(f), str(d / "out.json")], "reformat": [str(f), "--max_rounds", "2"],
                "to-multi-round": [str(f), "--max_rounds", "3"], "extract": [str(f), "coco,gqa"],
                "stats": [str(f)], "dup-report": [str(f)], "to-image-dir": [str(d / "out.json"), str(f)],
                "merge-shuffle": [str(d / "out.json"), str(f), str(f), "--seed", "3"]}[cmd]
        mod._cli([cmd, *argv])
        printed = capsys.readouterr().out.replace(str(d), "<dir>")
        written = {p.name: json.load(open(p)) for p in sorted(d.iterdir()) if p.name != "d.json"}
        results.append((printed, written))
    assert results[0] == results[1] and results[0][0]


# --------------------------------------------------------------------------
# the native tokenizer

TEXTS = ["", "Hello, world!", "The quick brown fox\n\njumps over 13 lazy dogs.\t",
         "\u4e16\u754c\u4f60\u597d\uff0c\u3053\u3093\u306b\u3061\u306f \U0001f642\U0001f680",
         "User: <image>\nWhat is in the picture?\n\nAssistant: a cat" * 20]


@pytest.fixture(scope="module")
def tokenizers():
    return (ptok.WorldTokenizer(use_native="always"), ptok.WorldTokenizer(use_native="never"),
            jtok.WorldTokenizer(use_native="never"))


def test_native_encode_equals_python(tokenizers):
    """The C++ trie (built by g++ under build/) encodes and decodes as the
    pure-Python walk does, on texts and on random bytes."""
    native, plain, _ = tokenizers
    assert native._native is not None and plain._native is None
    assert pfast._CACHE.parts[-2:] == ("build", "native") and list(pfast._CACHE.glob("libworldtok_*.so"))
    rng = np.random.default_rng(0)
    blobs = [t.encode("utf-8") for t in TEXTS] + [rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
                                                  for _ in range(5)]
    for b in blobs:
        ids = native.encode_bytes(b)
        assert ids == plain.encode_bytes(b)
        assert native._native.decode_bytes(ids) == plain.decode_bytes(ids) == b


def test_pure_python_tokenizer_equals_jax(tokenizers):
    """``use_native="never"`` gives JAX's ids and text."""
    _, plain, ref = tokenizers
    for t in TEXTS:
        assert plain.encode(t) == ref.encode(t)
        assert plain.decode(plain.encode(t)) == ref.decode(ref.encode(t)) == t


def test_use_native_fallback_and_failure(tokenizers, monkeypatch):
    """When the build fails, "auto" falls back to the pure-Python walk and
    "always" raises, as JAX's switch does; the default is JAX's, "auto"."""
    import inspect

    monkeypatch.setattr(pfast, "_build_library", lambda: None)
    auto = ptok.WorldTokenizer(use_native="auto")
    assert auto._native is None and auto.encode(TEXTS[2]) == tokenizers[1].encode(TEXTS[2])
    with pytest.raises(RuntimeError, match="native tokenizer unavailable"):
        ptok.WorldTokenizer(use_native="always")
    default = lambda cls: inspect.signature(cls.__init__).parameters["use_native"].default
    assert default(ptok.WorldTokenizer) == default(jtok.WorldTokenizer) == "auto"


# --------------------------------------------------------------------------
# the image transforms


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
def test_resize_images_matches_jax(method):
    """``resize_images`` against ``jax.image.resize`` (antialiased), down
    and up, on uint8 and float input: within 2e-4 absolute on the 0-255
    scale (about twice the largest difference measured, 1.07e-4)."""
    rng = np.random.default_rng(1)
    for h, w, size in ((37, 53, 24), (20, 20, 48), (64, 40, 64), (33, 33, 16)):
        x = rng.integers(0, 256, (2, h, w, 3)).astype(np.uint8)
        for inp in (x, x.astype(np.float32)):
            port = ptr.resize_images(torch.from_numpy(inp), size, method)
            ref = np.asarray(jtr.resize_images(jnp.asarray(inp), size, method))
            assert port.dtype == torch.float32 and port.shape == ref.shape == (2, size, size, 3)
            np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=2e-4)


def test_letterbox_and_normalize_match_jax():
    """``letterbox_pad`` gives JAX's image pixel for pixel (wide, tall,
    square); ``normalize_tower_dict`` JAX's values per tower (fp32 within
    1e-6; bf16 equal)."""
    from PIL import Image

    rng = np.random.default_rng(2)
    for w, h in ((7, 4), (4, 9), (5, 5)):
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        assert np.array_equal(np.asarray(ptr.letterbox_pad(img)), np.asarray(jtr.letterbox_pad(img)))
        assert np.array_equal(np.asarray(ptr.letterbox_pad(img, (1, 2, 3))),
                              np.asarray(jtr.letterbox_pad(img, (1, 2, 3))))
    images = {t: rng.integers(0, 256, (2, 4, 4, 3)).astype(np.uint8) for t in ("dino", "siglip", "sam", "clip")}
    for pdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        port = ptr.normalize_tower_dict({t: torch.from_numpy(v) for t, v in images.items()}, pdt)
        ref = jtr.normalize_tower_dict({t: jnp.asarray(v) for t, v in images.items()}, jdt)
        assert list(port) == list(ref)
        for t in images:
            assert port[t].dtype == pdt
            a, b = port[t].float().numpy(), np.asarray(ref[t].astype(jnp.float32))
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 if pdt == torch.float32 else 0)
