"""The port's own copies of the tokenizer, the conversation preprocessing
and the dataset give the arrays of the JAX package's on the records of the
``--dummy`` run, and the training CLI takes its dummy steps on the CPU."""

import argparse
import gzip
import json

import numpy as np
import pytest

import torch_port_helpers  # noqa: F401  (caps torch's CPU threads)
from visualrwkv_torch.data import conversation as pconv
from visualrwkv_torch.data import dataset as pds
from visualrwkv_torch.data import tokenizer as ptok
from visualrwkv_torch.train import cli as pcli
from visualrwkv_tpu.data import conversation as jconv
from visualrwkv_tpu.data import dataset as jds
from visualrwkv_tpu.data import tokenizer as jtok
from visualrwkv_tpu.train import cli as jcli


@pytest.fixture(scope="module")
def dummy(tmp_path_factory):
    """The dummy dataset as the JAX CLI writes it (json + 16 jpg images)."""
    args = argparse.Namespace()
    return jcli.make_dummy(args, tmp_path_factory.mktemp("dummy"))


def test_tokenizer_copies_agree():
    a, b = ptok.get_tokenizer(), jtok.WorldTokenizer(use_native="never")
    assert a.vocab_size == b.vocab_size == 65536 and a.n_tokens == b.n_tokens
    for text in ("User: <image>\nWhat number is this? 7\n\nAssistant: This is number 7.\n\n",
                 "héllo wörld 你好 \U0001f600", "", "\n\n", "a" * 300):
        ids = a.encode(text)
        assert ids == b.encode(text)
        assert a.decode(ids) == b.decode(ids) == text
    with gzip.open(ptok.DEFAULT_VOCAB, "rb") as f, open(jtok.DEFAULT_VOCAB, "rb") as g:
        assert f.read() == g.read()  # the port's compressed copy holds the same bytes


def test_conversation_constants_and_preprocess_agree(dummy):
    for name in ("IGNORE_INDEX", "IMAGE_TOKEN_INDEX", "STOP_TOKEN_INDEX", "DEFAULT_IMAGE_TOKEN",
                 "DEFAULT_STOP_TOKEN"):
        assert getattr(pconv, name) == getattr(jconv, name)
    records = json.loads(open(dummy.data_file).read())
    tok_p, tok_j = ptok.get_tokenizer(), jtok.get_tokenizer()
    for rec in records[:4]:
        for pos in ("first", "middle", "last"):
            cp = pconv.process_image_tokens_in_conversations(rec["conversations"], 1, pos)
            cj = jconv.process_image_tokens_in_conversations(rec["conversations"], 1, pos)
            assert cp == cj
            a = pconv.preprocess(cp, tok_p, has_image=True, ctx_len=128, num_token_per_image=16)
            b = jconv.preprocess(cj, tok_j, has_image=True, ctx_len=128, num_token_per_image=16)
            assert a.keys() == b.keys()
            for k in a:
                if isinstance(a[k], np.ndarray):
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
                else:
                    assert a[k] == b[k]


def test_dataset_batches_agree(dummy):
    kw = dict(data_file=dummy.data_file, image_folder=dummy.image_folder, ctx_len=128,
              num_token_per_image=16, epoch_steps=4, micro_bsz=2,
              tower_sizes={"dino": 64, "siglip": 64, "sam": 128})
    a = pds.VisualRWKVDataset(pds.DatasetConfig(**kw), ptok.get_tokenizer())
    b = jds.VisualRWKVDataset(jds.DatasetConfig(**kw), jtok.get_tokenizer())
    assert a.magic_prime == b.magic_prime and len(a) == len(b)
    for epoch in (0, 1):
        fa, fb = pds.batches_for_epoch(a, epoch), jds.batches_for_epoch(b, epoch)
        for step in range(4):
            x, y = fa(step), fb(step)
            assert x.keys() == y.keys()
            np.testing.assert_array_equal(x["input_ids"], y["input_ids"])
            np.testing.assert_array_equal(x["labels"], y["labels"])
            assert x["sample_id"] == y["sample_id"] and x["input_text"] == y["input_text"]
            for t in ("dino", "siglip", "sam"):
                assert x["images"][t].dtype == np.uint8
                np.testing.assert_array_equal(x["images"][t], y["images"][t])


def test_cli_dummy_run_on_cpu(tmp_path):
    """``--dummy`` takes its 4 steps with a finite loss that does not rise,
    and leaves a checkpoint."""
    trainer = pcli.main(["--dummy", "--device", "cpu", "--proj_dir", str(tmp_path)])
    losses = [h["loss"] for h in trainer.history]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert losses[-1] <= losses[0]
    assert trainer.state.step == 4
    assert (tmp_path / "rwkv-0.pth").exists()
    # the run log: the NEW RUN header, the configuration, one line for epoch 0
    log_lines = (tmp_path / "train_log.txt").read_text().splitlines()
    assert log_lines[0].startswith("NEW RUN ") and len(log_lines) == 3
    assert log_lines[2].split()[:2] == ["0", f"{losses[-1]:.6f}"]
    # the same flags build the same dummy configuration as the JAX CLI
    pa = pcli.apply_dummy_overrides(pcli.build_argparser().parse_args(["--dummy"]))
    ja = jcli.apply_dummy_overrides(jcli.build_argparser().parse_args(["--dummy"]))
    for name in ("n_layer", "n_embd", "ctx_len", "num_token_per_image", "epoch_steps",
                 "epoch_count", "micro_bsz", "vision_towers", "lr_init", "lr_final", "grad_clip"):
        assert getattr(pa, name) == getattr(ja, name), name


@pytest.mark.parametrize("flags", [["--n_seq", "2"], ["--num_nodes", "2"], ["--n_data", "2"],
                                   ["--n_data", "4", "--n_seq", "2"],
                                   ["--coordinator_address", "localhost:1234"]])
def test_cli_flags_of_unported_paths_raise(tmp_path, flags):
    with pytest.raises(NotImplementedError):
        pcli.main(["--dummy", "--device", "cpu", "--proj_dir", str(tmp_path)] + flags)


@pytest.mark.parametrize("flags", [["--wkv_impl", "packed"], ["--wkv_impl", "pallas"],
                                   ["--wkv_impl", "chunked"], ["--remat", "dots"],
                                   ["--remat", "wkv"]])
def test_cli_kernel_options_run_on_cpu(tmp_path, flags):
    """``--wkv_impl`` and ``--remat`` select the WKV implementation and the
    checkpoint policy, as in the JAX CLI: the dummy run takes its 4 steps
    with a finite loss under each (with a 1024-token head, to keep the five
    runs short; the tokenizer's ids beyond it are clamped in the loss)."""
    from visualrwkv_torch.ops import wkv7 as pw

    try:
        trainer = pcli.main(["--dummy", "--device", "cpu", "--proj_dir", str(tmp_path),
                             "--vocab_size", "1024"] + flags)
        mode = pw.get_wkv_impl()
    finally:
        pw.set_wkv_impl("auto")  # the mode is process-wide, as the JAX package's
    losses = [h["loss"] for h in trainer.history]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert trainer.state.step == 4
    if flags[0] == "--wkv_impl":
        assert mode == flags[1]
    else:
        assert mode == "auto" and trainer.cfg.grad_cp == flags[1]


@pytest.mark.parametrize("flags", [["--node_rank", "0"], ["--coordinator_address", ""],
                                   ["--param_dtype", "float16"], ["--zero_stage", "3"]])
def test_cli_reference_flags_parse_as_in_jax(flags):
    """Flags the JAX CLI parses and runs in one process: the port parses
    them to the same values and builds its configurations (one process,
    fp16 storage with fp32 masters, stage 3 as the one-device replicated
    layout)."""
    pa = pcli.build_argparser().parse_args(flags)
    ja = jcli.build_argparser().parse_args(flags)
    name = flags[0][2:]
    assert getattr(pa, name) == getattr(ja, name)
    pcli.check_ported(pa)
    _, tcfg = pcli.make_configs(pa)
    assert tcfg.param_dtype == pa.param_dtype and tcfg.zero_stage == pa.zero_stage
