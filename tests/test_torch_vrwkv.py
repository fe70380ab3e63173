"""v7.10 (``visualrwkv_torch/models/vrwkv.py``) and its ImageNet eval
(``visualrwkv_torch/evals/imagenet.py``) against the JAX package: the VRWKV
encoder's init, forward and ``imagenet_loss`` with its gradients, the
mixture-FFN blocks and LM forward with their gradients, ``pretrain_mode_mask``,
and ``topk_accuracy`` / ``iter_imagefolder`` / ``evaluate_imagenet`` /
``main`` over a two-class folder of PNGs the test writes.

The models: 2 LM layers, and VRWKV's first 2 blocks (its init makes 6 whatever
the LM depth; the init test holds all 6), 64 wide (two heads of 32),
vocabulary 512, patch 14, fp32 on both sides, the JAX parameters perturbed
so that the zero-initialised projections carry signal.

Tolerances: features, logits max |delta| <= 1e-4 * max |ref|; loss <= 1e-5
relative; gradients <= 1e-4 * max |ref| (the same arithmetic in another
order: the chunked WKV); images, labels, masks and accuracies exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_grads_match, grads_numpy, max_rel, np_tree, oracle_jit, perturbed, to_np
from visualrwkv_torch import config as pcfg
from visualrwkv_torch.convert.from_jax import params_from_jax, params_to_numpy
from visualrwkv_torch.evals import imagenet as pe
from visualrwkv_torch.models import rwkv7 as p7
from visualrwkv_torch.models import vrwkv as pv
from visualrwkv_tpu import config as jcfg
from visualrwkv_tpu.data.transforms import normalize_uint8
from visualrwkv_tpu.evals import imagenet as je
from visualrwkv_tpu.models import rwkv7 as j7
from visualrwkv_tpu.models import vrwkv as jv

TOL = 1e-4
KW = dict(n_layer=2, n_embd=64, vocab_size=512, head_size=32, compute_dtype="float32", ctx_len=64)
JC, PC = jcfg.RWKVConfig(**KW), pcfg.RWKVConfig(**KW)
VC = pcfg.VLMConfig(rwkv=PC, vision=pcfg.VisionConfig(towers=()))
jt = lambda t: jax.tree_util.tree_map(jnp.asarray, t)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small models: their eager loops
    launch many tiny operations, which a pool of threads a process slows
    when test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    """The VRWKV and mixture-FFN LM in JAX's layout (the port's seeded inits
    carried across by ``params_to_numpy``, then perturbed: numpy) and the
    port's copies of them. The VRWKV the forwards run is cut to its first 2
    blocks (both sides walk the list of blocks; the init test holds the
    whole tree), which keeps JAX's compiles of it short."""
    gen = torch.Generator().manual_seed(0)
    fresh = params_to_numpy({"vrwkv": pv.init_vrwkv_params(gen, PC, device="cpu"),
                             "rwkv": pv.add_mixture_ffn(gen, p7.init_rwkv7_params(gen, PC, "cpu"), PC)}, VC)
    vrwkv = perturbed(dict(fresh["vrwkv"], blocks=fresh["vrwkv"]["blocks"][:2]), seed=1)
    lm = perturbed(fresh["rwkv"], seed=4)
    port = params_from_jax({"rwkv": lm, "vrwkv": vrwkv}, VC, device="cpu")
    return {"vrwkv": vrwkv, "rwkv": lm}, port


def _pixels(B, px, seed):
    return np.random.default_rng(seed).normal(0, 1, (B, px, px, 3)).astype(np.float32)


# VRWKV's input: 2 images at 42 px (9 patches: a left pad of 7), and labels
PX = 42
PIX, LABELS = _pixels(2, PX, PX), np.array([3, 997])
# the mixture-FFN LM's: T = 21 (a left pad of 11 STOP-token text positions),
# the image positions, a random projection of the logits, one block's input
_rng = np.random.default_rng(9)
MIX_X = _rng.normal(0, 0.5, (2, 21, 64)).astype(np.float32)
MIX_MASK = np.zeros((2, 21), bool)
MIX_MASK[0, 2:9] = MIX_MASK[1, 10:] = True
MIX_R = _rng.normal(0, 1, (2, 21, 512)).astype(np.float32)
MIX_XB, MIX_MB = MIX_X[:, :16], MIX_MASK[:, :16, None]  # one block, on a whole chunk


@pytest.fixture(scope="module")
def oracles(trees):
    """JAX's results on ``trees``, one jitted program: VRWKV's loss,
    features, logits and gradients; the mixture-FFN LM's loss on ``MIX_R``,
    logits, one ``block_x070_mixffn``'s output and gradients."""
    jtree = trees[0]

    def vrwkv_loss(p):
        feats, logits = jv.vrwkv_forward(p, JC, jnp.asarray(PIX))
        return jv.imagenet_loss(logits, jnp.asarray(LABELS)), (feats, logits)

    def mix_loss(p):
        logits = jv.rwkv7_mixffn_forward(p, JC, jnp.asarray(MIX_X), jnp.asarray(MIX_MASK))
        block = jv.block_x070_mixffn(p["blocks"][0], JC, 0, jnp.asarray(MIX_XB), jnp.asarray(MIX_MB), None)[0]
        return (logits * MIX_R).sum(), (logits, block)

    oracle = lambda vp, lp: {"vrwkv": jax.value_and_grad(vrwkv_loss, has_aux=True)(vp),
                             "mixffn": jax.value_and_grad(mix_loss, has_aux=True)(lp)}
    return oracle_jit(oracle)(jt(jtree["vrwkv"]), jt(jtree["rwkv"]))


def test_vrwkv_forward_and_loss_match_jax(trees, oracles):
    """Features and logits at 42 px (9 patches: a left pad of 7),
    ``imagenet_loss`` and every VRWKV gradient against ``jax.grad``, the
    port's under activation checkpointing; its gradients without it equal
    those with it."""
    _, port = trees
    px, pix, labels = PX, PIX, LABELS
    (jl, (jf, jlog)), jg = oracles["vrwkv"]
    feats, logits = pv.vrwkv_forward(port["vrwkv"], PC, torch.from_numpy(pix))
    assert feats.shape == ((2, (px // 14) ** 2, 64)) and logits.shape == (2, pv.IMAGENET_CLASSES)
    assert max_rel(to_np(feats), jf) <= TOL and max_rel(to_np(logits), jlog) <= TOL
    runs = {}
    for grad_cp in (True, False):
        loss_fn = lambda p: pv.imagenet_loss(pv.vrwkv_forward(p["vrwkv"], PC, torch.from_numpy(pix),
                                                              grad_cp=grad_cp)[1], torch.from_numpy(labels))
        runs[grad_cp] = grads_numpy({"vrwkv": port["vrwkv"]}, loss_fn, VC)
    loss, g = runs[True]
    assert abs(loss - float(jl)) <= 1e-5 * abs(float(jl))
    assert_grads_match(g, {"vrwkv": jg}, ["vrwkv"], TOL)
    for a, b in zip(jax.tree_util.tree_leaves(runs[False][1]), jax.tree_util.tree_leaves(g)):
        np.testing.assert_array_equal(a, b)


def _formula_leaves(blocks):
    """Blocks 1 and 5's formula-set leaves: att x_r, x_k, w0 and ffn x_k."""
    return [[b["att"]["x_r"], b["att"]["x_k"], b["att"]["w0"], b["ffn"]["x_k"]] for b in (blocks[1], blocks[5])]


def test_init_vrwkv_params_as_jax():
    """The tree (leaf names and shapes through the carrier) and its
    formula-set leaves, whose layer ratios take the depth as at least
    ``VRWKV_DEPTH`` (6) under a 2-layer LM configuration. JAX's init is
    traced for its shapes and compiled for the formula-set leaves alone
    (its random leaves fall away in the compile)."""
    init = lambda: jv.init_vrwkv_params(jax.random.PRNGKey(0), JC)
    jshapes = jax.eval_shape(init)
    jvals = np_tree(oracle_jit(lambda: _formula_leaves(init()["blocks"]))())
    gen = torch.Generator().manual_seed(0)
    back = params_to_numpy({"vrwkv": pv.init_vrwkv_params(gen, PC, device="cpu")}, VC)["vrwkv"]
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jshapes))
    flat_p = dict(jax.tree_util.tree_leaves_with_path(back))
    assert flat_j.keys() == flat_p.keys() and len(back["blocks"]) == pv.VRWKV_DEPTH
    for path, ref in flat_j.items():
        assert np.shape(flat_p[path]) == ref.shape, path
    for got, want in zip(_formula_leaves(back["blocks"]), jvals):
        for name, a, b in zip(("att x_r", "att x_k", "att w0", "ffn x_k"), got, want):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 if name.startswith("att") else 0, err_msg=name)


def test_mixture_ffn_matches_jax(trees, oracles):
    """``add_mixture_ffn``'s leaves, one ``block_x070_mixffn``, and
    ``rwkv7_mixffn_forward`` (T = 21: a left pad of 11 STOP-token text
    positions) with every LM gradient against ``jax.grad``."""
    _, port = trees
    gen = torch.Generator().manual_seed(0)
    fresh = pv.add_mixture_ffn(gen, p7.init_rwkv7_params(gen, PC, "cpu"), PC)
    ref_x_k = np.asarray(oracle_jit(lambda: jv.add_mixture_ffn(
        jax.random.PRNGKey(3), j7.init_rwkv7_params(jax.random.PRNGKey(2), JC), JC)["blocks"][1]["ffn_v"]["x_k"])())
    np.testing.assert_allclose(to_np(fresh["blocks"][1]["ffn_v"]["x_k"]), ref_x_k, rtol=1e-6)
    assert set(fresh["blocks"][0]) >= {"ffn_v", "ln_v"}

    x, mask, R, xb, mb = MIX_X, MIX_MASK, MIX_R, MIX_XB, MIX_MB
    (jl, (jlog, jb)), jg = oracles["mixffn"]
    pb, _ = pv.block_x070_mixffn(port["rwkv"]["blocks"][0], PC, 0, torch.from_numpy(xb), torch.from_numpy(mb),
                                 None)
    assert max_rel(to_np(pb), jb) <= TOL
    logits = pv.rwkv7_mixffn_forward(port["rwkv"], PC, torch.from_numpy(x), torch.from_numpy(mask))
    assert max_rel(to_np(logits), jlog) <= TOL
    loss_fn = lambda p: (pv.rwkv7_mixffn_forward(p["rwkv"], PC, torch.from_numpy(x), torch.from_numpy(mask),
                                                 grad_cp=True) * torch.from_numpy(R)).sum()
    loss, g = grads_numpy({"rwkv": port["rwkv"]}, loss_fn, VC)
    assert abs(loss - float(jl)) <= 1e-5 * abs(float(jl))
    assert_grads_match(g, {"rwkv": jg}, ["rwkv"], TOL)


def test_pretrain_mode_mask_as_jax(trees):
    jtree, port = trees
    jm = dict(jax.tree_util.tree_leaves_with_path(jv.pretrain_mode_mask({k: jtree[k] for k in ("rwkv", "vrwkv")})))
    pm_ = dict(jax.tree_util.tree_leaves_with_path(pv.pretrain_mode_mask(port)))
    assert jm.keys() == pm_.keys() and jm == pm_
    assert any(jm.values()) and not all(jm.values())
    assert pm_[(jax.tree_util.DictKey("rwkv"), jax.tree_util.DictKey("blocks"), jax.tree_util.SequenceKey(1),
                jax.tree_util.DictKey("ffn_v"), jax.tree_util.DictKey("key"), jax.tree_util.DictKey("weight"))]


# ---------------------------------------------------------------------------
# the ImageNet eval
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Two classes of three PNGs (one unreadable file beside them)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.default_rng(11)
    for cls in ("n01", "n02"):
        (root / cls).mkdir()
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (30, 33, 3), dtype=np.uint8)).save(root / cls / f"{i}.png")
    (root / "n02" / "broken.png").write_bytes(b"not an image")
    return str(root)


def test_topk_and_folder_as_jax(folder):
    logits = np.random.default_rng(0).normal(size=(6, 10))
    labels = np.array([0, 3, 9, 9, 2, 5])
    assert pe.topk_accuracy(logits, labels, ks=(1, 3, 5)) == je.topk_accuracy(logits, labels, ks=(1, 3, 5))
    got, ref = list(pe.iter_imagefolder(folder, 28)), list(je.iter_imagefolder(folder, 28))
    assert len(got) == len(ref) == 6
    for (a, la, pa_), (b, lb, pb_) in zip(got, ref):
        np.testing.assert_array_equal(a, b)
        assert (la, pa_) == (lb, pb_) and a.shape == (28, 28, 3)


def test_evaluate_imagenet_as_jax(trees, folder):
    """The per-batch step (normalise, then the forward: 28 px gives 4
    patches and a left pad of 12) against the JAX eval's, and the
    accuracies over the folder (the port in batches of 4: a full one and a
    short one; JAX in batches of 3); then ``main`` on the CPU (seeded random
    weights, as in the JAX package)."""
    jtree, port = trees
    pix = np.stack([img for img, _, _ in je.iter_imagefolder(folder, 28)])
    ref = oracle_jit(lambda p, x: jv.vrwkv_forward(p, JC, normalize_uint8(x, "dino", jnp.float32))[1])(
        jt(jtree["vrwkv"]), jnp.asarray(pix[:3]))
    got = pe.imagenet_logits(port["vrwkv"], PC, torch.from_numpy(pix[:3]))
    assert got.shape == (3, pv.IMAGENET_CLASSES) and max_rel(to_np(got), ref) <= TOL
    want = je.evaluate_imagenet(jt(jtree["vrwkv"]), JC, folder, image_size=28, batch_size=3)
    assert pe.evaluate_imagenet(port["vrwkv"], PC, folder, image_size=28, batch_size=4, device="cpu") == want
    assert want["n"] == 6
    assert pe.evaluate_imagenet(port["vrwkv"], PC, folder, image_size=28, max_samples=2, device="cpu")["n"] == 2
    out = pe.main(["--data_root", folder, "--n_layer", "1", "--n_embd", "64", "--image_size", "28",
                   "--model_path", "ignored.pth", "--device", "cpu"])
    assert out["n"] == 6 and set(out) == {"top1", "top5", "n"}
