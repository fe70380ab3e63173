"""Tensor parallelism over ``model`` and the offloaded optimizer over data
ranks, on gloo ranks of the CPU.

- The tensor-parallel rule (``parallel.mesh.tensor_parallel_sharding``) picks
  the leaves JAX's ``tensor_parallel_sharding`` splits, on the matching dim
  of the port's layout, for 1 to 4 model ranks, with a vocabulary and a head
  count that some of them do not divide.
- The vocab-parallel CE + L2Wrap on 2 model ranks against the one-process
  ``chunked_ce_l2wrap`` and JAX's, with each position's largest logit on
  either rank, and with ties across the ranks.
- The trainer on ``model=2`` (x070 with images and x060 on text, ``grad_cp``
  True and "wkv", the packed WKV mode with one head a rank, x052 and x040,
  VisualRWKV-6's leftpad insertion with the reversed image span, the
  bidirectional scatter, the token compressor, ``bf16_sr``, a checkpoint
  that a one-process trainer loads), on ``data=2 x model=2`` (at
  ``zero_stage`` 0 and 1, and offloaded), on ``seq=2 x model=2``, and the
  offloaded optimizer on ``data=2`` at ``zero_stage`` 0, 1 and 3: each
  against the one-process port (losses 1e-5 relative, gradients rtol 1e-4,
  atol 1e-5, a split leaf's part against the slice of the whole) and JAX's
  ``Trainer(mesh=make_mesh(...))`` on the same mesh after 3 steps (losses
  rtol 2e-4, atol 2e-4, parameters rtol 5e-3, atol 3e-4): the limits of
  ``tests/test_train.py``'s 3-D mesh tests.

The four suites of ``tests/torch_parallel_worker.py`` (``tp`` on 2 ranks,
``tp_dm`` and ``tp_sm`` on 4, ``offload`` on 2) start together in one
fixture; the one-process and JAX references are made while they run. The
model is ``tests/test_torch_parallel_data.py``'s (2 layers, 128 wide, head
size 64: one head a model rank)."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from torch_port_helpers import np_tree, start_ranks
from visualrwkv_torch.config import RWKVConfig, VisionConfig, VLMConfig
from visualrwkv_torch.convert.from_jax import params_from_jax, params_to_numpy
from visualrwkv_torch.models.visualrwkv import L2WRAP_FACTOR, chunked_ce_l2wrap, init_visualrwkv_params
from visualrwkv_torch.ops.wkv7 import set_wkv_impl
from visualrwkv_torch.parallel.mesh import take_part, tensor_parallel_sharding
from visualrwkv_torch.train.optim import tree_leaves, tree_leaves_with_path
from visualrwkv_torch.train.trainer import Trainer
from visualrwkv_torch.vision.vit import ViTConfig
from visualrwkv_tpu import config as jcfg_mod
from visualrwkv_tpu.models.visualrwkv import _dense_ce_l2wrap as j_dense_ce_l2wrap
from visualrwkv_tpu.models.visualrwkv import _l2wrap_bwd as j_l2wrap_bwd
from visualrwkv_tpu.models.visualrwkv import chunked_ce_l2wrap as j_chunked_ce_l2wrap
from visualrwkv_tpu.ops.wkv7 import set_wkv_impl as j_set_wkv_impl
from visualrwkv_tpu.parallel.mesh import make_mesh as j_make_mesh
from visualrwkv_tpu.parallel.mesh import tensor_parallel_sharding as j_tensor_parallel_sharding
from visualrwkv_tpu.train.trainer import Trainer as JTrainer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import __graft_entry__ as graft  # noqa: E402

SUITES = {"tp": 2, "tp_dm": 4, "tp_sm": 4, "offload": 2}
# one-process reference runs: name -> (case, offload)
ONE = {**{case: (case, False) for case in W.TP_CASES}, "x070_offload": ("x070_img", True)}
# JAX's trainer runs: name -> (case, mesh (data, seq, model), zero_stage, offload)
JAX_RUNS = {**{f"tp_{case}": (case, (1, 1, 2), 0, False) for case in W.TP_CASES},
            "tp_dm": ("x070_img", (2, 1, 2), 1, False), "tp_sm": ("x070_img", (1, 2, 2), 0, False),
            "offload": ("x070_img", (2, 1, 1), 1, True)}
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5
JAX_LOSS_TOL, PARAM_RTOL, PARAM_ATOL = 2e-4, 5e-3, 3e-4


def _name(path):
    return "/".join(map(str, path))


def _jax_cfg(case):
    """JAX's config of ``W.case_cfg(case)``: the model of ``W.train_cfg``
    with the case's LM version and ``VLMConfig`` fields."""
    version, _, _, _, fields = W.TP_CASES[case]
    jcfg = graft._tiny_vlm_cfg(n_layer=2, n_embd=128)
    rwkv = jcfg.rwkv.__class__(**{**vars(jcfg.rwkv), "compute_dtype": "float32", "ctx_len": W.TRAIN_T,
                                  "version": version, "vocab_size": W.TP_VOCAB})
    return jcfg.replace(rwkv=rwkv, **fields)


def _one_process(case, offload, tmp):
    """The one-process port on the whole batches of ``W.TP_CASES[case]``: the
    first step's gradients, the losses of ``TP_STEPS`` steps, the parameters
    after them and the offloaded state's pinned bytes."""
    _, _, grad_cp, impl, _ = W.TP_CASES[case]
    set_wkv_impl(impl)
    try:
        tr = Trainer(W.case_cfg(case), W.tp_trainer_cfg(0, 4, grad_cp, offload_optimizer=offload),
                     W.case_params(case), device="cpu", proj_dir=str(tmp))
        batches = W.tp_batches(case)
        _, grads = tr.loss_and_reduced_grads(batches[0])
        names = [_name(p) for (p, _), t in zip(tree_leaves_with_path(tr.params),
                                               tree_leaves(tr.opt.train_mask)) if t]
        losses = [float(tr.train_step(b)) for b in batches]
    finally:
        set_wkv_impl("auto")
    return {"grads": {n: g.numpy() for n, g in zip(names, grads)}, "losses": losses,
            "params": {_name(p): t.detach().numpy() for p, t in tree_leaves_with_path(W.trained(tr.params))},
            "pinned": None if tr._streamed is None else tr._streamed.pinned_bytes}


def _jax_run(case, shape, zero, offload, tmp):
    """JAX's trainer on ``make_mesh(*shape)``: its losses and its parameters
    (in the port's layout) after ``TP_STEPS`` steps of ``W.TP_CASES[case]``."""
    _, _, grad_cp, impl, _ = W.TP_CASES[case]
    pcfg = W.case_cfg(case)
    t = W.tp_trainer_cfg(zero, 4, grad_cp)
    tcfg = jcfg_mod.TrainConfig(offload_optimizer=offload, **{k: getattr(t, k) for k in (
        "lr_init", "lr_final", "warmup_steps", "weight_decay", "epoch_steps", "epoch_count", "micro_bsz",
        "accumulate_grad_batches", "grad_cp", "grad_clip", "ce_chunk_t", "zero_stage")})
    n_data, n_seq, n_model = shape
    tree = params_to_numpy(W.case_params(case), pcfg)
    tr = JTrainer(_jax_cfg(case), tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                  mesh=j_make_mesh(n_data=n_data, n_model=n_model, n_seq=n_seq), proj_dir=str(tmp),
                  log_every=1)
    batches = W.tp_batches(case)
    j_set_wkv_impl(impl)
    try:
        tr.run_epoch(lambda s: batches[s], epoch=0)
    finally:
        j_set_wkv_impl("auto")
    params = params_from_jax(np_tree(tr.state.params), pcfg, device="cpu")
    return {"losses": [h["loss"] for h in tr.history],
            "params": {_name(p): t.numpy() for p, t in tree_leaves_with_path(W.trained(params))}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every suite's ranks, started together, and the references made while
    they run: (ranks by suite, the suites' directory, one-process runs, JAX
    runs)."""
    out = tmp_path_factory.mktemp("tp")
    finishes = {suite: start_ranks(suite, world, out, timeout=900) for suite, world in SUITES.items()}
    one = {name: _one_process(*spec, tmp_path_factory.mktemp(f"one_{name}")) for name, spec in ONE.items()}
    jx = {name: _jax_run(*spec, tmp_path_factory.mktemp(f"jax_{name}")) for name, spec in JAX_RUNS.items()}
    return {suite: finish() for suite, finish in finishes.items()}, out, one, jx


def _part(name, ref, got, model_index):
    """``ref`` (a whole leaf) cut to the part a model rank holds of it, when
    ``got`` is a part."""
    if got.shape == ref.shape:
        return ref
    ax = [a for a in range(ref.ndim) if got.shape[a] != ref.shape[a]]
    assert len(ax) == 1, (name, got.shape, ref.shape)
    return take_part(ref, ax[0], ref.shape[ax[0]] // got.shape[ax[0]], model_index)


def _hold(r, tag, one, model_index, jx=None):
    """A rank's run ``tag`` against the one-process run (and JAX's)."""
    np.testing.assert_allclose(r[f"{tag}/losses"], one["losses"], rtol=LOSS_RTOL)
    for name, ref in one["grads"].items():
        got = r[f"{tag}/grad1/{name}"]
        np.testing.assert_allclose(got, _part(name, ref, got, model_index), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
    for name, ref in one["params"].items():
        got = r[f"{tag}/params/{name}"]
        np.testing.assert_allclose(got, ref, rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=name)
        if jx is not None:
            np.testing.assert_allclose(got, jx["params"][name], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=name)
    if jx is not None:
        np.testing.assert_allclose(r[f"{tag}/losses"], jx["losses"], rtol=JAX_LOSS_TOL, atol=JAX_LOSS_TOL)


# ---------------------------------------------------------------------------
# The rule
# ---------------------------------------------------------------------------


def _rule_cfg(version):
    """Widths some model counts do not divide: 3 heads of 64, a vocabulary
    of 1002, a projector input of 150 channels (the tower's)."""
    tower = ViTConfig(img_size=16, patch_size=8, width=150, depth=1, heads=2, mlp_dim=64, use_cls=False,
                      num_reg=0, layerscale=False)
    return VLMConfig(rwkv=RWKVConfig(n_layer=2, n_embd=192, vocab_size=1002, head_size=64, version=version),
                     vision=VisionConfig(towers=("dino",), image_size=16, dino_dim=150,
                                         tower_config_overrides={"dino": tower}),
                     proj_type="mlp", num_token_per_image=4)


RULE_TREES = {"x070": ("x070", ("rwkv", "blocks")), "x060": ("x060", ("rwkv", "blocks")),
              "projector": ("x070", ("proj",)), "head": ("x070", ("rwkv", "head"))}


@pytest.mark.parametrize("n_model", [1, 2, 3, 4])
@pytest.mark.parametrize("tree", list(RULE_TREES))
def test_rule_splits_the_leaves_jax_splits(tree, n_model):
    """The leaves the port's rule splits over ``n_model`` ranks are those
    JAX's ``tensor_parallel_sharding`` splits, each on the matching dim of
    the port's ``[out, in]`` layout (JAX's dim d of ``[in, out]`` is dim 1 - d
    here). At 4 ranks the vocabulary (1002) and the projector's input (150)
    stay whole; at 2 and 4 the head count (3) is not divided but the time
    mix's output dim (192) is, and the leaves split as in JAX."""
    version, prefix = RULE_TREES[tree]
    cfg = _rule_cfg(version)
    params = init_visualrwkv_params(cfg, seed=0, device="cpu")
    axes = {_name(p): ax for p, ax in tree_leaves_with_path(tensor_parallel_sharding(params, n_model))}
    specs = j_tensor_parallel_sharding(params_to_numpy(params, cfg), j_make_mesh(n_data=1, n_model=n_model))
    want = {}
    for path, s in jax.tree_util.tree_leaves_with_path(specs, is_leaf=lambda x: hasattr(x, "spec")):
        name = _name(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        if "model" in tuple(s.spec):
            want[name] = 1 - tuple(s.spec).index("model")
    mine = {n: ax for n, ax in axes.items() if ax is not None}
    sub = lambda d: {n: a for n, a in d.items() if tuple(n.split("/")[:len(prefix)]) == prefix}
    assert sub(mine) == sub(want)
    assert mine == want  # and nothing outside the subtree differs either
    if n_model > 1:
        assert bool(sub(want)) == (tree in ("x070", "x060") or n_model < 4)


# ---------------------------------------------------------------------------
# The vocab-parallel loss
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vp_refs():
    """The one-process port's and JAX's loss and gradients of each case.
    JAX's gradients are those of its dense loss on ``hidden @ head``: its
    chunked backward gives a label beyond the vocabulary no target
    gradient, where its forward and its dense loss clamp it to the last id
    (ROADMAP §C); the port's losses follow the dense one."""
    out = {}
    j_loss = jax.jit(lambda w, h, l: j_chunked_ce_l2wrap(16, w, h, l))
    j_grad = jax.jit(jax.value_and_grad(lambda w, h, l: j_dense_ce_l2wrap(h @ w, l), argnums=(0, 1)))
    for case in ("rand", "tie"):
        hidden, head, labels = W.vp_inputs(case)
        h, w = hidden.clone().requires_grad_(True), head.clone().requires_grad_(True)
        loss = chunked_ce_l2wrap(16, w, h, labels)
        loss.backward()
        args = (jnp.asarray(head.numpy().T), jnp.asarray(hidden.numpy()), jnp.asarray(labels.numpy()))
        jl, (jw, jh) = j_grad(*args)
        assert abs(float(j_loss(*args)) - float(jl)) <= 1e-6 * abs(float(jl))
        logits = torch.nn.functional.linear(hidden, head)
        B, T = labels.shape
        maxx, ids = logits.max(-1, keepdim=True)
        inj = torch.zeros_like(logits).scatter_(-1, ids, maxx * (L2WRAP_FACTOR / (B * T)))
        out[case] = {"loss": float(loss.detach()), "dhead": w.grad.numpy(), "dhidden": h.grad.numpy(),
                     "jax": (float(jl), np.asarray(jw).T, np.asarray(jh)), "logits": logits.numpy(),
                     "injection": inj.numpy(),
                     "jax_injection": np.asarray(j_l2wrap_bwd(jnp.asarray(logits.numpy()), 1.0)[1])}
    return out


@pytest.mark.parametrize("case", ["rand", "tie"])
def test_vocab_parallel_loss_matches_one_process_and_jax(runs, vp_refs, case):
    """On 2 model ranks, each holding half of the head: the loss (the same on
    both) within 1e-6 of the one-process loss and JAX's, each rank's head
    gradient within 1e-5 (relative to the largest) of its rows of the
    one-process and JAX gradients, and the hidden state's gradient (summed
    over the ranks) likewise."""
    ranks = runs[0]["tp"]
    ref = vp_refs[case]
    jl, jw, jh = ref["jax"]
    for m, r in enumerate(ranks):
        np.testing.assert_allclose(r[f"vp_{case}/loss"], ref["loss"], rtol=1e-6)
        np.testing.assert_allclose(r[f"vp_{case}/loss"], jl, rtol=1e-6)
        for got, want in ((r[f"vp_{case}/dhead"], take_part(ref["dhead"], 0, 2, m)),
                          (r[f"vp_{case}/dhead"], take_part(jw, 0, 2, m)),
                          (r[f"vp_{case}/dhidden"], ref["dhidden"]), (r[f"vp_{case}/dhidden"], jh)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", ["rand", "tie"])
def test_l2wrap_injection_is_bit_equal_at_the_global_first_argmax(runs, vp_refs, case):
    """L2Wrap's gradient on each rank's slice of the logits equals, bit for
    bit, that slice of the one-process injection and of JAX's
    ``_l2wrap_bwd``: ``max * 1e-4 / (B * T)`` at the first index that
    attains the row's maximum. In "rand" both ranks own some rows' maxima;
    in "tie" rows ``VP_TIE`` are equal, the maximum of most positions is on
    both ranks and only the lower rank injects."""
    ranks = runs[0]["tp"]
    ref = vp_refs[case]
    for m, r in enumerate(ranks):
        got = r[f"vp_{case}/injection"]
        np.testing.assert_array_equal(got, take_part(ref["injection"], -1, 2, m))
        np.testing.assert_array_equal(got, take_part(ref["jax_injection"], -1, 2, m))
    owners = np.stack([(r[f"vp_{case}/injection"] != 0).any(-1) for r in ranks])
    assert (owners.sum(0) == 1).all()  # one rank injects at each position
    logits = ref["logits"]
    if case == "rand":
        assert owners[0].any() and owners[1].any()
    else:
        a, b = W.VP_TIE
        tied = (logits[..., a] == logits.max(-1)) & (logits[..., b] == logits[..., a])
        assert tied.mean() > 0.5
        assert owners[0][tied].all() and not owners[1][tied].any()
        assert (ranks[0][f"vp_{case}/injection"][..., a][tied] != 0).all()


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


def test_two_model_ranks_make_a_mesh_and_refuse_split_heads(runs):
    """``make_mesh(n_model=2)`` under a group of 2 returns the (1, 1, 2)
    mesh; a model of 3 heads in a ``dim_att`` of 192, which the rule splits
    in two, raises ``ValueError`` (the WKV runs on whole heads) instead of
    running anything replicated."""
    for r in runs[0]["tp"]:
        assert tuple(r["tp/mesh_shape"]) == (1, 1, 2)
        assert "not the 3 heads" in str(r["tp/odd_heads"])


@pytest.mark.parametrize("case", list(W.TP_CASES))
def test_model2_trainer_matches_one_process(runs, case):
    """``Trainer(mesh=make_mesh(n_model=2))``, 3 steps: each step's loss
    within 1e-5 of the one-process port's, the first step's gradients within
    rtol 1e-4, atol 1e-5 (a split leaf's part against that part of the whole
    gradient), the parameters after 3 steps within rtol 5e-3, atol 3e-4, and
    the leaves the ranks hold are the rule's parts."""
    ranks, _, one, _ = runs
    for m, r in enumerate(ranks["tp"]):
        _hold(r, f"tp_{case}", one[case], m)
        shapes = dict(x.rsplit(":", 1) for x in r[f"tp_{case}/shapes"].tolist())
        axes = {_name(p): ax for p, ax in tree_leaves_with_path(tensor_parallel_sharding(W.case_params(case), 2))}
        for name, ref in one[case]["params"].items():
            want = list(ref.shape)
            if axes[name] is not None:
                want[axes[name]] //= 2
            assert shapes[name] == str(tuple(want)), name


@pytest.mark.parametrize("case", list(W.TP_CASES))
def test_model2_trainer_matches_jax(runs, case):
    """The same runs against JAX's ``Trainer(mesh=make_mesh(n_model=2))``
    (with the case's ``grad_cp`` and WKV mode) after 3 steps: losses within
    rtol 2e-4, atol 2e-4, parameters within rtol 5e-3, atol 3e-4."""
    ranks, _, one, jx = runs
    for m, r in enumerate(ranks["tp"]):
        _hold(r, f"tp_{case}", one[case], m, jx[f"tp_{case}"])


def test_model2_checkpoint_loads_into_one_process(runs, tmp_path):
    """The checkpoint the 2 model ranks wrote after step 1 holds whole
    leaves (the JAX package's layout follows through ``params_to_numpy``); a
    one-process trainer loads it and its step 2 gives the loss of the
    one-process run that never split (within 1e-5) and the ranks'."""
    ranks, out, one, _ = runs
    cfg = W.case_cfg("x070_img")
    saved = torch.load(os.path.join(str(out), "tp_x070_img.pth"), weights_only=True)
    for (path, t), (_, ref) in zip(tree_leaves_with_path(saved["params"]),
                                   tree_leaves_with_path(W.model_params(cfg))):
        assert t.shape == ref.shape, path
    # and into the JAX package's layout, as convert/from_jax.py reads a checkpoint in reverse
    j_shapes = [x.shape for x in jax.tree_util.tree_leaves(params_to_numpy(W.model_params(cfg), cfg))]
    assert [x.shape for x in jax.tree_util.tree_leaves(params_to_numpy(saved["params"], cfg))] == j_shapes
    tr = Trainer(cfg, W.tp_trainer_cfg(0, 4), W.model_params(cfg, seed=9), device="cpu", proj_dir=str(tmp_path))
    tr.load_checkpoint(os.path.join(str(out), "tp_x070_img.pth"))
    assert tr.state.step == 1
    loss = float(tr.train_step(W.tp_batches("x070_img")[1]))
    np.testing.assert_allclose(loss, one["x070_img"]["losses"][1], rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss, ranks["tp"][0]["tp_x070_img/losses"][1], rtol=LOSS_RTOL)


def test_model2_bf16_sr_step_matches_one_process(runs, tmp_path):
    """One ``bf16_sr`` step (bf16 parameters, stochastic rounding, no
    masters) on 2 model ranks: the parameters equal the one-process step's
    but where the gradients' last bits differ (the partial sums): under 1 %
    of a leaf's elements (0.12 % at most read here; an element whose
    gradient is near 0 can take Adam's first step, +-lr, the other way).
    The 2 ranks' whole parameters are equal."""
    ranks = runs[0]["tp"]
    cfg = W.case_cfg("x070_img")
    tr = Trainer(cfg, W.trainer_cfg(0, param_dtype="bfloat16", optim_precision="bf16_sr", micro_bsz=4,
                                    accumulate_grad_batches=1), W.model_params(cfg), device="cpu",
                 proj_dir=str(tmp_path))
    tr.train_step(W.image_batch(20, 4, cfg))
    for path, t in tree_leaves_with_path(W.trained(tr.params)):
        ref = t.detach().float().numpy()
        for r in ranks:
            diff = r[f"tp_sr/params/{_name(path)}"] != ref
            assert diff.mean() < 1e-2, (_name(path), diff.mean())
    np.testing.assert_array_equal(*(np.concatenate([r[k].ravel() for k in sorted(r) if k.startswith("tp_sr/")])
                                    for r in ranks))


@pytest.mark.parametrize("zero_stage", [0, 1])
def test_bf16_sr_model_part_rounds_as_its_whole_leaf(zero_stage):
    """Under ``bf16_sr`` a model rank's part of a split leaf takes its
    rounding bits from the whole leaf's draw: each rank's optimizer step on
    its parts (with the rank's ZeRO-1 part of them over 2 data ranks at
    ``zero_stage`` 1) gives, bit for bit, that part of the whole leaves'
    step on the whole gradients (no clip: a part's norm is not the
    whole's). Drawing a part's own bits moves about half of its elements by
    one bf16 step. One process: the plans' group is never reached."""
    from visualrwkv_torch.parallel.tensor import TensorPlan
    from visualrwkv_torch.parallel.zero import ZeroPlan
    from visualrwkv_torch.parallel.mesh import zero_sharding
    from visualrwkv_torch.train.optim import make_optimizer, tree_map

    cfg = W.case_cfg("x070_img")
    tcfg = W.trainer_cfg(0, param_dtype="bfloat16", optim_precision="bf16_sr", grad_clip=0.0)
    whole = tree_map(lambda p: p.bfloat16(), W.model_params(cfg))
    rng = np.random.default_rng(5)
    grads = tree_map(lambda p: torch.from_numpy(1e-3 * rng.standard_normal(tuple(p.shape))).bfloat16(), whole)
    opt = make_optimizer(tcfg, whole, 10, cfg.rwkv.n_layer)
    ref = tree_map(lambda p: p.clone(), whole)
    state = opt.init(ref)
    opt.step(ref, [g for g, t in zip(tree_leaves(grads), tree_leaves(opt.train_mask)) if t], state, 0)
    for index in range(2):
        plan = TensorPlan(axes=tensor_parallel_sharding(whole, 2), n=2, index=index, group=None)
        part = lambda tree: tree_map(lambda t, ax: (t if ax is None else plan.part(t, ax)).clone(), tree, plan.axes)
        mine, mine_g = part(whole), part(grads)
        zero = None
        if zero_stage:
            zero = ZeroPlan(stage=1, axes=zero_sharding(mine, 2), n=2, index=index, group=None)
            zero.gather = lambda p, ax: torch.cat([p, p], dim=ax)  # the other data rank's part: not checked
        popt = make_optimizer(tcfg, mine, 10, cfg.rwkv.n_layer, zero, plan)
        popt.step(mine, [g for g, t in zip(tree_leaves(mine_g), tree_leaves(popt.train_mask)) if t],
                  popt.init(mine), 0)
        split = 0
        for (path, got), want, ax, zax in zip(tree_leaves_with_path(mine), tree_leaves(ref), tree_leaves(plan.axes),
                                              tree_leaves(zero.axes) if zero else [None] * len(tree_leaves(ref))):
            want = want if ax is None else plan.part(want, ax)
            if zax is not None:
                got, want = zero.part(got, zax), zero.part(want, zax)
            assert torch.equal(got, want), _name(path)
            split += ax is not None
        assert split > 0


@pytest.mark.parametrize("zero", [0, 1])
def test_data2_model2_trainer_matches_one_process_and_jax(runs, zero):
    """``data=2 x model=2`` on 4 ranks (ZeRO-1 splits each rank's parts over
    the data ranks): 3 steps against the one-process port and JAX's trainer
    on the same mesh, at the limits above; the 4 ranks' parameters equal."""
    ranks, _, one, jx = runs
    for i, r in enumerate(ranks["tp_dm"]):
        _hold(r, f"tp_dm{zero}", one["x070_img"], i % 2, jx["tp_dm"])
        for k in r:
            if k.startswith(f"tp_dm{zero}/params/"):
                np.testing.assert_array_equal(r[k], ranks["tp_dm"][0][k])


def test_data2_model2_offloaded_trainer_matches_resident(runs):
    """The offloaded optimizer on ``data=2 x model=2`` at ``zero_stage`` 1:
    its parameters equal the resident ZeRO-1 run's bit for bit (the same
    arithmetic on host state), and it holds against the one-process port."""
    ranks, _, one, _ = runs
    for i, r in enumerate(ranks["tp_dm"]):
        _hold(r, "tp_dm_offload", one["x070_img"], i % 2)
        for k in r:
            if k.startswith("tp_dm1/params/"):
                np.testing.assert_array_equal(r[k.replace("tp_dm1/", "tp_dm_offload/")], r[k])


def test_seq2_model2_trainer_matches_one_process_and_jax(runs):
    """The 3-D mesh ``data=1 x seq=2 x model=2``: the ring of each block on
    this rank's heads, the vocab-parallel loss over the seq ranks' token
    ranges; 3 steps against the one-process port and JAX's trainer on the
    same mesh."""
    ranks, _, one, jx = runs
    for i, r in enumerate(ranks["tp_sm"]):
        _hold(r, "tp_sm", one["x070_img"], i % 2, jx["tp_sm"])


@pytest.mark.parametrize("zero", [0, 1, 3])
def test_offload_over_two_data_ranks(runs, zero):
    """``offload_optimizer`` on ``data=2``: each rank keeps the host state of
    its ZeRO part of every split leaf (under ZeRO-3 its parameters are its
    parts), so its pinned bytes are those of the one-process offloaded
    trainer less half of the split leaves' state; 3 steps against that
    trainer and JAX's offloaded ``Trainer(mesh=make_mesh(n_data=2))``."""
    ranks, _, one, jx = runs
    ref = one["x070_offload"]
    for i, r in enumerate(ranks["offload"]):  # a ZeRO-3 gradient is the data rank's part
        _hold(r, f"offload{zero}", ref, i, jx["offload"])
        pinned = int(r[f"offload{zero}/pinned_bytes"])
        assert 0.45 * ref["pinned"] < pinned < 0.75 * ref["pinned"], (pinned, ref["pinned"])
