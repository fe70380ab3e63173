"""The port's RWKV-4 ("x040") recurrence and language model
(``visualrwkv_torch/ops/wkv4.py``, ``models/rwkv4.py`` through
``models/lm.py``) against the JAX package's ``ops/wkv4.py`` and
``models/rwkv4.py`` on the same inputs and weights: 2 layers, 128 wide,
vocabulary 512, JAX parameters perturbed so that the zero-initialised
projections carry signal.

Tolerances: the recurrence, fp32 on both sides, relative RMS <= 1e-6 (the
same operations: ~1e-7 is seen), with k near 80 on a quarter of the
channels, where the sums would overflow fp32 without the max tracking;
fp32 logits max |delta| <= 1e-5 * max |ref| (~4e-7 is seen). Kernels K17
and K18 run on the card only: ``chip_smoke.py`` holds them against
``wkv4_plain`` and ``wkv4_bwd_plain``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import max_rel, np_tree, perturbed, rel_rms, to_np
from visualrwkv_torch import config as pcfg
from visualrwkv_torch.convert.from_jax import params_from_jax, params_to_numpy
from visualrwkv_torch.convert.pth_import import detect_rwkv_version, import_rwkv_state_dict
from visualrwkv_torch.models import lm as plm
from visualrwkv_torch.ops import wkv4 as pw
from visualrwkv_tpu import config as jcfg
from visualrwkv_tpu.convert import pth_import as jpth
from visualrwkv_tpu.models import lm as jlm
from visualrwkv_tpu.models import rwkv4 as j4
from visualrwkv_tpu.ops import wkv4 as jw

TOL = 1e-5
B0, T0 = 2, 24


def _cfgs():
    kw = dict(n_layer=2, n_embd=128, vocab_size=512, version="x040", compute_dtype="float32",
              ctx_len=64)
    return jcfg.RWKVConfig(**kw), pcfg.RWKVConfig(**kw)


def _vlm(rcfg):
    return pcfg.VLMConfig(rwkv=rcfg, vision=pcfg.VisionConfig(towers=()), proj_type="linear",
                          num_token_per_image=4)


def _wkv4_inputs(B, T, C, seed, big_k):
    rng = np.random.default_rng(seed)
    w = -np.exp(rng.uniform(-5, 3, C)).astype(np.float32)
    u = rng.normal(0, 1, C).astype(np.float32)
    k = rng.normal(0, 1, (B, T, C)).astype(np.float32)
    v = rng.normal(0, 1, (B, T, C)).astype(np.float32)
    if big_k:  # e^80 overflows fp32 (max ~3.4e38 = e^88.7) once summed: only the max tracking holds it
        k[..., ::4] = rng.uniform(78, 82, (B, T, C // 4))
    s0 = np.stack([rng.normal(0, 1, (B, C)), rng.uniform(0.5, 2, (B, C)), rng.normal(0, 1, (B, C))], -1)
    return w, u, k, v, s0.astype(np.float32)


@pytest.mark.parametrize("big_k", [False, True])
def test_wkv4_and_step_match_jax(big_k):
    """Sequence form from the zero state and from a given state, and the
    one-token step, against the JAX package's."""
    w, u, k, v, s0 = _wkv4_inputs(2, 20, 64, 3, big_k)
    T_ = lambda x: torch.from_numpy(x)
    jy, js = jw.wkv4(*map(jnp.asarray, (w, u, k, v)))
    y, s = pw.wkv4(*map(T_, (w, u, k, v)))
    assert y.dtype == s.dtype == torch.float32 and s.shape == (2, 64, 3)
    assert np.isfinite(to_np(y)).all() and rel_rms(to_np(y), jy) < 1e-6
    assert rel_rms(to_np(s), js) < 1e-6
    jy, js = jw.wkv4(*map(jnp.asarray, (w, u, k, v)), initial_state=jnp.asarray(s0))
    y, s = pw.wkv4(*map(T_, (w, u, k, v)), initial_state=T_(s0))
    assert rel_rms(to_np(y), jy) < 1e-6 and rel_rms(to_np(s), js) < 1e-6
    jn, jy1 = jw.wkv4_step(jnp.asarray(s0), *map(jnp.asarray, (w, u, k[:, 0], v[:, 0])))
    n, y1 = pw.wkv4_step(T_(s0), *map(T_, (w, u, k[:, 0], v[:, 0])))
    assert rel_rms(to_np(y1), jy1) < 1e-6 and rel_rms(to_np(n), jn) < 1e-6
    np.testing.assert_array_equal(to_np(pw.wkv4_init_state(2, 64, "cpu")), np.asarray(jw.wkv4_init_state(2, 64)))


def test_wkv4_plain_is_differentiable():
    """On the CPU the sequence form's gradient is ``WKV4Function``'s plain
    backward (``wkv4_bwd_plain``; JAX differentiates its scan): a
    finite-difference check in float64."""
    w, u, k, v, _ = _wkv4_inputs(1, 5, 8, 4, False)
    xs = [torch.from_numpy(x).double().requires_grad_(True) for x in (w, u, k, v)]
    assert torch.autograd.gradcheck(lambda *a: pw.wkv4(*a)[0], xs, eps=1e-6, atol=1e-5)


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
def model():
    jc, pc = _cfgs()
    tree = perturbed(np_tree(j4.init_rwkv4_params(jax.random.PRNGKey(0), jc)), seed=5)
    params = params_from_jax({"rwkv": tree}, _vlm(pc), device="cpu")["rwkv"]
    ids = np.random.default_rng(0).integers(0, 512, (B0, T0))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    ref, _ = jlm.lm_forward(jp, jc, jlm.embed(jp, jnp.asarray(ids)))
    return tree, params, ids, np.asarray(ref, np.float32)


def _logits(params, cfg, ids, states=None):
    return plm.lm_forward(params, cfg, params["emb"]["weight"][torch.as_tensor(ids)], states)


def test_config_and_state_as_jax():
    """x040's FFN is 4x, its state [B, C, 3] with pp at -1e30, its tree the
    JAX init's leaves with their formula-set values."""
    jc, pc = _cfgs()
    assert pc.dim_ffn == jc.dim_ffn == 512
    st = plm.init_lm_state(pc, 2, "cpu")
    jst = jlm.init_lm_state(jc, 2)
    for a, b in zip(st, jst):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(to_np(x), np.asarray(y))
    gen = torch.Generator()
    gen.manual_seed(0)
    ours = plm.init_lm_params(gen, pc, "cpu")
    ref = j4.init_rwkv4_params(jax.random.PRNGKey(0), jc)
    for a, b in zip(ours["blocks"], ref["blocks"]):
        assert set(a["att"]) == set(b["att"]) and set(a["ffn"]) == set(b["ffn"])
        for name in ("time_decay", "time_first", "time_mix_k", "time_mix_v", "time_mix_r"):
            np.testing.assert_allclose(to_np(a["att"][name]), np.asarray(b["att"][name]), rtol=1e-6, atol=1e-6)


def test_forward_matches_jax(model):
    """T = 24, fp32: the JAX package's logits; the tree carried back to the
    JAX layout is the JAX tree."""
    tree, params, ids, ref = model
    _, pc = _cfgs()
    back = params_to_numpy({"rwkv": params}, _vlm(pc))["rwkv"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    out, states = _logits(params, pc, ids)
    assert out.shape == (B0, T0, 512) and states[0].wkv.shape == (B0, 128, 3)
    assert max_rel(to_np(out), ref) < TOL


def test_decode_and_chaining(model):
    """One-token steps from the zero state give the sequence logits, the
    first equal to the JAX package's step; split sequences with the carried
    state equal the whole (any T: nothing is padded)."""
    tree, params, ids, ref = model
    jc, pc = _cfgs()
    states = plm.init_lm_state(pc, B0, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jl, _ = jlm.lm_decode_step(jp, jc, jnp.asarray(ids[:, 0]), jlm.init_lm_state(jc, B0))
    steps = []
    for t in range(T0):
        lg, states = plm.lm_decode_step(params, pc, torch.as_tensor(ids[:, t]), states)
        steps.append(lg)
    assert max_rel(to_np(steps[0]), np.asarray(jl)) < TOL
    assert max_rel(to_np(torch.stack(steps, 1)), ref) < TOL
    a, st = _logits(params, pc, ids[:, :7])
    b, _ = _logits(params, pc, ids[:, 7:], states=st)
    assert max_rel(to_np(torch.cat([a, b], 1)), ref) < TOL


def test_pth_import_gives_jax_logits(model):
    tree, _, ids, ref = model
    _, pc = _cfgs()
    sd = {k: torch.from_numpy(np.array(v)) for k, v in jpth.export_rwkv_state_dict(tree).items()}
    info = detect_rwkv_version(sd)
    assert (info["version"], info["n_head"], info["head_size"]) == ("x040", 1, 128)
    out, _ = _logits(import_rwkv_state_dict(sd), pc, ids)
    assert max_rel(to_np(out), ref) < TOL


def test_engine_rules_and_serving(model):
    """The JAX engine's x040 rules: the head layout and an fp32 state only,
    each refusal a ValueError; the engine and the server serve it."""
    from visualrwkv_torch.infer.engine import InferenceEngine
    from visualrwkv_torch.infer.server import BatchedServer
    from visualrwkv_torch.infer.strategy import make_engine

    _, params, ids, _ = model
    _, pc = _cfgs()
    cfg = _vlm(pc)
    with pytest.raises(ValueError, match="flat"):
        InferenceEngine({"rwkv": params}, cfg, state_layout="flat", device="cpu")
    with pytest.raises(ValueError, match="float32"):
        InferenceEngine({"rwkv": params}, cfg, state_dtype="bfloat16", device="cpu")
    with pytest.raises(ValueError):
        make_engine({"rwkv": params}, cfg, "cpu fp32 s16")
    eng = make_engine({"rwkv": params}, cfg, "cpu fp32")
    ref = eng.generate(ids[:1, :9], max_new_tokens=5, stop_tokens=())
    seq, _ = _logits(params, pc, ids[:1, :9])
    assert ref.tokens[0, 0] == int(seq[0, -1].argmax())
    # a carried state re-enters prefill (the image-state path's shape)
    _, st = eng.prefill_ids(ids[:1, :4])
    again = eng.generate(ids[:1, 4:9], states=st, max_new_tokens=5, stop_tokens=())
    np.testing.assert_array_equal(again.tokens, ref.tokens)
    server = BatchedServer(eng, max_batch=2, stop_tokens=())
    rid = server.submit(ids[:1, :9], max_new_tokens=5)
    assert server.run()[rid] == ref.tokens[0].tolist()
