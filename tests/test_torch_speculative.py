"""The port's speculative decoding (``visualrwkv_torch/infer/speculative.py``)
and the state trails it verifies with (``ops.wkv7.wkv7_scan_states``,
``ops.wkv6.wkv6_scan_states``) against the JAX package's, and the serving
benchmark app (``apps/benchmark.py``) on the CPU. Mirrors
``tests/test_speculative.py`` and ``tests/test_apps_and_quant.py``'s
benchmark tests.

Models: 2 layers (the small draft 1), x070 64 wide with heads of 16, x060
128 wide with heads of 64, vocabulary 512, fp32, JAX parameters perturbed
and carried across by ``params_from_jax``. Tolerances: the trails and the
verify logits, fp32 against fp32, <= 1e-5 (relative RMS; ~1e-7 is seen);
greedy ids exactly."""

import functools
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import np_tree, perturbed, port_cfg, rel_rms, to_np
from visualrwkv_torch.convert.from_jax import params_from_jax
from visualrwkv_torch.infer import speculative as ps
from visualrwkv_torch.infer.engine import InferenceEngine
from visualrwkv_torch.infer.quant import quantize_lm_params
from visualrwkv_torch.models import lm as plm
from visualrwkv_tpu.config import RWKVConfig, VisionConfig, VLMConfig
from visualrwkv_tpu.infer import speculative as js
from visualrwkv_tpu.infer.engine import InferenceEngine as JaxEngine
from visualrwkv_tpu.infer.quant import quantize_lm_params as jax_quantize
from visualrwkv_tpu.models import lm as jlm
from visualrwkv_tpu.models.visualrwkv import init_visualrwkv_params

jw6 = importlib.import_module("visualrwkv_tpu.ops.wkv6")  # the package exports functions of these names
jw7 = importlib.import_module("visualrwkv_tpu.ops.wkv7")

TOL = 1e-5
GEOMETRY = {"x070": (64, 16), "x060": (128, 64)}  # n_embd, head_size


def text_cfg(version="x070", n_layer=2, n_embd=None, head_size=None):
    C, N = GEOMETRY[version]
    return VLMConfig(
        rwkv=RWKVConfig(version=version, n_layer=n_layer, n_embd=n_embd or C, vocab_size=512,
                        head_size=head_size or N, compute_dtype="float32", ctx_len=64,
                        chunk_len=16),
        vision=VisionConfig(towers=()), proj_type="linear", num_token_per_image=4)


def _model(jc, seed):
    """(JAX tree, numpy leaves; the port's tree on the CPU)."""
    tree = perturbed(np_tree(init_visualrwkv_params(jax.random.PRNGKey(seed), jc)), seed=seed + 3)
    return tree, params_from_jax(tree, port_cfg(jc), device="cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small models: their eager loops
    launch many tiny operations, which a pool of threads a process slows
    when test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["x070", "x060"])
def target(request):
    jc = text_cfg(request.param)
    return (jc, *_model(jc, 0))


def _ids(B, T, seed):
    return np.random.default_rng(seed).integers(1, 500, (B, T))


@pytest.mark.parametrize("family", ["wkv7", "wkv6"])
def test_scan_states_match_jax(family):
    """y and the state after every position, from a given state, against
    the JAX package's ``lax.scan`` of the decode step."""
    from visualrwkv_torch.ops import wkv6 as pw6
    from visualrwkv_torch.ops import wkv7 as pw7

    rng = np.random.default_rng(1)
    B, T, H, N = 2, 5, 2, 16
    xs = [rng.normal(0, 0.5, (B, T, H, N)).astype(np.float32) for _ in range(6 if family == "wkv7" else 4)]
    xs[1] = -np.exp(xs[1]) - 0.5  # w_raw
    s0 = rng.normal(0, 0.3, (B, H, N, N)).astype(np.float32)
    if family == "wkv7":
        ref = jw7.wkv7_scan_states(*map(jnp.asarray, xs), initial_state=jnp.asarray(s0))
        got = pw7.wkv7_scan_states(*map(torch.from_numpy, xs), initial_state=torch.from_numpy(s0))
    else:
        u = rng.normal(0, 0.5, (H, N)).astype(np.float32)
        ref = jw6.wkv6_scan_states(*map(jnp.asarray, xs), jnp.asarray(u), initial_state=jnp.asarray(s0))
        got = pw6.wkv6_scan_states(*map(torch.from_numpy, xs), torch.from_numpy(u),
                                   initial_state=torch.from_numpy(s0), chunk=16)
    assert got[1].shape == (B, T, H, N, N) and got[1].dtype == torch.float32
    for g, r in zip(got, ref):
        assert rel_rms(to_np(g), r) < TOL


@pytest.mark.parametrize("family", ["wkv7", "wkv6"])
def test_run_trail_layout(family):
    """``wkv7_cuda.run_trail`` (the CUDA path of the scans: one step launch a
    position, each writing the next slice of the trail) with a stand-in
    kernel that runs the plain step on the operands it is handed and writes
    into ``out``: the plain scan's y and trail, bit for bit, in r's dtype."""
    from visualrwkv_torch.ops import wkv6 as pw6
    from visualrwkv_torch.ops import wkv7 as pw7
    from visualrwkv_torch.ops import wkv7_cuda

    plain_step = pw7.wkv7_step if family == "wkv7" else pw6.wkv6_step
    launches = []

    def kernel(state, *vecs, out):
        assert all(x.dtype == torch.float32 and x.is_contiguous() for x in (state, *vecs, *out))
        s, y = plain_step(state, *vecs)
        out[0].copy_(s)
        out[1].copy_(y)
        launches.append(out[0].data_ptr())
        return out

    gen = torch.Generator().manual_seed(2)
    B, T, H, N = 3, 4, 2, 16
    xs = [torch.randn(B, T, H, N, generator=gen).to(torch.bfloat16) for _ in range(6 if family == "wkv7" else 4)]
    xs[1] = -torch.exp(xs[1]) - 0.5
    s0 = torch.randn(B, H, N, N, generator=gen)
    extra = () if family == "wkv7" else (torch.randn(H, N, generator=gen),)
    y, trail = wkv7_cuda.run_trail(kernel, xs, s0, extra)
    scan = pw7.wkv7_scan_states if family == "wkv7" else pw6.wkv6_scan_states
    y_ref, trail_ref = scan(*xs, *extra, initial_state=s0)
    assert len(set(launches)) == T and y.dtype == torch.bfloat16 and trail.shape == (B, T, H, N, N)
    assert torch.equal(y, y_ref) and torch.equal(trail, trail_ref)


def test_forward_states_match_jax(target):
    """The verify forward: logits at every position of the window and the
    trail of every layer, from a carried state, against the JAX package's;
    the state picked at each position is the decode steps' state there."""
    jc, tree, params = target
    rc = port_cfg(jc).rwkv
    B, K = 2, 4
    toks = _ids(B, 16 + K, 2)  # a chunk-aligned prefix, then the window
    jp = jax.tree_util.tree_map(jnp.asarray, tree["rwkv"])
    _, jst = jax.jit(lambda p, x, s: jlm.lm_forward(p, jc.rwkv, x, states=s))(
        jp, jlm.embed(jp, jnp.asarray(toks[:, :16])), jlm.init_lm_state(jc.rwkv, B))
    jl, jtrail = jax.jit(lambda p, x, s: js.forward_states(p, jc.rwkv, x, s))(
        jp, jlm.embed(jp, jnp.asarray(toks[:, 16:])), jst)
    p = params["rwkv"]
    _, st = plm.lm_forward(p, rc, p["emb"]["weight"][torch.as_tensor(toks[:, :16])],
                           states=plm.init_lm_state(rc, B, "cpu"))
    with torch.no_grad():
        logits, trail = ps.forward_states(p, rc, p["emb"]["weight"][torch.as_tensor(toks[:, 16:])], st)
    assert logits.shape == (B, K, 512)
    assert rel_rms(to_np(logits), jl) < TOL
    for a, b in zip(trail, jtrail):
        for x, y in zip(a, b):
            assert rel_rms(to_np(x), y) < TOL
    for i in range(K):
        step_logits, st = plm.lm_decode_step(p, rc, torch.as_tensor(toks[:, 16 + i]), st)
        assert rel_rms(to_np(logits[:, i]), to_np(step_logits)) < TOL
        picked = ps.select_states(trail, torch.full((B,), i))
        for x, y in zip(picked[-1], st[-1]):
            assert rel_rms(to_np(x), to_np(y)) < TOL


@functools.lru_cache(maxsize=None)
def _draft(kind, version):
    """(JAX draft tree and config, the port's) for the ``target`` fixture's
    model of ``version``: the target itself, its int8 copy, or a separate
    smaller int8 model (1 layer, half as wide). The int8 drafts quantize
    every linear of at least 256 elements: at this size the default
    threshold (65536) would leave the LM float."""
    jc = text_cfg(version)
    tree, params = _model(jc, 0)
    if kind == "self":
        return tree, jc, params, port_cfg(jc)
    if kind == "small_int8":
        C, N = GEOMETRY[version]
        jc = text_cfg(version, n_layer=1, n_embd=C // 2, head_size=min(N, C // 2))
        tree, params = _model(jc, 9)
    jd = {"rwkv": jax_quantize(jax.tree_util.tree_map(jnp.asarray, tree["rwkv"]), min_size=256)}
    return jd, jc, {"rwkv": quantize_lm_params(params["rwkv"], min_size=256)}, port_cfg(jc)


# the cases held against the JAX package's SpeculativeEngine too (each compiles
# its own while_loop); the rest against the greedy ids of both engines
JAX_SPEC_CASES = {("x070", "int8_self", 2), ("x070", "small_int8", 5), ("x060", "int8_self", 5)}


@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("kind", ["self", "int8_self", "small_int8"])
def test_speculative_is_greedy_lossless(target, kind, k):
    """Every emitted id is the port's greedy ``generate()``'s and the JAX
    package's (its engine's greedy ids, and in ``JAX_SPEC_CASES`` its
    SpeculativeEngine's with the same rounds and acceptance). A draft that
    is the target accepts all k a round."""
    jc, tree, params = target
    pc = port_cfg(jc)
    jd, jdc, dparams, dcfg = _draft(kind, jc.rwkv.version)
    ids = _ids(2, 8, 4)
    mnt = 20
    ref = InferenceEngine(params, pc, device="cpu").generate(ids, max_new_tokens=mnt, stop_tokens=())
    spec = ps.SpeculativeEngine(params, pc, dparams, dcfg, k=k, device="cpu").generate(
        ids, max_new_tokens=mnt, stop_tokens=())
    np.testing.assert_array_equal(spec.tokens, ref.tokens)
    np.testing.assert_array_equal(spec.lengths, ref.lengths)
    assert 0 <= int(spec.accepted.sum()) <= spec.rounds * k * 2
    if kind == "self":
        assert spec.rounds == -(-mnt // (k + 1)) and (spec.accepted == spec.rounds * k).all()
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    if (jc.rwkv.version, kind, k) in JAX_SPEC_CASES:
        jres = js.SpeculativeEngine(jtree, jc, jd, jdc, k=k).generate(ids, max_new_tokens=mnt, stop_tokens=())
        np.testing.assert_array_equal(spec.tokens, jres.tokens)
        assert spec.rounds == jres.rounds
        np.testing.assert_array_equal(spec.accepted, jres.accepted)
    elif kind == "self" and k == 2:
        jref = JaxEngine(jtree, jc).generate(ids, max_new_tokens=mnt, do_sample=False, stop_tokens=())
        np.testing.assert_array_equal(spec.tokens, jref.tokens)


def test_speculative_stops_as_generate(target):
    """With stop tokens: rows end at their first stop, lengths count it, and
    the ids and lengths are ``generate()``'s (the first greedy id stops one
    row)."""
    jc, _, params = target
    pc = port_cfg(jc)
    ids = _ids(2, 8, 5)
    eng = InferenceEngine(params, pc, device="cpu")
    free = eng.generate(ids, max_new_tokens=12, stop_tokens=())
    stop = (int(free.tokens[0, 3]),)
    ref = eng.generate(ids, max_new_tokens=12, stop_tokens=stop)
    draft = {"rwkv": ps.quantize_self_draft(params["rwkv"])}
    spec = ps.SpeculativeEngine(params, pc, draft, pc, k=3, device="cpu").generate(
        ids, max_new_tokens=12, stop_tokens=stop)
    np.testing.assert_array_equal(spec.tokens, ref.tokens)
    np.testing.assert_array_equal(spec.lengths, ref.lengths)
    assert spec.lengths[0] <= 4


@pytest.mark.parametrize("version", ["x052", "x040"])
def test_speculative_refuses_legacy_targets(version):
    from visualrwkv_torch import config as pcfg

    rc = pcfg.RWKVConfig(version=version, n_layer=1, n_embd=64, vocab_size=512, compute_dtype="float32")
    cfg = pcfg.VLMConfig(rwkv=rc, vision=pcfg.VisionConfig(towers=()))
    with pytest.raises(NotImplementedError, match="x070/x060"):
        ps.SpeculativeEngine({}, cfg, {}, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="x070/x060"):
        ps.forward_states({}, rc, torch.zeros(1, 2, 64), [])


@pytest.mark.parametrize("draft", ["int8_self", "small"])
def test_benchmark_app_spec_branches(tmp_path, draft):
    """``apps.benchmark`` end to end on the CPU at a tiny geometry, with the
    speculative leg on each draft: records with the JAX package's keys."""
    from visualrwkv_torch.apps import benchmark as bm

    out = tmp_path / "bench.jsonl"
    bm.main(["--device", "cpu", "--n_layer", "1", "--n_embd", "64", "--ctx_len", "64",
             "--max_pow", "2", "--reps", "2", "--discard", "1", "--spec_k", "2",
             "--spec_draft", draft, "--draft_n_layer", "1", "--draft_n_embd", "64",
             "--output_file", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert recs[0]["metric"] == "ttft_prefill512_s" and recs[0]["value"] > 0
    plain = [r for r in recs if "new_tokens" in r and "spec_k" not in r]
    assert [r["new_tokens"] for r in plain] == [1, 2, 4]
    assert set(plain[0]) == {"new_tokens", "batch", "latency_s", "tok_per_s", "memory"}
    spec = [r for r in recs if r.get("spec_k") == 2]
    assert len(spec) == 1 and spec[0]["spec_draft"] == draft and spec[0]["tok_per_s"] > 0
    assert set(spec[0]) == {"new_tokens", "batch", "spec_k", "spec_draft", "latency_s", "tok_per_s",
                            "acceptance"}
    assert 0.0 <= spec[0]["acceptance"] <= 1.0
