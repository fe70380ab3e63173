"""The port's RWKV-5.2 ("x052") language model (``visualrwkv_torch/models/
rwkv5.py`` through ``models/lm.py``) against the JAX package's
``models/rwkv5.py`` on the same weights: 2 layers, 128 wide (two heads of
64), vocabulary 512, JAX parameters perturbed so that the zero-initialised
projections carry signal, carried across by ``params_from_jax``.

Tolerances: fp32 logits max |delta| <= 1e-5 * max |ref| (the same
arithmetic in another order: the chunked WKV6 form against the JAX
package's, ``F.linear`` against ``matmul``; ~4e-7 is seen). The decode step
runs the one-token WKV6 step on the head and on the flat state (the
kernels' plain versions here), and serves through the strategy strings,
int8 weights and the server."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import max_rel, np_tree, perturbed, to_np
from visualrwkv_torch import config as pcfg
from visualrwkv_torch.convert.from_jax import params_from_jax, params_to_numpy
from visualrwkv_torch.convert.pth_import import (
    detect_rwkv_version,
    export_rwkv_state_dict,
    import_rwkv_state_dict,
)
from visualrwkv_torch.models import lm as plm
from visualrwkv_tpu import config as jcfg
from visualrwkv_tpu.convert import pth_import as jpth
from visualrwkv_tpu.models import lm as jlm
from visualrwkv_tpu.models import rwkv5 as j5

TOL = 1e-5
B0, T0 = 2, 32  # every JAX sequence forward of this file runs at this shape


def _cfgs(version="x052"):
    kw = dict(n_layer=2, n_embd=128, vocab_size=512, head_size=64, version=version,
              compute_dtype="float32", ctx_len=64)
    return jcfg.RWKVConfig(**kw), pcfg.RWKVConfig(**kw)


def _vlm(rcfg):
    return pcfg.VLMConfig(rwkv=rcfg, vision=pcfg.VisionConfig(towers=()), proj_type="linear",
                          num_token_per_image=4)


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
    """(JAX tree with numpy leaves, the port's LM params, ids, JAX logits)."""
    jc, pc = _cfgs()
    tree = perturbed(np_tree(j5.init_rwkv5_params(jax.random.PRNGKey(0), jc)), seed=5)
    params = params_from_jax({"rwkv": tree}, _vlm(pc), device="cpu")["rwkv"]
    ids = np.random.default_rng(0).integers(0, 512, (B0, T0))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    ref, _ = jlm.lm_forward(jp, jc, jlm.embed(jp, jnp.asarray(ids)))
    return tree, params, ids, np.asarray(ref, np.float32)


def _logits(params, cfg, ids, states=None):
    x = params["emb"]["weight"][torch.as_tensor(ids)]
    return plm.lm_forward(params, cfg, x, states)


def test_config_and_init_as_jax():
    """x052's FFN is 3.5x rounded to 32 and its tree has the JAX init's
    leaves and shapes (linears transposed), and its formula-set values."""
    jc, pc = _cfgs()
    assert pc.dim_ffn == jc.dim_ffn == 448
    gen = torch.Generator()
    gen.manual_seed(0)
    ours = plm.init_lm_params(gen, pc, "cpu")
    ref = j5.init_rwkv5_params(jax.random.PRNGKey(0), jc)
    for a, b in zip(ours["blocks"], ref["blocks"]):
        assert set(a) == set(b) and set(a["att"]) == set(b["att"]) and set(a["ffn"]) == set(b["ffn"])
        for name in ("time_mix_k", "time_mix_v", "time_mix_r", "time_mix_g", "time_decay", "time_faaaa"):
            np.testing.assert_allclose(to_np(a["att"][name]), np.asarray(b["att"][name]), rtol=1e-6, atol=1e-6)
        assert a["att"]["gate"]["weight"].shape == b["att"]["gate"]["weight"].shape[::-1]


def test_forward_matches_jax(model):
    """T = 32, stateless, fp32: the JAX package's logits; the tree carried
    back to the JAX layout is the JAX tree."""
    tree, params, ids, ref = model
    _, pc = _cfgs()
    back = params_to_numpy({"rwkv": params}, _vlm(pc))["rwkv"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    out, states = _logits(params, pc, ids)
    assert out.shape == (B0, T0, 512) and states[0].wkv.shape == (B0, 2, 64, 64)
    assert max_rel(to_np(out), ref) < TOL


@pytest.mark.parametrize("layout", ["head", "flat"])
def test_decode_matches_sequence_and_jax(model, layout):
    """One-token steps from the zero state give the sequence logits (T = 16,
    one chunk: no padding), on the head and the flat state; the first
    steps equal the JAX package's decode step."""
    tree, params, ids, _ = model
    jc, pc = _cfgs()
    from visualrwkv_torch.ops.wkv7 import state_to_flat

    seq, _ = _logits(params, pc, ids[:, :16])
    states = plm.init_lm_state(pc, B0, "cpu")
    if layout == "flat":
        states = [s._replace(wkv=state_to_flat(s.wkv)) for s in states]
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jstates = jlm.init_lm_state(jc, B0)
    steps = []
    for t in range(16):
        lg, states = plm.lm_decode_step(params, pc, torch.as_tensor(ids[:, t]), states)
        steps.append(lg)
        if t < 2:
            jl, jstates = jlm.lm_decode_step(jp, jc, jnp.asarray(ids[:, t]), jstates)
            assert max_rel(to_np(lg), np.asarray(jl)) < TOL
    assert states[0].wkv.dim() == (3 if layout == "flat" else 4)
    assert max_rel(to_np(torch.stack(steps, 1)), to_np(seq)) < TOL


def test_state_chaining(model):
    """Two chunk-aligned halves with the carried state equal the whole."""
    _, params, ids, ref = model
    _, pc = _cfgs()
    a, st = _logits(params, pc, ids[:, :16])
    b, _ = _logits(params, pc, ids[:, 16:], states=st)
    assert max_rel(to_np(torch.cat([a, b], 1)), ref) < TOL


def test_pth_round_trip_gives_jax_logits(model):
    """The JAX package's reference-layout export, read by the port's
    importer, serves the JAX logits; the port's export reads back equal, and
    the detector names the family."""
    tree, _, ids, ref = model
    _, pc = _cfgs()
    sd = {k: torch.from_numpy(np.array(v)) for k, v in jpth.export_rwkv_state_dict(tree).items()}
    assert detect_rwkv_version(sd)["version"] == "x052"
    params = import_rwkv_state_dict(sd)
    out, _ = _logits(params, pc, ids)
    assert max_rel(to_np(out), ref) < TOL
    back = import_rwkv_state_dict(export_rwkv_state_dict(params))
    assert torch.equal(_logits(back, pc, ids)[0], out)


def test_int8_and_strategies_serve(model):
    """int8 weights quantize the leaves the JAX package's
    ``quantize_lm_params`` does; a strategy string serves the family on the
    head and the flat state, bf16 carry included, with the same ids; the
    server's ids equal ``generate()``'s alone."""
    from visualrwkv_torch.infer.quant import quantize_lm_params
    from visualrwkv_torch.infer.server import BatchedServer
    from visualrwkv_torch.infer.strategy import make_engine
    from visualrwkv_tpu.infer.quant import quantize_lm_params as jq

    tree, params, ids, _ = model
    _, pc = _cfgs()

    def paths(node, path=""):
        if isinstance(node, dict):
            if "weight_q" in node:
                return {path}
            return set().union(*(paths(v, f"{path}.{k}") for k, v in node.items()))
        if isinstance(node, list):
            return set().union(*(paths(v, f"{path}[{i}]") for i, v in enumerate(node)))
        return set()

    q = quantize_lm_params(params, min_size=4096)
    assert paths(q) == paths(jq(jax.tree_util.tree_map(jnp.asarray, tree), min_size=4096))
    assert len(paths(q)) == 17  # 5 TimeMix + 3 ChannelMix linears of 2 blocks, and the head
    cfg = _vlm(pc)
    prompt = ids[:1, :20]
    ref = make_engine({"rwkv": params}, cfg, "cpu fp32").generate(prompt, max_new_tokens=6,
                                                                   stop_tokens=())
    for s in ("cpu fp32 flat", "cpu fp32 s16", "cpu fp32 s16 flat"):
        got = make_engine({"rwkv": params}, cfg, s).generate(prompt, max_new_tokens=6, stop_tokens=())
        np.testing.assert_array_equal(got.tokens, ref.tokens, err_msg=s)
    eng = make_engine({"rwkv": params}, cfg, "cpu fp32i8")
    assert eng.generate(prompt, max_new_tokens=6, stop_tokens=()).tokens.shape == (1, 6)
    server = BatchedServer(make_engine({"rwkv": params}, cfg, "cpu fp32"), max_batch=2,
                           stop_tokens=())
    rids = [server.submit(ids[i:i + 1, :12 + 4 * i], max_new_tokens=5) for i in range(2)]
    out = server.run()
    for i, rid in enumerate(rids):
        alone = make_engine({"rwkv": params}, cfg, "cpu fp32").generate(
            ids[i:i + 1, :12 + 4 * i], max_new_tokens=5, stop_tokens=())
        assert out[rid] == alone.tokens[0].tolist()
