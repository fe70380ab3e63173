"""A rank of the port's multi-process tests (``tests/test_torch_parallel*.py``).

    python tests/torch_parallel_worker.py <suite> <rank> <world> <init_file> <out_dir>

Joins a gloo process group on the CPU through ``file://<init_file>`` (no
port to race for), runs the suite's cases on one torch thread and writes
``<out_dir>/<suite>_<rank>.npz``. It imports torch, numpy and the port only,
never JAX: the test process builds the same inputs with the functions here
and holds the ranks' results against the one-process port and the JAX
package.

Suites: ``seq`` (2 ranks, seq=2: the WKV7 / WKV6 rings, the context-parallel
forwards, ``training_loss_seq``, the L2Wrap injection), ``data`` (2 ranks,
data=2: trainer steps at ``zero_stage`` 1 and 3 with checkpoints, a
``bf16_sr`` step at ``zero_stage`` 0, 1 and 3, the L2Wrap injection), ``mesh4`` (4 ranks, data=2 x seq=2: trainer steps).
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from visualrwkv_torch.config import IGNORE_INDEX, IMAGE_TOKEN_INDEX, RWKVConfig, TrainConfig, VisionConfig, VLMConfig  # noqa: E402
from visualrwkv_torch.vision.vit import ViTConfig  # noqa: E402

SEQ_T = 64
TRAIN_T = 64
RING_SHAPE = (2, 64, 2, 32)  # B, T, H, N
L2_SHAPE = (4, 64, 64, 512)  # B, T, C, V
ZERO_STAGES = (1, 3)


# ---------------------------------------------------------------------------
# Inputs, the same in every process
# ---------------------------------------------------------------------------


def seq_cfg(version: str = "x070") -> VLMConfig:
    """``tests/test_train.py``'s tiny model at T = 64, fp32."""
    tower = ViTConfig(img_size=16, patch_size=8, width=32, depth=1, heads=2, mlp_dim=64,
                      use_cls=False, num_reg=0, layerscale=False)
    return VLMConfig(
        rwkv=RWKVConfig(n_layer=2, n_embd=64, vocab_size=66000, head_size=32,
                        compute_dtype="float32", ctx_len=SEQ_T, version=version),
        vision=VisionConfig(towers=("dino",), image_size=16, dino_dim=32,
                            tower_config_overrides={"dino": tower}),
        proj_type="linear", num_token_per_image=4,
    )


def train_cfg() -> VLMConfig:
    """``__graft_entry__._tiny_vlm_cfg(n_layer=2, n_embd=128)`` in fp32 at
    T = 64 (the ffn's 512 x 128 leaves are big enough for ZeRO to split)."""
    dino = ViTConfig(img_size=64, patch_size=8, width=128, depth=2, heads=4, mlp_dim=256,
                     use_cls=True, num_reg=4, layerscale=True)
    return VLMConfig(
        rwkv=RWKVConfig(n_layer=2, n_embd=128, vocab_size=65536, head_size=64,
                        compute_dtype="float32", ctx_len=TRAIN_T),
        vision=VisionConfig(towers=("dino",), image_size=64, dino_dim=128,
                            tower_config_overrides={"dino": dino}),
        proj_type="mlp", num_token_per_image=16,
    )


def trainer_cfg(zero_stage: int, **kw) -> TrainConfig:
    base = dict(lr_init=1e-3, lr_final=1e-4, warmup_steps=1, weight_decay=0.01, epoch_steps=2,
                epoch_count=1, micro_bsz=1, accumulate_grad_batches=2, grad_cp=True,
                grad_clip=1.0, ce_chunk_t=16, zero_stage=zero_stage)
    base.update(kw)
    return TrainConfig(**base)


def model_params(cfg: VLMConfig, seed: int = 0):
    """The seeded init with seeded noise on every leaf, so that the
    zero-initialised projections carry signal."""
    from visualrwkv_torch.models.visualrwkv import init_visualrwkv_params
    from visualrwkv_torch.train.optim import tree_map

    params = init_visualrwkv_params(cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed + 100)
    return tree_map(lambda p: p + torch.from_numpy(0.02 * rng.standard_normal(tuple(p.shape))).float(),
                    params)


def text_batch(seed: int, bsz: int, T: int, vocab: int = 2000):
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, vocab, (bsz, T)).astype(np.int64)
    labels = ids.copy()
    labels[:, :4] = IGNORE_INDEX
    return {"input_ids": ids, "labels": labels}


def image_batch(seed: int, bsz: int, cfg: VLMConfig, T: int = TRAIN_T):
    rng = np.random.default_rng(seed)
    n = cfg.num_token_per_image
    ids = rng.integers(10, 2000, (bsz, T)).astype(np.int64)
    ids[:, 2:2 + n] = IMAGE_TOKEN_INDEX
    labels = np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids)
    labels[:, 2 + n:2 + n + 3] = IGNORE_INDEX
    size = cfg.vision.image_size
    return {"input_ids": ids, "labels": labels,
            "images": {"dino": rng.integers(0, 256, (bsz, size, size, 3)).astype(np.uint8)}}


def ring_inputs(family: str, with_state: bool, seed: int = 7):
    """Model-like WKV streams [B, T, H, N] (fp32): the decay below -0.5,
    ``a = -kk``, ``b = kk * gate`` with ``kk`` unit per head; the cotangents
    of y and of the final state; an initial state when asked."""
    B, T, H, N = RING_SHAPE
    rng = np.random.default_rng(seed + (10 if family == "wkv6" else 0) + int(with_state))
    f = lambda *s: torch.from_numpy(rng.standard_normal(s)).float()
    ins = {"r": 0.5 * f(B, T, H, N), "k": 0.5 * f(B, T, H, N), "v": 0.5 * f(B, T, H, N)}
    ins["w_raw"] = -torch.nn.functional.softplus(f(B, T, H, N)) - 0.5
    if family == "wkv7":
        kk = f(B, T, H, N)
        kk = kk / kk.norm(dim=-1, keepdim=True)
        ins["a"], ins["b"] = -kk, kk * torch.sigmoid(f(B, T, H, N))
    else:
        ins["u"] = 0.5 * f(H, N)
    ins["s0"] = 0.1 * f(B, H, N, N) if with_state else None
    cot = {"y": f(B, T, H, N), "s": f(B, H, N, N)}
    return ins, cot


RING_ORDER = {"wkv7": ("r", "w_raw", "k", "v", "a", "b"), "wkv6": ("r", "w_raw", "k", "v", "u")}


def l2_inputs(seed: int = 11):
    """A hidden state and a head whose CE term is 0: every label ignored."""
    B, T, C, V = L2_SHAPE
    rng = np.random.default_rng(seed)
    hidden = torch.from_numpy(rng.standard_normal((B, T, C))).float()
    head = torch.from_numpy(0.2 * rng.standard_normal((V, C))).float()
    return hidden, head, np.full((B, T), IGNORE_INDEX, np.int64)


def flat(tree, prefix=""):
    """{"a/b/0/c": numpy} of a tree of tensors (None leaves dropped)."""
    from visualrwkv_torch.train.optim import tree_leaves_with_path

    return {prefix + "/".join(map(str, p)): t.detach().float().numpy()
            for p, t in tree_leaves_with_path(tree) if t is not None}


# ---------------------------------------------------------------------------
# Suites
# ---------------------------------------------------------------------------


def _ring(out, group, seq_index, n_seq):
    from visualrwkv_torch.ops.wkv_sp import wkv6_seq_shard, wkv7_seq_shard

    for family in ("wkv7", "wkv6"):
        for with_state in (False, True):
            ins, cot = ring_inputs(family, with_state)
            tag = f"ring_{family}_{int(with_state)}"
            part = lambda x: x.chunk(n_seq, dim=1)[seq_index]
            leaves = {k: (x if k == "u" else part(x)).clone().requires_grad_(True)
                      for k, x in ins.items() if k != "s0"}
            s0 = None if ins["s0"] is None else ins["s0"].clone().requires_grad_(True)
            fn = wkv7_seq_shard if family == "wkv7" else wkv6_seq_shard
            y, s = fn(*(leaves[k] for k in RING_ORDER[family]), initial_state=s0, chunk=16, group=group)
            loss = (y * part(cot["y"])).sum() + (s * cot["s"]).sum()
            loss.backward()
            out[f"{tag}/y"], out[f"{tag}/s"] = y.detach().numpy(), s.detach().numpy()
            for k, x in leaves.items():
                out[f"{tag}/d{k}"] = x.grad.numpy()
            if s0 is not None:
                out[f"{tag}/ds0"] = s0.grad.numpy()


def _forward_seq(out, group, mesh):
    from visualrwkv_torch.models import rwkv6, rwkv7
    from visualrwkv_torch.parallel.mesh import seq_range
    from visualrwkv_torch.train.optim import tree_map

    for version in ("x070", "x060"):
        cfg = seq_cfg(version)
        params = model_params(cfg)
        ids = torch.from_numpy(text_batch(3, 2, SEQ_T)["input_ids"])
        fwd = rwkv7.rwkv7_forward_seq if version == "x070" else rwkv6.rwkv6_forward_seq
        c = torch.from_numpy(np.random.default_rng(5).standard_normal((2, SEQ_T, cfg.rwkv.n_embd))).float()
        for grad_cp in (False, True):
            p = tree_map(lambda t: t.clone().requires_grad_(True), params["rwkv"])
            x = seq_range(rwkv7.embed(p, ids), mesh)
            hidden = fwd(p, cfg.rwkv, x, group=group, grad_cp=grad_cp, return_hidden=True)
            (hidden * seq_range(c, mesh)).sum().backward()
            tag = f"fwd_{version}_{int(grad_cp)}"
            out[f"{tag}/hidden"] = hidden.detach().numpy()
            with torch.no_grad():
                out[f"{tag}/logits"] = rwkv7.linear(p["head"], hidden, cfg.rwkv.dtype)[..., :512].numpy()
            out.update(flat(tree_map(lambda t: t.grad, p), f"{tag}/grad/"))


def _loss_seq(out, group, mesh):
    from visualrwkv_torch.models.visualrwkv import training_loss_seq
    from visualrwkv_torch.parallel.mesh import seq_range
    from visualrwkv_torch.train.optim import tree_map
    from visualrwkv_torch.train.trainer import shift_labels

    for version in ("x070", "x060"):
        cfg = seq_cfg(version)
        params = tree_map(lambda t: t.requires_grad_(True), model_params(cfg))
        b = text_batch(4, 4, SEQ_T)
        loss = training_loss_seq(params, cfg, seq_range(b["input_ids"], mesh),
                                 seq_range(shift_labels(b["labels"]), mesh), grad_cp=False,
                                 ce_chunk_t=16, seq_group=group, device="cpu")
        loss.backward()
        tag = f"loss_{version}"
        out[f"{tag}/loss"] = loss.detach().numpy()
        out.update(flat(tree_map(lambda t: t.grad, params["rwkv"]), f"{tag}/grad/"))


def _l2_only(out, mesh):
    """The L2Wrap injection alone (every label ignored): the head's and the
    hidden state's gradients on this rank, through the loss each axis runs."""
    import torch.distributed as dist

    from visualrwkv_torch.models.visualrwkv import chunked_ce_l2wrap, chunked_ce_l2wrap_sp
    from visualrwkv_torch.parallel.collectives import all_reduce_replicated, reduce_gradients
    from visualrwkv_torch.parallel.mesh import axis_group, axis_size, data_rows, seq_range
    from visualrwkv_torch.train.trainer import shift_labels

    hidden, head, labels = l2_inputs()
    rows = data_rows({"h": hidden, "l": labels}, mesh)
    h = seq_range(rows["h"], mesh).clone().requires_grad_(True)
    w = head.clone().requires_grad_(True)
    if axis_size(mesh, "seq") > 1:
        local = chunked_ce_l2wrap_sp(16, w, h, torch.as_tensor(seq_range(shift_labels(rows["l"]), mesh)),
                                     axis_group(mesh, "seq"))
    else:
        local = chunked_ce_l2wrap(16, w, h, torch.from_numpy(rows["l"]))
    all_reduce_replicated(local, axis_group(mesh, "data"), mean=True).backward()
    g = w.grad.contiguous()
    reduce_gradients([g], dist.group.WORLD, divide=axis_size(mesh, "data"))
    out["l2/dhead"], out["l2/dhidden"] = g.numpy(), h.grad.numpy()


def _trainer_runs(out, mesh, cfg, out_dir, rows_per_rank, tag0, ckpt=True):
    """At each ZeRO stage: the first step's reduced gradients, two steps'
    losses and parameters, the parts each rank keeps, and (``ckpt``) a
    checkpoint after step 1 resumed by a fresh trainer."""
    from visualrwkv_torch.parallel.collectives import all_gather_along
    from visualrwkv_torch.parallel.mesh import axis_size, data_rows
    from visualrwkv_torch.train.optim import tree_leaves, tree_leaves_with_path
    from visualrwkv_torch.train.trainer import Trainer

    n_data = axis_size(mesh, "data")
    batches = [data_rows(image_batch(20 + s, rows_per_rank * n_data, cfg), mesh) for s in range(2)]
    for zero in ZERO_STAGES:
        tag = f"{tag0}{zero}"
        make = lambda: Trainer(cfg, trainer_cfg(zero), model_params(cfg), device="cpu",
                               proj_dir=os.path.join(out_dir, f"{tag}_{torch.distributed.get_rank()}"),
                               log_every=1, mesh=mesh)
        tr = make()
        z = tr.zero
        paths = [p for p, _ in tree_leaves_with_path(tr.params)]
        axes = tree_leaves(z.axes)
        out[f"{tag}/split"] = np.array(["/".join(map(str, p)) for p, ax in zip(paths, axes) if ax is not None])
        # the parts each rank keeps: ZeRO-1 the optimizer state, ZeRO-3 the parameters too
        whole = [tuple(p.shape) for p in tree_leaves(model_params(cfg))]
        parts = [shape if ax is None else tuple(s // n_data if i == ax else s for i, s in enumerate(shape))
                 for shape, ax in zip(whole, axes)]
        mu = tree_leaves(tr.state.opt_state.mu)  # None at the frozen leaves
        for p, shape, part, m in zip(tree_leaves(tr.params), whole, parts, mu):
            assert tuple(p.shape) == (part if zero >= 3 else shape), (tag, p.shape, part)
            assert m is None or tuple(m.shape) == part, (tag, m.shape, part)
        loss, grads = tr.loss_and_reduced_grads(batches[0])
        grads = [g if id(p) not in tr._split else all_gather_along(g, tr._split[id(p)], z.group)
                 for g, p in zip(grads, tr.leaves)]
        names = ["/".join(map(str, p)) for p, t in zip(paths, tree_leaves(tr.opt.train_mask)) if t]
        out.update({f"{tag}/grad1/{n}": g.numpy() for n, g in zip(names, grads)})
        losses = [float(tr.train_step(batches[0]))]
        path = os.path.join(out_dir, f"{tag}.pth")
        if ckpt:
            tr.save_checkpoint(path)
        losses.append(float(tr.train_step(batches[1])))
        out[f"{tag}/losses"] = np.array(losses)
        out[f"{tag}/shapes_after"] = np.array([tuple(p.shape) == (part if zero >= 3 else shape)
                                               for p, shape, part in zip(tree_leaves(tr.params), whole, parts)])
        out[f"{tag}/logged"] = np.array([os.path.exists(os.path.join(tr.proj_dir, "train_log.txt")),
                                         len(tr.history)])
        final = tr.full_params()
        out.update(flat(final, f"{tag}/params/"))
        if ckpt:
            again = make()
            again.load_checkpoint(path)
            again.train_step(batches[1])
            resumed = again.full_params()
            out[f"{tag}/resumed_equal"] = np.array(all(
                torch.equal(a, b) for a, b in zip(tree_leaves(final), tree_leaves(resumed))))


def _sr_runs(out, mesh, cfg, out_dir, rows_per_rank):
    """One ``bf16_sr`` step (bf16 parameters, stochastic rounding, no
    masters) without ZeRO and at each ZeRO stage: the whole parameters after
    it, and the leaves split over the data ranks. One micro-batch a step:
    ZeRO-3 reduce-scatters each micro-batch's gradient in its backward and
    rounds it to bf16 there, where without ZeRO the bf16 sum of the
    micro-batches is reduced once, so with several the gradients would
    differ in their last bit before the update this holds."""
    from visualrwkv_torch.parallel.mesh import axis_size, data_rows
    from visualrwkv_torch.train.optim import tree_leaves, tree_leaves_with_path
    from visualrwkv_torch.train.trainer import Trainer

    batch = data_rows(image_batch(20, rows_per_rank * axis_size(mesh, "data"), cfg), mesh)
    for zero in (0, *ZERO_STAGES):
        tr = Trainer(cfg, trainer_cfg(zero, param_dtype="bfloat16", optim_precision="bf16_sr",
                                 micro_bsz=rows_per_rank, accumulate_grad_batches=1),
                     model_params(cfg), device="cpu", mesh=mesh,
                     proj_dir=os.path.join(out_dir, f"sr{zero}_{torch.distributed.get_rank()}"))
        if tr.zero is not None:
            out[f"sr{zero}/split"] = np.array(["/".join(map(str, p)) for (p, t), ax in zip(
                tree_leaves_with_path(tr.params), tree_leaves(tr.zero.axes))
                if ax is not None and t.dtype == torch.bfloat16])
        tr.train_step(batch)
        out.update(flat(tr.full_params(), f"sr{zero}/params/"))


def main():
    suite, rank, world, init_file, out_dir = sys.argv[1], *map(int, sys.argv[2:4]), *sys.argv[4:6]
    torch.set_num_threads(1)
    from visualrwkv_torch.parallel import distributed
    from visualrwkv_torch.parallel.mesh import axis_group, axis_index, axis_size, make_mesh

    distributed.initialize(num_processes=world, process_id=rank, device="cpu",
                           init_method=f"file://{init_file}")
    out = {}
    if suite == "seq":
        mesh = make_mesh(n_data=1, n_seq=2)
        group = axis_group(mesh, "seq")
        _ring(out, group, axis_index(mesh, "seq"), axis_size(mesh, "seq"))
        _forward_seq(out, group, mesh)
        _loss_seq(out, group, mesh)
        _l2_only(out, mesh)
    elif suite == "data":
        mesh = make_mesh(n_data=2)
        _trainer_runs(out, mesh, train_cfg(), out_dir, 2, "zero")
        _sr_runs(out, mesh, train_cfg(), out_dir, 2)
        _l2_only(out, mesh)
    elif suite == "mesh4":
        mesh = make_mesh(n_data=2, n_seq=2)
        _trainer_runs(out, mesh, train_cfg(), out_dir, 2, "mesh4_zero", ckpt=False)
    else:
        raise SystemExit(f"unknown suite {suite!r}")
    np.savez(os.path.join(out_dir, f"{suite}_{rank}.npz"), **out)
    distributed.shutdown()


if __name__ == "__main__":
    main()
