"""Training CLI. Counterpart of ``visualrwkv_tpu/train/cli.py``: the flags of
the reference ``train.py`` over the trainer, on one GPU or one process a GPU.
The two training stages (pretrain, finetune) are the same invocation with
different freeze flags.

    python -m visualrwkv_torch.train.cli --dummy            # tiny run on the card
    python -m visualrwkv_torch.train.cli --dummy --device cpu
    torchrun --nproc_per_node 8 -m visualrwkv_torch.train.cli --n_seq 2 ...  # data=4 x seq=2

Several processes join one process group (NCCL on the GPUs, gloo with
``--device cpu``): from torchrun's variables, or from
``--coordinator_address`` / ``--num_nodes`` (the process count) /
``--node_rank`` or the ``VRWKV_*`` variables
(:mod:`visualrwkv_torch.parallel.distributed`). ``--n_data`` (default: the
process count over ``--n_seq``) and ``--n_seq`` shape the mesh; the global
batch is ``micro_bsz * n_data * accumulate_grad_batches`` and each data
rank reads its own rows of the dataset.

``--dummy`` synthesises a tiny dataset with random images on the fly (it needs
PIL) and trains a 2-layer, 128-wide model with tiny towers for 4 steps.
``--wkv_impl`` selects the WKV implementation (``ops.wkv7.set_wkv_impl``) and
``--remat`` the checkpoint policy (``grad_cp``). Flags that select paths the
port does not have are parsed and raise when used.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from pathlib import Path

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("visualrwkv_torch.train")
    p.add_argument("--data_file", default="", type=str)
    p.add_argument("--image_folder", default="", type=str)
    p.add_argument("--proj_dir", default="out", type=str)
    p.add_argument("--model_path", default="", type=str,
                   help="a reference RWKV .pth whose LM weights replace the initialised ones")
    p.add_argument("--device", default="cuda", type=str, help="cuda (default) or cpu")
    p.add_argument("--vocab_size", default=65536, type=int)
    p.add_argument("--n_layer", default=12, type=int)
    p.add_argument("--n_embd", default=768, type=int)
    p.add_argument("--ctx_len", default=2048, type=int)
    p.add_argument("--head_size_a", default=64, type=int)
    p.add_argument("--proj_type", default="mlp", choices=["linear", "mlp"])
    p.add_argument("--num_token_per_image", default=1024, type=int)
    p.add_argument("--vision_towers", default="dino,siglip,sam", type=str)
    p.add_argument("--image_position", default="first", choices=["first", "middle", "last"])
    p.add_argument("--micro_bsz", default=2, type=int)
    p.add_argument("--accumulate_grad_batches", default=1, type=int)
    p.add_argument("--epoch_steps", default=1000, type=int)
    p.add_argument("--epoch_count", default=2, type=int)
    p.add_argument("--epoch_begin", default=0, type=int)
    p.add_argument("--epoch_save", default=1, type=int)
    p.add_argument("--lr_init", default=6e-4, type=float)
    p.add_argument("--lr_final", default=1e-5, type=float)
    p.add_argument("--warmup_steps", default=-1, type=int)
    p.add_argument("--beta1", default=0.9, type=float)
    p.add_argument("--beta2", default=0.99, type=float)
    p.add_argument("--adam_eps", default=1e-8, type=float)
    p.add_argument("--weight_decay", default=0.0, type=float)
    p.add_argument("--weight_decay_final", default=-1.0, type=float)
    p.add_argument("--grad_cp", default=1, type=int)
    p.add_argument("--remat", default="", choices=["", "none", "full", "dots", "wkv"],
                   help="activation checkpointing policy (overrides --grad_cp): full per-block, "
                   "or selective keeping the projections' products (dots) or the WKV outputs (wkv)")
    p.add_argument("--grad_clip", default=1.0, type=float)
    p.add_argument("--freeze_rwkv", default=0, type=int, help="freeze first N layers")
    p.add_argument("--freeze_emb", default=0, type=int)
    p.add_argument("--freeze_proj", default=0, type=int)
    p.add_argument("--zero_stage", default=1, type=int)
    p.add_argument("--n_data", default=None, type=int,
                   help="data-parallel size (default: the process count over --n_seq)")
    p.add_argument("--n_seq", default=1, type=int,
                   help="context-parallel size (tokens split on T; x070/x060, scatter-insertion image "
                   "batches, see ops/wkv_sp.py)")
    p.add_argument("--num_nodes", default=1, type=int,
                   help="process count of a run started without torchrun (one process a GPU)")
    p.add_argument("--coordinator_address", default="", type=str,
                   help="host:port of process 0 (or VRWKV_COORDINATOR_ADDRESS, or torchrun's "
                   "MASTER_ADDR / MASTER_PORT); empty: one process")
    p.add_argument("--node_rank", default=-1, type=int,
                   help="this process's id (or VRWKV_PROCESS_ID, or torchrun's RANK)")
    p.add_argument("--dummy", action="store_true", help="dummy-data smoke run")
    p.add_argument("--dtype", default="bfloat16", type=str)
    p.add_argument("--wkv_impl", default="auto", choices=["auto", "pallas", "chunked", "packed"],
                   help="WKV implementation: auto and pallas the head-layout CUDA kernels, packed "
                   "the head-pair kernels, chunked the plain chunked form (the plain versions on "
                   "the CPU)")
    p.add_argument("--chunk_len", default=16, type=int, help="WKV chunk length (T is padded to it)")
    p.add_argument("--param_dtype", default="float32", choices=["float32", "bfloat16", "float16"],
                   help="parameter storage dtype; below fp32 keeps fp32 masters in the optimizer")
    p.add_argument("--optim_precision", default="master_fp32", choices=["master_fp32", "bf16_sr"])
    p.add_argument("--stacked_layers", default=0, type=int, help="accepted and ignored")
    p.add_argument("--split_step", default=-1, type=int, help="accepted and ignored")
    return p


def check_ported(args) -> None:
    """Refuses nothing: every configuration these flags express runs in the
    port (tensor parallelism is reached through ``Trainer(mesh=make_mesh(
    n_model=...))``, as in the JAX package, whose CLI has no ``--n_model``
    either, and the offloaded optimizer runs over several data ranks). Kept
    for callers that check a namespace before they build from it."""


def load_lm_weights(init, loaded, where: str = "rwkv"):
    """``loaded`` (an imported checkpoint's LM) in place of the leaves of
    ``init``, on their device and in their dtype. Raises ``ValueError`` when
    the structure or any shape differs: the checkpoint's geometry must be
    the one the flags configure."""
    if isinstance(init, dict):
        if not isinstance(loaded, dict) or set(init) != set(loaded):
            got = sorted(loaded) if isinstance(loaded, dict) else type(loaded).__name__
            raise ValueError(f"{where}: the checkpoint has {got}, the model {sorted(init)}")
        return {k: load_lm_weights(init[k], loaded[k], f"{where}.{k}") for k in init}
    if isinstance(init, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) or len(init) != len(loaded):
            got = len(loaded) if isinstance(loaded, (list, tuple)) else type(loaded).__name__
            raise ValueError(f"{where}: the checkpoint has {got} entries, the model {len(init)}")
        return [load_lm_weights(a, b, f"{where}[{i}]") for i, (a, b) in enumerate(zip(init, loaded))]
    if tuple(init.shape) != tuple(loaded.shape):
        raise ValueError(f"{where}: the checkpoint's shape {tuple(loaded.shape)} is not the "
                         f"model's {tuple(init.shape)}")
    return loaded.to(device=init.device, dtype=init.dtype)


def make_configs(args):
    from visualrwkv_torch.config import RWKVConfig, TrainConfig, VisionConfig, VLMConfig

    towers = tuple(t for t in args.vision_towers.split(",") if t)
    vlm_cfg = VLMConfig(
        rwkv=RWKVConfig(
            n_layer=args.n_layer, n_embd=args.n_embd, vocab_size=args.vocab_size,
            head_size=args.head_size_a, ctx_len=args.ctx_len, compute_dtype=args.dtype,
            chunk_len=args.chunk_len,
        ),
        vision=VisionConfig(towers=towers),
        proj_type=args.proj_type,
        num_token_per_image=args.num_token_per_image,
    )
    tcfg = TrainConfig(
        lr_init=args.lr_init, lr_final=args.lr_final, warmup_steps=args.warmup_steps,
        beta1=args.beta1, beta2=args.beta2, adam_eps=args.adam_eps,
        weight_decay=args.weight_decay, weight_decay_final=args.weight_decay_final,
        grad_clip=args.grad_clip, micro_bsz=args.micro_bsz,
        accumulate_grad_batches=args.accumulate_grad_batches,
        epoch_steps=args.epoch_steps, epoch_count=args.epoch_count,
        epoch_begin=args.epoch_begin, epoch_save=args.epoch_save,
        grad_cp={"": bool(args.grad_cp), "none": False, "full": True,
                 "dots": "dots", "wkv": "wkv"}[args.remat],
        freeze_rwkv_layers=args.freeze_rwkv,
        freeze_emb=bool(args.freeze_emb), freeze_proj=bool(args.freeze_proj),
        zero_stage=args.zero_stage, param_dtype=args.param_dtype,
        optim_precision=args.optim_precision,
        stacked_layers=bool(args.stacked_layers),
        split_step=None if args.split_step < 0 else bool(args.split_step),
    )
    return vlm_cfg, tcfg


def make_dummy(args, tmp_dir: Path, write: bool = True):
    """Synthesise a tiny LLaVA-format dataset + images (``write=False``:
    only point ``args`` at them, for the processes that wait for rank 0)."""
    from PIL import Image

    img_dir = tmp_dir / "images"
    data_file = tmp_dir / "dummy.json"
    args.data_file = str(data_file)
    args.image_folder = str(img_dir)
    if not write:
        return args
    img_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    records = []
    for i in range(16):
        name = f"img_{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(img_dir / name)
        records.append({
            "id": f"dummy_{i}",
            "image": name,
            "conversations": [
                {"from": "human", "value": f"<image>\nWhat number is this? {i}"},
                {"from": "gpt", "value": f"This is number {i}."},
            ],
        })
    data_file.write_text(json.dumps(records))
    return args


def apply_dummy_overrides(args):
    args.n_layer = 2
    args.n_embd = 128
    args.ctx_len = 128
    args.num_token_per_image = 16
    args.epoch_steps = 4
    args.epoch_count = 1
    args.micro_bsz = 2
    args.vision_towers = "dino,siglip,sam"
    return args


def dummy_vision_config():
    """Tiny towers, so that the dummy run is fast on any device."""
    from visualrwkv_torch.config import VisionConfig
    from visualrwkv_torch.vision.sam import SAMConfig
    from visualrwkv_torch.vision.vit import ViTConfig

    overrides = {
        "dino": ViTConfig(img_size=64, patch_size=8, width=64, depth=2, heads=4,
                          mlp_dim=128, use_cls=True, num_reg=4, layerscale=True),
        "siglip": ViTConfig(img_size=64, patch_size=8, width=64, depth=2, heads=4,
                            mlp_dim=128, act="gelu_tanh", use_cls=False),
        "sam": SAMConfig(img_size=128, patch_size=8, width=64, depth=2, heads=4,
                         mlp_dim=128, out_chans=32, window_size=4, global_attn_indexes=(1,)),
    }
    return VisionConfig(towers=("dino", "siglip", "sam"), image_size=64, sam_image_size=128,
                        dino_dim=64, siglip_dim=64, sam_dim=128, tower_config_overrides=overrides)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_argparser().parse_args(argv)
    from visualrwkv_torch.parallel import distributed
    from visualrwkv_torch.parallel.mesh import axis_index, axis_size, make_mesh

    distributed.initialize(  # no-op unless flags or the environment ask for several processes
        coordinator_address=args.coordinator_address or None,
        num_processes=args.num_nodes if args.num_nodes > 1 else None,
        process_id=args.node_rank if args.node_rank >= 0 else None,
        device=args.device,
    )
    device = distributed.device_for(args.device)
    rank0 = distributed.process_index() == 0
    mesh = make_mesh(n_data=args.n_data, n_seq=args.n_seq)
    os.makedirs(args.proj_dir, exist_ok=True)
    if args.dummy:
        args = apply_dummy_overrides(args)
        args = make_dummy(args, Path(args.proj_dir) / "dummy_data", write=rank0)
        if mesh is not None:
            import torch.distributed as dist

            dist.barrier()  # rank 0 has written the dummy data

    from visualrwkv_torch.data.dataset import DatasetConfig, VisualRWKVDataset, batches_for_epoch
    from visualrwkv_torch.data.tokenizer import get_tokenizer
    from visualrwkv_torch.models.visualrwkv import init_visualrwkv_params
    from visualrwkv_torch.ops.wkv7 import set_wkv_impl
    from visualrwkv_torch.train.trainer import Trainer

    set_wkv_impl(args.wkv_impl)
    vlm_cfg, tcfg = make_configs(args)
    if args.dummy:
        vlm_cfg = vlm_cfg.replace(vision=dummy_vision_config())

    tok = get_tokenizer()
    if args.vocab_size < tok.vocab_size:
        logging.warning(
            "vocab_size %d is smaller than the tokenizer's %d: token ids beyond the head are "
            "CLAMPED in the loss (finite but wrong); use the full vocab for real training",
            args.vocab_size, tok.vocab_size,
        )
    params = init_visualrwkv_params(vlm_cfg, seed=0, device=device)  # the same on every rank
    if args.model_path:  # a reference .pth: its LM replaces the initialised one
        from visualrwkv_torch.convert.pth_import import import_rwkv_state_dict, load_pth

        params["rwkv"] = load_lm_weights(params["rwkv"], import_rwkv_state_dict(load_pth(args.model_path)))
        logging.info("loaded RWKV weights from %s", args.model_path)
    trainer = Trainer(vlm_cfg, tcfg, params, device=device, proj_dir=args.proj_dir, log_every=1,
                      mesh=mesh)
    del params  # the fp32 init tree must not outlive the trainer's cast copy

    # reference real_bsz = nodes * devices * micro_bsz (train.py:98): the
    # global batch is micro_bsz * n_data * accumulate_grad_batches, and each
    # data rank reads its own rows (the ranks of one seq group the same rows)
    n_data = axis_size(mesh, "data")
    ds_cfg = DatasetConfig(
        data_file=args.data_file, image_folder=args.image_folder,
        ctx_len=args.ctx_len, num_token_per_image=args.num_token_per_image,
        epoch_steps=args.epoch_steps, micro_bsz=args.micro_bsz * args.accumulate_grad_batches,
        image_position=args.image_position,
        towers=tuple(vlm_cfg.vision.towers),
        tower_sizes={"dino": vlm_cfg.vision.image_size, "siglip": vlm_cfg.vision.image_size,
                     "sam": vlm_cfg.vision.sam_image_size},
    )
    dataset = VisualRWKVDataset(ds_cfg, tok, world_size=n_data, rank=axis_index(mesh, "data"))
    if rank0:
        logging.info("global batch %d (micro_bsz %d x data %d x accumulate %d), seq %d",
                     args.micro_bsz * n_data * args.accumulate_grad_batches, args.micro_bsz, n_data,
                     args.accumulate_grad_batches, axis_size(mesh, "seq"))

    for epoch in range(args.epoch_begin, args.epoch_begin + args.epoch_count):
        loss = trainer.run_epoch(batches_for_epoch(dataset, epoch), epoch)
        if rank0:
            logging.info("epoch %d done, loss %.4f", epoch, loss)
        periodic = args.epoch_save > 0 and (epoch + 1) % args.epoch_save == 0
        if periodic or epoch == args.epoch_begin + args.epoch_count - 1:
            path = str(Path(args.proj_dir).absolute() / f"rwkv-{epoch}.pth")
            trainer.save_checkpoint(path)  # every rank: the ZeRO parts are gathered
            if rank0:
                logging.info("saved checkpoint %s", path)
    return trainer


if __name__ == "__main__":
    from visualrwkv_torch.parallel import distributed as _distributed

    main()
    _distributed.shutdown()
