"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: configuration mirroring, numpy parameter trees, error measures."""

import dataclasses

import jax
import numpy as np

from visualrwkv_torch import config as pcfg
from visualrwkv_torch.vision.sam import SAMConfig as PortSAMConfig
from visualrwkv_torch.vision.vit import ViTConfig as PortViTConfig


def _mirror(obj, cls):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj) if f.name in names})


def port_tower_cfg(jcfg):
    """A JAX ViTConfig / SAMConfig -> the port's class with the same fields."""
    cls = PortSAMConfig if type(jcfg).__name__ == "SAMConfig" else PortViTConfig
    return _mirror(jcfg, cls)


def port_cfg(jcfg):
    """A JAX VLMConfig -> the port's VLMConfig with the same geometry."""
    jv = jcfg.vision
    overrides = None
    if jv.tower_config_overrides:
        overrides = {k: port_tower_cfg(v) for k, v in jv.tower_config_overrides.items()}
    vision = pcfg.VisionConfig(
        towers=jv.towers, image_size=jv.image_size, sam_image_size=jv.sam_image_size,
        dino_dim=jv.dino_dim, siglip_dim=jv.siglip_dim, sam_dim=jv.sam_dim,
        clip_dim=jv.clip_dim, tower_config_overrides=overrides,
    )
    return pcfg.VLMConfig(
        rwkv=_mirror(jcfg.rwkv, pcfg.RWKVConfig), vision=vision, proj_type=jcfg.proj_type,
        num_token_per_image=jcfg.num_token_per_image, grid_size=jcfg.grid_size,
        n_vtc_layer=jcfg.n_vtc_layer, bidirectional_image=jcfg.bidirectional_image,
        image_scanning=jcfg.image_scanning, uhd_fusion=jcfg.uhd_fusion,
        insertion_mode=jcfg.insertion_mode,
    )


def oracle_jit(fun):
    """``jax.jit`` for a test's JAX oracle, compiled at XLA's backend
    optimisation level 0: the same HLO program with less LLVM optimisation
    of its machine code (results agree to rounding), compiled in about 40%
    less time on the CPU, where these programs run once on small inputs."""
    return jax.jit(fun, compiler_options={"xla_backend_optimization_level": 0})


def np_tree(params):
    """A JAX parameter tree with numpy leaves."""
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)


def perturbed(tree, seed, scale=0.02):
    """Add seeded normal noise to every leaf, so zero-initialised weights
    (RWKV output / value projections, LoRA down-factors, biases) carry
    signal and every layout transpose matters."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    leaves = [(l + scale * rng.standard_normal(l.shape)).astype(np.float32) for l in leaves]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def max_rel(x, ref):
    """max |x - ref| / max |ref|."""
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def rel_rms(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(((x - ref) ** 2).sum() / max(1e-30, (ref**2).sum())))


def to_np(t):
    """A torch tensor -> numpy fp32."""
    return t.detach().float().cpu().numpy()


def grads_numpy(params, loss_fn, pcfg):
    """The loss and its gradient with respect to every leaf of ``params``
    outside the vision towers, as a JAX-layout numpy tree (the towers' leaves
    zero). ``loss_fn(params)`` -> a 0-d tensor."""
    import torch

    from visualrwkv_torch.convert.from_jax import params_to_numpy
    from visualrwkv_torch.train.optim import tree_map_with_path

    trainable = lambda path: path[0] != "vit"
    leaves = []

    def mark(path, p):
        if trainable(path):
            p.requires_grad_(True)
            leaves.append(p)
        return p

    tree_map_with_path(mark, params)
    loss = loss_fn(params)
    grads = iter(torch.autograd.grad(loss, leaves))
    gtree = tree_map_with_path(lambda path, p: next(grads) if trainable(path) else torch.zeros_like(p),
                               params)
    for p in leaves:
        p.requires_grad_(False)
    return float(loss.detach()), params_to_numpy(gtree, pcfg)


def assert_grads_match(port_grads, jax_grads, parts, tol):
    """Each leaf of ``parts`` within ``tol * max |ref|`` of JAX's, and JAX's
    not all zero."""
    for part in parts:
        flat_p = jax.tree_util.tree_leaves_with_path(port_grads[part])
        flat_j = jax.tree_util.tree_leaves(np_tree(jax_grads[part]))
        assert len(flat_p) == len(flat_j), part
        for (path, g), ref in zip(flat_p, flat_j):
            assert np.abs(ref).max() > 0, (part, jax.tree_util.keystr(path))
            assert max_rel(g, ref) < tol, (part, jax.tree_util.keystr(path), max_rel(g, ref))
