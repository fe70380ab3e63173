"""VisualRWKV in PyTorch and CUDA for NVIDIA Hopper (H100).

The port of ``visualrwkv_tpu`` (JAX on TPU). Plain tensor code is PyTorch;
the kernels that the JAX package wrote in Pallas are hand-written CUDA C++
under ``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use
(``visualrwkv_torch.cuda_build``). Every kernel wrapper runs its plain
PyTorch version for CPU tensors and launches its kernel for CUDA tensors.

The layout mirrors the JAX package: ``config``, ``data``, ``ops``,
``vision``, ``multimodal``, ``models``, ``infer`` and ``convert``.
"""
