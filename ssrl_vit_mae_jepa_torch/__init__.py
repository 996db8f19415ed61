"""PyTorch/CUDA port of ssrl_vit_mae_jepa_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's module paths and public names. The transformer
branches run as hand-written CUDA kernels (``csrc/``, built by ``_build``)
on CUDA tensors and as their plain PyTorch versions on CPU tensors.
Importing the package imports nothing.
"""
