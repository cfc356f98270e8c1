"""Sampler numerics, the attention and GroupNorm seams, and the CUDA kernels.

Import from the submodules (``ops.attention``, ``ops.flash_attention``,
``ops.group_norm``, ...); several share a name with their main function.
"""
