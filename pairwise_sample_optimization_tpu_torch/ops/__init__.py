"""Sampler numerics, the attention and GroupNorm seams, and the CUDA kernels.

Import from the submodules (``ops.attention``, ``ops.flash_attention``,
``ops.group_norm``, ...); several share a name with their main function.
``ddim_step_with_logprob`` (``ops.ddim``) is exported here too.
"""

from .ddim import ddim_step_with_logprob

__all__ = ["ddim_step_with_logprob"]
