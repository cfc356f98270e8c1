"""Pairwise Sample Optimization (PSO) in PyTorch for NVIDIA Hopper.

The PyTorch/CUDA counterpart of ``pairwise_sample_optimization_tpu``. The
module tree mirrors the JAX package (``ops/``, ``models/``, ``train/``,
``rewards/``, ``data/``, ``configs/``, ``cli/``, ``utils/``,
``checkpoints/``, ``pipeline.py``) so each counterpart is easy to find;
inside, it is PyTorch idiom: NCHW ``nn.Module``s whose ``state_dict`` keys
are the diffusers/HF keys.

The hot TPU kernels are hand-written CUDA C++ for ``sm_90a`` under
``csrc/`` (flash-attention forward and its dK/dV and dQ backward,
GroupNorm+SiLU stats and normalize), built with ``nvcc`` at first use and
bound through ``ctypes``. Each kernel has a plain PyTorch version beside
it, used for CPU tensors only.

Entry points take ``device=`` (default ``"cuda"``) and raise when CUDA is
missing unless the caller passes ``device="cpu"``.

This package imports no JAX and nothing of the JAX package.
"""

__version__ = "0.1.0"
