"""Weight carry from the JAX package's param trees into the port."""

from .convert import state_dict_from_jax
