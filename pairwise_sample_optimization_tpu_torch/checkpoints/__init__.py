"""Weight carry from the JAX package's param trees, and train-state checkpoints."""

from .convert import state_dict_from_jax
from .scorer_loaders import load_aesthetic_mlp
from .train_state_io import (
    latest_checkpoint,
    prune_checkpoints,
    restore_train_state,
    save_train_state,
)
