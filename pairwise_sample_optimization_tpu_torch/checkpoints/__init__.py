"""Weight carry from the JAX package's param trees, train-state checkpoints and
the LoRA safetensors export."""

from .convert import state_dict_from_jax
from .lora_safetensors import LORA_FILE, export_lora_safetensors
from .safetensors_io import load_file, save_file
from .scorer_loaders import load_aesthetic_mlp
from .train_state_io import (
    latest_checkpoint,
    prune_checkpoints,
    restore_train_state,
    save_train_state,
)
