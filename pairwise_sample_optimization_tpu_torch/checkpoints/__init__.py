"""Released torch checkpoints in, weight carry from the JAX package's param
trees, train-state checkpoints and the LoRA safetensors export and import."""

from .clip_loader import is_openclip_format, load_clip_dual, openclip_to_hf_clip
from .convert import load_torch_state_dict, load_weights, state_dict_from_jax, tower_weight_file
from .lora_safetensors import (
    KOHYA_FILE,
    LORA_FILE,
    export_kohya_lora_safetensors,
    export_lora_safetensors,
    export_sdxl_lora_safetensors,
    import_lora_safetensors,
)
from .safetensors_io import load_file, save_file
from .scorer_loaders import load_aesthetic_mlp, load_clip_vision, load_imagereward
from .train_state_io import (
    latest_checkpoint,
    prune_checkpoints,
    restore_train_state,
    save_train_state,
)
