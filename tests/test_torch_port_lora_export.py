"""The port's LoRA safetensors export (``checkpoints/lora_safetensors.py``)
against the JAX package's ``export_lora_safetensors``, and the port's own
safetensors writer and reader (``checkpoints/safetensors_io.py``) against
the ``safetensors`` package, which is installed here (the port itself does
not import it). Then the online runner's checkpoint: a tiny CPU run writes
``lora-1/pytorch_lora_weights.safetensors`` beside ``checkpoint-1``, holding
the LoRA that checkpoint restores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as st_save_numpy
from safetensors.torch import load_file as st_load_torch

from pairwise_sample_optimization_tpu.checkpoints import lora_safetensors as jls
from pairwise_sample_optimization_tpu.models import unet as junet
from pairwise_sample_optimization_tpu_torch.checkpoints import (LORA_FILE,
                                                                export_lora_safetensors,
                                                                latest_checkpoint, load_file,
                                                                restore_train_state, save_file,
                                                                state_dict_from_jax)
from pairwise_sample_optimization_tpu_torch.cli.online_runner import run_dir, run_online_pso
from pairwise_sample_optimization_tpu_torch.cli.train_online_pso_sdxl_turbo import build_config
from pairwise_sample_optimization_tpu_torch.models import unet as tunet
from pairwise_sample_optimization_tpu_torch.train import (PSOTrainState, lora_parameters,
                                                          make_optimizer)

RANK = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is as fast, and does not
    oversubscribe the CPU when test files run in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def adapters():
    """A tiny JAX UNet's variables (random, LoRA A and B both non-zero) and
    the port's UNet carrying them."""
    cfg = junet.UNetConfig.tiny(lora_rank=RANK)
    shapes = jax.eval_shape(junet.SDXLUNet(cfg).init, jax.random.key(0), jnp.zeros((1, 8, 8, 4)),
                            jnp.zeros((1,)), jnp.zeros((1, 5, 32)), jnp.zeros((1, 16)),
                            jnp.zeros((1, 6)))
    r = np.random.default_rng(0)
    variables = jax.tree.map(lambda s: (r.standard_normal(s.shape) * 0.1).astype(np.float32),
                             shapes)
    unet = tunet.SDXLUNet(tunet.UNetConfig.tiny(lora_rank=RANK), device="cpu")
    unet.load_state_dict(state_dict_from_jax(variables, "unet", n_levels=2), strict=True)
    return variables, unet


def test_export_equals_the_jax_export(adapters):
    variables, unet = adapters
    want = jls.export_lora_safetensors(variables["lora"], n_levels=2)
    got = export_lora_safetensors(unet)
    assert set(got) == set(want) and len(got) > 0
    assert all(k.startswith("unet.") and k.endswith((".lora.down.weight", ".lora.up.weight"))
               for k in got)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == torch.float32 and g.device.type == "cpu" and g.is_contiguous()
        assert np.array_equal(g.numpy(), w), k
    assert any(float(np.abs(w).max()) > 0 for k, w in want.items() if k.endswith("up.weight"))


def test_the_port_file_reads_back_through_safetensors(adapters, tmp_path):
    _, unet = adapters
    path = tmp_path / LORA_FILE
    got = export_lora_safetensors(unet, str(path))
    back = st_load_torch(str(path))
    assert set(back) == set(got)
    assert all(torch.equal(back[k], got[k]) for k in got)
    # the writer's other dtypes and shapes, a scalar and an empty tensor among them
    extra = {"bf16": torch.randn(3, 5).to(torch.bfloat16), "i64": torch.arange(7),
             "f16": torch.randn(2, 1, 4).half(), "scalar": torch.tensor(2.5),
             "empty": torch.zeros(0, 3), "mask": torch.tensor([True, False, True])}
    save_file(extra, str(tmp_path / "extra.safetensors"))
    back = st_load_torch(str(tmp_path / "extra.safetensors"))
    assert set(back) == set(extra)
    for k, t in extra.items():
        assert back[k].dtype == t.dtype and back[k].shape == t.shape and torch.equal(back[k], t)


def test_load_file_reads_what_safetensors_wrote(tmp_path):
    r = np.random.default_rng(1)
    arrays = {"w": r.standard_normal((4, 6)).astype(np.float32),
              "h": r.standard_normal((3,)).astype(np.float16),
              "ids": np.arange(10, dtype=np.int64).reshape(2, 5),
              "bytes": np.arange(5, dtype=np.uint8), "flags": np.array([True, False])}
    path = tmp_path / "np.safetensors"
    st_save_numpy(arrays, str(path), metadata={"origin": "numpy"})
    got = load_file(str(path))
    assert set(got) == set(arrays)
    for k, a in arrays.items():
        assert got[k].shape == a.shape and np.array_equal(got[k].numpy(), a), k


def test_load_file_refuses_a_truncated_file(tmp_path):
    path = tmp_path / "t.safetensors"
    save_file({"w": torch.ones(4, 4)}, str(path))
    path.write_bytes(path.read_bytes()[:-4])
    with pytest.raises(ValueError):
        load_file(str(path))


def test_runner_checkpoint_writes_the_lora_file(tmp_path):
    config = build_config(True, [f"output_dir={tmp_path}", "run_name=export"])
    state, history, pipe = run_online_pso(config, num_epochs=1, device="cpu")
    out = tmp_path / "export"
    assert str(out) == run_dir(config)
    exported = load_file(str(out / "lora-1" / LORA_FILE))
    lora = lora_parameters(pipe.unet)
    restored = PSOTrainState.create(lora, make_optimizer(lora))
    with torch.no_grad():
        for p in lora.values():
            p.zero_()
    restore_train_state(latest_checkpoint(str(out)), restored)
    assert set(exported) == {"unet." + k for k in restored.lora}
    for k, p in restored.lora.items():
        assert exported["unet." + k].dtype == torch.float32
        assert torch.equal(exported["unet." + k], p.detach()), k
    assert float(sum(p.detach().abs().sum() for k, p in restored.lora.items() if ".up." in k)) > 0
