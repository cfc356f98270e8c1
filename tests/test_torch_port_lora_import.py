"""The port's LoRA import (``checkpoints/lora_safetensors.py::
import_lora_safetensors``) against the JAX package's import and export:
a file the JAX package exported, or the same adapter under peft's raw
``lora_A`` / ``lora_B`` keys, loads into the port's UNet bit-equal; a
missing site or a wrong shape raises as it does in JAX. Then
``cli/generate.py`` on the toy models: an adapter trained by the tiny
runner changes its images.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as st_save_numpy

from pairwise_sample_optimization_tpu.checkpoints import lora_safetensors as jls
from pairwise_sample_optimization_tpu.models import unet as junet
from pairwise_sample_optimization_tpu_torch.checkpoints import (LORA_FILE,
                                                                export_lora_safetensors,
                                                                import_lora_safetensors,
                                                                state_dict_from_jax)
from pairwise_sample_optimization_tpu_torch.cli import generate
from pairwise_sample_optimization_tpu_torch.cli.online_runner import run_dir, run_online_pso
from pairwise_sample_optimization_tpu_torch.cli.train_online_pso_sdxl_turbo import build_config
from pairwise_sample_optimization_tpu_torch.models import unet as tunet

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
def jax_lora(tmp_path_factory):
    """A tiny JAX UNet's LoRA tree (A and B both non-zero), the file the JAX
    package exports from it, and the port's state dict of that adapter."""
    cfg = junet.UNetConfig.tiny(lora_rank=RANK)
    shapes = jax.eval_shape(junet.SDXLUNet(cfg).init, jax.random.key(0), jnp.zeros((1, 8, 8, 4)),
                            jnp.zeros((1,)), jnp.zeros((1, 5, 32)), jnp.zeros((1, 16)),
                            jnp.zeros((1, 6)))
    r = np.random.default_rng(0)
    lora = jax.tree.map(lambda s: (r.standard_normal(s.shape) * 0.1).astype(np.float32),
                        shapes["lora"])
    path = tmp_path_factory.mktemp("lora") / LORA_FILE
    exported = jls.export_lora_safetensors(lora, str(path), n_levels=2)
    want = state_dict_from_jax({"params": {}, "lora": lora}, "unet", n_levels=2)
    return lora, path, exported, want


def _fresh_unet():
    return tunet.SDXLUNet(tunet.UNetConfig.tiny(lora_rank=RANK), device="cpu")


def _port_lora(unet):
    return {k: v for k, v in unet.state_dict().items() if ".lora." in k}


def test_jax_exported_file_imports_bit_equal(jax_lora):
    lora, path, _, want = jax_lora
    unet = _fresh_unet()
    frozen = {k: v.clone() for k, v in unet.state_dict().items() if ".lora." not in k}
    assert import_lora_safetensors(str(path), unet) is unet
    got = _port_lora(unet)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], w), k
    assert all(torch.equal(v, frozen[k]) for k, v in unet.state_dict().items() if k in frozen)
    # and back: the port's export of it is what the JAX import reads as the same tree
    back = jls.import_lora_safetensors({k: v.numpy() for k, v in export_lora_safetensors(
        unet).items()}, lora, n_levels=2)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                 back, lora)


def test_peft_keys_import_bit_equal(jax_lora, tmp_path):
    _, _, exported, want = jax_lora
    peft = {k.replace(".lora.down.weight", ".lora_A.weight")
            .replace(".lora.up.weight", ".lora_B.weight"): v for k, v in exported.items()}
    assert set(peft).isdisjoint(exported)
    st_save_numpy(peft, str(tmp_path / "peft.safetensors"))
    unet = import_lora_safetensors(str(tmp_path / "peft.safetensors"), _fresh_unet())
    got = _port_lora(unet)
    assert all(torch.equal(got[k], w) for k, w in want.items())
    # a state dict works as a file does
    unet = import_lora_safetensors({k: torch.from_numpy(v) for k, v in peft.items()},
                                   _fresh_unet())
    assert all(torch.equal(_port_lora(unet)[k], w) for k, w in want.items())


@pytest.mark.parametrize("fault", ["missing_site", "wrong_shape"])
def test_a_missing_site_or_a_wrong_shape_raises_as_in_jax(jax_lora, fault):
    lora, _, exported, _ = jax_lora
    bad = dict(exported)
    key = sorted(bad)[0]
    if fault == "missing_site":
        del bad[key]
        error = KeyError
    else:
        bad[key] = np.zeros(bad[key].shape[::-1] + (1,), np.float32)[..., 0]
        error = ValueError
    with pytest.raises(error):
        jls.import_lora_safetensors(bad, lora, n_levels=2)
    with pytest.raises(error, match="no lora tensor" if error is KeyError else "shape mismatch"):
        import_lora_safetensors({k: torch.from_numpy(v) for k, v in bad.items()}, _fresh_unet())


def test_generate_cli_with_a_trained_adapter_differs_from_without(tmp_path):
    """A tiny run trains the adapter one update (a large learning rate, so
    that the images move by more than a PNG's 1/255 steps); ``cli/generate.py``
    with ``--lora_path`` of its ``lora-1`` file writes other images than
    without it, and the same images without it twice."""
    config = build_config(True, [f"output_dir={tmp_path}", "run_name=t",
                                 "train.learning_rate=0.05"])
    run_online_pso(config, num_epochs=1, device="cpu")
    lora_file = f"{run_dir(config)}/lora-1/{LORA_FILE}"
    args = ["--tiny", "--device", "cpu", "--lora_rank", "4", "--prompt", "a red fox",
            "--prompt", "an astronaut riding a horse"]
    base = generate.main(args + ["--out", str(tmp_path / "base")])
    again = generate.main(args + ["--out", str(tmp_path / "again")])
    tuned = generate.main(args + ["--out", str(tmp_path / "tuned"), "--lora_path", lora_file])
    assert [p.rsplit("/", 1)[1] for p in base] == ["000.png", "001.png"]
    read = lambda paths: [open(p, "rb").read() for p in paths]
    assert read(base) == read(again)
    assert all(a != b for a, b in zip(read(base), read(tuned)))
