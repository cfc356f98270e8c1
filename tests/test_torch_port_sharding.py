"""FSDP and tensor parallelism in the port (``parallel/fsdp.py``,
``parallel/tp.py``), on the CPU over gloo.

The sharding plans are held against the JAX package's own rules
(``tp._spec_for``, ``tp._lora_spec_for``, ``fsdp._fsdp_spec``) on the
tiny and the full SDXL configs, each JAX leaf carried to its torch name and
axis by the port's name maps (those of ``checkpoints/convert.py::
state_dict_from_jax``). The rank processes are this file run as a script
(``_worker``) with torchrun's environment: four processes started once for
the module form a group of 4, then (three of them) of 3, then (two) of 2,
each group running all of its scenarios while the world-1 and JAX
references run here:

- 4 ranks: the tiny UNet's forward and LoRA gradients at (data 2, model 2);
- 3 ranks: the same at (data 1, model 3), the uneven split of the tiny
  UNet's 8 heads and 256 GEGLU columns (3 / 3 / 2 heads, 86 / 85 / 85), and
  full finetuning with the fp32 and the 8-bit AdamW;
- 2 ranks: the same at (data 1, model 2) and under FSDP (data 2); the tiny
  Turbo and DMD2 loops through ``run_online_pso`` under ``mesh.model=2``
  (with a checkpoint and LoRA export, and resumed from a world-1
  checkpoint; the Turbo loop with the int8 reference pass too), and both loops under ``mesh.fsdp=True`` and plain data
  parallelism with the ``dots`` remat and ``offload_aux_during_update``.

Tolerance: ATOL 3e-5 / RTOL 2e-4 in fp32 against world 1 and JAX (the
row-parallel sums are taken in another order); bit-identical where only
exact gathers differ (FSDP against data parallelism at the same world size,
the model ranks against each other).
"""

import copy
import functools
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # run as a script: the rank processes
    sys.path.insert(0, str(ROOT))

from pairwise_sample_optimization_tpu_torch import parallel  # noqa: E402
from pairwise_sample_optimization_tpu_torch.checkpoints import load_file  # noqa: E402
from pairwise_sample_optimization_tpu_torch.cli import online_runner  # noqa: E402
from pairwise_sample_optimization_tpu_torch.cli import train_online_pso_sdxl_dmd2 as dmd_cli  # noqa: E402,E501
from pairwise_sample_optimization_tpu_torch.cli import train_online_pso_sdxl_turbo as turbo_cli  # noqa: E402,E501
from pairwise_sample_optimization_tpu_torch.models import layers as tlayers  # noqa: E402
from pairwise_sample_optimization_tpu_torch.models import unet as tunet  # noqa: E402
from pairwise_sample_optimization_tpu_torch.parallel import collectives, fsdp, tp  # noqa: E402
from pairwise_sample_optimization_tpu_torch.train import lora_parameters  # noqa: E402

ATOL, RTOL = 3e-5, 2e-4
JOIN_S = 150
GROUP_TIMEOUT_S = 60
TINY_MIN_SIZE = 2**10  # FSDP's threshold for the tiny models (2**16 shards one tensor there)
WORLDS = (4, 3, 2)  # the groups the rank processes form, one after the other
UNET_MESHES = {2: [(1, 2, False), (2, 1, True)], 3: [(1, 3, False)], 4: [(2, 2, False)]}
BATCH = 4  # the UNet cases' global batch
FULL = ["use_lora=False", "train.learning_rate=1e-4"]
INT8 = ["train.int8_ref_pass=True"]  # the reference pass in dynamic int8
SHARED_OPTS = ["sample.batch_size=1", "train.batch_size=1", "activation_checkpoint=dots",
               "offload_aux_during_update=True"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), atol=atol, rtol=rtol)


def _close_trees(got, want):
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k])


def _equal_trees(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------- #
# cases: each runs in the rank processes and (at world 1) here
# ---------------------------------------------------------------------- #


def unet_case(unet_file, data=1, model=1, use_fsdp=False):
    """The tiny UNet's forward over the global batch and the LoRA gradients
    of half the per-sample sum of squares averaged over the batch (gradients
    of order 1), whole on every rank (the data index's rows), and the
    activation all-reduces of tensor parallelism (forward, backward)."""
    blob = torch.load(unet_file, weights_only=True)
    remat = "dots" if use_fsdp else ""
    u = tunet.SDXLUNet(tunet.UNetConfig.tiny(lora_rank=4, remat=remat), device="cpu")
    u.load_state_dict(blob["state_dict"])
    if parallel.world_size() > 1:
        parallel.init_mesh(parallel.MeshSpec(data, model, use_fsdp))
        if model > 1:
            tp.shard_unet_tp(u, parallel.model_index(), model, parallel.model_group())
        if use_fsdp:
            fsdp.shard_module_fsdp(u, parallel.data_group())
    lora = lora_parameters(u)
    b = BATCH // parallel.data_size()
    rows = slice(parallel.data_index() * b, (parallel.data_index() + 1) * b)
    inputs = [blob["inputs"][k][rows] for k in ("x", "t", "ehs", "pooled", "tids")]
    calls, reduce = [], collectives._reduce
    collectives._reduce = lambda x, group: calls.append(x.shape) or reduce(x, group)
    try:
        out = u(*inputs, lora_scale=1.0)
        n_forward = len(calls)
        ((out ** 2).sum() / (2 * BATCH)).backward()
    finally:
        collectives._reduce = reduce
    grads = {k: p.grad for k, p in lora.items()}
    tp.sum_partial_grads_(lora, grads)
    parallel.all_reduce_sum_(list(grads.values()), parallel.data_group())
    whole = {k: (tp.shard_of(lora[k]).gather(g) if tp.shard_of(lora[k]) else g)
             for k, g in grads.items()}
    out = parallel.process_allgather(out.detach(), parallel.data_group()).flatten(0, 1)
    parallel.reset_mesh()
    return {"out": out, "grads": whole, "reduces": (n_forward, len(calls) - n_forward)}


def unet_int8_case(unet_file, model=1):
    """The tiny UNet's reference forward (``lora_scale=0``) inside the int8
    scope over the global batch, at (data 1, ``model``)."""
    from pairwise_sample_optimization_tpu_torch.ops.qconv import int8_ref_pass

    blob = torch.load(unet_file, weights_only=True)
    u = tunet.SDXLUNet(tunet.UNetConfig.tiny(lora_rank=4), device="cpu")
    u.load_state_dict(blob["state_dict"])
    if model > 1:
        parallel.init_mesh(parallel.MeshSpec(1, model, False))
        tp.shard_unet_tp(u, parallel.model_index(), model, parallel.model_group())
    with torch.no_grad(), int8_ref_pass():
        out = u(*[blob["inputs"][k] for k in ("x", "t", "ehs", "pooled", "tids")],
                lora_scale=0.0)
    parallel.reset_mesh()
    return out


def runner_case(out_dir, name, overrides=(), sampler="turbo", epochs=1):
    """One tiny ``run_online_pso``: the whole trained tensors (gathered on
    every rank) and the metrics."""
    cli = turbo_cli if sampler == "turbo" else dmd_cli
    config = cli.build_config(True, [f"output_dir={out_dir}", f"run_name={name}",
                                     "checkpointing_steps=1", *overrides])
    state, history, _ = online_runner.run_online_pso(config, sampler=sampler,
                                                     num_epochs=epochs, device="cpu")
    whole = {k: v.clone() for k, v in tp.whole_tensors(state.lora).items()}
    parallel.reset_mesh()
    return {"lora": whole, "history": history, "step": state.step}


def _phase(out_dir, world):
    """One world's scenarios on this rank."""
    res = {"rank": parallel.rank(), "world": world}
    for mesh in UNET_MESHES[world]:
        res[f"unet-{mesh}"] = unet_case(out_dir / "unet.pt", *mesh)
    run = lambda name, *a, **k: runner_case(out_dir / f"world{world}", name, *a, **k)
    if world == 3:
        res["full-fp32"] = run("full-fp32", ["mesh.model=3", *FULL])
        res["full-8bit"] = run("full-8bit", ["mesh.model=3", *FULL, "train.use_8bit_adam=True"])
    if world == 2:
        res["turbo"] = run("turbo", ["mesh.model=2"])
        res["unet-int8"] = unet_int8_case(out_dir / "unet.pt", 2)
        res["turbo-int8"] = run("turbo-int8", ["mesh.model=2", *INT8])
        res["turbo-resumed"] = run("turbo-resumed", ["mesh.model=2",
                                                     f"resume_from={out_dir / 'w1' / 'turbo'}"])
        res["dmd"] = run("dmd", ["mesh.model=2"], sampler="dmd")
        for sampler in ("turbo", "dmd"):
            for mode, extra in (("fsdp", ["mesh.fsdp=True"]), ("ddp", [])):
                res[f"{mode}-{sampler}"] = run(f"{mode}-{sampler}", [*SHARED_OPTS, *extra],
                                               sampler=sampler)
    torch.save(res, out_dir / f"world{world}-rank{parallel.rank()}.pt")


def _worker(out_dir):
    """Rank ``RANK`` of a group of 4, then (the ranks below 3) of 3, then
    (below 2) of 2, each group on its own port of ``PORTS``: one set of
    processes, each paying its start-up once."""
    torch.set_num_threads(1)
    fsdp.MIN_SIZE = TINY_MIN_SIZE
    rank = int(os.environ["RANK"])
    for world, port in zip(WORLDS, os.environ["PORTS"].split(",")):
        if rank >= world:
            break
        os.environ.update(WORLD_SIZE=str(world), MASTER_PORT=port)
        if not parallel.maybe_initialize_distributed(timeout_s=GROUP_TIMEOUT_S):
            raise RuntimeError("no process group from the environment")
        _phase(out_dir, world)
        parallel.shutdown_distributed()


# ---------------------------------------------------------------------- #
# the rank processes
# ---------------------------------------------------------------------- #


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(out):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env.update(MASTER_ADDR="127.0.0.1", PORTS=",".join(str(_free_port()) for _ in WORLDS),
               OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p]))
    return [subprocess.Popen([sys.executable, __file__, str(out)], cwd=ROOT,
                             env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(max(WORLDS))]


def _unet_weights(path):
    """The JAX tiny UNet's params drawn with numpy in the flax tree's shapes
    (LoRA B non-zero); the port's state dict of them with the inputs is
    written to ``path`` for the ranks. Returns a function that computes the
    JAX UNet's output and LoRA gradients (jitted when called)."""
    import jax
    import jax.numpy as jnp

    from pairwise_sample_optimization_tpu.models import unet as junet
    from pairwise_sample_optimization_tpu_torch.checkpoints import state_dict_from_jax

    model = junet.SDXLUNet(junet.UNetConfig.tiny(lora_rank=4))
    r = np.random.default_rng(0)
    inputs = {"x": r.standard_normal((BATCH, 8, 8, 4)).astype(np.float32),
              "t": np.array([999, 499, 17, 250], np.int32),
              "ehs": r.standard_normal((BATCH, 77, 32)).astype(np.float32),
              "pooled": r.standard_normal((BATCH, 16)).astype(np.float32),
              "tids": np.tile(np.array([[512, 512, 0, 0, 512, 512]], np.float32), (BATCH, 1))}
    order = ("x", "t", "ehs", "pooled", "tids")
    shapes = _flax_trees("tiny")[1]  # the param shapes do not depend on the batch

    def leaf(path, a):
        name, shape = path[-1].key, a.shape
        if name == "scale":
            return np.ones(shape, np.float32)
        std = (0.2 if name == "b" else 1.0 / shape[-1] if name == "a" else 0.02
               if name == "bias" or len(shape) < 2 or "embedding" in name
               else 1.0 / np.sqrt(np.prod(shape[:-1])))
        return (r.standard_normal(shape) * std).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    torch_inputs = {k: torch.from_numpy(v) for k, v in inputs.items()}
    torch_inputs["x"] = torch_inputs["x"].permute(0, 3, 1, 2).contiguous()
    torch.save({"state_dict": state_dict_from_jax(variables, "unet", n_levels=2),
                "inputs": torch_inputs}, path)

    def loss(lora, params, *args):
        out = model.apply({"params": params, "lora": lora}, *args)
        return jnp.sum(out ** 2) / (2 * BATCH), out

    def reference():
        args = [jnp.asarray(inputs[k]) for k in order]
        (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["lora"], variables["params"], *args)
        return np.asarray(out), state_dict_from_jax({}, "unet", n_levels=2,
                                                    lora=jax.tree.map(np.asarray, grads))

    return reference


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """At the module's start: the UNet file and a world-1 checkpoint (which
    the 2-rank group resumes at model 2), then the rank processes; they run
    beside every test here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # for the module's fixtures too: the shapes are tiny
    out = tmp_path_factory.mktemp("sharding")
    jax_reference = _unet_weights(out / "unet.pt")
    w1_turbo = runner_case(out / "w1", "turbo")
    procs = _launch(out)
    box = {"out": out, "procs": procs, "results": None, "jax_reference": jax_reference,
           "w1_turbo": w1_turbo}
    yield box
    torch.set_num_threads(threads)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def results(ranks):
    """{world: [each rank's results]}, once every rank exited 0."""
    if ranks["results"] is None:
        procs = ranks["procs"]
        try:
            logs = [p.communicate(timeout=JOIN_S)[0] for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            pytest.fail(f"a rank did not finish within {JOIN_S} s")
        codes = [p.returncode for p in procs]
        assert codes == [0] * len(procs), "\n".join(
            f"rank {r} exit {c}:\n{log[-3000:]}" for r, (c, log) in enumerate(zip(codes, logs)))
        ranks["results"] = {w: [torch.load(ranks["out"] / f"world{w}-rank{r}.pt",
                                           weights_only=False) for r in range(w)]
                            for w in WORLDS}
    return ranks["results"]


@pytest.fixture(scope="module")
def world1(ranks):
    """The world-1 runs the sharded ones are held against."""
    out = ranks["out"] / "w1"
    w1_ckpt = str(out / "turbo")
    return {"turbo": ranks["w1_turbo"],
            "turbo-2-epochs": runner_case(out, "turbo-resumed", [f"resume_from={w1_ckpt}"]),
            "dmd": runner_case(out, "dmd", sampler="dmd"),
            "turbo-int8": runner_case(out, "turbo-int8", INT8),
            "unet-int8": unet_int8_case(ranks["out"] / "unet.pt"),
            "full-fp32": runner_case(out, "full-fp32", FULL),
            "full-8bit": runner_case(out, "full-8bit", FULL + ["train.use_8bit_adam=True"]),
            "unet": unet_case(ranks["out"] / "unet.pt"), "jax": ranks["jax_reference"]()}


# ---------------------------------------------------------------------- #
# the plans against the JAX package's rules
# ---------------------------------------------------------------------- #


def _torch_axis(kind, ndim, axis):
    """The torch axis of flax axis ``axis`` of a leaf of ``kind`` (as
    ``convert._to_torch`` lays it out)."""
    if kind == "?":
        kind = "conv" if ndim == 4 else "linear"
    return {"linear": 1 - axis, "conv": (2, 3, 1, 0)[axis]}.get(kind, axis)


@functools.lru_cache(maxsize=None)
def _flax_trees(config_name):
    import jax
    import jax.numpy as jnp

    from pairwise_sample_optimization_tpu.models import unet as junet
    from pairwise_sample_optimization_tpu.models import vae as jvae

    cfg = getattr(junet.UNetConfig, config_name)(lora_rank=4)
    args = (jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 77, cfg.cross_attention_dim)), jnp.zeros((1, cfg.pooled_embed_dim)),
            jnp.zeros((1, 6)))
    unet = jax.eval_shape(junet.SDXLUNet(cfg).init, jax.random.key(0), *args)
    vae = jax.eval_shape(jvae.AutoencoderKL(getattr(jvae.VAEConfig, config_name)()).init,
                         jax.random.key(0), jnp.zeros((1, 16, 16, 3)), jax.random.key(1))
    return cfg, unet, vae["params"]


@functools.lru_cache(maxsize=None)
def _port_modules(config_name):
    from pairwise_sample_optimization_tpu_torch.models import vae as tvae

    unet = tunet.SDXLUNet(getattr(tunet.UNetConfig, config_name)(lora_rank=4), device="meta")
    return unet, tvae.AutoencoderKL(getattr(tvae.VAEConfig, config_name)(), device="meta")


def _sharded_leaves(tree, spec_fn, name_map, axis_name, lora=False):
    """{torch key: torch axis} of the leaves ``spec_fn`` shards."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        spec = spec_fn(path, leaf)
        axes = [i for i, a in enumerate(spec) if a == axis_name]
        if not axes:
            continue
        names = tuple(p.key for p in path)
        if lora:  # a (in, r) / b (r, out) -> down (r, in) / up (out, r)
            key, _ = name_map(names[:-1] + ("kernel",))
            key = key[:-len("weight")] + {"a": "lora.down.weight", "b": "lora.up.weight"}[
                names[-1]]
            out[key] = 1 - axes[0]
        else:
            key, kind = name_map(names)
            out[key] = _torch_axis(kind, len(leaf.shape), axes[0])
    return out


@pytest.mark.parametrize("config_name", ["tiny", "sdxl"])
def test_tp_plan_is_the_jax_packages(config_name):
    """Every tensor the JAX rules width-shard is sliced on the same torch
    axis, and no other."""
    from pairwise_sample_optimization_tpu.parallel import tp as jtp
    from pairwise_sample_optimization_tpu_torch.checkpoints.torch_names import unet_param_map

    cfg, unet_tree, _ = _flax_trees(config_name)
    name_map = functools.partial(unet_param_map, n_levels=len(cfg.block_out_channels))
    want = {**_sharded_leaves(unet_tree["params"], lambda p, _: jtp._spec_for(p), name_map,
                              "model"),
            **_sharded_leaves(unet_tree["lora"], lambda p, _: jtp._lora_spec_for(p), name_map,
                              "model", lora=True)}
    unet = copy.deepcopy(_port_modules(config_name)[0])  # sliced in place below
    got = tp.tp_plan(tp.shard_unet_tp(unet, 1, 2, None))
    assert got == want and len(want) > 0


@pytest.mark.parametrize("config_name,min_size,n", [("tiny", TINY_MIN_SIZE, 2),
                                                    ("sdxl", 2**16, 4)])
def test_fsdp_plan_is_the_jax_packages(monkeypatch, config_name, min_size, n):
    """FSDP shards the UNet's and the VAE's leaves on JAX's axes (the
    largest the data size divides, at ``min_size`` elements and up)."""
    from pairwise_sample_optimization_tpu.parallel import fsdp as jfsdp
    from pairwise_sample_optimization_tpu_torch.checkpoints.torch_names import (unet_param_map,
                                                                               vae_param_map)

    cfg, unet_tree, vae_tree = _flax_trees(config_name)
    spec = lambda p, leaf: jfsdp._fsdp_spec(leaf.shape, n, min_size)
    unet, vae = _port_modules(config_name)
    for module, tree, name_map in (
            (unet, unet_tree["params"],
             functools.partial(unet_param_map, n_levels=len(cfg.block_out_channels))),
            (vae, vae_tree, vae_param_map)):
        want = _sharded_leaves(tree, spec, name_map, "data")
        monkeypatch.setattr(fsdp, "MIN_SIZE", min_size)
        assert fsdp.fsdp_plan(module, n) == want and want


def test_shard_gather_and_splits_are_exact():
    """Heads split whole and evenly (3, 3, 2, 2); a slice's flat indices are
    its elements' places in the whole tensor; the ranks' positions cover the
    axis once; FSDP with ``mesh.model > 1`` is refused."""
    assert tp.split_bounds(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert tp.split_bounds(256, 3) == [(0, 86), (86, 171), (171, 256)]
    whole = torch.arange(6 * 10).reshape(6, 10)
    pos = [torch.cat([torch.arange(0, 2), 5 + torch.arange(0, 2)]),
           torch.cat([torch.arange(2, 5), 5 + torch.arange(2, 5)])]
    shard = tp.Shard((6, 10), 1, tuple(pos), 1, None)
    assert torch.equal(shard.take(whole).reshape(-1), shard.flat_index())
    assert torch.equal(torch.sort(torch.cat(shard.positions)).values, torch.arange(10))
    with pytest.raises(ValueError, match="unsupported"):
        parallel.MeshSpec(model=2, fsdp=True).resolve(2)


# ---------------------------------------------------------------------- #
# the ranks against world 1 and JAX
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("world,mesh", [(2, (1, 2, False)), (2, (2, 1, True)),
                                        (3, (1, 3, False)), (4, (2, 2, False))])
def test_unet_forward_and_lora_grads_match_world_1_and_jax(ranks, results, world1, world, mesh):
    """The sharded tiny UNet's output and LoRA gradients equal one process's
    and the JAX UNet's on the same weights; every rank holds the same."""
    jax_out, jax_grads = world1["jax"]
    want = world1["unet"]
    _close(want["out"].permute(0, 2, 3, 1), jax_out)
    _close_trees(want["grads"], jax_grads)
    got = [r[f"unet-{mesh}"] for r in results[world]]
    _close(got[0]["out"], want["out"])
    _close_trees(got[0]["grads"], want["grads"])
    for other in got[1:]:
        assert torch.equal(other["out"], got[0]["out"])
        _equal_trees(other["grads"], got[0]["grads"])


def test_tensor_parallelism_all_reduces_once_per_block_input(results):
    """Per transformer block, three activation all-reduces forward (the two
    ``to_out`` and ``ff.net.2`` sums) and three backward (the attentions'
    inputs and the feed-forward's, each copied once for all its column
    layers and LoRA ``down`` products), but for the first block's
    self-attention input, which no trained tensor precedes, and the text
    context: they have no gradient."""
    blocks = sum(isinstance(m, tlayers.BasicTransformerBlock)
                 for m in tunet.SDXLUNet(tunet.UNetConfig.tiny(lora_rank=4), device="meta").modules())
    for world, mesh in ((2, (1, 2, False)), (3, (1, 3, False)), (4, (2, 2, False))):
        for r in results[world]:
            assert r[f"unet-{mesh}"]["reduces"] == (3 * blocks, 3 * blocks - 1), (world, mesh)
    assert all(r["unet-(2, 1, True)"]["reduces"] == (0, 0) for r in results[2])


@pytest.mark.parametrize("name", ["turbo", "dmd"])
def test_loops_under_tensor_parallelism_equal_world_1(results, world1, name):
    got = [r[name] for r in results[2]]
    want = world1[name]
    _close_trees(got[0]["lora"], want["lora"])
    _equal_trees(got[1]["lora"], got[0]["lora"])
    assert got[0]["history"] == got[1]["history"] and len(want["history"]) == 1
    for k, v in want["history"][0].items():
        _close(got[0]["history"][0][k], v)


def test_int8_reference_pass_under_tensor_parallelism_equals_world_1(results, world1):
    """``train.int8_ref_pass`` at model 2: the row-parallel layers
    (``to_out.0``, ``ff.net.2``) quantize on the grids of the whole
    contracted dim (both absmaxes reduced with max over the model group), so
    on the same input the reference forward is one process's; the loop's
    LoRA equals world 1's. Its loss is held at 5e-3 relative: the policy's
    rollouts differ from one process's by the row sums' ulps, and an
    activation within an ulp of a rounding tie then lands one int8 step
    apart in the reference log-prob (3.2e-3 of the loss here; the
    forward on one input agrees bit for bit)."""
    got = [r["unet-int8"] for r in results[2]]
    _close(got[0], world1["unet-int8"])
    assert torch.equal(got[1], got[0])
    loop, want = [r["turbo-int8"] for r in results[2]], world1["turbo-int8"]
    _close_trees(loop[0]["lora"], want["lora"])
    _equal_trees(loop[1]["lora"], loop[0]["lora"])
    assert loop[0]["history"] == loop[1]["history"] and len(want["history"]) == 1
    for k, v in want["history"][0].items():
        _close(loop[0]["history"][0][k], v, atol=0.0, rtol=5e-3)


def test_tp_checkpoint_and_lora_export_hold_whole_tensors(ranks, results, world1):
    """Rank 0 writes the whole LoRA and the one-process optimizer state: the
    checkpoint and the LoRA file equal the trained tensors and a world-1
    run's files."""
    run, ref = ranks["out"] / "world2" / "turbo", ranks["out"] / "w1" / "turbo"
    got, want = (torch.load(d / "checkpoint-1" / "state.pt", weights_only=True)
                 for d in (run, ref))
    _equal_trees(got["lora"], results[2][0]["turbo"]["lora"])
    _close_trees(got["lora"], want["lora"])
    assert got["optimizer"]["names"] == want["optimizer"]["names"]
    _close_trees(got["optimizer"]["state"], want["optimizer"]["state"])
    files = [load_file(str(d / "lora-1" / online_runner.LORA_FILE)) for d in (run, ref)]
    _close_trees(files[0], files[1])
    assert all(torch.equal(files[0][f"unet.{k}"], v) for k, v in got["lora"].items())


@pytest.mark.parametrize("direction", ["model_2_to_1", "model_1_to_2"])
def test_resume_across_model_sizes(ranks, results, world1, direction):
    """A model-2 checkpoint resumes at model 1 and a model-1 one at model 2,
    each as a world-1 run of two epochs trains."""
    want = world1["turbo-2-epochs"]
    if direction == "model_1_to_2":
        got = results[2][0]["turbo-resumed"]
    else:
        got = runner_case(ranks["out"] / "w1", "from-tp",
                          [f"resume_from={ranks['out'] / 'world2' / 'turbo'}"])
    assert got["step"] == want["step"] == 2
    _close_trees(got["lora"], want["lora"])
    for k, v in want["history"][0].items():
        _close(got["history"][0][k], v)


@pytest.mark.parametrize("world,name", [(3, "full-fp32"), (3, "full-8bit")])
def test_full_finetuning_under_tensor_parallelism(results, world1, world, name):
    """Every UNet weight trained over model ranks (the 8-bit moments in the
    whole tensors' blocks, the global norm over the slices) equals world 1."""
    got, want = results[world][0][name], world1[name]
    _close_trees(got["lora"], want["lora"])
    for k, v in want["history"][0].items():
        _close(got["history"][0][k], v)
    for other in results[world][1:]:
        _equal_trees(other[name]["lora"], got["lora"])


def test_8bit_moments_are_quantized_in_whole_tensor_blocks(ranks, world1, results):
    """The model-3 checkpoint's 8-bit moments (uneven slices): one process's
    layout, each block's scale the whole tensor's (a slice's own blocks
    would give other scales), each value within one quantization step."""
    got, want = (torch.load(d / "full-8bit" / "checkpoint-1" / "state.pt",
                            weights_only=True)["optimizer"]["state"]
                 for d in (ranks["out"] / "world3", ranks["out"] / "w1"))
    for m in ("mu", "nu"):
        for q, s, wq, ws in zip(got[f"{m}_q"], got[f"{m}_scale"], want[f"{m}_q"],
                                want[f"{m}_scale"]):
            assert q.shape == wq.shape and s.shape == ws.shape
            _close(s, ws, atol=1e-12, rtol=1e-3)
            deq, wdeq = q.float() * s[:, None], wq.float() * ws[:, None]
            # one step, with the fp32 rounding of the two products
            step = ws[:, None] * (1 + 1e-5) + 127 * (s - ws).abs()[:, None] + 1e-12
            assert bool(((deq - wdeq).abs() <= step).all())


@pytest.mark.parametrize("sampler", ["turbo", "dmd"])
def test_fsdp_is_bit_identical_to_data_parallelism(results, sampler):
    """Two ranks under ``mesh.fsdp=True`` (the frozen UNet, VAE, text towers
    and scorer sharded, gathered per module; ``dots`` remat and the aux
    offload on) train exactly what two data-parallel ranks train."""
    for r in results[2]:
        _equal_trees(r[f"fsdp-{sampler}"]["lora"], results[2][0][f"ddp-{sampler}"]["lora"])
        assert r[f"fsdp-{sampler}"]["history"] == results[2][0][f"ddp-{sampler}"]["history"]


def test_fsdp_runner_shards_the_frozen_suite(ranks, results):
    """The FSDP run's metrics show the offloaded towers at about half their
    world-1 bytes."""
    rows = {}
    for mode in ("fsdp", "ddp"):
        path = ranks["out"] / "world2" / f"{mode}-turbo" / "metrics.jsonl"
        rows[mode] = next(json.loads(x) for x in path.read_text().splitlines()
                          if "offload_bytes" in json.loads(x))["offload_bytes"]
    assert 0.45 * rows["ddp"] < rows["fsdp"] < 0.6 * rows["ddp"]


if __name__ == "__main__":
    _worker(Path(sys.argv[1]))
