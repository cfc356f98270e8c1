"""Data-parallel training and evaluation in the port (``parallel/``), on the
CPU over gloo with two processes: the world-size-2 run equals the
world-size-1 run over the concatenated batch, and every rank ends with the
same weights.

The two ranks are this file run as a script (``_worker``), launched with
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) once for the module, at the start, while
the world-1 references run here in the test process. Each rank saves what
it computed; a rank that fails or hangs fails every test that reads them
(the processes are joined with a timeout and the group has one too).

Tiny configs, fp32. The world-2 results are held against world 1 at ATOL
3e-5 / RTOL 2e-4 (the sums over the global batch are taken in another
order), the ranks against each other bit for bit, and the collectives
against numpy exactly.
"""

import json
import math
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
from pairwise_sample_optimization_tpu_torch.cli import evaluate_sdxl_dmd2 as ev  # noqa: E402
from pairwise_sample_optimization_tpu_torch.cli import online_runner  # noqa: E402
from pairwise_sample_optimization_tpu_torch.cli import (  # noqa: E402
    train_pso_sdxl_turbo_dreambooth as db_cli)
from pairwise_sample_optimization_tpu_torch.cli.train_online_pso_sdxl_turbo import (  # noqa: E402
    build_config)
from pairwise_sample_optimization_tpu_torch.device import resolve_device  # noqa: E402
from pairwise_sample_optimization_tpu_torch.parallel import collectives  # noqa: E402
from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline  # noqa: E402
from pairwise_sample_optimization_tpu_torch.train import (  # noqa: E402
    DreamBoothPSOConfig, DreamBoothPSOTrainer, OnlinePSOConfig, OnlinePSOTrainer, PSOTrainState,
    lora_parameters, make_optimizer)
from pairwise_sample_optimization_tpu_torch.utils.png import write_png  # noqa: E402

ATOL, RTOL = 3e-5, 2e-4
WORLD = 2
JOIN_S = 150  # the two ranks' whole run, against ~30 s alone on one core each
GROUP_TIMEOUT_S = 60
PROMPTS = 2 * WORLD  # the global batch of the trainer cases
SAMPLERS = [("turbo", True), ("dmd", True), ("dmd", False)]  # (sampler, shared_noise)
EVAL_ARGS = ["--tiny", "--device", "cpu", "--max_prompts", "5", "--scorers", "pickscore,clip"]
LORA_ARGS = dict(learning_rate=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is as fast, and does not
    oversubscribe the CPU when test files run in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), atol=atol, rtol=rtol)


def _rows(x):
    """This rank's rows of a global-batch tensor (all of them in one process)."""
    b = x.shape[0] // parallel.world_size()
    return x[parallel.rank() * b:(parallel.rank() + 1) * b]


# ---------------------------------------------------------------------- #
# the cases: each runs at world 1 here and at world 2 in the rank processes
# ---------------------------------------------------------------------- #


def _tiny_pipe(lora_b_std=0.02, resolution=16, with_scorer=True):
    return SDXLPipeline.random(lora_rank=4, dtype=torch.float32, resolution=resolution,
                               tiny=True, seed=0, lora_b_std=lora_b_std, device="cpu",
                               with_scorer=with_scorer)


def _trainer(pipe, sampler, shared):
    bs = 2 // parallel.world_size()  # the global microbatch holds 2 pairs
    return OnlinePSOTrainer(OnlinePSOConfig(
        sampler=sampler, num_steps=4, train_batch_size=bs, grad_accum=1,
        compare="sample" if sampler == "turbo" else "pareto", shared_noise=shared), pipe)


def sample_case(sampler, shared):
    """This rank's samples and conditioning of a global batch of PROMPTS
    prompts, the noise from one shared generator."""
    pipe = _tiny_pipe()
    ids = np.random.default_rng(7).integers(1, 250, (3, PROMPTS, 77))
    cond = pipe.encode_prompt(*(_rows(torch.as_tensor(i)) for i in ids))
    gen = torch.Generator().manual_seed(11)
    samples, _ = _trainer(pipe, sampler, shared).sample_pairs(cond, gen)
    return {"samples": samples,
            "cond": {k: cond[k] for k in ("embeds", "pooled", "time_ids")}}


def epoch_case(sampler, samples, cond, num_batches=1):
    """``train_epoch`` over ``samples`` (this rank's ``num_batches`` pair
    batches): the trained LoRA and the metrics."""
    pipe = _tiny_pipe()
    lora = lora_parameters(pipe.unet)
    state = PSOTrainState.create(lora, make_optimizer(lora, **LORA_ARGS))
    gen = torch.Generator().manual_seed(13)
    state, metrics = _trainer(pipe, sampler, True).train_epoch(state, samples, cond, gen,
                                                               num_batches)
    return {"lora": {k: v.detach().clone() for k, v in state.lora.items()}, "metrics": metrics}


def _db_global_batch(ga=2, b=2, hw=4):
    r = np.random.default_rng(5)
    f = lambda *shape: torch.from_numpy(r.standard_normal(shape).astype(np.float32))
    batch = {"instance_latents": f(ga, b, hw, hw, 4), "negative_latents": f(ga, b, hw, hw, 4),
             "cond": {"embeds": f(ga, b, 77, 32), "pooled": f(ga, b, 16),
                      "time_ids": torch.tensor([512., 512, 0, 0, 512, 512]).repeat(ga, b, 1)}}
    idx = torch.from_numpy(r.choice([0, 250, 500, 750], (ga, b))).long()
    return batch, idx, f(ga, b, hw, hw, 4)


def dreambooth_case():
    """One DreamBooth ``pso`` update over this rank's columns of a global
    batch of 2 x 2 microbatch rows."""
    pipe = _tiny_pipe(lora_b_std=0.05, resolution=32, with_scorer=False)
    batch, idx, noise = _db_global_batch()
    cols = lambda x: ({k: cols(v) for k, v in x.items()} if isinstance(x, dict)
                      else _rows(x.transpose(0, 1)).transpose(0, 1))
    lora = lora_parameters(pipe.unet)
    state = PSOTrainState.create(lora, make_optimizer(lora, **LORA_ARGS))
    trainer = DreamBoothPSOTrainer(DreamBoothPSOConfig(grad_accum=2, loss_type="pso"), pipe)
    metrics = trainer.update(state, cols(batch), cols(idx), cols(noise))
    return {"lora": {k: v.detach().clone() for k, v in state.lora.items()}, "metrics": metrics}


def _write_instance_pngs(d):
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(2):
        write_png(str(d / f"{i}.png"), rng.integers(0, 256, (40, 36, 3)).astype(np.uint8))


# ---------------------------------------------------------------------- #
# the rank processes
# ---------------------------------------------------------------------- #


def _collectives_case():
    """Every collective on this rank's inputs (the test holds them against
    numpy)."""
    r = parallel.rank()
    special = torch.tensor([-0.0, float("nan"), float("inf"), 1e-40, r + 0.5])
    out = {
        "gather_f32": parallel.process_allgather(special),
        "gather_bf16": parallel.process_allgather(torch.arange(5.0).bfloat16() * (r + 1)),
        "gather_i64": parallel.process_allgather(torch.arange(3) + 10 * r),
        "gather_bool": parallel.process_allgather(torch.tensor([True, r == 1])),
        "gather_np": parallel.process_allgather(np.full((2, 3), r, np.float32)),
        # uneven shards: 7 items round-robin, the last shard padded with its last
        "round_robin": parallel.round_robin_gather(
            np.asarray(ev.shard_prompts(list(range(7)), r, WORLD), np.int64), 7),
    }
    # bucketed mean over buckets of 40 bytes: two tensors packed, one alone
    # (larger than a bucket), a view that is not contiguous packed with a scalar
    base = torch.arange(64, dtype=torch.float32).reshape(8, 8) * (r + 1)
    means = [base[0, :3].clone(), base[1, :4].clone(), base[2:4].clone(), base[4:8, 1],
             torch.tensor(float(r))]
    bucket, collectives.BUCKET_BYTES = collectives.BUCKET_BYTES, 40
    try:
        parallel.all_reduce_mean_(means)
    finally:
        collectives.BUCKET_BYTES = bucket
    out["mean_"] = [t.clone() for t in means]
    bc = [torch.full((3,), float(r)), torch.arange(4) * (r + 1)]
    parallel.broadcast_(bc)
    out["broadcast"] = bc
    # a train state whose rank-1 copy differs in weights, moments, step and count
    w = {"w": torch.nn.Parameter(torch.arange(4.0))}
    state = PSOTrainState.create(w, make_optimizer(w, learning_rate=0.1))
    for _ in range(r + 1):
        w["w"].grad = torch.ones(4) * (r + 1)
        state.apply_gradients({"w": w["w"].grad})
    parallel.broadcast_train_state_(state)
    out["state"] = {"w": w["w"].detach().clone(), "step": state.step,
                    "opt": {k: v for k, v in state.tx.state_dict()["state"].items()},
                    "count": state.tx.state_dict()["count"]}
    return out


def _runner_case(out_dir):
    """A tiny Turbo run of one epoch with a checkpoint, then one more resumed
    from it; the prompts each rank's loader gave."""
    prompts = []

    class Recording(online_runner.PromptLoader):
        def epoch(self):
            for batch in super().epoch():
                prompts.append(list(batch["prompts"]))
                yield batch

    config = build_config(True, [f"output_dir={out_dir}", "run_name=r", "checkpointing_steps=1"])
    loader, online_runner.PromptLoader = online_runner.PromptLoader, Recording
    try:
        state, history, _ = online_runner.run_online_pso(config, num_epochs=1, device="cpu")
        first = {k: v.detach().clone() for k, v in state.lora.items()}
        config.resume_from = str(out_dir / "r")
        state2, history2, _ = online_runner.run_online_pso(config, num_epochs=1, device="cpu")
    finally:
        online_runner.PromptLoader = loader
    return {"lora": first, "history": history, "prompts": prompts, "step2": state2.step,
            "lora2": {k: v.detach().clone() for k, v in state2.lora.items()},
            "history2": history2}


def _full_finetune_case(out_dir):
    """``use_lora=False`` with 64 KiB buckets: most tensors packed, the
    largest alone."""
    config = build_config(True, [f"output_dir={out_dir}", "run_name=full", "use_lora=False",
                                 "checkpointing_steps=0"])
    bucket, collectives.BUCKET_BYTES = collectives.BUCKET_BYTES, 1 << 16
    try:
        state, history, _ = online_runner.run_online_pso(config, num_epochs=1, device="cpu")
    finally:
        collectives.BUCKET_BYTES = bucket
    sizes = [p.numel() * p.element_size() for p in state.lora.values()]
    return {"weights": {k: v.detach().clone() for k, v in state.lora.items()},
            "history": history, "alone": sum(s > 1 << 16 for s in sizes), "tensors": len(sizes)}


def _dreambooth_cli_case(out_dir):
    """One DreamBooth CLI step with a checkpoint; the negatives' latents each
    rank's update took."""
    seen = []
    update = DreamBoothPSOTrainer.update

    def recording(self, state, batch, idx, noise):
        seen.append(batch["negative_latents"].clone())
        return update(self, state, batch, idx, noise)

    DreamBoothPSOTrainer.update = recording
    try:
        state, history, _ = db_cli.main([
            "--tiny", "--device", "cpu", "--instance_data_dir", str(out_dir / "instance"),
            "--instance_prompt", "a photo of sks dog", "--class_prompt", "a photo of dog",
            "--output_dir", str(out_dir / "db"), "--rank", "2", "--num_negatives", "2",
            "--sample_batch_size", "2", "--gradient_accumulation_steps", "2",
            "--skip_validation", "--max_train_steps", "1", "--checkpointing_steps", "1"])
    finally:
        DreamBoothPSOTrainer.update = update
    return {"lora": {k: v.detach().clone() for k, v in state.lora.items()},
            "history": history, "negatives": seen}


def _worker(out_dir):
    torch.set_num_threads(1)
    if not parallel.maybe_initialize_distributed(timeout_s=GROUP_TIMEOUT_S):
        raise RuntimeError("no process group from the environment")
    res = {"rank": parallel.rank(), "world": parallel.world_size(),
           "collectives": _collectives_case()}
    for sampler, shared in SAMPLERS:
        res[f"sample-{sampler}-{shared}"] = sample_case(sampler, shared)
    for sampler in ("turbo", "dmd"):
        s = res[f"sample-{sampler}-True"]
        res[f"epoch-{sampler}"] = epoch_case(sampler, s["samples"], s["cond"])
    # the rank's two rows as two pair batches of one prompt each
    s = res["sample-turbo-True"]
    res["epoch-turbo-2-batches"] = epoch_case("turbo", s["samples"], s["cond"], num_batches=2)
    res["dreambooth"] = dreambooth_case()
    res["runner"] = _runner_case(out_dir)
    res["full"] = _full_finetune_case(out_dir)
    res["db_cli"] = _dreambooth_cli_case(out_dir)
    res["eval"] = ev.main(EVAL_ARGS + ["--output_json", str(out_dir / "eval_world2.json")])
    torch.save(res, out_dir / f"rank{parallel.rank()}.pt")
    parallel.shutdown_distributed()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", autouse=True)
def _ranks(tmp_path_factory):
    """Start the two rank processes at the module's start; they run beside
    the world-1 references."""
    out = tmp_path_factory.mktemp("world2")
    _write_instance_pngs(out / "instance")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(WORLD),
               OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen([sys.executable, __file__, str(out)], cwd=ROOT,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    box = {"out": out, "procs": procs, "results": None}
    yield box
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def world2(_ranks):
    """The ranks' results, once both exited 0 within ``JOIN_S``."""
    if _ranks["results"] is None:
        logs = []
        try:
            for p in _ranks["procs"]:
                logs.append(p.communicate(timeout=JOIN_S)[0])
        except subprocess.TimeoutExpired:
            for p in _ranks["procs"]:
                p.kill()
            pytest.fail(f"a rank did not finish within {JOIN_S} s")
        codes = [p.returncode for p in _ranks["procs"]]
        assert codes == [0] * WORLD, "\n".join(f"rank {r} exit {c}:\n{log[-3000:]}" for r, (c, log)
                                              in enumerate(zip(codes, logs)))
        _ranks["results"] = [torch.load(_ranks["out"] / f"rank{r}.pt", weights_only=False)
                             for r in range(WORLD)]
    return _ranks["results"], _ranks["out"]


def _cat(trees):
    """Concatenate the ranks' trees in rank order."""
    if isinstance(trees[0], dict):
        return {k: _cat([t[k] for t in trees]) for k in trees[0]}
    return torch.cat(trees)


def _equal_trees(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------- #
# one process, no environment
# ---------------------------------------------------------------------- #


def test_world_1_without_environment_is_one_process(monkeypatch):
    """No launch contract and no group: nothing starts, the collectives are
    identities and a trainer draws exactly what the pipeline draws."""
    for k in ("PSO_COORDINATOR", "MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    from pairwise_sample_optimization_tpu_torch.parallel import multihost

    assert multihost.launch_contract() is None
    assert not parallel.maybe_initialize_distributed()
    assert (parallel.rank(), parallel.world_size(), parallel.local_rank()) == (0, 1, 0)
    x = torch.randn(3, 2)
    assert torch.equal(parallel.process_allgather(x), x[None])
    y = x.clone()
    parallel.all_reduce_mean_([y])
    parallel.broadcast_([y])
    assert torch.equal(y, x)
    assert resolve_device("cpu") == torch.device("cpu")
    pipe = _tiny_pipe()
    ids = np.random.default_rng(7).integers(1, 250, (3, 2, 77))
    cond = pipe.encode_prompt(*(torch.as_tensor(i) for i in ids))
    got, _ = _trainer(pipe, "turbo", True).sample_pairs(cond, torch.Generator().manual_seed(3))
    want = pipe.sample_pairs(cond, torch.Generator().manual_seed(3), num_steps=4)
    assert torch.equal(got["log_probs"][:, 0], want.trajectory.log_probs[:3, :2].T)


def test_launch_contract_reads_torchrun_and_the_jax_packages_variables(monkeypatch):
    from pairwise_sample_optimization_tpu_torch.parallel import multihost

    for k in ("PSO_COORDINATOR", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert multihost.launch_contract() == ("env://", 3, 4)
    monkeypatch.setenv("PSO_COORDINATOR", "host0:999")
    monkeypatch.setenv("PSO_NUM_PROCESSES", "2")
    monkeypatch.setenv("PSO_PROCESS_ID", "1")
    assert multihost.launch_contract() == ("tcp://host0:999", 1, 2)
    # a rank's card is cuda:LOCAL_RANK
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert resolve_device("cuda") == torch.device("cuda", 3)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)


def test_mesh_covers_the_world_and_refuses_what_is_not_ported(tmp_path):
    """(data, model) over the world as JAX resolves it; a mesh that does not
    cover the world, and FSDP with ``mesh.model > 1`` (refused by the JAX
    runner too), are refused before any work."""
    from pairwise_sample_optimization_tpu_torch.parallel import MeshSpec

    assert MeshSpec().resolve(4) == (4, 1) and MeshSpec(data=2).resolve(2) == (2, 1)
    assert MeshSpec(model=2).resolve(4) == (2, 2) and MeshSpec(model=4).resolve(4) == (1, 4)
    assert MeshSpec(data=1, model=3).resolve(3) == (1, 3)
    assert MeshSpec(fsdp=True).resolve(1) == (1, 1) and MeshSpec(fsdp=True).resolve(2) == (2, 1)
    with pytest.raises(ValueError, match="does not cover"):
        MeshSpec(data=2).resolve(4)
    with pytest.raises(ValueError, match="does not cover"):
        MeshSpec(model=3).resolve(4)
    with pytest.raises(ValueError, match="unsupported; pick one"):
        MeshSpec(model=2, fsdp=True).resolve(2)
    config = build_config(True, [f"output_dir={tmp_path}", "mesh.data=2"])
    online_runner.check_config(config, "turbo", world=2)
    with pytest.raises(ValueError):
        online_runner.check_config(config, "turbo", world=1)
    with pytest.raises(ValueError):
        online_runner.run_online_pso(config, num_epochs=1, device="cpu")
    both = build_config(True, [f"output_dir={tmp_path}", "mesh.model=2", "mesh.fsdp=True"])
    with pytest.raises(ValueError, match="pick one"):
        online_runner.check_config(both, "turbo", world=2)
    assert not any(tmp_path.iterdir())  # refused before any work


def test_scale_lr_multiplies_by_the_world_size(monkeypatch):
    args = db_cli.parse_args(["--instance_data_dir", "x", "--instance_prompt", "p",
                              "--scale_lr", "--train_batch_size", "2"])
    w = {"w": torch.nn.Parameter(torch.zeros(2))}
    lr = lambda: db_cli.make_dreambooth_optimizer(args, w, 10).group_slices[0][2]
    one = lr()
    monkeypatch.setattr(db_cli, "world_size", lambda: 2)
    assert one == pytest.approx(2e-4 * 4 * 2) and lr() == pytest.approx(2 * one)


# ---------------------------------------------------------------------- #
# two processes against numpy and against one process
# ---------------------------------------------------------------------- #


def test_collectives_match_numpy(world2):
    res, _ = world2
    got = [r["collectives"] for r in res]
    special = [np.array([-0.0, np.nan, np.inf, 1e-40, r + 0.5], np.float32) for r in range(WORLD)]
    for g in got:  # every rank receives every row bit for bit
        assert np.array_equal(g["gather_f32"].numpy().view(np.int32),
                              np.stack(special).view(np.int32))
        assert torch.equal(g["gather_bf16"], torch.stack(
            [torch.arange(5.0).bfloat16() * (r + 1) for r in range(WORLD)]))
        assert g["gather_i64"].tolist() == [[0, 1, 2], [10, 11, 12]]
        assert g["gather_bool"].tolist() == [[True, False], [True, True]]
        assert np.array_equal(g["gather_np"], np.stack([np.full((2, 3), r, np.float32)
                                                        for r in range(WORLD)]))
        assert g["round_robin"].tolist() == list(range(7))
        base = np.arange(64, dtype=np.float32).reshape(8, 8) * 1.5  # mean of x1 and x2
        want = [base[0, :3], base[1, :4], base[2:4], base[4:8, 1], 0.5]
        for m, w in zip(g["mean_"], want):
            assert np.array_equal(m.numpy(), np.asarray(w, np.float32))
        assert g["broadcast"][0].tolist() == [0.0] * 3 and g["broadcast"][1].tolist() == [0, 1,
                                                                                          2, 3]


def test_broadcast_train_state_gives_every_rank_rank_0s(world2):
    res, _ = world2
    s0, s1 = (r["collectives"]["state"] for r in res)
    assert s0["step"] == s1["step"] == 1 and s0["count"] == s1["count"] == 1
    assert torch.equal(s0["w"], s1["w"])
    _equal_trees(s0["opt"], s1["opt"])


@pytest.mark.parametrize("sampler,shared", SAMPLERS)
def test_sample_pairs_at_world_2_equal_world_1(world2, sampler, shared):
    """Each rank's trajectories are those of one process sampling the
    concatenated prompts with the same generator."""
    res, _ = world2
    want = sample_case(sampler, shared)
    got = _cat([r[f"sample-{sampler}-{shared}"] for r in res])
    for k in want["samples"]:
        _close(got["samples"][k], want["samples"][k])
    for k in want["cond"]:
        _close(got["cond"][k], want["cond"][k])


@pytest.mark.parametrize("sampler", ["turbo", "dmd"])
def test_train_epoch_at_world_2_equals_world_1(world2, sampler):
    """Two ranks training on their halves end where one process training on
    the concatenation ends, and with the same weights as each other."""
    res, _ = world2
    halves = [r[f"sample-{sampler}-True"] for r in res]
    want = epoch_case(sampler, _cat([h["samples"] for h in halves]),
                      _cat([h["cond"] for h in halves]))
    got = [r[f"epoch-{sampler}"] for r in res]
    _equal_trees(got[0]["lora"], got[1]["lora"])
    assert got[0]["metrics"] == got[1]["metrics"] and len(want["metrics"]) == 2
    for k in want["lora"]:
        _close(got[0]["lora"][k], want["lora"][k])
    moved = max(float((want["lora"][k] - _tiny_pipe().unet.state_dict()[k]).abs().max())
                for k in want["lora"])
    assert moved > 1e-4
    for g, w in zip(got[0]["metrics"], want["metrics"]):
        for k in w:
            _close(g[k], w[k])


def test_train_epoch_over_two_pair_batches_at_world_2_equals_world_1(world2):
    """With two pair batches an epoch, two ranks train as one process whose
    every pair batch holds both ranks' prompts of that batch: the global
    batch is ordered (batch, rank), not (rank, batch)."""
    res, _ = world2
    halves = [r["sample-turbo-True"] for r in res]

    def by_batch(trees):  # one process's epoch: pair batch j = row j of each rank
        return _cat([{k: t[k][j:j + 1] for k in t} for j in range(2) for t in trees])

    want = epoch_case("turbo", by_batch([h["samples"] for h in halves]),
                      by_batch([h["cond"] for h in halves]), num_batches=2)
    rank_major = epoch_case("turbo", _cat([h["samples"] for h in halves]),
                            _cat([h["cond"] for h in halves]), num_batches=2)
    got = [r["epoch-turbo-2-batches"] for r in res]
    _equal_trees(got[0]["lora"], got[1]["lora"])
    assert got[0]["metrics"] == got[1]["metrics"] and len(want["metrics"]) == 2
    for k in want["lora"]:
        _close(got[0]["lora"][k], want["lora"][k])
    for g, w in zip(got[0]["metrics"], want["metrics"]):
        for k in w:
            _close(g[k], w[k])
    # the order matters: the rank-major concatenation trains to other weights
    assert max(float((rank_major["lora"][k] - want["lora"][k]).abs().max())
               for k in want["lora"]) > 10 * ATOL


def test_dreambooth_update_at_world_2_equals_world_1(world2):
    res, _ = world2
    want = dreambooth_case()
    got = [r["dreambooth"] for r in res]
    _equal_trees(got[0]["lora"], got[1]["lora"])
    for k in want["lora"]:
        _close(got[0]["lora"][k], want["lora"][k])
    for k in want["metrics"]:
        _close(got[0]["metrics"][k], want["metrics"][k])


def test_runner_ranks_end_bit_identical_and_resume(world2):
    """``run_online_pso`` at world 2: per-rank prompt streams, the same
    weights and logged numbers on both ranks, a fresh adapter's first loss
    log 2, one metrics row per update (rank 0 alone logs), rank 0's
    checkpoint restored by both ranks on resume."""
    res, out = world2
    r0, r1 = (r["runner"] for r in res)
    assert r0["prompts"] != r1["prompts"]  # seed + rank
    _equal_trees(r0["lora"], r1["lora"])
    _equal_trees(r0["lora2"], r1["lora2"])
    assert r0["history"] == r1["history"] and r0["history2"] == r1["history2"]
    assert abs(r0["history"][0]["loss"] - math.log(2.0)) < 1e-6
    assert r0["step2"] == r1["step2"] == 2
    assert any(not torch.equal(r0["lora"][k], r0["lora2"][k]) for k in r0["lora"])
    rows = [json.loads(x) for x in (out / "r" / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in rows if "loss" in x] == [1, 2]
    assert [x["epoch"] for x in rows if "epoch" in x] == [0, 1]
    assert (out / "r" / "checkpoint-1" / "state.pt").exists()
    assert (out / "r" / "lora-2" / "pytorch_lora_weights.safetensors").exists()


def test_full_finetuning_ranks_end_bit_identical_over_buckets(world2):
    res, _ = world2
    f0, f1 = (r["full"] for r in res)
    assert 0 < f0["alone"] < f0["tensors"]  # some tensors alone, the rest packed
    _equal_trees(f0["weights"], f1["weights"])
    assert f0["history"] == f1["history"]
    assert abs(f0["history"][0]["loss"] - math.log(2.0)) < 1e-6


def test_dreambooth_cli_ranks_draw_their_own_and_end_bit_identical(world2):
    res, out = world2
    d0, d1 = (r["db_cli"] for r in res)
    assert len(d0["negatives"]) == 1 and not torch.equal(d0["negatives"][0], d1["negatives"][0])
    _equal_trees(d0["lora"], d1["lora"])
    assert d0["history"][0]["loss"] == d1["history"][0]["loss"]
    assert (out / "db" / "checkpoint-1").exists() and (out / "db" / "lora-1").exists()
    rows = (out / "db" / "metrics.jsonl").read_text().splitlines()
    assert sum("loss" in json.loads(x) for x in rows) == 1


def test_eval_two_processes_equal_one(world2, tmp_path):
    """Rank 0 writes the JSON; its per-prompt scores equal one process's
    exactly (each prompt's noise is keyed by its global index)."""
    res, out = world2
    one = tmp_path / "eval_world1.json"
    ev.main(EVAL_ARGS + ["--output_json", str(one)])
    want = json.loads(one.read_text())
    got = json.loads((out / "eval_world2.json").read_text())
    assert got["n_prompts"] == want["n_prompts"] == 5
    assert got["per_prompt"] == want["per_prompt"]
    assert res[0]["eval"] == res[1]["eval"] == {k: v for k, v in want.items()
                                                if k.endswith("_mean")}


if __name__ == "__main__":  # a rank process of the module's fixture
    _worker(Path(sys.argv[1]))
