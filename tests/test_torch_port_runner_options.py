"""The runner's options that JAX accepts and the port used to refuse, on the
CPU with the tiny models: gradients released after every update (both
trainers), the per-tensor 8-bit AdamW against the flat one and the JAX
package's ``adam8bit`` (int8 state bit-equal) and under ``use_lora=False``
through the runner (save, restore, resume), ``profile_dir``, ``use_wandb``,
the runner's ``hf:`` validation source and the eval's ``--hf_dataset``.
"""

import json
import logging
import math
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pairwise_sample_optimization_tpu.data import prompt_dataset as jpd
from pairwise_sample_optimization_tpu.train.quantized_adam import adam8bit as jadam8bit
from pairwise_sample_optimization_tpu_torch.cli import evaluate_sdxl_dmd2 as ev
from pairwise_sample_optimization_tpu_torch.cli import online_runner
from pairwise_sample_optimization_tpu_torch.cli import train_pso_sdxl_turbo_dreambooth as db_cli
from pairwise_sample_optimization_tpu_torch.cli.train_online_pso_sdxl_turbo import build_config
from pairwise_sample_optimization_tpu_torch.train import (DreamBoothPSOTrainer, OnlinePSOTrainer,
                                                          PSOTrainState)
from pairwise_sample_optimization_tpu_torch.train.quantized_adam import Adam8bit, ForeachAdam8bit
from pairwise_sample_optimization_tpu_torch.utils.png import write_png

FIXTURE = Path(__file__).parent / "fixtures" / "pickapic_test_unique_export"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is as fast, and does not
    oversubscribe the CPU when test files run in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(tmp_path, *overrides, epochs=1, name="r"):
    config = build_config(True, [f"output_dir={tmp_path}", f"run_name={name}", *overrides])
    state, history, pipe = online_runner.run_online_pso(config, num_epochs=epochs, device="cpu")
    return config, state, history, pipe


def _rows(tmp_path, name="r"):
    return [json.loads(r) for r in (tmp_path / name / "metrics.jsonl").read_text().splitlines()]


def _db_argv(tmp_path, *extra):
    d = tmp_path / "instance"
    d.mkdir(exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(2):
        write_png(str(d / f"{i}.png"), rng.integers(0, 256, (40, 36, 3)).astype(np.uint8))
    return ["--tiny", "--device", "cpu", "--instance_data_dir", str(d), "--instance_prompt",
            "a photo of sks dog", "--class_prompt", "a photo of dog", "--output_dir",
            str(tmp_path / "out"), "--rank", "2", "--num_negatives", "2",
            "--sample_batch_size", "2", "--gradient_accumulation_steps", "2",
            "--skip_validation", *extra]


# ---------------------------------------------------------------------- #
# gradients released after each update
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("trainer", ["online-lora", "online-full", "dreambooth-lora"])
def test_update_releases_every_gradient(tmp_path, monkeypatch, trainer):
    """Every trained tensor held a gradient when the optimizer stepped, and
    none holds one when ``update`` returns (JAX's die with the step)."""
    held, left = [], []
    apply = PSOTrainState.apply_gradients

    def apply_gradients(state, grads):
        held.append(sum(p.grad is not None for p in state.lora.values()) / len(state.lora))
        return apply(state, grads)

    cls = DreamBoothPSOTrainer if trainer.startswith("dreambooth") else OnlinePSOTrainer
    update = cls.update

    def watched(self, state, *args, **kwargs):
        out = update(self, state, *args, **kwargs)
        left.append([k for k, p in state.lora.items() if p.grad is not None])
        return out

    monkeypatch.setattr(PSOTrainState, "apply_gradients", apply_gradients)
    monkeypatch.setattr(cls, "update", watched)
    if trainer == "dreambooth-lora":
        state, history, _ = db_cli.main(_db_argv(tmp_path, "--max_train_steps", "2"))
    else:
        over = ["use_lora=False"] if trainer == "online-full" else []
        _, state, history, _ = _run(tmp_path, *over, epochs=2)
    assert len(held) == len(left) == len(history) >= 2
    assert all(h > 0.5 for h in held) and left == [[]] * len(left)


# ---------------------------------------------------------------------- #
# the per-tensor 8-bit AdamW
# ---------------------------------------------------------------------- #

SHAPES = {"a.lora.down.weight": (17, 20), "a.lora.up.weight": (300,), "b.weight": (5,),
          "c.weight": (40, 30), "d.bias": (600,)}
GROUPS = (("a.lora.down.weight", "a.lora.up.weight", "b.weight"), ("c.weight", "d.bias"))
HP = ((1e-2, 1e-2), (3e-3, 0.0))  # (lr, weight decay) of each group


def _groups(ps, schedule=None):
    return [{"params": {k: ps[k] for k in names}, "lr": lr, "weight_decay": wd,
             "schedule": schedule if i == 0 else None}
            for i, (names, (lr, wd)) in enumerate(zip(GROUPS, HP))]


def _steps(make, params, grads):
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    tx = make(ps)
    for g in grads:
        tx.step(ps, {k: torch.from_numpy(v) for k, v in g.items()})
    return ps, tx


@pytest.mark.parametrize("clip", [math.inf, 0.5], ids=["no-clip", "clip"])
def test_per_tensor_8bit_adam_is_bit_equal_to_the_flat_one_and_jax(clip):
    """3 steps over two groups, the tensors split over four chunks. Without
    the clip (JAX's ``adam8bit`` has none): every int8 payload and scale
    bit-equal to the flat ``Adam8bit``'s and to JAX's per group, the weights
    equal to the flat one's and within 1e-6 of JAX's. With the clip engaged
    (and a schedule on the first group) the global norm is summed in another
    order than the flat buffer's, so its last bit may differ: the scales
    within 1e-6, the payloads within one step, the weights within 1e-6."""
    r = np.random.default_rng(4)
    params = {k: (r.standard_normal(s) * 0.5).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (r.standard_normal(s) * r.choice([1e-3, 0.1, 3.0])).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(3)]
    schedule = (lambda k: 1.0 / k) if clip != math.inf else None
    flat_ps, flat = _steps(lambda ps: Adam8bit(_groups(ps, schedule), max_grad_norm=clip),
                           params, grads)
    ps, tx = _steps(lambda ps: ForeachAdam8bit(_groups(ps, schedule), max_grad_norm=clip,
                                               chunk=1100), params, grads)
    assert len(tx.chunks) == 4 and tx.count == 3
    for k in SHAPES:
        got, want = tx.tensor_state(k), flat.tensor_state(k)
        assert [t.dtype for t in got] == [t.dtype for t in want]
        if clip == math.inf:
            assert all(torch.equal(a, b) for a, b in zip(got, want)), k
            assert torch.equal(ps[k], flat_ps[k]), k
        else:
            for q in (0, 2):
                assert int((got[q].int() - want[q].int()).abs().max()) <= 1, k
                torch.testing.assert_close(got[q + 1], want[q + 1], atol=0, rtol=1e-6)
            torch.testing.assert_close(ps[k], flat_ps[k], atol=1e-6, rtol=0)
    if clip != math.inf:
        return
    for names, (lr, wd) in zip(GROUPS, HP):
        tx_j = jadam8bit(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd)
        tree = {k: jnp.asarray(params[k]) for k in names}
        state = tx_j.init(tree)
        for g in grads:
            updates, state = tx_j.update({k: jnp.asarray(g[k]) for k in names}, state, tree)
            tree = {k: tree[k] + updates[k] for k in names}
        for k in names:
            want = (state.mu[k].q, state.mu[k].scale, state.nu[k].q, state.nu[k].scale)
            for got, w in zip(tx.tensor_state(k), want):
                np.testing.assert_array_equal(got.numpy(), np.asarray(w), err_msg=k)
            np.testing.assert_allclose(ps[k].detach().numpy(), np.asarray(tree[k]), atol=1e-6,
                                       rtol=0)


def test_runner_full_finetune_with_8bit_adam_saves_restores_and_resumes(tmp_path):
    """``use_lora=False`` with ``train.use_8bit_adam``: the per-tensor 8-bit
    AdamW over every UNet weight, first loss log 2, every weight trained; a
    run resumed from its first epoch's checkpoint gives the uninterrupted
    run's second epoch, weights and int8 state bit for bit."""
    over = ("use_lora=False", "train.use_8bit_adam=True", "train.learning_rate=1e-3",
            "checkpointing_steps=1")
    _, state, history, pipe = _run(tmp_path, *over, epochs=2, name="a")
    assert isinstance(state.tx, ForeachAdam8bit) and state.step == 2
    assert abs(history[0]["loss"] - math.log(2.0)) < 1e-6
    ref = pipe.reference_unet.state_dict()
    assert set(state.lora) == set(ref) and all(not torch.equal(p, ref[k])
                                               for k, p in state.lora.items())
    config, _, _, _ = _run(tmp_path, *over, name="b")
    config.resume_from = str(tmp_path / "b")
    resumed, history_b, _ = online_runner.run_online_pso(config, num_epochs=1, device="cpu")
    assert resumed.step == 2 and history_b == history[1:]
    for k, p in state.lora.items():
        assert torch.equal(resumed.lora[k], p), k
    for name in ForeachAdam8bit.state_names:
        for got, want in zip(getattr(resumed.tx, name), getattr(state.tx, name)):
            assert torch.equal(got, want), name


# ---------------------------------------------------------------------- #
# profile_dir, use_wandb
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("epochs", [2, 1])
def test_profile_dir_traces_the_second_epoch_or_the_only_one(tmp_path, epochs):
    """As the JAX runner: the second epoch of the invocation where there is
    one, else the only one; a Chrome trace of the host's operators."""
    _run(tmp_path, f"profile_dir={tmp_path / 'trace'}", epochs=epochs)
    files = sorted(p.name for p in (tmp_path / "trace").iterdir())
    assert files == [f"epoch-{epochs - 1}.json"]
    events = json.loads((tmp_path / "trace" / files[0]).read_text())["traceEvents"]
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert "aten::convolution" in ops and "aten::mm" in ops


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.mark.parametrize("entry", ["runner", "dreambooth"])
def test_use_wandb_without_wandb_warns_and_keeps_the_jsonl(tmp_path, monkeypatch, entry):
    monkeypatch.setitem(sys.modules, "wandb", None)  # an import of wandb fails
    handler = _Warnings()
    logging.getLogger("pso").addHandler(handler)
    try:
        if entry == "runner":
            _, _, history, _ = _run(tmp_path, "use_wandb=True")
            rows = _rows(tmp_path)
        else:
            _, history, _ = db_cli.main(_db_argv(tmp_path, "--max_train_steps", "1",
                                                 "--use_wandb"))
            rows = [json.loads(r) for r in
                    (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()]
    finally:
        logging.getLogger("pso").removeHandler(handler)
    assert any("wandb unavailable" in m and "JSONL logging only" in m for m in handler.messages)
    assert history and any("loss" in r for r in rows)


def test_use_wandb_logs_each_row_to_a_wandb_run(tmp_path, monkeypatch):
    """With wandb importable the runner starts a run (project, name, the
    config) and logs every JSONL row to it at its step, then finishes it."""
    calls = {"init": [], "log": [], "finish": 0}

    class Run:
        def log(self, metrics, step):
            calls["log"].append((step, dict(metrics)))

        def finish(self):
            calls["finish"] += 1

    def init(**kwargs):
        calls["init"].append(kwargs)
        return Run()

    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(init=init))
    config, _, _, _ = _run(tmp_path, "use_wandb=True")
    (kw,) = calls["init"]
    assert kw["project"] == "Online_PSO" and kw["name"] == "r"
    assert kw["config"]["train"]["beta"] == config.train.beta
    rows = _rows(tmp_path)
    assert [s for s, _ in calls["log"]] == [r["step"] for r in rows]
    assert all(m == {k: v for k, v in r.items() if k not in ("step", "ts")}
               for (_, m), r in zip(calls["log"], rows))
    assert calls["finish"] == 1


# ---------------------------------------------------------------------- #
# HF datasets prompt sources
# ---------------------------------------------------------------------- #


def test_runner_validates_on_an_hf_export(tmp_path, monkeypatch):
    """``val_dataset=hf:<save_to_disk dir>`` with ``val_split_name``: the
    validation prompts are the JAX package's (``load_from_disk``), and a
    run validates on them."""
    seen = []
    validate = online_runner.run_validation

    def run_validation(pipe, clip_scorer, prompts, *args, **kwargs):
        seen.append(list(prompts))
        return validate(pipe, clip_scorer, prompts, *args, **kwargs)

    monkeypatch.setattr(online_runner, "run_validation", run_validation)
    over = (f"val_dataset=hf:{FIXTURE}", "val_split_name=test_unique", "validation_steps=1",
            "val_max_prompts=3")
    config, _, _, _ = _run(tmp_path, *over)
    want = jpd.PromptDataset(hf_dataset=str(FIXTURE), split="test_unique").prompts[:3]
    assert online_runner.validation_prompts(config) == want and seen == [want]
    assert any(math.isfinite(r.get("val/pickscore", math.nan)) for r in _rows(tmp_path))


def test_eval_cli_reads_an_hf_export(tmp_path):
    """``--hf_dataset <dir> --split test_unique``: the fixture holds the
    first packaged ImageReward prompts, so the scores equal those of
    ``--prompts_json imagereward`` bit for bit."""
    def run(name, *extra):
        out = tmp_path / f"{name}.json"
        ev.main(["--tiny", "--device", "cpu", "--scorers", "pickscore,aesthetic",
                 "--aesthetic_mlp_path", "packaged", "--max_prompts", "3", "--output_json",
                 str(out), *extra])
        return json.loads(out.read_text())

    hf = run("hf", "--hf_dataset", str(FIXTURE), "--split", "test_unique")
    packaged = run("packaged", "--prompts_json", "imagereward")
    assert hf["n_prompts"] == 3 and hf["per_prompt"] == packaged["per_prompt"]
