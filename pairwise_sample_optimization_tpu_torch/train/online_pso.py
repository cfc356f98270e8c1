"""Online PSO: sample trajectory pairs -> reward-rank -> DPO-style update.

Counterpart of the JAX package's ``train/online_pso.py`` for the Turbo
sampler, as eager PyTorch:

- ``sample_pairs``: both trajectories of every prompt through the
  pipeline's rollout (batch 2B), decoded and scored with PickScore, packed
  into the JAX samples dict: (B, 2, T, h, w, c) latents / next_latents /
  input_latents, (B, 2, T) log_probs, (B, T) step_indices and timesteps,
  (B, 2, M) rewards;
- ``shuffle``: one batch permutation, plus per-sample timestep
  permutations shared by the two trajectories of a pair;
- ``update``: one optimizer step over ``grad_accum x T`` microbatches;
  each microbatch runs the policy pass (``lora_scale=1``, with grad) and
  the frozen reference pass (``lora_scale=0``; under ``no_grad`` by
  default, or fused into one 4b-batch call with a per-sample scale and a
  detached reference half), recomputes the transition log-probs and
  backpropagates loss / n_micro into the LoRA gradients.

Randomness is explicit: generators, or permutation and axis tensors that
a test can take from the JAX side.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..ops.euler_ancestral import turbo_logprob
from ..ops.schedules import make_euler_ancestral_schedule
from .losses import pareto_compare, pso_pairwise_loss, sample_compare
from .train_state import PSOTrainState, global_norm

_TIME_AXIS_KEYS = ("latents", "next_latents", "input_latents", "log_probs")
_STEP_KEYS = ("step_indices", "timesteps")


@dataclasses.dataclass(frozen=True)
class OnlinePSOConfig:
    sampler: str = "turbo"  # only "turbo" is ported
    num_steps: int = 4
    beta: float = 50.0
    eps: float = 0.1
    train_batch_size: int = 4
    grad_accum: int = 2
    num_inner_epochs: int = 1
    compare: str = "sample"  # "sample" | "pareto"
    clamp_mode: str = "ratio"  # "ratio" | "logratio" | "none"
    num_train_timesteps: Optional[int] = None  # default: num_steps - 1
    fuse_ref_pass: bool = False
    full_finetune: bool = False
    int8_ref_pass: bool = False

    def __post_init__(self):
        if self.num_steps < 2:
            raise ValueError(
                "online PSO needs >= 2 sampling steps (the single step of a 1-step sampler "
                "is deterministic: nothing stochastic to train)")
        if self.num_train_timesteps and self.num_train_timesteps > self.num_steps - 1:
            raise ValueError(
                f"num_train_timesteps={self.num_train_timesteps} exceeds the "
                f"{self.num_steps - 1} recorded stochastic transitions")
        if self.full_finetune and self.fuse_ref_pass:
            raise ValueError("full_finetune needs fuse_ref_pass=False")
        if self.int8_ref_pass and self.fuse_ref_pass:
            raise ValueError("int8_ref_pass needs fuse_ref_pass=False")
        if self.sampler == "dmd":
            raise NotImplementedError("the DMD2 sampler is not ported yet")
        if self.sampler != "turbo":
            raise ValueError(f"unknown sampler {self.sampler!r}")
        if self.full_finetune:
            raise NotImplementedError("full finetuning is not ported yet (LoRA only)")
        if self.int8_ref_pass:
            raise NotImplementedError("the int8 reference pass is not ported yet")
        if self.compare not in ("sample", "pareto"):
            raise ValueError(f"unknown compare {self.compare!r}")

    @property
    def train_timesteps(self) -> int:
        return self.num_train_timesteps or (self.num_steps - 1)


def _cat2(x):
    return torch.cat([x, x], dim=0)


class OnlinePSOTrainer:
    """Sampling and update for one pipeline (``pipeline.SDXLPipeline``).

    The update needs only ``pipeline.unet_eps``; ``sample_pairs`` also
    needs its VAE and PickScore scorer."""

    def __init__(self, config: OnlinePSOConfig, pipeline):
        self.config = config
        self.pipe = pipeline
        self.schedule = make_euler_ancestral_schedule(config.num_steps)

    # ------------------------------------------------------------------ #
    # sampling
    # ------------------------------------------------------------------ #

    def sample_pairs(self, cond: dict, generator: Optional[torch.Generator] = None,
                     init_noise=None, step_noise=None):
        """Two trajectories per prompt of ``cond``'s batch B -> (samples,
        images (2B, H, W, 3)). Trajectory-major as the pipeline's batch:
        row i of trajectory k is row k*B + i."""
        out = self.pipe.sample_pairs(cond, generator, num_steps=self.config.num_steps,
                                     lora_scale=1.0, init_noise=init_noise,
                                     step_noise=step_noise)
        traj, b = out.trajectory, cond["embeds"].shape[0]
        t_axis = self.config.train_timesteps
        dev = traj.latents.device

        def to_bp(x):  # (T, 2B, ...) -> (B, 2, T, ...)
            x = x[:t_axis].movedim(0, 1)
            return x.reshape((2, b) + x.shape[1:]).transpose(0, 1)

        samples = {
            "latents": to_bp(traj.current_latents),
            "next_latents": to_bp(traj.next_latents),
            "input_latents": to_bp(traj.input_latents),
            "log_probs": to_bp(traj.log_probs),
            "step_indices": torch.arange(t_axis, dtype=torch.long, device=dev).repeat(b, 1),
            "timesteps": torch.as_tensor(self.schedule.timesteps[:t_axis], device=dev)
            .to(torch.int32).repeat(b, 1),
            "rewards": out.scores.float().reshape(2, b, 1).transpose(0, 1),
        }
        return samples, out.images

    # ------------------------------------------------------------------ #
    # shuffling
    # ------------------------------------------------------------------ #

    def shuffle(self, samples: dict, cond: dict, generator: Optional[torch.Generator] = None,
                batch_perm=None, step_perms=None):
        """Permute samples and cond together over the batch; permute each
        sample's timesteps (the same permutation for both trajectories).
        Draws from ``generator`` (CPU) unless ``batch_perm`` (B,) and
        ``step_perms`` (B, T) are given."""
        b, _, t = samples["log_probs"].shape
        dev = samples["log_probs"].device
        if batch_perm is None:
            batch_perm = torch.randperm(b, generator=generator)
        if step_perms is None:
            step_perms = torch.stack([torch.randperm(t, generator=generator) for _ in range(b)])
        batch_perm, step_perms = batch_perm.to(dev).long(), step_perms.to(dev).long()
        out = {k: v[batch_perm] for k, v in samples.items()}
        cond = {k: v[batch_perm.to(v.device)] for k, v in cond.items()}

        def perm_time(x, axis):
            idx = step_perms.reshape((b,) + (1,) * (axis - 1) + (t,) + (1,) * (x.ndim - axis - 1))
            return torch.take_along_dim(x, idx, dim=axis)

        for k in _TIME_AXIS_KEYS:
            out[k] = perm_time(out[k], 2)
        for k in _STEP_KEYS:
            out[k] = perm_time(out[k], 1)
        return out, cond

    # ------------------------------------------------------------------ #
    # update
    # ------------------------------------------------------------------ #

    def _micro_loss(self, micro: dict, cond: dict, generator=None, axis=None):
        """Loss and ratio_win for one (train_bs, one-timestep) microbatch."""
        cfg = self.config
        bsz = micro["timesteps"].shape[0]

        def flat(x):  # (b, 2, ...) -> (2b, ...): [traj0 | traj1]
            return x.transpose(0, 1).reshape((2 * bsz,) + x.shape[2:])

        inp, x_t, x_prev = (flat(micro[k]) for k in ("input_latents", "latents", "next_latents"))
        t2, s2 = _cat2(micro["timesteps"]), _cat2(micro["step_indices"])
        cond2 = {k: _cat2(v) for k, v in cond.items()}
        if cfg.fuse_ref_pass:
            scale4 = torch.cat([torch.ones(2 * bsz, device=inp.device),
                                torch.zeros(2 * bsz, device=inp.device)])
            cond4 = {k: _cat2(v) for k, v in cond2.items()}
            eps4 = self.pipe.unet_eps(_cat2(inp), _cat2(t2), cond4, scale4)
            eps_pol, eps_ref = eps4.chunk(2)
            eps_ref = eps_ref.detach()
        else:
            eps_pol = self.pipe.unet_eps(inp, t2, cond2, 1.0)
            with torch.no_grad():
                eps_ref = self.pipe.unet_eps(inp, t2, cond2, 0.0)

        lp_0, lp_1 = turbo_logprob(self.schedule, eps_pol, s2, x_t, x_prev).chunk(2)
        ref_0, ref_1 = turbo_logprob(self.schedule, eps_ref, s2, x_t, x_prev).chunk(2)
        r = micro["rewards"]
        if cfg.compare == "sample":
            prefer = sample_compare(r[:, 0], r[:, 1], generator, axis)
        else:
            prefer = pareto_compare(r[:, 0], r[:, 1])
        loss = pso_pairwise_loss(lp_0, ref_0, lp_1, ref_1, prefer, cfg.beta, cfg.eps,
                                 clamp_mode=cfg.clamp_mode)
        ratio_w = torch.exp(torch.where(prefer[:, 0] > 0, lp_0 - ref_0, lp_1 - ref_1)).mean()
        return loss, ratio_w

    def update(self, state: PSOTrainState, batch: dict, cond: dict,
               generator: Optional[torch.Generator] = None,
               compare_axes=None) -> Dict[str, float]:
        """One optimizer update. ``batch`` and ``cond`` leaves are
        (grad_accum, train_bs, ...). Gradients of loss / n_micro accumulate
        over the ``grad_accum x T`` microbatches (microbatch a*T + j takes
        slice a, timestep column j); ``grad_norm`` is the norm of their
        mean, before clipping. ``compare_axes`` (n_micro, train_bs) fixes
        ``sample_compare``'s reward axes."""
        cfg = self.config
        t_steps = cfg.train_timesteps
        n_micro = cfg.grad_accum * t_steps
        dev = batch["log_probs"].device
        for p in state.lora.values():
            p.grad = None
        loss_sum = torch.zeros((), device=dev)
        ratio_sum = torch.zeros((), device=dev)
        for aj in range(n_micro):
            a, j = divmod(aj, t_steps)
            micro = {k: batch[k][a][:, :, j] for k in ("input_latents", "latents", "next_latents")}
            micro.update({k: batch[k][a][:, j] for k in _STEP_KEYS})
            micro["rewards"] = batch["rewards"][a]
            c = {k: v[a] for k, v in cond.items()}
            axis = None if compare_axes is None else compare_axes[aj]
            loss, ratio_w = self._micro_loss(micro, c, generator, axis)
            (loss / n_micro).backward()
            loss_sum += loss.detach()
            ratio_sum += ratio_w.detach()
        grads = {name: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for name, p in state.lora.items()}
        grad_norm = global_norm(grads.values())
        state.apply_gradients(grads)
        metrics = {"loss": loss_sum / n_micro, "ratio_win": ratio_sum / n_micro,
                   "grad_norm": grad_norm}
        return {k: float(v) for k, v in metrics.items()}

    def train_epoch(self, state: PSOTrainState, samples: dict, cond: dict,
                    generator: Optional[torch.Generator] = None):
        """All optimizer updates for one epoch of collected samples
        (leaves (B_tot, ...)). Shuffles and compare draws come from
        ``generator`` (CPU). Returns (state, list of metrics dicts)."""
        cfg = self.config
        b_tot = samples["log_probs"].shape[0]
        per_update = cfg.train_batch_size * cfg.grad_accum
        if b_tot % per_update:
            raise ValueError(f"{b_tot} sampled pairs are not a multiple of train_batch_size x "
                             f"grad_accum = {per_update}")
        n_updates = b_tot // per_update
        metrics = []
        for _ in range(cfg.num_inner_epochs):
            shuffled, cond_sh = self.shuffle(samples, cond, generator)

            def slice_update(tree, u):
                return {k: v[u * per_update:(u + 1) * per_update].reshape(
                    (cfg.grad_accum, cfg.train_batch_size) + v.shape[1:]) for k, v in tree.items()}

            for u in range(n_updates):
                metrics.append(self.update(state, slice_update(shuffled, u),
                                           slice_update(cond_sh, u), generator))
        return state, metrics
