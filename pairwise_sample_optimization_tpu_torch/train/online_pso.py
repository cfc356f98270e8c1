"""Online PSO: sample trajectory pairs -> reward-rank -> DPO-style update.

Counterpart of the JAX package's ``train/online_pso.py`` for the Turbo
and DMD2 samplers, as eager PyTorch:

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
  backpropagates loss / n_micro into the LoRA gradients. Under
  ``full_finetune`` (the reference's ``use_lora=False``) the policy is the
  whole trained UNet and the reference pass runs the pipeline's separate
  frozen copy (``pipeline.reference_unet``), unfused. ``int8_ref_pass``
  runs that unfused reference forward (either kind) inside
  ``ops.qconv.int8_ref_pass``: its weight products and resnet convs in
  dynamic int8.

DMD2 (``sampler="dmd"``) samples on the fixed lattice
(``ops.schedules.distill_timesteps``) with DDPM re-noise transitions, and
recomputes each transition's log-prob towards ``timestep - step_ratio``
(``step_ratio = 1000 // num_steps``), as the JAX package does. With
``shared_noise`` (the reference's quirk) each transition's noise is one
draw per trajectory side: every prompt's trajectory 0 shares one, every
trajectory 1 another.

Randomness is explicit: generators, or permutation and axis tensors that
a test can take from the JAX side.

Data parallelism (a ``torch.distributed`` group of W ranks, each with B
prompts of its own) keeps the JAX package's semantics, in which every key
is the same on every process and the batch is global: ``sample_pairs``
draws the noise of the global batch of W x B prompts from the shared
generator and keeps its own rows; ``train_epoch`` gathers the ranks'
samples into the global batch (pair batch by pair batch, the ranks' rows
in rank order within each), shuffles it and draws the preference axes of
each global microbatch (``train_batch_size`` x W) from the shared CPU
generator, each rank taking its own ``train_batch_size`` rows; and
``update`` averages the gradients and the metrics over the ranks before
the clip and the optimizer. W ranks thus train as one process would whose
every pair batch holds the ranks' prompts of that batch, concatenated, and
end with the same weights.

On a (data, model) mesh (``parallel/mesh.py``) every "rank" and "W" above
is the data axis's: the model ranks of one data index draw, gather and
train on the same rows, the gradients and metrics are averaged over the
data group, and the gradient norm of tensor-parallel slices sums their
squares over the model group (``foreach_adamw.sharded_global_norm``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..ops.ddpm_renoise import distilled_logprob
from ..ops.euler_ancestral import turbo_logprob
from ..ops.qconv import int8_ref_pass
from ..ops.schedules import distill_timesteps, make_alphas_cumprod, make_euler_ancestral_schedule
from ..parallel import all_reduce_mean_, data_group, data_index, data_size, process_allgather
from ..parallel.tp import sum_partial_grads_
from .foreach_adamw import sharded_global_norm
from .losses import pareto_compare, pso_pairwise_loss, sample_compare
from .train_state import PSOTrainState

_TIME_AXIS_KEYS = ("latents", "next_latents", "input_latents", "log_probs")
_STEP_KEYS = ("step_indices", "timesteps")


@dataclasses.dataclass(frozen=True)
class OnlinePSOConfig:
    sampler: str = "turbo"  # "turbo" | "dmd"
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
    shared_noise: bool = True  # dmd only: one transition draw per trajectory side

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
        if self.sampler not in ("turbo", "dmd"):
            raise ValueError(f"unknown sampler {self.sampler!r}")
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
        if config.full_finetune and pipeline.reference_unet is None:
            raise ValueError("full_finetune needs the pipeline's frozen reference copy "
                             "(pipeline.reference_unet = models.unet.frozen_copy(unet))")
        self.config = config
        self.pipe = pipeline
        if config.sampler == "turbo":
            self.schedule = make_euler_ancestral_schedule(config.num_steps)
            self.timestep_table = self.schedule.timesteps
        else:
            self.schedule = None
            self.timestep_table = distill_timesteps(config.num_steps)
            self.alphas_cumprod = make_alphas_cumprod()
            self.step_ratio = 1000 // config.num_steps

    # ------------------------------------------------------------------ #
    # sampling
    # ------------------------------------------------------------------ #

    def sample_pairs(self, cond: dict, generator: Optional[torch.Generator] = None,
                     init_noise=None, step_noise=None):
        """Two trajectories per prompt of ``cond``'s batch B -> (samples,
        images (2B, H, W, 3)). Trajectory-major as the pipeline's batch:
        row i of trajectory k is row k*B + i. For DMD2 with
        ``shared_noise`` and no ``step_noise``, the transition noise is one
        (S-1, 2, 1, h, w, C) draw broadcast over each side's B prompts.
        With W > 1 ranks and no ``init_noise``, the noise is the global
        batch's (:meth:`global_noise`), this rank's rows of it."""
        cfg = self.config
        b = cond["embeds"].shape[0]
        if data_size() > 1 and init_noise is None:
            init_noise, step_noise = self.global_noise(b, generator, step_noise)
        if cfg.sampler == "dmd" and cfg.shared_noise and step_noise is None:
            hw, c, dev = self.pipe.latent_hw, self.pipe.unet.config.in_channels, self.pipe.device
            if init_noise is None:
                init_noise = torch.randn((2 * b, hw, hw, c), generator=generator, device=dev)
            s = cfg.num_steps - 1
            step_noise = torch.randn((s, 2, 1, hw, hw, c), generator=generator, device=dev)
            step_noise = step_noise.expand(s, 2, b, hw, hw, c).reshape(s, 2 * b, hw, hw, c)
        out = self.pipe.sample_pairs(cond, generator, num_steps=cfg.num_steps,
                                     lora_scale=1.0, init_noise=init_noise,
                                     step_noise=step_noise, sampler=cfg.sampler,
                                     shared_noise=cfg.shared_noise)
        traj = out.trajectory
        t_axis = cfg.train_timesteps
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
            "timesteps": torch.as_tensor(self.timestep_table[:t_axis], device=dev)
            .to(torch.int32).repeat(b, 1),
            "rewards": out.scores.float().reshape(2, b, 1).transpose(0, 1),
        }
        return samples, out.images

    def global_noise(self, b: int, generator: Optional[torch.Generator], step_noise=None):
        """This rank's rows of the noise a one-process run draws from
        ``generator`` for the global batch of W x ``b`` prompts (rank r's
        prompts are its rows r*b .. r*b + b-1, in both trajectory halves), in
        the one-process run's order of draws: the initial latents, then
        Turbo's step noise in one draw, DMD2's transition noise one draw a
        step (one shared draw under ``shared_noise``: kept whole, as it is
        the same for every prompt). ``step_noise``, where given, is kept."""
        cfg, pipe = self.config, self.pipe
        world, r = data_size(), data_index()
        g = world * b
        dev = pipe.device
        shape = (pipe.latent_hw, pipe.latent_hw, pipe.unet.config.in_channels)
        rows = torch.cat([torch.arange(r * b, (r + 1) * b), g + torch.arange(r * b, (r + 1) * b)])
        rows = rows.to(dev)
        init = torch.randn((2 * g,) + shape, generator=generator, device=dev)[rows]
        if step_noise is not None or (cfg.sampler == "dmd" and cfg.shared_noise):
            return init, step_noise
        if cfg.sampler == "turbo":
            step_noise = torch.randn((cfg.num_steps, 2 * g) + shape, generator=generator,
                                     device=dev, dtype=torch.float32)
        else:
            step_noise = torch.stack([
                torch.randn((2 * g,) + shape, generator=generator, device=dev,
                            dtype=torch.float32) for _ in range(cfg.num_steps - 1)])
        return init, step_noise[:, rows]

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

    def _recompute_logprob(self, eps, step_indices, timesteps, x_t, x_prev):
        if self.config.sampler == "turbo":
            return turbo_logprob(self.schedule, eps, step_indices, x_t, x_prev)
        return distilled_logprob(self.alphas_cumprod, eps, timesteps,
                                 timesteps - self.step_ratio, x_t, x_prev)

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
            ref = self.pipe.reference_unet if cfg.full_finetune else None
            with torch.no_grad(), int8_ref_pass(cfg.int8_ref_pass):
                eps_ref = self.pipe.unet_eps(inp, t2, cond2, 0.0, unet=ref)

        lp_0, lp_1 = self._recompute_logprob(eps_pol, s2, t2, x_t, x_prev).chunk(2)
        ref_0, ref_1 = self._recompute_logprob(eps_ref, s2, t2, x_t, x_prev).chunk(2)
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
        ``sample_compare``'s reward axes. With W > 1 ranks the gradients,
        the loss and ratio_win are averaged over the ranks first."""
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
        sum_partial_grads_(state.lora, grads)  # tensor parallelism's shared shares
        # the mean over the ranks' global microbatch rows, as JAX's pmean gives
        all_reduce_mean_(list(grads.values()), data_group())
        all_reduce_mean_([loss_sum, ratio_sum], data_group())
        grad_norm = sharded_global_norm(state.lora.values(), grads.values())
        state.apply_gradients(grads)
        # every optimizer has read or copied the gradients inside its step: free
        # them now, not when the next update starts (JAX's die with the step)
        del grads
        for p in state.lora.values():
            p.grad = None
        metrics = {"loss": loss_sum / n_micro, "ratio_win": ratio_sum / n_micro,
                   "grad_norm": grad_norm}
        return {k: float(v) for k, v in metrics.items()}

    def train_epoch(self, state: PSOTrainState, samples: dict, cond: dict,
                    generator: Optional[torch.Generator] = None, num_batches: int = 1):
        """All optimizer updates for one epoch of collected samples
        (leaves (B_tot, ...): ``num_batches`` pair batches one after
        another). Shuffles and compare draws come from ``generator`` (CPU).
        With W > 1 ranks the ranks' samples are gathered first into the
        global batch of a one-process run, ordered (pair batch, rank, row),
        and every draw is over it: each update's global microbatch holds
        ``train_batch_size`` x W rows, of which this rank takes its own
        ``train_batch_size``. Returns (state, list of metrics dicts)."""
        cfg = self.config
        world, r = data_size(), data_index()
        if world > 1:
            if generator is None:  # the global RNG differs between the ranks
                raise ValueError("train_epoch over several ranks needs the shared generator")
            # (W, nb * B, ...) -> (nb, W, B, ...) -> the global batch
            gather = lambda tree: {k: process_allgather(v, data_group())
                                   .unflatten(1, (num_batches, -1))
                                   .transpose(0, 1).flatten(0, 2) for k, v in tree.items()}
            samples, cond = gather(samples), gather(cond)
        b_tot = samples["log_probs"].shape[0]
        bs = cfg.train_batch_size
        per_update = bs * world * cfg.grad_accum
        if b_tot % per_update:
            raise ValueError(f"{b_tot} sampled pairs are not a multiple of train_batch_size x "
                             f"grad_accum x ranks = {per_update}")
        n_updates = b_tot // per_update
        n_micro = cfg.grad_accum * cfg.train_timesteps
        metrics = []
        for _ in range(cfg.num_inner_epochs):
            shuffled, cond_sh = self.shuffle(samples, cond, generator)

            def slice_update(tree, u):
                return {k: v[u * per_update:(u + 1) * per_update].reshape(
                    (cfg.grad_accum, bs * world) + v.shape[1:])[:, r * bs:(r + 1) * bs]
                        for k, v in tree.items()}

            for u in range(n_updates):
                axes = None
                if world > 1 and cfg.compare == "sample":
                    # the draws sample_compare makes in one process, one per
                    # global microbatch in order; this rank's columns
                    m = samples["rewards"].shape[-1]
                    axes = torch.stack([torch.randint(0, m, (bs * world,), generator=generator)
                                        for _ in range(n_micro)])[:, r * bs:(r + 1) * bs]
                metrics.append(self.update(state, slice_update(shuffled, u),
                                           slice_update(cond_sh, u), generator, axes))
        return state, metrics
