"""The train step.

Port of ``dfot_tpu/training/trainer.py``: draw per-token noise levels,
diffuse, run the denoiser, weighted-MSE loss with the frame mask as a
weight, backward, AdamW update, EMA update. Eager PyTorch: the state is
updated in place and handed back.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..diffusion import core as dc
from ..diffusion.continuous import continuous_training_fields, continuous_v_loss
from .noise_levels import NoiseLevelConfig, draw_rows, training_noise_levels
from .optim import global_norm
from .state import TrainState, gated_ema_update

__all__ = ["denoising_loss", "make_train_step", "training_noise"]


def training_noise(dcfg: dc.DiffusionConfig, shape, generator, device, dtype,
                   rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The diffusion noise of a training pass, clipped; with ``rows``, this
    share's rows of the global batch's draw (:func:`draw_rows`)."""
    return draw_rows(lambda s: dc.clipped_normal(s, dcfg.clip_noise, generator, device, dtype),
                     shape, rows)


def denoising_loss(model_apply: Callable, dcfg: dc.DiffusionConfig, sched: dc.Schedule,
                   nl_cfg: NoiseLevelConfig, model, xs, conditions, frame_mask,
                   generator: Optional[torch.Generator], train: bool = True,
                   noise_levels=None, noise=None,
                   rows: Optional[Tuple[int, int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked mean loss, x0 reconstruction) of one denoising pass: noise
    levels drawn per token (``train=False``: no context dropout), xs
    diffused, the denoiser's loss weighted by the frame mask and averaged
    over all elements. The draws can be injected as in
    :func:`make_train_step`; ``rows`` as :func:`training_noise_levels` takes
    it, for the level draws and the noise alike. The train step's loss
    (``dfot_tpu/training/trainer.py:45``) and the eval denoiser's
    (``dfot_tpu/algorithms/dfot_video.py:388``)."""
    dev = sched.device
    draws = noise_levels if isinstance(noise_levels, dict) or noise_levels is None \
        else {"levels": noise_levels}
    k, loss_mask = training_noise_levels(generator, nl_cfg, frame_mask, train, draws, rows=rows)
    xs = xs.float()
    if noise is None:
        noise = training_noise(dcfg, xs.shape, generator, dev, xs.dtype, rows)
    else:
        noise = torch.as_tensor(noise, device=dev, dtype=xs.dtype).clamp(
            -dcfg.clip_noise, dcfg.clip_noise)
    if dcfg.is_continuous:
        x_t, logsnr, alpha_t, sigma_t = continuous_training_fields(dcfg, xs, k, noise)
        out = model_apply(model, x_t, dcfg.precond_scale * logsnr, conditions, None)
        recons, loss = continuous_v_loss(dcfg, out, x_t, noise, logsnr, alpha_t, sigma_t)
    else:
        noised, target = dc.training_targets(sched, dcfg, xs, k, noise)
        out = model_apply(model, noised, k.float(), conditions, None)
        loss = dc.training_loss(sched, dcfg, out, target, k)
        if dcfg.objective == "pred_x0":
            recons = out
        elif dcfg.objective == "pred_noise":
            recons = dc.predict_start_from_noise(sched, noised, k, out)
        else:
            recons = dc.predict_start_from_v(sched, noised, k, out)
    # the frame mask weighs the loss; the mean is over all elements
    w = dc.bcast_right(loss_mask.to(loss.dtype), loss.ndim)
    return (loss * w).mean(), recons


def make_train_step(
    model_apply: Callable,
    dcfg: dc.DiffusionConfig,
    sched: dc.Schedule,
    nl_cfg: NoiseLevelConfig,
    ema_decay: float = 0.9999,
    accumulate_steps: int = 1,
    loss_fn: Optional[Callable] = None,
    rows: Optional[Tuple[int, int]] = None,
    grad_sync: Optional[Callable] = None,
):
    """Build ``train_step(state, batch, generator) -> (state, metrics)``.

    ``model_apply(model, x, noise_levels, cond, cond_mask)`` runs the
    denoiser (noise_levels: raw k for discrete models, precond-scaled logSNR
    for continuous ones) and returns fp32; mixed precision is its business.

    batch: {"xs": (B, T, *x), "conditions": optional, "masks": (B, T) bool},
    on the device of ``sched``. metrics: {"loss", "grad_norm"}, 0-d tensors
    on that device (reading them waits for the step).

    Noise levels and noise are drawn from ``generator``; dropout inside the
    model draws from the device's global generator, seeded here from the
    generator's seed and the step count and restored afterwards. For
    parity tests the draws can be injected: ``noise_levels`` (the level draw
    as a tensor, or a dict of draws as :func:`training_noise_levels` takes
    them), ``noise`` (unclipped N(0, 1), same shape as xs), and
    ``dropout=False`` puts the model in eval mode.

    ``loss_fn(model, xs, conditions, frame_mask, generator, noise_levels,
    noise) -> (loss, parts)`` replaces the denoising loss; ``parts``, a dict
    of detached 0-d tensors, joins the metrics.

    Data parallelism: ``rows=(index, count)`` says the batch is the rows
    ``index::count`` of a global batch (:func:`denoising_loss` then draws for
    the global batch and takes these rows), and ``grad_sync(model)``, called
    after the backward, averages the gradients over the processes
    (``parallel.mesh.average_gradients``); the losses in the metrics are this
    process's, the gradient norm the averaged gradients'.
    """
    dev = sched.device
    if loss_fn is None:
        def loss_fn(model, xs, conditions, frame_mask, generator, noise_levels, noise):
            return denoising_loss(model_apply, dcfg, sched, nl_cfg, model, xs, conditions,
                                  frame_mask, generator, True, noise_levels, noise, rows)[0], {}

    def train_step(
        state: TrainState, batch: Dict, generator: Optional[torch.Generator], *,
        noise_levels=None, noise=None, dropout: bool = True,
    ) -> Tuple[TrainState, Dict]:
        model, opt = state.model, state.optimizer
        model.train(dropout)
        opt.zero_grad()
        seed = 0 if generator is None else generator.initial_seed()
        with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
            torch.manual_seed((seed * 1000003 + state.step) % (2 ** 63))
            loss, parts = loss_fn(model, batch["xs"], batch.get("conditions"), batch["masks"],
                                  generator, noise_levels, noise)
            loss.backward()
        if grad_sync is not None:
            grad_sync(model)
        grads = [p.grad for p in opt.params if p.grad is not None]
        grad_norm = global_norm(grads)
        opt.step()
        state.step += 1
        if state.ema is not None:
            gated_ema_update(state.ema, dict(model.named_parameters()), ema_decay,
                             state.step, accumulate_steps)
        return state, {"loss": loss.detach(), "grad_norm": grad_norm, **parts}

    return train_step
