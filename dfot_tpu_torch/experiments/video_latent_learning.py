"""First-stage (VAE) training: reconstruction + KL + PatchGAN adversarial.

Port of ``dfot_tpu/experiments/video_latent_learning.py`` on ``device``
(None: the card). An ImageVAE (``algorithm=image_vae``: the frames of a clip
are its batch) or a VideoVAE (``algorithm=video_vae``) trains against
:class:`NLayerDiscriminator`, one autoencoder update and one discriminator
update a step, each with Adam(lr, betas (0.5, 0.9)):

- the autoencoder's loss is the mean reconstruction error (``loss_type``
  l1 or l2), ``kl_weight`` times the posterior's KL, and the adversarial
  term -mean(D(recon)) times ``disc_weight`` (zero before ``disc_start``,
  :func:`adopt_weight`) times the adaptive weight ||grad rec|| / (||grad
  gan|| + 1e-4), both gradients taken with respect to the decoder's last
  conv weight, clipped and detached. As in the JAX package, the step has no
  perceptual term (``perceptual_weight`` is not read);
- the discriminator consumes frames; its pass inside the autoencoder's loss
  normalizes by the batch's statistics and discards them, while its own
  update folds the real batch's and then the reconstruction's statistics
  into its running ones, as the JAX step threads them;
- ``metrics.jsonl`` gets ``g_total``, ``d_total``, ``rec_loss``, ``kl_loss``,
  ``g_loss`` and ``d_weight`` at step 1 and every 50 steps; the
  autoencoder's train state is saved at the end under
  ``<output_dir>/checkpoints/`` (``training/checkpoint.py``);
- ``timings``: each step's wall (the device synchronized at its end) and the
  seconds of its phases: the forward, the adaptive weight, the autoencoder's
  update and the discriminator's.

Data comes from ``build_dataset`` through the loader, shuffled; videos are
in [0, 1] and scaled to [-1, 1]. The posterior draws come from a generator
seeded ``experiment.training.manual_seed`` (0), the models' initial weights
from the same seed.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import torch

from ..data.loader import DataLoader
from ..data.video_dataset import build_dataset
from ..diffusion.core import resolve_device
from ..training.checkpoint import save_checkpoint
from ..training.optim import Optimizer
from ..training.state import create_train_state
from ..utils.logging import MetricsLogger
from ..vae import (
    ImageVAE,
    ImageVAEConfig,
    NLayerDiscriminator,
    VideoVAE,
    VideoVAEConfig,
    adopt_weight,
    calculate_adaptive_weight,
    decoder_last_layer,
    vae_discriminator_loss,
    vae_generator_loss,
)

__all__ = ["VideoLatentLearningExperiment"]

LOG_EVERY = 50
PHASES = ("ae_forward", "adaptive_weight", "ae_update", "disc_update")


class VideoLatentLearningExperiment:
    def __init__(self, cfg, output_dir: Optional[str] = None, load: Optional[str] = None,
                 device=None):
        self.cfg = cfg
        self.output_dir = output_dir or "outputs"
        os.makedirs(self.output_dir, exist_ok=True)
        self.ckpt_dir = os.path.join(self.output_dir, "checkpoints")
        self.device = resolve_device(device)
        self.logger = MetricsLogger(self.output_dir)
        self.timings: Dict[str, object] = {}
        acfg = cfg.algorithm
        self.is_video = "video" in acfg.get("_name", "image_vae")
        if self.is_video:
            self.vae_cfg = VideoVAEConfig.from_config(acfg)
            self.loss_cfg = acfg.loss
        else:
            self.vae_cfg = ImageVAEConfig.from_config(acfg)
            self.loss_cfg = acfg.lossconfig
        self.seed = int(cfg.experiment.training.get("manual_seed", 0) or 0)
        self._build_models()

    def _build_models(self) -> None:
        """The VAE and the discriminator, initialized from the seed."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            vae = VideoVAE(self.vae_cfg) if self.is_video else ImageVAE(self.vae_cfg)
            disc = NLayerDiscriminator()
        self.vae = vae.to(self.device).train()
        self.disc = disc.to(self.device).train()

    def exec_task(self, task: str) -> None:
        if task != "training":
            raise ValueError("video_latent_learning only supports training")
        self.training()

    # ------------------------------------------------------------------
    def _layout(self, videos: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) -> the VAE's input: (B*T, C, H, W) frames for the
        ImageVAE, (B, C, T, H, W) for the VideoVAE."""
        if self.is_video:
            return videos.permute(0, 4, 1, 2, 3).contiguous()
        return videos.flatten(0, 1).permute(0, 3, 1, 2).contiguous()

    def _frames(self, x: torch.Tensor) -> torch.Tensor:
        """The discriminator's input: frames (N, C, H, W)."""
        if self.is_video:
            return x.transpose(1, 2).flatten(0, 1)
        return x

    def _phase(self, name: str, marks: List):
        """Marks the end of a phase of the step: a CUDA event on the card
        (read once training ends), the host clock on the CPU."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))
        else:
            marks.append((name, time.perf_counter()))

    def train_step(self, videos: torch.Tensor, step: int, marks: List) -> Dict[str, torch.Tensor]:
        """One autoencoder and one discriminator update on a batch of
        (B, T, H, W, C) videos in [0, 1]; ``step`` counts the steps before."""
        lc = self.loss_cfg
        kl_weight = lc.get("kl_weight", 1e-6)
        loss_type = lc.get("loss_type", "l1")
        dw = adopt_weight(lc.get("disc_weight", 0.5), step, lc.get("disc_start", 0))
        x = self._layout(videos) * 2.0 - 1.0
        self._phase("start", marks)

        posterior = self.vae.encode(x)
        recon = self.vae.decode(posterior.sample(self.generator))
        logits_fake = self.disc(self._frames(recon), train=True, update_stats=False)
        self._phase("ae_forward", marks)

        last = decoder_last_layer(self.vae)
        rec = (recon - x).abs().mean() if loss_type == "l1" else ((recon - x) ** 2).mean()
        (nll_grads,) = torch.autograd.grad(rec, last, retain_graph=True)
        (gan_grads,) = torch.autograd.grad(-logits_fake.mean(), last, retain_graph=True)
        d_weight = calculate_adaptive_weight(nll_grads, gan_grads)
        self._phase("adaptive_weight", marks)

        g_total, parts = vae_generator_loss(
            recon, x, posterior.kl(), logits_fake, kl_weight=kl_weight, disc_weight=dw,
            loss_type=loss_type, adaptive_weight=d_weight)
        self.ae_opt.zero_grad()
        g_total.backward()
        self.ae_opt.step()
        self._phase("ae_update", marks)

        logits_real = self.disc(self._frames(x), train=True)
        logits_fake = self.disc(self._frames(recon.detach()), train=True)
        d_total = vae_discriminator_loss(logits_real, logits_fake, dw)
        self.d_opt.zero_grad()
        d_total.backward()
        self.d_opt.step()
        self._phase("disc_update", marks)
        return {"g_total": g_total.detach(), "d_total": d_total.detach(),
                **{k: v.detach() for k, v in parts.items()}, "d_weight": d_weight}

    def _phase_seconds(self, marks: List) -> List[Dict[str, float]]:
        """Per step, the seconds of each phase."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        steps, current, prev = [], {}, None
        for name, mark in marks:
            if name != "start":
                current[name] = (prev.elapsed_time(mark) / 1e3 if self.device.type == "cuda"
                                 else mark - prev)
                if name == PHASES[-1]:
                    steps.append(current)
                    current = {}
            prev = mark
        return steps

    def prepare(self) -> None:
        """The two optimizers and the posterior's generator."""
        lr = float(self.cfg.experiment.training.lr)
        # optax.adam(lr, b1=0.5, b2=0.9): no weight decay, no clipping
        self.ae_opt, self.d_opt = (Optimizer(m.parameters(), lambda _: lr, 0.0, (0.5, 0.9), 0.0, 1)
                                   for m in (self.vae, self.disc))
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)

    def training(self) -> None:
        tcfg = self.cfg.experiment.training
        dataset = build_dataset(self.cfg.dataset, "training")
        loader = DataLoader(dataset, tcfg.batch_size, shuffle=True, drop_last=True)
        # the JAX experiment takes its init sample from a first pass of its
        # loader, so its training starts at the second epoch's order
        loader.epoch = 1
        self.prepare()

        max_steps = tcfg.max_steps if tcfg.get("max_steps", -1) > 0 else 1000
        step, marks, walls = 0, [], []
        while step < max_steps:
            for batch in loader:
                t0 = time.perf_counter()
                videos = torch.as_tensor(batch["videos"]).to(self.device, non_blocking=True)
                metrics = self.train_step(videos, step, marks)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)  # the wall of the whole step
                step += 1
                if step % LOG_EVERY == 0 or step == 1:
                    self.logger.log({k: float(v) for k, v in metrics.items()}, step)
                walls.append(time.perf_counter() - t0)
                if step >= max_steps:
                    break
        self.timings["step_wall_s"] = walls
        self.timings["phases_s"] = self._phase_seconds(marks)
        self.ae_state = create_train_state(self.vae, self.ae_opt, use_ema=False)
        self.ae_state.step = step
        save_checkpoint(self.ckpt_dir, step, self.ae_state, 1)

    def close(self) -> None:
        self.logger.close()
