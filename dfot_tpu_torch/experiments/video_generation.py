"""Video-generation experiment: the training loop and the validation loop.

Port of ``dfot_tpu/experiments/video_generation.py:VideoGenerationExperiment``
(:37) on ``device`` (None: the card).

Training (:120-402): batches of the training set (re-loaded each epoch when
the dataset sets ``subdataset_size``), normalized on the device, through the
algorithm's train step (AdamW, warm-up, clipping, EMA; bf16 autocast over
fp32 master weights), warm-started from an upstream ``.ckpt`` (fresh
optimizer, EMA = weights) or resumed from a ``checkpoint_<step>`` directory
(``load=``, else this run's newest). The loss, gradient norm and steps/s go
to ``metrics.jsonl`` every ``algorithm.logging.loss_freq`` steps, the only
points where the loop waits for the device. Checkpoints every
``every_n_train_steps`` and ``every_n_epochs``, written in the background,
pruned to ``save_top_k``, and a last one at the end (a wait and a prune
where the last periodic save was of the final step). Mid-run validation:
the EMA weights' denoising loss over ``limit_batch`` batches, the
``denoising_vis_step<N>.gif`` panel, and with ``validate_sample`` a sampled
batch scored. A ``torch.profiler`` trace of step
``experiment.training.profile_at_step`` goes to
``experiment.training.profile_dir``.

Latent recipes (``algorithm.latent.enabled``) build the dataset's VAE as a
``LatentCodec`` on the same device (:48-52): a batch's tokens are its
``latents`` (pre-sampled on disk), or its videos encoded online with the
experiment's own generator (seeded 7, as the JAX package's PRNGKey(7)), or,
for ``pre_sample`` without latents, a ``FileNotFoundError``; the
temporal-compression mapping of masks and conditions follows (:71-110).
Sampled latents are decoded to pixels for the metrics and GIFs, the ground
truth kept as the batch's pixel videos where it has them (:618-630).

Validation (:405-440): batches through the algorithm's ``sample_videos``,
unnormalized, scored by ``VideoMetric`` per task and logged (with sampled
GIFs up to ``algorithm.logging.max_num_videos``), with the EMA weights of
``load=`` (an upstream ``.ckpt``/``.pt``/``.pth``/``.safetensors`` file,
``pretrained:NAME`` for ``data/ckpts/NAME``, or a ``checkpoint_<step>``
directory), else of this run's newest checkpoint, else of the train state,
else the algorithm's seeded fresh init, whose numbers differ from the JAX
package's. ``val_all_ckpt`` sweeps every ``checkpoint_<step>`` directory.

Several processes (``parallel/``, a ``torchrun`` or SLURM launch): the
training mesh (:126-185) is (data, fsdp[, tensor]) over the processes, its
data axis the largest divisor of ``batch_size`` among the processes a ring
leaves, the rest on fsdp. A data rank loads its share of every epoch
(``process_shard``, ``batch_size`` // data rows), draws the global batch's
noise levels and noise and takes its rows ``index::data``, its gradients
are averaged over the data and fsdp axes, and the losses it logs are
averaged over the data axis. With the in-process loader
(``experiment.training.data.num_workers=0``) the share is the strided slice
of the one-process order, so the run equals the one-process run (model
dropout aside: ROADMAP.md C14). With loader workers the share is grain's
(the rank's consecutive piece of the records, shuffled within), as the JAX
package's ``GrainDataLoader`` under data parallelism: a step's rows are
then other records than the one-process run's. fsdp > 1 wraps the model in
FSDP2.
``mesh.tensor`` with ``mesh.sequence_parallel`` makes the tensor axis the
group of ring attention (``ops/ring_attention.py``), the weights replicated
along it. Checkpoints are gathered whole and written, and metrics and videos
logged, by rank 0. Validation (:517-555) samples every batch on every
process, the NFE-expanded denoiser batch split over the validation mesh's
data axis (``set_sampling_mesh``), and rank 0 scores; the mid-run
validation's losses and reconstructions are the data ranks' shares,
gathered (``gather_for_metrics``). The sequence-parallel ring is put back as
it was after training and after each validation.

What is not ported raises ``NotImplementedError`` naming its ROADMAP.md
queue item: ``algorithm.save_attn_map.enabled`` and ``mesh.tensor > 1``
without ``mesh.sequence_parallel`` (Megatron tensor parallelism) are A16b.

Every configured metric is scored (``VideoMetric``), its frozen networks
from one ``SharedMetricModelRegistry`` on the experiment's device with the
weights of ``algorithm.logging.metrics_weights_dir`` (random fallback
weights and ``_uncalibrated`` names without them), built at the first
scoring and shared by the validation passes and the mid-run validations.

``timings`` holds host-clock seconds of the experiment's phases (model
build, checkpoint load and restore, sampling, metrics and video logging,
mid-run validation, and the metrics logger's set-up and ``close``), each
ending where its results are on the host; ``metrics_split_s`` splits the
validation's metric seconds by metric (``VideoMetric.seconds``).
"""

from __future__ import annotations

import contextlib
import os
import re
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..algorithms.dfot_video import build_algorithm
from ..data.loader import DataLoader, make_loader
from ..data.video_dataset import build_dataset
from ..metrics.registry import SharedMetricModelRegistry
from ..metrics.video_metric import VideoMetric
from ..ops.attention import set_sequence_parallel
from ..ops.ring_attention import ProcessRing
from ..parallel import multihost
from ..parallel.mesh import (
    average_gradients,
    axis_group,
    make_mesh,
    mesh_shape,
    shard_model,
    unsharded,
)
from ..training.state import load_module_state
from ..training.checkpoint import (
    latest_checkpoint,
    prune_checkpoints,
    restore_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
)
from ..utils.logging import MetricsLogger, log_video
from ..utils.profiling import trace
from ..utils.torch_ckpt import load_state_dict, resolve_weights_path, strip_checkpoint
from ..vae.codec import LatentCodec

# checkpoint entries of upstream modules that the port's backbone does not
# hold: the temporal RoPE table (UNet3D) and the fixed sincos table (DiT1D),
# which the port makes itself, and FAR-DiT's unused noise-level embedding
NOT_HELD = {
    "u_net3d": re.compile(r"rotary_time_pos_embedding\."),
    "dit1d": re.compile(r"pos_embed$"),
    "far_dit": re.compile(r"noise_level_pos_embedding\."),
}

__all__ = ["VideoGenerationExperiment"]

TORCH_CKPT_SUFFIXES = (".ckpt", ".pt", ".pth", ".safetensors")
CODEC_SEED = 7  # the online encoding's posterior draws


def _is_torch_file(path: str) -> bool:
    return path.startswith("pretrained:") or path.endswith(TORCH_CKPT_SUFFIXES)


def _mesh_options(mesh_cfg) -> tuple:
    """(tensor, sequence_parallel) of an experiment's ``mesh`` node; what the
    port cannot run raises."""
    mesh_cfg = mesh_cfg or {}
    tensor = int(mesh_cfg.get("tensor", 1) or 1)
    sequence_parallel = bool(mesh_cfg.get("sequence_parallel", False))
    if tensor > 1 and not sequence_parallel:
        raise NotImplementedError(
            "mesh.tensor > 1 without mesh.sequence_parallel is Megatron tensor parallelism, "
            "not ported yet (ROADMAP.md queue A16b)")
    if sequence_parallel and tensor <= 1:
        raise ValueError("mesh.sequence_parallel needs mesh.tensor > 1")
    return tensor, sequence_parallel


def _ring(mesh, sequence_parallel: bool):
    """The ring of the mesh's tensor axis, or None."""
    return ProcessRing(axis_group(mesh, "tensor")[0]) if sequence_parallel else None


def _context_mask(task: str, B: int, T: int, nct: int) -> np.ndarray:
    """The frames a task is given: prediction the first ``nct``,
    interpolation both ends."""
    ctx = np.zeros((B, T), dtype=bool)
    if task.startswith("interpolation"):
        ctx[:, [0, -1]] = True
    else:
        ctx[:, :nct] = True
    return ctx


class VideoGenerationExperiment:
    """Training and validation of DFoT video models on ``device`` (None: the
    card)."""

    def __init__(self, cfg, output_dir: Optional[str] = None, load: Optional[str] = None,
                 device=None):
        self.cfg = cfg
        self.output_dir = output_dir or str(cfg.get("output_dir", "outputs"))
        self.ckpt_dir = os.path.join(self.output_dir, "checkpoints")
        self.load_path = load
        self.timings: Dict[str, float] = {}
        attn_cfg = cfg.algorithm.get("save_attn_map")
        if attn_cfg is not None and attn_cfg.get("enabled"):
            raise NotImplementedError(
                "algorithm.save_attn_map needs attention capture, which is not ported yet "
                "(ROADMAP.md queue A16b)")
        os.makedirs(self.output_dir, exist_ok=True)
        t0 = time.perf_counter()
        self.algo = build_algorithm(cfg, device=device)
        self._codec = None
        if self.algo.is_latent:
            self._codec = LatentCodec(cfg.algorithm, cfg.dataset, device=self.algo.device)
            self._codec_generator = torch.Generator(device=self.algo.device).manual_seed(
                CODEC_SEED)
        self._sync()
        self.timings["model_build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.logger = MetricsLogger(
            self.output_dir,
            cfg.get("wandb").to_dict() if cfg.get("wandb") else None,
            name=str(cfg.get("name", "")), enabled=multihost.is_rank_zero(),
        )
        self._add_time("logger_s", t0)
        self.state = None  # the train state, once trained
        self.saves = []  # each checkpoint's record (training/checkpoint.py)
        self._weights_from = None  # what the model's weights were last loaded from
        self.last_metrics: Dict[str, float] = {}
        self.last_videos: Dict[str, torch.Tensor] = {}
        self._registry: Optional[SharedMetricModelRegistry] = None

    def _sync(self) -> None:
        if self.algo.device.type == "cuda":
            torch.cuda.synchronize(self.algo.device)

    def _add_time(self, key: str, t0: float) -> None:
        self.timings[key] = self.timings.get(key, 0.0) + time.perf_counter() - t0

    # ------------------------------------------------------------------
    def exec_task(self, task: str) -> None:
        if task == "training":
            self.training()
        elif task in ("validation", "test"):
            self.validation(namespace=task)
        else:
            raise ValueError(f"unknown task {task}")

    # ------------------------------------------------------------------
    # batch -> model tokens
    # ------------------------------------------------------------------
    def _to_device(self, a) -> torch.Tensor:
        """A host array on the algorithm's device; to the card through pinned
        memory, queued without waiting for the device."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.algo.device.type == "cuda":
            return t.pin_memory().to(self.algo.device, non_blocking=True)
        return t.to(self.algo.device)

    def _tokenize_batch(self, batch: Dict[str, np.ndarray]) -> Dict:
        """``{"xs": normalized tokens, "masks": (B, T) frames present,
        "conditions": raw host conditions, "gt_videos"}``; xs and masks on
        the device (``dfot_tpu/experiments/video_generation.py:71``)."""
        algo = self.algo
        if not algo.is_latent:
            xs = self._to_device(batch["videos"])
        elif "latents" in batch:
            xs = self._to_device(batch["latents"])
        elif str(self.cfg.dataset.latent.type) == "online":
            xs = self._codec.encode_video(self._to_device(batch["videos"]),
                                          self._codec_generator)
        else:
            raise FileNotFoundError(
                "pre-sampled latents missing; run experiment=video_latent_preprocessing first")
        xs = algo.normalize(xs)
        masks = self._to_device(batch["nonterminal"])
        conds = batch.get("conds")
        # frame -> token conversion under temporal compression: token i maps
        # to frames ((i-1)*f, i*f]
        f = algo.temporal_downsampling
        if f > 1:
            if masks.shape[1] != xs.shape[1]:
                masks = masks[:, ::f]
            if conds is not None and np.ndim(conds) > 1 and conds.shape[1] != xs.shape[1]:
                conds = conds[:, ::f]
        out = {"xs": xs, "masks": masks}
        if conds is not None:
            out["conditions"] = conds
        if "videos" in batch:
            out["gt_videos"] = batch["videos"]
        return out

    def _pixels(self, videos: Dict[str, torch.Tensor], batch) -> Dict[str, torch.Tensor]:
        """Unnormalized sampled videos as pixels: a latent recipe's decoded,
        its ground truth the batch's own videos where it has them
        (``dfot_tpu/experiments/video_generation.py:618``)."""
        if self._codec is None:
            return videos
        return {k: (self._to_device(batch["videos"]) if k == "gt" and "videos" in batch
                    else self._codec.decode_video(v)) for k, v in videos.items()}

    def _train_batch(self, batch: Dict[str, np.ndarray]) -> Dict:
        """A batch as the train step and the eval denoiser take it: the
        conditions through the algorithm's host processing, on the device."""
        tokens = self._tokenize_batch(batch)
        tokens.pop("gt_videos", None)
        if "conditions" in tokens:
            conds = self.algo.process_conditions(tokens["conditions"])
            tokens["conditions"] = self._to_device(np.asarray(conds, np.float32))
        return tokens

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def training(self) -> None:
        tensor, sequence_parallel = _mesh_options(self.cfg.experiment.training.get("mesh"))
        mesh = None
        if torch.distributed.is_initialized() or tensor > 1:
            batch = self.cfg.experiment.training.batch_size
            mesh = make_mesh(mesh_shape(batch, multihost.world_size(), tensor))
        prior = set_sequence_parallel(_ring(mesh, sequence_parallel))
        try:
            self._train(mesh)
        finally:
            set_sequence_parallel(prior)

    def _train(self, mesh) -> None:
        cfg, algo = self.cfg, self.algo
        tcfg = cfg.experiment.training
        accumulate = tcfg.optim.get("accumulate_grad_batches", 1)
        seed = tcfg.get("manual_seed", 0)
        # sub-epoch resumable data: each epoch a slice of a seeded shuffle
        use_subdataset = isinstance(cfg.dataset.get("subdataset_size"), int)
        # a data rank's share: the rows index::data of every global batch
        data_group, data, data_index = axis_group(mesh, "data")
        shard = (data_index, data) if data > 1 else None

        def make_train_loader(epoch: int):
            dataset = build_dataset(cfg.dataset, "training",
                                    current_epoch=epoch if use_subdataset else None)
            return make_loader(dataset, tcfg.batch_size // data,
                               shuffle=tcfg.data.get("shuffle", True), seed=seed,
                               num_workers=tcfg.data.get("num_workers", 0) or 0,
                               process_shard=shard)

        loader = make_train_loader(0)
        if len(loader) == 0:
            raise ValueError(f"the training set holds no batch of {tcfg.batch_size}")

        # warm start from torch weights (a fresh optimizer, the EMA a copy of
        # the weights), or resume from a checkpoint directory
        resume = self.load_path or latest_checkpoint(self.ckpt_dir)
        if resume and _is_torch_file(str(resume)):
            self._load_weights(str(resume))
            resume = None
        shard_model(algo.model, mesh)
        state = algo.make_train_state(
            accumulate_steps=accumulate,
            num_training_steps=tcfg.max_steps if tcfg.max_steps > 0 else None,
            grad_clip=tcfg.optim.get("gradient_clip_val", 1.0) or 0.0,
        )
        if resume:
            t0 = time.perf_counter()
            state.load_state_dict(restore_checkpoint(str(resume)))
            self._sync()
            self.timings["checkpoint_restore_s"] = time.perf_counter() - t0
        self._weights_from = None  # the model now holds the trained weights
        train_step = algo.make_train_step(
            ema_decay=cfg.experiment.ema.get("decay", 0.9999), accumulate_steps=accumulate,
            rows=shard, grad_sync=None if mesh is None else (
                lambda model: average_gradients(model, mesh)))
        # the random stream is not checkpointed: a resumed run draws anew
        # from the seed, as the JAX package re-splits PRNGKey(manual_seed)
        generator = torch.Generator(device=algo.device).manual_seed(seed)

        max_steps = tcfg.max_steps if tcfg.max_steps > 0 else None
        max_epochs = tcfg.max_epochs if tcfg.max_epochs is not None and tcfg.max_epochs > 0 \
            else None
        ckpt_every = tcfg.checkpointing.get("every_n_train_steps") or 0
        ckpt_epochs = tcfg.checkpointing.get("every_n_epochs") or 0
        save_top_k = tcfg.checkpointing.get("save_top_k", 3)
        loss_freq = max(cfg.algorithm.logging.get("loss_freq", 100), 1)
        profile_dir = tcfg.get("profile_dir")
        profile_at = tcfg.get("profile_at_step", 10)
        mid_validation = self._mid_validation(state, generator, mesh)
        val_every, val_epoch_every = mid_validation.every_step, mid_validation.every_epoch

        step = step0 = state.step
        saved = None  # the step of the newest save
        t_start = time.time()
        epoch = 0
        done = False
        while not done:
            for batch in loader:
                tokens = self._train_batch(batch)
                if profile_dir and step == profile_at:
                    with trace(str(profile_dir)):
                        state, metrics = train_step(state, tokens, generator)
                        self._sync()
                else:
                    state, metrics = train_step(state, tokens, generator)
                # the host counts steps: reading state on the device every
                # step would make the loop wait for each one
                step += 1
                if step % loss_freq == 0:
                    if data > 1:  # the global batch's losses: the means of the shares'
                        names = [k for k in metrics if k != "grad_norm"]  # already global
                        means = torch.stack([metrics[k].float() for k in names])
                        torch.distributed.all_reduce(means, group=data_group)
                        metrics.update(zip(names, means / data))
                    m = {k: float(v) for k, v in metrics.items()}
                    m["steps_per_sec"] = (step - step0) / max(time.time() - t_start, 1e-9)
                    self.logger.log(m, step)
                if ckpt_every and step % ckpt_every == 0:
                    self.saves.append(
                        save_checkpoint(self.ckpt_dir, step, state, save_top_k, block=False))
                    saved = step
                if val_every and step % val_every == 0:
                    mid_validation(step)
                if max_steps is not None and step >= max_steps:
                    done = True
                    break
            epoch += 1
            if val_epoch_every and not done and epoch % val_epoch_every == 0:
                mid_validation(step)
            if ckpt_epochs and not done and epoch % ckpt_epochs == 0:
                self.saves.append(
                    save_checkpoint(self.ckpt_dir, step, state, save_top_k, block=False))
                saved = step
            if use_subdataset and not done:
                loader.close()
                loader = make_train_loader(epoch)
            if max_epochs is not None and epoch >= max_epochs:
                done = True
        loader.close()
        wait_for_checkpoints()
        if saved != step:
            self.saves.append(save_checkpoint(self.ckpt_dir, step, state, save_top_k))
        elif multihost.is_rank_zero():  # the state has not changed since: that save is the last
            prune_checkpoints(self.ckpt_dir, save_top_k)
        multihost.barrier("checkpoints")  # every process reads what rank 0 wrote
        self.state = state

    def _mid_validation(self, state, generator, mesh=None):
        """``run(at_step)``: the EMA weights' denoising loss over the first
        ``limit_batch`` validation batches (4 when it is not a count), the
        first batch's x0 reconstructions beside the ground truth as
        ``videos/denoising_vis_step<N>.gif``, and with ``validate_sample``
        that batch sampled and scored; ``run.every_step`` and
        ``run.every_epoch`` are its cadences (0: never). Over a data axis each
        data rank takes its strided share of every batch (the global batch's
        draws, its rows) and the losses and reconstructions are gathered."""
        cfg, algo = self.cfg, self.algo
        vcfg = cfg.experiment.validation
        every_step = vcfg.get("val_every_n_step")
        every_step = every_step if isinstance(every_step, int) and every_step > 1 else 0
        every_epoch = vcfg.get("val_every_n_epoch") or 0
        limit = vcfg.get("limit_batch")
        limit = limit if isinstance(limit, int) and limit > 0 else 4
        sample = bool(vcfg.get("validate_sample"))
        max_vis = cfg.algorithm.logging.get("max_num_videos", 8)
        _, data, data_index = axis_group(mesh, "data")
        shard = (data_index, data) if data > 1 and vcfg.batch_size % data == 0 else None
        loader = eval_denoise = None
        if every_step or every_epoch:
            loader = DataLoader(build_dataset(cfg.dataset, "validation"),
                                max(vcfg.batch_size, 1) // (shard[1] if shard else 1),
                                process_shard=shard)
            eval_denoise = algo.make_eval_denoise()

        def interleave(local):
            """The data ranks' shares of a batch (a tensor or a dict of arrays)
            back in the batch's order: gathered over the world, whose ranks
            run data-major, one share per data rank kept, rows interleaved."""
            if shard is None:
                return local
            world = multihost.world_size()

            def order(parts):
                b, rest = parts.shape[0] // world, tuple(parts.shape[1:])
                parts = parts.reshape(data, world // data, b, *rest)[:, 0]
                return parts.swapaxes(0, 1).reshape(data * b, *rest)

            got = multihost.gather_for_metrics(local)
            return {k: order(v) for k, v in got.items()} if isinstance(got, dict) else order(got)

        def run(at_step: int) -> None:
            t0 = time.perf_counter()
            losses, first = [], None
            weights = state.ema_weights() if state.ema is not None else contextlib.nullcontext()
            with weights:
                for j, vb in enumerate(loader):
                    if j >= limit:
                        break
                    vt = self._train_batch(vb)
                    loss, recons = eval_denoise(vt, generator, rows=shard)
                    losses.append(loss.reshape(1))
                    if j == 0:
                        first = interleave(vb)  # the whole first batch
                        if max_vis > 0:
                            vis = algo.unnormalize(interleave(recons)[:max_vis])
                            gt = algo.unnormalize(interleave(vt["xs"])[:max_vis])
                            if self._codec is not None:
                                vis = self._codec.decode_video(vis)
                                gt = (self._to_device(first["videos"][:max_vis])
                                      if "videos" in first else self._codec.decode_video(gt))
                            if multihost.is_rank_zero():
                                log_video(vis.cpu().numpy(), gt.cpu().numpy(),
                                          os.path.join(self.output_dir, "videos",
                                                       f"denoising_vis_step{at_step}.gif"),
                                          context_frames=0)
                if losses:
                    # each share's loss is the mean of equal shares of a batch:
                    # their mean is the batch's
                    losses = multihost.gather_for_metrics(torch.cat(losses))
                    self.logger.log({"validation/loss": float(losses.double().mean())}, at_step)
                if sample and first is not None:
                    self._score_sampled_batch(first, at_step, max_vis)
            self._sync()
            self._add_time("mid_validation_s", t0)

        run.every_step, run.every_epoch = every_step, every_epoch
        return run

    def _score_sampled_batch(self, batch, at_step: int, max_vis: int = 8) -> None:
        """Mid-run sampled validation: one batch's videos generated with the
        weights in the model, scored and logged
        (``dfot_tpu/experiments/video_generation.py:442``)."""
        cfg, algo = self.cfg, self.algo
        tokens = self._tokenize_batch(batch)
        generator = torch.Generator(device=algo.device).manual_seed(at_step)
        with unsharded(algo.model):
            videos = algo.sample_videos(generator, tokens["xs"], conditions=batch.get("conds"))
        videos = self._pixels({k: algo.unnormalize(v) for k, v in videos.items()}, batch)
        if not multihost.is_rank_zero():
            return
        gt = videos["gt"]
        B, T = gt.shape[:2]
        nct = algo.n_context_tokens
        logging_cfg = cfg.algorithm.logging
        metric_types = tuple(logging_cfg.get("metrics", ["mse", "psnr"]))
        results: Dict[str, float] = {}
        for task, vid in videos.items():
            if task == "gt":
                continue
            ctx = _context_mask(task, B, T, nct)
            vm = VideoMetric(metric_types, self._metric_registry(),
                             logging_cfg.get("n_metrics_frames"))
            vm.update(vid[:max_vis], gt[:max_vis], ctx[:max_vis])
            results.update(vm.log(f"validation/{task}"))
            if max_vis > 0:
                log_video(vid[:max_vis].cpu().numpy(), gt[:max_vis].cpu().numpy(),
                          os.path.join(self.output_dir, "videos",
                                       f"{task}_validation_step{at_step}.gif"),
                          context_frames=nct)
        if results:
            self.logger.log(results, at_step)

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------
    def validation(self, namespace: str = "validation") -> None:
        vcfg = self.cfg.experiment.validation
        tensor, sequence_parallel = _mesh_options(vcfg.get("mesh"))
        ring = None
        if torch.distributed.is_initialized():
            # every process samples every batch; the NFE-expanded denoiser
            # batch is split over the data axis, the ring takes the tensor axis
            world = multihost.world_size()
            if world % tensor:
                raise ValueError(f"mesh.tensor={tensor} does not divide {world} processes")
            mesh = make_mesh((world // tensor, 1) + ((tensor,) if tensor > 1 else ()))
            self.algo.set_sampling_mesh(mesh)
            ring = _ring(mesh, sequence_parallel)
        prior = set_sequence_parallel(ring)
        try:
            self._validation(namespace)
        finally:
            set_sequence_parallel(prior)

    def _validation(self, namespace: str) -> None:
        vcfg = self.cfg.experiment.validation
        if vcfg.get("val_all_ckpt"):
            # every checkpoint_<step> directory under load= (or this run's)
            sweep = str(self.load_path) if self.load_path else self.ckpt_dir
            if os.path.isdir(os.path.join(sweep, "checkpoints")):
                sweep = os.path.join(sweep, "checkpoints")
            ckpts = sorted(
                (d for d in os.listdir(sweep) if d.startswith("checkpoint_")),
                key=lambda d: int(d.split("_")[1]),
            ) if os.path.isdir(sweep) else []
            if not ckpts:
                raise FileNotFoundError(f"val_all_ckpt: no checkpoint_<step> dirs under {sweep}")
            for ckpt in ckpts:
                self.load_path = os.path.join(sweep, ckpt)
                self._validate_once(f"{namespace}/step_{int(ckpt.split('_')[1])}")
            return
        self._validate_once(namespace)
        # extra passes: history-free repeats with 0 context tokens, and the
        # training split
        has_context = self.algo.n_context_tokens > 0
        if vcfg.get("validate_history_free") and has_context:
            self._validate_once(f"{namespace}_history_free", n_context_override=0)
        if vcfg.get("validate_training_set"):
            self._validate_once("val_on_training", split="training")
            if vcfg.get("validate_history_free") and has_context:
                self._validate_once("val_on_training_history_free", split="training",
                                    n_context_override=0)

    def _validate_once(self, namespace: str = "validation", split: str = "validation",
                       n_context_override: Optional[int] = None) -> None:
        cfg, algo = self.cfg, self.algo
        vcfg = cfg.experiment.validation
        nct = algo.n_context_tokens if n_context_override is None else n_context_override
        dataset = build_dataset(cfg.dataset, split)
        loader = DataLoader(dataset, vcfg.batch_size)
        self._load_eval_weights()
        generator = torch.Generator(device=algo.device).manual_seed(vcfg.get("manual_seed", 0))

        limit = vcfg.get("limit_batch")
        n_batches = len(loader)
        if isinstance(limit, float):
            n_batches = max(int(n_batches * limit), 1)
        elif isinstance(limit, int) and limit > 0:
            n_batches = min(n_batches, limit)

        logging_cfg = cfg.algorithm.logging
        max_videos = logging_cfg.get("max_num_videos", 8)
        metric_types = tuple(logging_cfg.get("metrics", ["mse", "psnr"]))
        n_metrics_frames = logging_cfg.get("n_metrics_frames")
        registry = self._metric_registry()
        VideoMetric(metric_types, registry, n_metrics_frames)  # refuses unknown metrics before sampling
        task_metrics: Dict[str, VideoMetric] = {}
        num_logged = 0
        for i, batch in enumerate(loader):
            if i >= n_batches:
                break
            xs = self._tokenize_batch(batch)["xs"]
            t0 = time.perf_counter()
            with unsharded(algo.model):
                videos = algo.sample_videos(generator, xs, conditions=batch.get("conds"),
                                            n_context_tokens=nct)
            videos = self._pixels({k: algo.unnormalize(v) for k, v in videos.items()}, batch)
            self._sync()
            self._add_time("sampling_s", t0)
            if not multihost.is_rank_zero():  # the same videos: rank 0 scores them
                continue
            t0 = time.perf_counter()
            gt = videos["gt"]
            B, T = gt.shape[:2]
            for task, vid in videos.items():
                if task == "gt":
                    continue
                if task not in task_metrics:
                    task_metrics[task] = VideoMetric(metric_types, registry, n_metrics_frames)
                task_metrics[task].update(vid, gt, _context_mask(task, B, T, nct))
                if num_logged < max_videos:
                    log_video(
                        vid.cpu().numpy(), gt.cpu().numpy(),
                        os.path.join(self.output_dir, "videos", f"{task}_{namespace}_{i}.gif"),
                        context_frames=nct, raw_dir=logging_cfg.get("raw_dir"),
                    )
            num_logged += B
            self.last_videos = videos
            self._add_time("metrics_s", t0)

        t0 = time.perf_counter()
        results: Dict[str, float] = {}
        split = self.timings.setdefault("metrics_split_s", {})
        for task, vm in task_metrics.items():
            results.update(vm.log(f"{namespace}/{task}"))
            for name, sec in vm.seconds.items():
                split[name] = split.get(name, 0.0) + sec
        if results:
            self.logger.log(results, 0)
        self.last_metrics = results
        self._add_time("metrics_s", t0)

    def _metric_registry(self) -> SharedMetricModelRegistry:
        """The frozen metric networks on the experiment's device, with the
        weights of ``algorithm.logging.metrics_weights_dir``: built at the
        first scoring and kept for the later ones (the JAX experiment keeps
        its mid-run registry the same way,
        ``dfot_tpu/experiments/video_generation.py:481-485``)."""
        if self._registry is None:
            self._registry = SharedMetricModelRegistry(
                self.cfg.algorithm.logging.get("metrics_weights_dir"), device=self.algo.device)
        return self._registry

    def close(self) -> None:
        """Close the metrics logger (and its wandb run)."""
        t0 = time.perf_counter()
        self.logger.close()
        self._add_time("logger_s", t0)

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------
    def _load_eval_weights(self) -> None:
        """The weights to validate, into ``algo.model``
        (``dfot_tpu/experiments/video_generation.py:720``): those of
        ``load=``, else of this run's newest checkpoint, else the train
        state's EMA, else the seeded fresh init."""
        path = self.load_path or latest_checkpoint(self.ckpt_dir)
        if path is not None:
            self._load_weights(str(path))
        elif self.state is not None and self._weights_from is not self.state:
            load_module_state(self.algo.model, self.state.ema_state_dict())
            self._weights_from = self.state

    def _load_weights(self, path: str) -> None:
        """An upstream torch file's weights or a checkpoint directory's EMA
        weights (with its buffers) into ``algo.model``, once a path."""
        if path == self._weights_from:
            return
        t0 = time.perf_counter()
        file = resolve_weights_path(path)
        if _is_torch_file(file):
            self._import_torch_checkpoint(file)
        else:
            saved = restore_checkpoint(file)
            load_module_state(self.algo.model, {**saved["params"], **(saved["ema_params"] or {})})
            del saved
        self._sync()
        self._add_time("checkpoint_load_s", t0)
        self._weights_from = path

    def _import_torch_checkpoint(self, path: str) -> None:
        """An upstream checkpoint after the reference's surgery (EMA
        promotion, prefix and ``_orig_mod.`` removal), loaded strictly: the
        port's modules keep the upstream names, and the Fourier noise
        embedding's ``freqs`` and ``phases`` buffers come with it. The
        entries of :data:`NOT_HELD` are dropped first, as the JAX importers
        drop them."""
        state = strip_checkpoint(load_state_dict(path))
        dropped = NOT_HELD.get(self.cfg.algorithm.backbone.name)
        if dropped is not None:
            state = {k: v for k, v in state.items() if not dropped.match(k)}
        load_module_state(self.algo.model, state)
