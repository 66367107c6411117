"""Video-generation experiment: the validation loop.

Port of ``dfot_tpu/experiments/video_generation.py:VideoGenerationExperiment``
(:37), its validation side: batches from the dataset through the
algorithm's ``sample_videos``, unnormalized, scored by ``VideoMetric`` per
task and logged to ``metrics.jsonl`` (with sampled GIFs up to
``algorithm.logging.max_num_videos``), with the weights of an upstream
``.ckpt``/``.pt``/``.pth``/``.safetensors`` file (``load=``, or
``pretrained:NAME`` for ``data/ckpts/NAME``). Without ``load=`` the weights
are the algorithm's seeded fresh init, whose numbers differ from the JAX
package's fresh init.

What is not ported raises ``NotImplementedError`` naming its ROADMAP.md
queue item: ``training`` and the port-native ``checkpoint_<step>``
directories (``val_all_ckpt`` too) are A10; latent experiments (the VAEs)
are A13; ``algorithm.save_attn_map.enabled`` and a validation mesh
(``mesh.tensor > 1``, ``mesh.sequence_parallel``) are A16.

``timings`` holds host-clock seconds of the experiment's phases (model
build, checkpoint load, sampling, metrics and video logging, and the
metrics logger's set-up and ``close``), each ending where its results are
on the host.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..algorithms.dfot_video import build_algorithm
from ..data.loader import DataLoader
from ..data.video_dataset import build_dataset
from ..metrics.video_metric import VideoMetric
from ..utils.logging import MetricsLogger, log_video
from ..utils.torch_ckpt import load_state_dict, strip_checkpoint

__all__ = ["VideoGenerationExperiment"]

TORCH_CKPT_SUFFIXES = (".ckpt", ".pt", ".pth", ".safetensors")


class VideoGenerationExperiment:
    """Validation of DFoT video models on ``device`` (None: the card)."""

    def __init__(self, cfg, output_dir: Optional[str] = None, load: Optional[str] = None,
                 device=None):
        self.cfg = cfg
        self.output_dir = output_dir or str(cfg.get("output_dir", "outputs"))
        self.load_path = load
        self.timings: Dict[str, float] = {}
        if cfg.algorithm.latent.enabled:
            raise NotImplementedError(
                "latent experiments need the VAEs, which are not ported yet (ROADMAP.md queue A13)")
        attn_cfg = cfg.algorithm.get("save_attn_map")
        if attn_cfg is not None and attn_cfg.get("enabled"):
            raise NotImplementedError(
                "algorithm.save_attn_map needs attention capture, which is not ported yet "
                "(ROADMAP.md queue A16)")
        os.makedirs(self.output_dir, exist_ok=True)
        t0 = time.perf_counter()
        self.algo = build_algorithm(cfg, device=device)
        self._sync()
        self.timings["model_build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.logger = MetricsLogger(
            self.output_dir,
            cfg.get("wandb").to_dict() if cfg.get("wandb") else None,
            name=str(cfg.get("name", "")),
        )
        self._add_time("logger_s", t0)
        self._weights_loaded = False
        self.last_metrics: Dict[str, float] = {}
        self.last_videos: Dict[str, torch.Tensor] = {}

    def _sync(self) -> None:
        if self.algo.device.type == "cuda":
            torch.cuda.synchronize(self.algo.device)

    # ------------------------------------------------------------------
    def exec_task(self, task: str) -> None:
        if task == "training":
            raise NotImplementedError(
                "the training loop is not ported yet (ROADMAP.md queue A10)")
        if task in ("validation", "test"):
            self.validation(namespace=task)
        else:
            raise ValueError(f"unknown task {task}")

    # ------------------------------------------------------------------
    def _tokenize_batch(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """A batch's videos as normalized tokens on the device (the latent
        path is A13)."""
        return self.algo.normalize(torch.as_tensor(batch["videos"], device=self.algo.device))

    # ------------------------------------------------------------------
    def validation(self, namespace: str = "validation") -> None:
        vcfg = self.cfg.experiment.validation
        if vcfg.get("val_all_ckpt"):
            raise NotImplementedError(
                "val_all_ckpt sweeps checkpoint_<step> directories, which come with the "
                "training loop (ROADMAP.md queue A10)")
        mesh_cfg = vcfg.get("mesh", {}) or {}
        if int(mesh_cfg.get("tensor", 1) or 1) > 1 or mesh_cfg.get("sequence_parallel", False):
            raise NotImplementedError(
                "a validation mesh (tensor or sequence parallel) is multi-GPU work, not "
                "ported yet (ROADMAP.md queue A16)")
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
        VideoMetric(metric_types, n_metrics_frames)  # refuses unported metrics before sampling
        task_metrics: Dict[str, VideoMetric] = {}
        num_logged = 0
        for i, batch in enumerate(loader):
            if i >= n_batches:
                break
            xs = self._tokenize_batch(batch)
            t0 = time.perf_counter()
            videos = algo.sample_videos(generator, xs, conditions=batch.get("conds"),
                                        n_context_tokens=nct)
            videos = {k: algo.unnormalize(v) for k, v in videos.items()}
            self._sync()
            self._add_time("sampling_s", t0)
            t0 = time.perf_counter()
            gt = videos["gt"]
            B, T = gt.shape[:2]
            for task, vid in videos.items():
                if task == "gt":
                    continue
                # per-task context frames: prediction conditions on the
                # prefix, interpolation on both endpoints
                ctx = np.zeros((B, T), dtype=bool)
                if task.startswith("interpolation"):
                    ctx[:, [0, -1]] = True
                else:
                    ctx[:, :nct] = True
                if task not in task_metrics:
                    task_metrics[task] = VideoMetric(metric_types, n_metrics_frames)
                task_metrics[task].update(vid, gt, ctx)
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
        for task, vm in task_metrics.items():
            results.update(vm.log(f"{namespace}/{task}"))
        if results:
            self.logger.log(results, 0)
        self.last_metrics = results
        self._add_time("metrics_s", t0)

    def _add_time(self, key: str, t0: float) -> None:
        self.timings[key] = self.timings.get(key, 0.0) + time.perf_counter() - t0

    def close(self) -> None:
        """Close the metrics logger (and its wandb run)."""
        t0 = time.perf_counter()
        self.logger.close()
        self._add_time("logger_s", t0)

    # ------------------------------------------------------------------
    def _load_eval_weights(self) -> None:
        """The weights to validate, into ``algo.model``: those of the
        ``load=`` file, or the seeded fresh init when there is none."""
        if self._weights_loaded or self.load_path is None:
            return
        path = str(self.load_path)
        if path.startswith("pretrained:"):
            # the reference downloads these; here they live under data/ckpts/
            path = os.path.join("data", "ckpts", path.split(":", 1)[1])
        if not path.endswith(TORCH_CKPT_SUFFIXES):
            raise NotImplementedError(
                f"load={self.load_path}: checkpoint_<step> directories come with the training "
                "loop (ROADMAP.md queue A10); give an upstream .ckpt, .pt, .pth or .safetensors")
        t0 = time.perf_counter()
        self._import_torch_checkpoint(path)
        self._sync()
        self.timings["checkpoint_load_s"] = time.perf_counter() - t0
        self._weights_loaded = True

    def _import_torch_checkpoint(self, path: str) -> None:
        """An upstream checkpoint after the reference's surgery (EMA
        promotion, prefix and ``_orig_mod.`` removal), loaded strictly: the
        port's modules keep the upstream names, and the Fourier noise
        embedding's ``freqs`` and ``phases`` buffers come with it."""
        state = strip_checkpoint(load_state_dict(path))
        self.algo.model.load_state_dict(state, strict=True)
