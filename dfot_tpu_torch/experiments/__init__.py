"""Experiment registry (``dfot_tpu/experiments/__init__.py``)."""

from typing import Optional

from .video_generation import VideoGenerationExperiment
from .video_latent_learning import VideoLatentLearningExperiment
from .video_latent_preprocessing import VideoLatentPreprocessingExperiment

__all__ = ["VideoGenerationExperiment", "VideoLatentLearningExperiment",
           "VideoLatentPreprocessingExperiment", "build_experiment"]


def build_experiment(cfg, output_dir: Optional[str] = None, load: Optional[str] = None,
                     device=None):
    """The experiment a composed config names, on ``device`` (None: the card)."""
    name = cfg.experiment.get("_name", "video_generation")
    if name == "video_generation":
        return VideoGenerationExperiment(cfg, output_dir, load, device)
    if name == "video_latent_preprocessing":
        return VideoLatentPreprocessingExperiment(cfg, output_dir, load, device)
    if name == "video_latent_learning":
        return VideoLatentLearningExperiment(cfg, output_dir, load, device)
    raise ValueError(f"unknown experiment {name!r}")
