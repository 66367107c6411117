"""Experiment registry (``dfot_tpu/experiments/__init__.py``)."""

from typing import Optional

from .video_generation import VideoGenerationExperiment

__all__ = ["VideoGenerationExperiment", "build_experiment"]


def build_experiment(cfg, output_dir: Optional[str] = None, load: Optional[str] = None,
                     device=None):
    """The experiment a composed config names, on ``device`` (None: the card)."""
    name = cfg.experiment.get("_name", "video_generation")
    if name == "video_generation":
        return VideoGenerationExperiment(cfg, output_dir, load, device)
    if name in ("video_latent_preprocessing", "video_latent_learning"):
        raise NotImplementedError(
            f"experiment {name!r} needs the VAEs, which are not ported yet (ROADMAP.md queue A13)")
    raise ValueError(f"unknown experiment {name!r}")
