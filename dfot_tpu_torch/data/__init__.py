"""Video data: the synthetic dataset and the batching loader."""

from .loader import DataLoader
from .video_dataset import SyntheticVideoDataset, build_dataset

__all__ = ["DataLoader", "SyntheticVideoDataset", "build_dataset"]
