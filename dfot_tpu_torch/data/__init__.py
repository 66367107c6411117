"""Video data: the on-disk datasets and their layouts, the synthetic
videos, clip indexing and the batching loaders."""

from .clips import build_idx_remap, clip_location, cumulative_clip_sizes, stack_external_cond
from .loader import DataLoader, WorkerDataLoader, make_loader
from .video_dataset import SyntheticVideoDataset, VideoDataset, build_dataset

__all__ = ["DataLoader", "SyntheticVideoDataset", "VideoDataset", "WorkerDataLoader",
           "build_dataset", "build_idx_remap", "clip_location", "cumulative_clip_sizes",
           "make_loader", "stack_external_cond"]
