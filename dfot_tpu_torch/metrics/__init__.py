"""Video metrics: the frame-wise metrics, the frozen networks' registry and
the VideoMetric wrapper (port of ``dfot_tpu/metrics``)."""

from .frechet import FrechetDistance, InceptionScore, frechet_distance
from .functional import mse, psnr, ssim
from .i3d import I3D
from .inception import InceptionV3
from .registry import SharedMetricModelRegistry
from .vbench import VBenchQuality
from .video_metric import VideoMetric

__all__ = ["FrechetDistance", "InceptionScore", "frechet_distance", "mse", "psnr", "ssim", "I3D",
           "InceptionV3", "SharedMetricModelRegistry", "VBenchQuality", "VideoMetric"]
