"""Video metrics: per-frame MSE, PSNR and SSIM and the VideoMetric wrapper."""

from .functional import mse, psnr, ssim
from .video_metric import VideoMetric

__all__ = ["mse", "psnr", "ssim", "VideoMetric"]
