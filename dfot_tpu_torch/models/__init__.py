"""Denoiser backbones (the UViT3DPose flagship) and their embeddings."""
