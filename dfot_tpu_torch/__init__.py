"""dfot_tpu_torch: the PyTorch/CUDA port of dfot_tpu for NVIDIA Hopper.

The JAX package ``dfot_tpu`` is the reference; this package keeps its module
layout and names. It imports torch and numpy only. Kernels are CUDA C++ for
sm_90a under ``csrc/``, built with nvcc at first use (see ``ops/_cuda.py``).
"""
