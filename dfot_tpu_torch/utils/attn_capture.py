"""Attention-statistics capture (reference: algorithms/common/attn_hook/).

Port of ``dfot_tpu/utils/attn_capture.py``. The JAX models sow their
(B, H, N, N) attention weights into flax's ``intermediates`` when capture is
on; here the DiT's ``Attention`` appends them to its ``captured`` list
(``models/dit.py``), and :func:`collect_attention_maps` names each map by
the JAX module path (``dit/block_0/attn/attn_weights/0``), so the maps and
the heatmap files are those of the JAX package. Rendering imports
matplotlib when called.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.attention import set_attention_capture

__all__ = ["collect_attention_maps", "save_attention_heatmaps", "capture_attention_maps"]

# the port's module path -> the JAX module path (utils/torch_ckpt.py's
# import_dit3d_params names the DiT trunk ``dit`` and its blocks ``block_<i>``)
_JAX_NAMES = ((re.compile(r"^dit_base\."), "dit."),
              (re.compile(r"(^|\.)temporal_blocks\.(\d+)"), r"\1temporal_block_\2"),
              (re.compile(r"(^|\.)blocks\.(\d+)"), r"\1block_\2"))


def _jax_path(name: str) -> str:
    for pattern, repl in _JAX_NAMES:
        name = pattern.sub(repl, name)
    return name.replace(".", "/")


@torch.no_grad()
def capture_attention_maps(model: torch.nn.Module, *args, apply=None, **kwargs):
    """Run a forward pass with capture on: (output, {module path: weights
    (B, H, N, N) as numpy}). ``apply(model, *args, **kwargs)`` runs the
    pass (default: ``model(*args, **kwargs)``)."""
    collect_attention_maps(model)  # drop what an earlier pass left
    prior = set_attention_capture(True)
    try:
        out = model(*args, **kwargs) if apply is None else apply(model, *args, **kwargs)
    finally:
        set_attention_capture(prior)
    return out, collect_attention_maps(model)


def collect_attention_maps(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """{JAX path ``.../attn_weights/<call>``: the weights} of every module
    that captured some, emptied as they are read."""
    flat = {}
    for name, m in model.named_modules():
        captured = getattr(m, "captured", None)
        if not captured:
            continue
        for i, w in enumerate(captured):
            flat[f"{_jax_path(name)}/attn_weights/{i}"] = w.float().cpu().numpy()
        m.captured = None
    return flat


def save_attention_heatmaps(
    maps: Dict[str, np.ndarray],
    out_dir: str,
    timestep: Optional[int] = None,
    max_maps: int = 16,
) -> List[str]:
    """Render head-averaged attention heatmaps to PNG (reference
    attn_hook/hook.py:15-149 saves analogous grids)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, (name, arr) in enumerate(sorted(maps.items())):
        if i >= max_maps:
            break
        a = arr.astype(np.float32)
        while a.ndim > 2:  # average batch/head axes
            a = a.mean(axis=0)
        fig, ax = plt.subplots(figsize=(4, 4))
        im = ax.imshow(a, cmap="viridis", aspect="auto")
        fig.colorbar(im)
        safe = name.replace("/", "_")[:120]
        suffix = f"_t{timestep}" if timestep is not None else ""
        path = os.path.join(out_dir, f"{safe}{suffix}.png")
        ax.set_title(safe, fontsize=6)
        fig.savefig(path, dpi=80, bbox_inches="tight")
        plt.close(fig)
        paths.append(path)
    return paths
