"""History-guidance visualizer: per-step GIF of the (time x noise) bands.

Port of ``dfot_tpu/guidance/visualizer.py`` (the reference's
HistoryGuidanceVisualizer, history_guidance.py:169-308): for each sampling
step, one panel per history condition showing which history tokens are
conditioned on (green, with their noise band) and which tokens are being
generated (orange), titled by the condition's signed weight; the frames
stack into an animated GIF. It renders from the port's host
:class:`~dfot_tpu_torch.sampling.sampler.SamplingPlan`, the tables the window
sampler runs. Host numpy, matplotlib and PIL, imported when called.
"""

from __future__ import annotations

import io
import os
from typing import Optional

import numpy as np

__all__ = ["visualize_plan"]


def visualize_plan(
    plan,
    timesteps: int,
    path: str,
    batch_index: int = 0,
    max_steps: int = 50,
    fps: int = 20,
) -> str:
    """Render a SamplingPlan to an animated GIF; returns the path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    S = min(plan.num_steps, max_steps)
    H = plan.num_hist
    T = plan.from_levels.shape[-1]
    frames = []
    for s in range(S):
        fig, axs = plt.subplots(1, H, figsize=(T * H / 2.0, 3), squeeze=False)
        mask = plan.context_masks[s, batch_index]
        for h in range(H):
            ax = axs[0][h]
            ax.add_patch(plt.Rectangle((0, 0), T, 1, color="grey", alpha=0.15))
            for t in range(T):
                if mask[t] >= 1:  # history token: green band at its level
                    level = plan.override_levels[s, batch_index, h, t]
                    frac = (level + 1) / timesteps
                    ax.add_patch(plt.Rectangle((t, 0), 1, 1, color="green", alpha=0.2))
                    ax.add_patch(
                        plt.Rectangle((t, frac), 1, max(1 - frac, 0.02), color="green")
                    )
                elif mask[t] == 0:  # being generated
                    excluded = plan.gen_excluded[s, batch_index, :, t].all()
                    ax.add_patch(
                        plt.Rectangle(
                            (t, 0), 1, 1, color="orange",
                            alpha=0.2 if excluded else 1.0,
                        )
                    )
            ax.set_xlim(0, T)
            ax.set_ylim(0, 1)
            ax.set_xticks(range(T))
            ax.set_xticklabels([])
            ax.set_yticklabels([])
            ax.set_title(rf"{plan.weights[s, h]:+.1f}$\times$", fontweight="bold")
        fig.suptitle(f"Step {s}")
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=60)
        plt.close(fig)
        buf.seek(0)
        frames.append(Image.open(buf).convert("P"))

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames[0].save(
        path, save_all=True, append_images=frames[1:],
        duration=max(1000 // fps, 20), loop=0,
    )
    return path
