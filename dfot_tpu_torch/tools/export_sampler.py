"""Export the one-window DFoT sampler for serving (``torch.export``).

The counterpart of ``scripts/export_sampler.py``, whose ``jax.export``
artifact holds the whole jitted 50-step scan. Here the artifact is a
directory:

- ``step.pt2``: one denoising step as an ``ExportedProgram``: the
  history-guidance expansion (``hg_prepare``), the model forward, the DDIM
  update and the weighted composition (``hg_compose``), with the step's
  plan rows and its noise as inputs and the weights inside;
- ``prepare.pt2``: the window's conditioning (the pose vectors' ray maps
  and every block's pose FiLM term, once a window);
- ``window.npz``: the plan's per-step arrays, the window's initial state
  and conditions, and the noise seed.

Unrolling 50 steps of the 467M U-ViT into one graph would make the artifact
far larger than the window it serves; the loop over the plan's rows runs
on the host. ``--load`` runs the window from the artifact with nothing but
``torch`` and ``dfot_tpu_torch.ops`` (which registers the custom ops the
graph calls and builds their kernels): no model-building code, no config.
It draws the steps' noise from a generator seeded as the in-process sampler
and checks the result against that sampler (``--check``), which is
bit-equal where the exported graph runs the same operations (the JAX
script's ``--load`` is bit-equal, ``scripts/export_sampler.py:80-83``)::

    python -m dfot_tpu_torch.tools.export_sampler --tiny --out <dir>
    python -m dfot_tpu_torch.tools.export_sampler --load <dir> --check

The full-size window is the flagship's 8-frame quick-start window (one
context frame, vanilla HG at scale 4, 50 DDIM steps) on seeded random
weights in bf16, on the card; ``--tiny`` is a two-level 16 px stand-in in
fp32 (CPU with ``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["build", "export_window", "load_window", "main"]

SEED = 0          # the weights
NOISE_SEED = 1    # the window's draws
PLAN_FIELDS = ("from_levels", "to_levels", "context_masks", "override_mask", "override_levels",
               "cond_mask", "weights", "gen_excluded", "gen_coverage", "renoise", "noop")


def build(tiny: bool, device, depth: Optional[dict] = None):
    """(model, recipe, plan, x_init, conditions): the flagship (or the tiny
    stand-in) on seeded random weights, its quick-start window's plan,
    initial state (seeded noise, context frame 0 at 0.5) and poses.
    ``depth``: ``num_updown_blocks`` and ``num_mid_blocks`` to cut the
    flagship's depth to (its widths kept)."""
    import dataclasses

    from ..algorithms.dfot_video import build_model, flagship
    from ..sampling.sampler import plan_sampling
    from ..utils.geometry import conditioning_dim
    from ..utils.weights import init_random_weights

    fs = flagship()
    if depth:
        depth = {k: tuple(v) if isinstance(v, list) else v for k, v in depth.items()}
        fs = fs._replace(spec=dataclasses.replace(fs.spec, **depth))
    if tiny:
        spec = dataclasses.replace(
            fs.spec, channels=(32, 64), emb_channels=64,
            block_types=("ResBlock", "TransformerBlock"), block_dropouts=(0.0, 0.0),
            num_updown_blocks=(1,), num_mid_blocks=1, num_heads=2,
            use_checkpointing=(False, False), max_temporal_length=4)
        fs = fs._replace(spec=spec, resolution=16, conditioning_type="ray",
                         external_cond_dim=conditioning_dim("ray"),
                         dcfg=dataclasses.replace(fs.dcfg, sampling_timesteps=5))
    model = build_model(fs, token_io=True, device=device)
    init_random_weights(model, torch.Generator().manual_seed(SEED))
    model = model.eval() if tiny else model.to(torch.bfloat16).eval()
    T, R = fs.spec.max_temporal_length, fs.resolution
    mask = np.zeros((1, T), np.int64)
    mask[:, 0] = 1
    d = fs.dcfg
    plan = plan_sampling(mask, fs.history_guidance, "full_sequence", d.timesteps,
                         d.sampling_timesteps, T, is_full_sequence=True)
    g = torch.Generator(device=device).manual_seed(SEED)
    x_init = torch.randn(1, T, R, R, fs.x_channels, generator=g, device=device)
    x_init[:, 0] = 0.5
    poses = torch.zeros(1, T, 16, device=device)
    poses[..., :4] = torch.tensor([1.0, 1.0, 0.5, 0.5], device=device)
    poses[..., 4] = poses[..., 9] = poses[..., 14] = 1.0
    return model, fs, plan, x_init, poses


def in_process_window(model, fs, plan, x_init, poses):
    """The port's window sampler on the same model, plan and draws: the
    result the artifact must reproduce."""
    from ..algorithms.dfot_video import sampling_cond_transform
    from ..diffusion.core import make_schedule
    from ..models.uvit import patchify_tokens, unpatchify_tokens
    from ..sampling.sampler import make_window_sampler

    p, R = fs.spec.patch_size, fs.resolution
    window = make_window_sampler(
        lambda x, k, c, m: model(x, k, c, m), fs.dcfg, make_schedule(fs.dcfg, x_init.device),
        cond_transform=sampling_cond_transform(model, fs.conditioning_type),
        state_codec=(lambda x: patchify_tokens(x, p), lambda x: unpatchify_tokens(x, p, R, R)))
    g = torch.Generator(device=x_init.device).manual_seed(NOISE_SEED)
    return window(x_init, plan, poses, g)


class _Step(torch.nn.Module):
    """One denoising step of ``sampling.sampler.make_window_sampler``'s loop
    (not a re-noising or padding row), its draws given: ``q_noise`` the
    history re-noising's clipped normal (B * H rows), ``fresh`` the excluded
    generation tokens' normal (used where the plan excludes some).
    ``host``: a step's host table (``HGTable`` of numpy rows), whose shapes
    and exclusions every step of the window shares."""

    def __init__(self, model, fs, host):
        super().__init__()
        from ..diffusion.core import make_schedule

        self.model, self.dcfg, self.host = model, fs.dcfg, host
        self.sched = make_schedule(fs.dcfg, next(model.parameters()).device)

    def forward(self, xs, from_levels, to_levels, context_masks, override_mask,
                override_levels, cond_mask, weights, gen_excluded, gen_coverage, q_noise,
                fresh, cond_e):
        from ..diffusion import core as dc
        from ..diffusion.continuous import continuous_model_noise_input
        from ..guidance.history_guidance import HGTable, hg_compose, hg_prepare

        dcfg, sched = self.dcfg, self.sched
        dev = HGTable(override_mask, override_levels, cond_mask, weights, gen_excluded,
                      gen_coverage)
        B = xs.shape[0]
        x_e, from_e, to_e, condmask_e = hg_prepare(
            xs, from_levels, to_levels, context_masks, self.host, dev,
            lambda x, k: dc.q_sample(sched, x, k.clamp(min=0), q_noise),
            dcfg.timesteps, False, None, fresh)
        k_clip = from_e.clamp(min=0)
        noise_in = (continuous_model_noise_input(dcfg, sched, k_clip) if dcfg.is_continuous
                    else k_clip.float())
        out = self.model(x_e, noise_in, cond_e, condmask_e)
        pred = dc.model_predictions(sched, dcfg, x_e, k_clip, out)
        x_pred = dc.ddim_step(sched, dcfg, x_e, from_e, to_e, pred, 0.0)
        composed = hg_compose(x_pred, dev, B)
        return torch.where(dc.bcast_right(context_masks == 0, xs.ndim), composed, xs)


class _Prepare(torch.nn.Module):
    """The window's conditioning: NFE-expanded pose vectors -> what the
    model reads (``algorithms.dfot_video.sampling_cond_transform``)."""

    def __init__(self, model, fs):
        super().__init__()
        from ..algorithms.dfot_video import sampling_cond_transform

        # the model is not a submodule: the program keeps only the weights
        # the transform reads (the pose embedding, every block's FiLM
        # projection), not a second copy of the whole model
        self.transform = sampling_cond_transform(model, fs.conditioning_type)

    def forward(self, poses_e):
        return self.transform(poses_e)


def _step_rows(plan, s: int, device):
    return [torch.as_tensor(getattr(plan, f)[s], device=device) for f in PLAN_FIELDS[:9]]


def export_window(model, fs, plan, x_init, poses, out_dir: str,
                  depth: Optional[dict] = None) -> dict:
    """Export the step and the conditioning of ``plan``'s window to
    ``out_dir`` (``depth``: the cut :func:`build` was given, recorded for
    ``--check``); returns sizes and seconds."""
    from ..models.uvit import patchify_tokens

    if fs.dcfg.ddim_sampling_eta != 0 or plan.renoise.any():
        raise ValueError("the exported step is DDIM at eta 0 without re-noising rows")
    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    dev = x_init.device
    steps = [s for s in range(plan.num_steps) if not plan.noop[s]]
    excluded = {bool(plan.gen_excluded[s].any()) for s in steps}
    if len(excluded) != 1:
        raise ValueError("the window's steps differ in excluding generation tokens")
    poses_e = torch.repeat_interleave(poses, plan.nfe, dim=0)
    prepare = _Prepare(model, fs).eval()
    from ..guidance.history_guidance import HGTable

    host = HGTable(*(np.asarray(getattr(plan, f)[steps[0]]) for f in PLAN_FIELDS[3:9]))
    step = _Step(model, fs, host).eval()
    xs = patchify_tokens(x_init, fs.spec.patch_size)
    B, H, G = xs.shape[0], plan.num_hist, plan.num_gen
    q_noise = torch.zeros((B * H,) + tuple(xs.shape[1:]), device=dev, dtype=xs.dtype)
    fresh = torch.zeros((B, H, G) + tuple(xs.shape[1:]), device=dev, dtype=xs.dtype)
    with torch.no_grad():
        ep_prepare = torch.export.export(prepare, (poses_e,))
        cond_e = prepare(poses_e)
        ep_step = torch.export.export(step, tuple([xs] + _step_rows(plan, steps[0], dev)
                                                  + [q_noise, fresh, cond_e]))
    for ep, name in ((ep_prepare, "prepare"), (ep_step, "step")):
        # the example inputs (the window's pose terms among them) are not
        # part of the artifact
        ep.example_inputs = None
        torch.export.save(ep, os.path.join(out_dir, f"{name}.pt2"))
    meta = {"nfe": plan.nfe, "num_hist": H, "num_gen": G, "clip_noise": fs.dcfg.clip_noise,
            "noise_seed": NOISE_SEED, "patch_size": fs.spec.patch_size,
            "resolution": fs.resolution, "depth": depth}
    np.savez(os.path.join(out_dir, "window.npz"), x_init=x_init.float().cpu().numpy(),
             poses=poses.cpu().numpy(), meta=json.dumps(meta),
             **{f: getattr(plan, f) for f in PLAN_FIELDS})
    size = sum(os.path.getsize(os.path.join(out_dir, f)) for f in os.listdir(out_dir))
    return {"export_s": time.perf_counter() - t0, "artifact_bytes": size}


def load_window(out_dir: str, device) -> tuple:
    """Run the artifact's window on ``device``: (the sampled (1, T, R, R, C)
    window, seconds to load, seconds to run, the kernels' launch counts of
    the process). Needs only torch and the custom ops."""
    from .. import ops  # registers dfot::* for the graph

    t0 = time.perf_counter()
    prepare = torch.export.load(os.path.join(out_dir, "prepare.pt2")).module()
    step = torch.export.load(os.path.join(out_dir, "step.pt2")).module()
    arrays = np.load(os.path.join(out_dir, "window.npz"))
    meta = json.loads(str(arrays["meta"]))
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = torch.device(device)
    p, R = meta["patch_size"], meta["resolution"]
    x = torch.as_tensor(arrays["x_init"], device=dev)
    B, T, _, _, C = x.shape
    # the sampler's state: patch tokens (B, T, h*w, p*p*C)
    xs = x.reshape(B, T, R // p, p, R // p, p, C).transpose(3, 4).reshape(
        B, T, (R // p) ** 2, p * p * C)
    poses = torch.as_tensor(arrays["poses"], device=dev)
    with torch.no_grad():
        cond_e = prepare(torch.repeat_interleave(poses, meta["nfe"], dim=0))
        g = torch.Generator(device=dev).manual_seed(meta["noise_seed"])
        H, G, clip = meta["num_hist"], meta["num_gen"], meta["clip_noise"]
        for s in range(len(arrays["noop"])):
            if arrays["noop"][s]:
                continue
            rows = [torch.as_tensor(arrays[f][s], device=dev) for f in PLAN_FIELDS[:9]]
            # the in-process sampler's draws, in its order
            q_noise = torch.randn((B * H,) + tuple(xs.shape[1:]), generator=g, device=dev,
                                  dtype=xs.dtype).clamp_(-clip, clip)
            if arrays["gen_excluded"][s].any():
                fresh = torch.randn((B, H, G) + tuple(xs.shape[1:]), generator=g, device=dev,
                                    dtype=xs.dtype)
            else:
                fresh = torch.zeros((B, H, G) + tuple(xs.shape[1:]), device=dev,
                                    dtype=xs.dtype)
            xs = step(xs, *rows, q_noise, fresh, cond_e)
    out = xs.reshape(B, T, R // p, R // p, p, p, C).transpose(3, 4).reshape(B, T, R, R, C)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, load_s, time.perf_counter() - t0, ops.launch_counts()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true", help="the two-level 16 px stand-in")
    ap.add_argument("--out", default="dfot_sampler_export", help="the artifact directory")
    ap.add_argument("--load", default=None, help="run the window of this artifact directory")
    ap.add_argument("--check", action="store_true",
                    help="with --load: build the model again and compare with the in-process "
                         "sampler")
    ap.add_argument("--save", default=None, help="with --load: write the window to this .npy")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    report = {}
    if args.load:
        out, report["load_s"], report["run_s"], report["launches"] = load_window(
            args.load, args.device)
        report["shape"] = list(out.shape)
        if args.save:
            np.save(args.save, out.float().cpu().numpy())
        if args.check:
            meta = json.loads(str(np.load(os.path.join(args.load, "window.npz"))["meta"]))
            model, fs, plan, x_init, poses = build(meta["resolution"] == 16, args.device,
                                                   meta.get("depth"))
            with torch.no_grad():
                want = in_process_window(model, fs, plan, x_init, poses)
            report["bit_equal"] = bool(torch.equal(out, want))
            report["max_abs_diff"] = float((out.float() - want.float()).abs().max())
    else:
        model, fs, plan, x_init, poses = build(args.tiny, args.device)
        report.update(export_window(model, fs, plan, x_init, poses, args.out))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
