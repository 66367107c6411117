"""The multi-process dry run: the port's parallel paths in N CPU processes.

The gloo/CPU counterpart of ``__graft_entry__.py:dryrun_multichip`` (:45-338),
which jits the training step over N virtual devices. Here N processes of one
gloo group each take a rank of the mesh the JAX dry run picks: (N/4, 2, 2)
(data, fsdp, tensor) at multiples of 8, (N/2, 2) at 4-7 and other even
counts of at least 4, (N, 1) otherwise. On it:

- the tiny DiT3D train step (data-parallel rows, FSDP2 over the (data,
  fsdp) axes with the sharding floor lowered to 1024 elements, Megatron
  tensor parallelism over the tensor axis), its loss finite; then one
  history-guided window with the NFE batch split over the data axis, held
  to the same window of one process on the trained EMA weights (bit-equal
  or within 1e-5);
- the tiny UViT3DPose the same way, its (B, T, 16) camera vectors expanded
  to ray maps on the device and the pose FiLM terms precomputed once a
  window;
- ring attention over the tensor axis (the data axis without one) against
  dense attention, within 1e-5;
- a 32 px UViT3DPose forward with its attention routed through the ring
  (``set_sequence_parallel``) against the dense forward, within 1e-5.

Rank 0 prints the JAX dry run's one-line summary. The JAX dry run's
AOT memory certificate of the flagship (``certify_fsdp_flagship``) is not
ported (ROADMAP.md). Run::

    python -m dfot_tpu_torch.tools.dryrun_multichip 4
"""

from __future__ import annotations

import copy
import json
import os
import socket
import subprocess
import sys

import numpy as np

__all__ = ["mesh_for", "dryrun_multichip"]


def mesh_for(n: int) -> tuple:
    """The JAX dry run's mesh shape for ``n`` devices."""
    if n % 8 == 0:
        return (n // 4, 2, 2)
    if n % 2 == 0 and n >= 4:
        return (n // 2, 2)
    return (n, 1)


def dryrun_multichip(n: int, timeout: float = 600.0) -> str:
    """Spawn ``n`` gloo processes running the dry run; returns rank 0's
    summary line (a failing rank raises)."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = []
    for rank in range(n):
        env = {**os.environ, "WORLD_SIZE": str(n), "RANK": str(rank), "LOCAL_RANK": str(rank),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1",
               "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dfot_tpu_torch.tools.dryrun_multichip", "--worker"],
            env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode:
                raise RuntimeError(f"dry-run rank failed:\n{err[-4000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs[0].strip().splitlines()[-1]


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------


def _train_and_sample(model, batch, mesh, dcfg, sched, nl_cfg, window_of, model_apply):
    """One train step of ``model`` on the mesh and one HG window with the
    NFE rows split over its data axis; then the same window in this process
    alone on an unsharded copy with the trained EMA weights. ``window_of(m)``
    is (the rollout config's fields, ``sample_sequence``'s arguments) of a
    window on model ``m``. Returns (loss, sampled, the one-process window)."""
    import torch

    from ..guidance.history_guidance import HistoryGuidance
    from ..parallel.mesh import (
        average_gradients,
        axis_group,
        full_tensors,
        shard_model,
        unsharded,
    )
    from ..parallel.tensor import apply_tensor_parallel
    from ..sampling import DFoTRollout, RolloutConfig
    from ..training import create_train_state, make_optimizer, make_train_step
    from ..training.state import load_module_state

    single = copy.deepcopy(model)
    tgroup, tensor, _ = axis_group(mesh, "tensor")
    if tensor > 1:
        apply_tensor_parallel(model, tgroup)
    shard_model(model, mesh)
    state = create_train_state(model, make_optimizer(model.parameters(), lr=1e-4,
                                                     num_warmup_steps=10))
    _, data, index = axis_group(mesh, "data")
    rows = (index, data) if data > 1 else None
    train_step = make_train_step(model_apply, dcfg, sched, nl_cfg, rows=rows,
                                 grad_sync=lambda m: average_gradients(m, mesh))
    local = {k: (v[index::data] if rows else v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    state, metrics = train_step(state, local, gen)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"non-finite loss {loss}"
    assert state.step == 1
    ema = full_tensors(state.state_dict()["ema_params"])  # gathered whole

    hg = HistoryGuidance.vanilla(guidance_scale=2.0, timesteps=dcfg.timesteps)

    def window(m, mesh):
        fields, kw = window_of(m)
        ro = DFoTRollout(RolloutConfig(mesh=mesh, **fields), dcfg, sched,
                         lambda x, k, c, cm: m(x, k, c, cm))
        return ro.sample_sequence(torch.Generator().manual_seed(4), history_guidance=hg, **kw)

    with torch.no_grad(), state.ema_weights(), unsharded(model):
        model.eval()
        out = window(model, mesh)
    assert torch.isfinite(out).all(), "non-finite samples"
    load_module_state(single, {**single.state_dict(), **ema})
    with torch.no_grad():
        single.eval()
        out_single = window(single, None)
    return loss, out, out_single


def _compare(a, b) -> tuple:
    import torch

    bit_equal = bool(torch.equal(a, b))
    diff = float((a - b).abs().max())
    assert bit_equal or diff < 1e-5, f"sharded vs one-process sampling: max|diff|={diff}"
    return bit_equal, diff


def _tiny_uvit(res: int, cond_dropout: float = 0.1):
    from ..models.uvit import UViT3DPose, UViTSpec

    spec = UViTSpec(channels=(32, 64), emb_channels=64, patch_size=2,
                    block_types=("ResBlock", "TransformerBlock"), block_dropouts=(0.0, 0.0),
                    num_updown_blocks=(1,), num_mid_blocks=1, num_heads=2, pos_emb_type="rope",
                    use_checkpointing=(False, False), max_temporal_length=4)
    return UViT3DPose(spec, 3, res, 6, external_cond_dropout=cond_dropout)


def _identity_poses(B: int, T: int):
    import torch

    pose = torch.zeros(B, T, 16)
    pose[..., :4] = torch.tensor([1.0, 1.0, 0.5, 0.5])
    pose[..., 4] = pose[..., 9] = pose[..., 14] = 1.0
    return pose


def _worker() -> None:
    import torch

    torch.set_num_threads(1)
    from ..diffusion.core import DiffusionConfig, make_schedule
    from ..models.dit import DiT3D, DiTSpec
    from ..models.uvit import precompute_pose_conditioning
    from ..ops.attention import attention_reference, set_sequence_parallel
    from ..ops.ring_attention import ProcessRing, sequence_parallel_attention
    from ..parallel import mesh as M
    from ..parallel import multihost
    from ..training import NoiseLevelConfig
    from ..utils.geometry import expand_pose_conditions
    from ..utils.weights import init_random_weights

    multihost.initialize(device="cpu")
    n = multihost.world_size()
    shape = mesh_for(n)
    fsdp = shape[1]
    mesh = M.make_mesh(shape)
    M.FSDP_MIN_SIZE = 1024
    dcfg = DiffusionConfig(timesteps=100, sampling_timesteps=10, objective="pred_v",
                           loss_weighting_strategy="fused_min_snr")
    sched = make_schedule(dcfg, "cpu")
    nl_cfg = NoiseLevelConfig(noise_level="random_independent", timesteps=100,
                              n_context_tokens=1)
    B = max(n // fsdp, 2) * 2  # divisible by the data axis
    Bs = max(n // fsdp, 2)     # B * NFE (2) divides the data axis

    # the DiT3D (the JAX dry run's tiny flagship)
    torch.manual_seed(0)
    dit = DiT3D(DiTSpec(hidden_size=64, depth=2, num_heads=2, mlp_ratio=2.0, variant="full",
                        pos_emb_type="rope_3d", patch_size=2, max_temporal_length=4), 4, (8, 8))
    init_random_weights(dit, torch.Generator().manual_seed(0))
    batch = {"xs": torch.as_tensor(np.random.RandomState(0).randn(B, 4, 8, 8, 4),
                                   dtype=torch.float32),
             "masks": torch.ones(B, 4, dtype=torch.bool)}
    ctx = torch.zeros(Bs, 4, 8, 8, 4)
    ctx[:, 0] = 0.5
    cmask = np.zeros((Bs, 4), np.int64)
    cmask[:, 0] = 1
    loss, out, single = _train_and_sample(
        dit, batch, mesh, dcfg, sched, nl_cfg,
        lambda m: (dict(max_tokens=4, x_shape=(8, 8, 4)),
                   dict(batch_size=Bs, length=4, context=ctx, context_mask=cmask)),
        lambda m, x, k, c, cm: m(x, k, c, cm))
    bit_equal, max_diff = _compare(out, single)

    # the UViT3DPose with the device-side ray encodings
    res, T = 16, 4
    uvit = _tiny_uvit(res)
    init_random_weights(uvit, torch.Generator().manual_seed(1))
    poses = _identity_poses(B, T)
    batch = {"xs": torch.as_tensor(np.random.RandomState(1).randn(B, T, res, res, 3),
                                   dtype=torch.float32),
             "conditions": expand_pose_conditions(poses, "ray", res),
             "masks": torch.ones(B, T, dtype=torch.bool)}
    ctx = torch.zeros(Bs, T, res, res, 3)
    ctx[:, 0] = 0.5
    cmask = np.zeros((Bs, T), np.int64)
    cmask[:, 0] = 1
    def uvit_window(m):
        def cond_transform(c):  # on-device ray maps, then the pose FiLM terms
            return precompute_pose_conditioning(m, expand_pose_conditions(c, "ray", res))

        return (dict(max_tokens=T, x_shape=(res, res, 3), external_cond_type="action",
                     cond_transform=cond_transform),
                dict(batch_size=Bs, length=T, context=ctx, context_mask=cmask,
                     conditions=_identity_poses(Bs, T)))

    uvit_loss, uvit_out, uvit_single = _train_and_sample(
        uvit, batch, mesh, dcfg, sched, nl_cfg, uvit_window,
        lambda m, x, k, c, cm: m(x, k, c, cm))
    uvit_bit_equal, uvit_max_diff = _compare(uvit_out, uvit_single)

    # ring attention over the tensor axis (the data axis without one)
    axis = "tensor" if len(shape) == 3 else "data"
    group, size, _ = M.axis_group(mesh, axis)
    ring = ProcessRing(group)
    rng = np.random.RandomState(7)
    q, k, v = (torch.as_tensor(rng.randn(2, 2, 8 * size, 8), dtype=torch.float32)
               for _ in range(3))
    sp_diff = float((sequence_parallel_attention(q, k, v, ring)
                     - attention_reference(q, k, v)).abs().max())
    assert sp_diff < 1e-5, f"ring attention vs dense: {sp_diff}"

    # a UViT forward with its attention routed through the ring
    model = _tiny_uvit(32)
    init_random_weights(model, torch.Generator().manual_seed(2))
    model.eval()
    x = torch.as_tensor(np.random.RandomState(11).randn(2, 4, 32, 32, 3), dtype=torch.float32)
    kk = torch.full((2, 4), 50.0)
    cond = torch.zeros(2, 4, 32, 32, 6)
    with torch.no_grad():
        dense = model(x, kk, cond, None)
        prior = set_sequence_parallel(ring)
        try:
            sp = model(x, kk, cond, None)
        finally:
            set_sequence_parallel(prior)
    sp_model_diff = float((sp - dense).abs().max())
    assert sp_model_diff < 1e-5, f"UViT forward under sequence parallel: {sp_model_diff}"

    names = ("data", "fsdp", "tensor")[:len(shape)]
    line = (f"dryrun_multichip({n}): ok, mesh={dict(zip(names, shape))} | "
            f"DiT3D: loss={loss:.4f}, sampled={tuple(out.shape)}, "
            f"bit_equal={bit_equal}, max_diff={max_diff:.2e} | "
            f"UViT3DPose+cond_transform: loss={uvit_loss:.4f}, "
            f"sampled={tuple(uvit_out.shape)}, bit_equal={uvit_bit_equal}, "
            f"max_diff={uvit_max_diff:.2e} | "
            f"ring-attention(sp over '{axis}') vs dense: max_diff={sp_diff:.2e} | "
            f"UViT forward under sequence_parallel vs dense: max_diff={sp_model_diff:.2e}")
    multihost.barrier()
    torch.distributed.destroy_process_group()
    print(json.dumps({"rank": multihost.rank()}))
    print(line)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--worker":
        _worker()
        return
    n = int(argv[0]) if argv else 4
    print(dryrun_multichip(n))


if __name__ == "__main__":
    main()
