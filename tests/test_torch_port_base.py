"""UViT3DPose at the backbone's own widths (heads of 256) and the axial U-ViT's
gradients, in the port against the JAX package.

- ``uvit3d_pose_base()`` against ``configurations/algorithm/backbone/
  u_vit3d_pose.yaml``, read with the repository's YAML loader, and against
  ``flagship()`` for everything outside the backbone.
- A tiny UViT3DPose whose level 3 has one head of 256 lanes (the base
  widths' level-3 head dim): the weights carried across by
  ``uvit3d_state_dict_from_flax`` and back by ``import_uvit3d_params``
  bitwise; its forward against the JAX model on its reference attention and
  on its fused Pallas route in interpret mode; every gradient leaf against
  ``jax.grad``.
- The axial U-ViT (``AxialTransformerBlock`` on both transformer levels, one
  head of 64, and one of 256 at level 3): every gradient leaf against
  ``jax.grad``, through ``uvit3d_state_dict_from_flax(cotangent=True)``. Its
  temporal attention (``another_attn``) runs the small-N route, whose
  backward is the plain backward formulas, and the 1D and 2D RoPE tables.

fp32 on the CPU, where the port runs the plain versions of its kernels. The
JAX forward and ``jax.value_and_grad`` are jitted (eager, the gradients took
55 s a case on an 8-core CPU).
Tolerances as ``tests/test_torch_port_train_step.py``'s: outputs 1e-4
relative (L2), the loss 1e-5, every gradient leaf 1e-4 relative (L2). Two
channels per GroupNorm group at every level (64-channel levels), as there.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfot_tpu.config import _yaml_load
from dfot_tpu.ops.qkv_prep import force_fused_interpret
from dfot_tpu.utils.torch_ckpt import import_uvit3d_params
from dfot_tpu_torch.algorithms.dfot_video import flagship, uvit3d_pose_base
from dfot_tpu_torch.ops import attention as TA
from dfot_tpu_torch.utils.weights import uvit3d_state_dict_from_flax

from torch_port_helpers import POSE_DIM, build_pair, t, tiny_spec, one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


ROOT = Path(__file__).resolve().parents[1]
OUT_RTOL = 1e-4
GRAD_RTOL = 1e-4
AXIAL = ("ResBlock", "ResBlock", "AxialTransformerBlock", "AxialTransformerBlock")
# one head a level: level 2 has heads of 64, level 3 of 64 or 256
WIDTHS = {64: (64, 64, 64, 64), 256: (64, 64, 64, 256)}


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_base_recipe_matches_the_backbone_yaml():
    """The backbone fields of ``uvit3d_pose_base()`` are the YAML's own
    values; the rest of the recipe is the flagship's."""
    text = (ROOT / "configurations/algorithm/backbone/u_vit3d_pose.yaml").read_text()
    y = _yaml_load(text)
    base, fs = uvit3d_pose_base(), flagship()
    s = base.spec
    assert s.channels == tuple(y["channels"]) == (128, 256, 512, 1024)
    assert s.emb_channels == y["emb_channels"] and s.patch_size == y["patch_size"]
    assert s.block_types == tuple(y["block_types"])
    assert s.block_dropouts == tuple(y["block_dropouts"])
    assert s.num_updown_blocks == tuple(y["num_updown_blocks"]) == (3, 3, 3)
    assert s.num_mid_blocks == y["num_mid_blocks"] == 16
    assert s.num_heads == y["num_heads"] == 4
    assert s.pos_emb_type == y["pos_emb_type"]
    assert s.use_checkpointing == tuple(y["use_checkpointing"]) == (False,) * 4
    assert s.max_temporal_length == fs.spec.max_temporal_length == 8
    assert base._replace(spec=fs.spec) == fs
    # level 3: heads of 1024 / 4 = 256 over 16 * 16 * 8 tokens, a kernel route
    assert s.channels[-1] // s.num_heads == 256
    assert TA.attention_route((base.resolution // s.patch_size // 8) ** 2 * 8, 256) == "flash"
    assert TA.attention_route(8, 256) == "small_n"


def _inputs(rng, B, T, R):
    x, g = (rng.standard_normal((B, T, R, R, 3)).astype(np.float32) for _ in range(2))
    k = rng.uniform(-2, 2, (B, T)).astype(np.float32)
    pose = rng.standard_normal((B, T, R, R, POSE_DIM)).astype(np.float32)
    return x, g, k, pose


def _gradients_match(jm, jv, pm, spec, x, g, k, pose):
    """Loss and every gradient leaf of the port against ``jax.grad``; returns
    the port's gradients and each leaf's relative error."""
    def jloss(params):
        out = jm.apply({"params": params, "buffers": jv["buffers"]}, jnp.asarray(x),
                       jnp.asarray(k), jnp.asarray(pose), None, train=True,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.mean(out * jnp.asarray(g))

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(jv["params"])
    want = uvit3d_state_dict_from_flax(jax.device_get(want), None, spec, 3, POSE_DIM,
                                       cotangent=True)
    pm.train()
    loss = (pm(t(x), t(k), t(pose)) * t(g)).mean()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5, abs=1e-8)
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert set(got) == set(want)
    errs = {}
    for name, w in want.items():
        assert got[name] is not None, f"{name} got no gradient"
        assert got[name].shape == w.shape
        errs[name] = rel_err(got[name].numpy(), w.numpy())
    return got, errs


def test_head_dim_256_level_matches_jax():
    """Level 3 with one head of 256 (64 px: 128 tokens, the flash route at
    d = 256): the weights across and back bitwise, the forward on the JAX
    reference attention and on its fused Pallas route (interpret mode), and
    every gradient leaf."""
    spec = tiny_spec(channels=WIDTHS[256], num_heads=1)
    jm, jv, pm = build_pair(spec, 64, seed=5)
    assert dict(pm.named_parameters())["mid_blocks.0.q_norm.weight"].shape == (256,)
    assert TA.attention_route(4 * 4 * 8, 256) == "flash"
    params = jax.device_get(jv["params"])
    back = import_uvit3d_params(
        {n: v.numpy() for n, v in uvit3d_state_dict_from_flax(params, None, spec, 3,
                                                              POSE_DIM).items()},
        spec.num_updown_blocks, len(spec.channels), spec.patch_size)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, a in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(np.asarray(flat[path]), np.asarray(a), err_msg=str(path))

    x, g, k, pose = _inputs(np.random.default_rng(21), 1, 8, 64)
    with torch.no_grad():
        got = pm(t(x), t(k), t(pose))
    for fused in (False, True):
        force_fused_interpret(fused)
        try:
            want = jax.jit(jm.apply)(jv, jnp.asarray(x), jnp.asarray(k), jnp.asarray(pose), None)
        finally:
            force_fused_interpret(False)
        assert rel_err(got, want) < OUT_RTOL, fused

    _, errs = _gradients_match(jm, jv, pm, spec, x, g, k, pose)
    bad = {n: e for n, e in errs.items() if e > GRAD_RTOL}
    assert not bad, bad


@pytest.mark.parametrize("level3_head_dim", [64, 256])
def test_axial_uvit_gradients_match_jax(level3_head_dim):
    """Every gradient leaf of the axial U-ViT in training mode (dropouts 0):
    spatial attention over each frame's tokens (64 at level 2: the packed
    route; 16 at level 3: the small-N route) and temporal attention
    (``another_attn``) over the 8 frames (the small-N route), against
    ``jax.grad`` of the JAX model on its reference attention. The temporal
    q/k norm scales, whose gradients sum nearly cancelling terms, are named
    in the message with their errors."""
    spec = tiny_spec(channels=WIDTHS[level3_head_dim], num_heads=1, block_types=AXIAL)
    jm, jv, pm = build_pair(spec, 64, seed=7)
    x, g, k, pose = _inputs(np.random.default_rng(22), 1, 8, 64)
    got, errs = _gradients_match(jm, jv, pm, spec, x, g, k, pose)
    temporal = {n: e for n, e in errs.items()
                if "another_attn" in n and n.endswith(("q_norm.weight", "k_norm.weight"))}
    assert len(temporal) == 2 * 3  # down_blocks.2.0, mid_blocks.0, up_blocks.0.1
    for name in temporal:
        assert got[name].abs().max() > 0, f"{name}: zero gradient"
    bad = {n: e for n, e in errs.items() if e > GRAD_RTOL}
    assert not bad, (f"leaves off by more than {GRAD_RTOL}: {bad}; the temporal q/k norm "
                     f"scales: {temporal}")
