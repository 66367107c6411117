"""PyTorch port of the UViT3DPose flagship model against the JAX package.

Same weights (``uvit3d_state_dict_from_flax``), same seeded numpy inputs,
fp32 on the CPU. Tolerances: 1e-5 absolute for elementwise ops and tables,
1e-4 relative (L2) for whole-model outputs, whose sums run in another order
in the two frameworks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfot_tpu.models import embeddings as JE
from dfot_tpu.models import uvit as JU
from dfot_tpu.ops.qkv_prep import force_fused_interpret
from dfot_tpu.utils.geometry import expand_pose_conditions_jax
from dfot_tpu.utils.torch_ckpt import import_uvit3d_params
from dfot_tpu_torch.models import embeddings as TE
from dfot_tpu_torch.models import uvit as TU
from dfot_tpu_torch.utils.geometry import expand_pose_conditions
from dfot_tpu_torch.utils.weights import init_random_weights, uvit3d_state_dict_from_flax

from torch_port_helpers import POSE_DIM, build_pair, randomize, t, tiny_spec, one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


MODEL_RTOL = 1e-4


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize(
    "make", [
        lambda m: m.make_rope_1d(16, 8),
        lambda m: m.make_rope_2d(32, (4, 4)),
        lambda m: m.make_rope_3d(64, (8, 32, 32)),
        lambda m: m.make_rope_3d(128, (8, 16, 16)),
        lambda m: m.make_rope_3d(32, (8, 2, 2)),
    ],
)
def test_rope_tables_equal(make):
    a, b = make(JE), make(TE)
    assert a.sizes == b.sizes
    np.testing.assert_array_equal(a.cos, b.cos)
    np.testing.assert_array_equal(a.sin, b.sin)


def test_embeddings_match():
    rng = np.random.default_rng(0)
    tsteps = rng.uniform(-15, 15, (2, 8)).astype(np.float32)
    want = JE.timestep_embedding(jnp.asarray(tsteps), 256)
    np.testing.assert_allclose(TE.timestep_embedding(t(tsteps), 256).numpy(), want, atol=1e-5)

    x = rng.standard_normal((2, 1, 16, 8)).astype(np.float32)
    rope = JE.make_rope_2d(8, (4, 4))
    np.testing.assert_allclose(
        TE.apply_rope(t(x), rope).numpy(), JE.apply_rope(jnp.asarray(x), rope), atol=1e-6
    )
    np.testing.assert_array_equal(TE._rotate_half(t(x)).numpy(), JE._rotate_half(jnp.asarray(x)))

    fj = JE.FourierEmbedding(32)
    fv = fj.init(jax.random.PRNGKey(0), jnp.zeros((2, 8)))
    ft = TE.FourierEmbedding(32)
    ft.freqs.copy_(t(fv["buffers"]["freqs"]))
    ft.phases.copy_(t(fv["buffers"]["phases"]))
    np.testing.assert_allclose(
        ft(t(tsteps)).numpy(), fj.apply(fv, jnp.asarray(tsteps)), atol=1e-5
    )


def test_patchify_tokens_roundtrip():
    x = np.random.default_rng(1).standard_normal((2, 3, 8, 8, 3)).astype(np.float32)
    tok = TU.patchify_tokens(t(x), 2)
    np.testing.assert_array_equal(tok.numpy(), JU.patchify_tokens(jnp.asarray(x), 2))
    np.testing.assert_array_equal(TU.unpatchify_tokens(tok, 2, 8, 8).numpy(), x)


def _poses(rng, B, T):
    pose = np.zeros((B, T, 16), np.float32)
    pose[..., :4] = rng.uniform(0.5, 1.5, (B, T, 4))
    q, _ = np.linalg.qr(rng.standard_normal((B, T, 3, 3)))
    pose[..., 4:16] = np.concatenate([q, rng.standard_normal((B, T, 3, 1))], -1).reshape(B, T, 12)
    pose[0, -1] = 0.0  # a padding row -> zero maps
    return pose


@pytest.mark.parametrize("ctype", ["ray", "plucker", "ray_encoding"])
def test_expand_pose_conditions(ctype):
    pose = _poses(np.random.default_rng(2), 2, 3)
    want = np.asarray(expand_pose_conditions_jax(jnp.asarray(pose), ctype, 8))
    got = expand_pose_conditions(t(pose), ctype, 8).numpy()
    assert got.shape == want.shape
    # the ray encoding's top frequency, 2**14 * pi ~ 5e4, multiplies the
    # ~6e-8 fp32 rounding difference of the rays into ~3e-3
    np.testing.assert_allclose(got, want, atol=1e-2 if ctype == "ray_encoding" else 1e-5)
    assert not got[0, -1].any()


def _inputs(rng, B, T, R, token_io=False):
    if token_io:
        x = rng.standard_normal((B, T, (R // 2) ** 2, 12)).astype(np.float32)
    else:
        x = rng.standard_normal((B, T, R, R, 3)).astype(np.float32)
    k = rng.uniform(-2, 2, (B, T)).astype(np.float32)  # scaled logSNR noise input
    pose = rng.standard_normal((B, T, R, R, POSE_DIM)).astype(np.float32)
    return x, k, pose


def test_uvit_forward_raw_pose():
    """Raw pose-map conditioning, pixel layout, JAX reference attention chain."""
    spec = tiny_spec()
    jm, jv, pm = build_pair(spec, 16)
    x, k, pose = _inputs(np.random.default_rng(3), 2, 8, 16)
    want = jm.apply(jv, jnp.asarray(x), jnp.asarray(k), jnp.asarray(pose), None)
    with torch.no_grad():
        got = pm(t(x), t(k), t(pose))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert rel_err(got, want) < MODEL_RTOL


def test_precompute_pose_conditioning_matches():
    spec = tiny_spec()
    jm, jv, pm = build_pair(spec, 16)
    pose = np.random.default_rng(4).standard_normal((2, 8, 16, 16, POSE_DIM)).astype(np.float32)
    want = JU.precompute_pose_conditioning(jm, jv, jnp.asarray(pose))
    got = TU.precompute_pose_conditioning(pm, t(pose))
    assert got["levels"] == {} and want["levels"] == {}
    assert set(got["mods"]) == set(want["mods"])
    for name, w in want["mods"].items():
        np.testing.assert_allclose(got["mods"][name].numpy(), w, rtol=1e-4, atol=1e-5)


def test_folded_tables_follow_the_norm_scales():
    """Each level's RoPE tables are made once and shared by its blocks; a
    block folds its q/k norm scales into them once and folds again after a
    weight load, so a reused model equals a freshly loaded one."""
    spec = tiny_spec()
    _, _, pm = build_pair(spec, 16)
    by_level = {}
    for name, i in pm.block_names():
        blk = pm.block(name)
        if isinstance(blk, TU.TransformerBlock):
            assert by_level.setdefault(i, blk.rope) is blk.rope
    assert len(by_level) == 2
    x, k, pose = _inputs(np.random.default_rng(8), 1, 8, 16)
    with torch.no_grad():
        before = pm(t(x), t(k), t(pose))
        sd = {n: (v * 1.5 if n.endswith(("q_norm.weight", "k_norm.weight")) else v)
              for n, v in pm.state_dict().items()}
        pm.load_state_dict(sd)
        reused = pm(t(x), t(k), t(pose))
        fresh = TU.UViT3DPose(spec, 3, 16, POSE_DIM, use_fourier_noise_emb=True).eval()
        fresh.load_state_dict(sd)
        want = fresh(t(x), t(k), t(pose))
    assert not torch.equal(reused, before)
    assert torch.equal(reused, want)


def test_uvit_forward_precomputed_token_io():
    """The sampling route: token layout, precomputed pose terms, cond mask."""
    spec = tiny_spec()
    jm, jv, pm = build_pair(spec, 16, seed=1, token_io=True)
    rng = np.random.default_rng(5)
    x, k, pose = _inputs(rng, 2, 8, 16, token_io=True)
    mask = np.array([False, True])
    jc = JU.precompute_pose_conditioning(jm, jv, jnp.asarray(pose))
    want = jm.apply(jv, jnp.asarray(x), jnp.asarray(k), jc, jnp.asarray(mask))
    with torch.no_grad():
        got = pm(t(x), t(k), TU.precompute_pose_conditioning(pm, t(pose)), t(mask))
    assert got.shape == want.shape
    assert rel_err(got, want) < MODEL_RTOL


def test_uvit_forward_fused_interpret():
    """The JAX fused route (qkv_prep -> flash -> collect Pallas kernels in
    interpret mode) against the port's attention route; both transformer
    levels have N >= 128 tokens at 64 px."""
    spec = tiny_spec()
    jm, jv, pm = build_pair(spec, 64, seed=2)
    x, k, pose = _inputs(np.random.default_rng(6), 1, 8, 64)
    force_fused_interpret(True)
    try:
        want = jm.apply(jv, jnp.asarray(x), jnp.asarray(k), jnp.asarray(pose), None)
    finally:
        force_fused_interpret(False)
    with torch.no_grad():
        got = pm(t(x), t(k), t(pose))
    assert rel_err(got, want) < MODEL_RTOL


def test_weight_roundtrip_bitwise():
    spec = tiny_spec()
    jm, jv, pm = build_pair(spec, 16)
    params = jax.device_get(jv["params"])
    state = uvit3d_state_dict_from_flax(params, None, spec, 3, POSE_DIM)
    back = import_uvit3d_params(
        {k: v.numpy() for k, v in state.items()}, spec.num_updown_blocks, len(spec.channels),
        spec.patch_size,
    )
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(a), err_msg=str(path))
    # the port's state dict is exactly the converted one (buffers included)
    full = uvit3d_state_dict_from_flax(params, jax.device_get(jv["buffers"]), spec, 3, POSE_DIM)
    assert set(full) == set(pm.state_dict())


def test_project_output_bias_must_tile():
    spec = tiny_spec()
    params = randomize(
        jax.device_get(build_pair(spec, 16)[1]["params"]), np.random.default_rng(0), 2
    )
    params["project_output"]["bias"] = np.arange(12, dtype=np.float32)
    with pytest.raises(ValueError):
        uvit3d_state_dict_from_flax(params, None, spec, 3, POSE_DIM)


def test_flagship_width_forward_low_resolution():
    """Flagship widths (128/256/576/1152 channels, 9 heads of d = 64 and
    128), one block per level, at 32 px: the port's random init runs and is
    finite, and the JAX model on the converted weights agrees."""
    spec = tiny_spec(channels=(128, 256, 576, 1152), emb_channels=1024, num_heads=9)
    pm = TU.UViT3DPose(spec, 3, 32, POSE_DIM, use_fourier_noise_emb=True).eval()
    init_random_weights(pm, torch.Generator().manual_seed(0))
    x, k, pose = _inputs(np.random.default_rng(7), 1, 8, 32)
    with torch.no_grad():
        got = pm(t(x), t(k), t(pose))
    assert torch.isfinite(got).all()
    sd = {n: v.numpy() for n, v in pm.state_dict().items()}
    params = import_uvit3d_params(
        {n: v for n, v in sd.items() if not n.endswith(("freqs", "phases"))},
        spec.num_updown_blocks, 4, 2,
    )
    buffers = {"noise_emb": {"fourier": {
        "freqs": sd["noise_level_pos_embedding.timesteps.freqs"],
        "phases": sd["noise_level_pos_embedding.timesteps.phases"],
    }}}
    jm = JU.UViT3DPose(spec=JU.UViTSpec(**dataclasses.asdict(spec)), x_channels=3,
                       resolution=32, external_cond_dim=POSE_DIM, use_fourier_noise_emb=True)
    want = jm.apply({"params": params, "buffers": buffers}, jnp.asarray(x), jnp.asarray(k),
                    jnp.asarray(pose), None)
    assert rel_err(got, want) < MODEL_RTOL
