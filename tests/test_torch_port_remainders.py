"""The A2-A6 remainders of the port against the JAX package: every noise
schedule family, ``estimate_noise_level``, the plain U-ViT's action and
label conditions, the axial U-ViT's precomputed per-level pose maps, a
U-ViT without RoPE, and reconstruction guidance in the window sampler.

Host schedules are float64 numpy in both packages: equal within 1e-12.
Models run in fp32 on the CPU on the same seeded weights and inputs (the
U-ViTs 1e-4 relative L2, as ``tests/test_torch_port_uvit.py`` holds them).
Guided windows chain a model and its input gradient through three DDIM
steps with the random draws pinned on both sides: each frame within 1e-4
relative L2, and the same window without the guidance gradient must miss
the JAX window by more than 1e-2, or the comparison could not see the
guidance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfot_tpu.diffusion import core as JDC
from dfot_tpu.diffusion import schedules as JS
from dfot_tpu.guidance import history_guidance as JHG
from dfot_tpu.models import dit as JD
from dfot_tpu.models import uvit as JU
from dfot_tpu.sampling import rollout as JR
from dfot_tpu.utils.geometry import expand_pose_conditions_jax
from dfot_tpu.utils.torch_ckpt import import_dit3d_params
from dfot_tpu_torch.algorithms.dfot_video import (
    build_algorithm,
    flagship,
    k600_dit_xl,
    sampling_cond_transform,
)
from dfot_tpu_torch.config import load_config
from dfot_tpu_torch.diffusion import core as TDC
from dfot_tpu_torch.diffusion import schedules as TS
from dfot_tpu_torch.guidance import history_guidance as THG
from dfot_tpu_torch.models import dit as TD
from dfot_tpu_torch.models import uvit as TU
from dfot_tpu_torch.sampling import rollout as TR
from dfot_tpu_torch.utils.weights import init_random_weights, uvit3d_state_dict_from_flax

from torch_port_helpers import POSE_DIM, build_pair, pinned, randomize, t, tiny_spec, one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


MODEL_RTOL = 1e-4
WINDOW_RTOL = 1e-4
CONTROL_MIN = 1e-2


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def jax_dcfg(dcfg):
    return JDC.DiffusionConfig(**dataclasses.asdict(dcfg))


# ---------------------------------------------------------------------------
# A2: schedules and the noise-level estimate
# ---------------------------------------------------------------------------

FAMILIES = [
    ("cosine", {}),
    ("cosine_simple_diffusion", {"shifted": 0.25}),
    ("alphas_cumprod_linear", {}),
    ("linear", {"end": 0.03}),
    ("sigmoid", {}),
    ("sd", {}),
]


@pytest.mark.parametrize("zero_terminal_snr", [True, False])
@pytest.mark.parametrize("shift", [1.0, 0.5])
@pytest.mark.parametrize("name,kw", FAMILIES, ids=[f for f, _ in FAMILIES])
def test_schedule_families_equal(name, kw, shift, zero_terminal_snr):
    got = TS.make_beta_schedule(name, 1000, shift=shift, zero_terminal_snr=zero_terminal_snr, **kw)
    want = JS.make_beta_schedule(name, 1000, shift=shift, zero_terminal_snr=zero_terminal_snr,
                                 **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown beta schedule"):
        TS.make_beta_schedule("no_such_schedule", 10)


@pytest.mark.parametrize("name", ["linear", "sigmoid", "sd", "alphas_cumprod_linear"])
def test_make_schedule_every_family(name):
    """The device buffers of a config that names the family, pred_v (zero
    terminal SNR enforced) and pred_noise (not)."""
    for objective in ("pred_v", "pred_noise"):
        dcfg = TDC.DiffusionConfig(beta_schedule=name, objective=objective)
        js, ts = JDC.make_schedule(jax_dcfg(dcfg)), TDC.make_schedule(dcfg, device="cpu")
        for field in JDC.Schedule._fields:
            np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                          np.asarray(getattr(js, field)), err_msg=field)


@pytest.mark.parametrize("with_mu", [False, True])
def test_estimate_noise_level_matches(with_mu):
    dcfg = flagship().dcfg
    js, ts = JDC.make_schedule(jax_dcfg(dcfg)), TDC.make_schedule(dcfg, device="cpu")
    rng = np.random.default_rng(6)
    levels = rng.integers(0, 1000, (3, 5))
    ac = np.asarray(js.alphas_cumprod)[levels][..., None, None, None]
    x0 = rng.standard_normal((3, 5, 4, 4, 3)).astype(np.float32) * 0.1
    x = (np.sqrt(ac) * x0 + np.sqrt(1 - ac) * rng.standard_normal(x0.shape)).astype(np.float32)
    mu = (np.sqrt(ac) * x0).astype(np.float32) if with_mu else None
    want = np.asarray(JDC.estimate_noise_level(js, jnp.asarray(x),
                                               None if mu is None else jnp.asarray(mu)))
    got = TDC.estimate_noise_level(ts, t(x), None if mu is None else t(mu))
    assert got.shape == (3, 5)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# A3: the U-ViT's conditions, pose maps and positions
# ---------------------------------------------------------------------------


def plain_uvit_pair(spec, resolution, cond_dim, dropout, seed):
    """The JAX UViT3D and the port's on the same random weights."""
    jm = JU.UViT3D(spec=JU.UViTSpec(**dataclasses.asdict(spec)), x_channels=3,
                   resolution=resolution, external_cond_dim=cond_dim,
                   external_cond_dropout=dropout, use_fourier_noise_emb=True)
    T = spec.max_temporal_length
    variables = jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                        jnp.zeros((1, T, resolution, resolution, 3)), jnp.zeros((1, T)),
                        jnp.zeros((1, T, cond_dim)))
    params = randomize(jax.device_get(variables["params"]), np.random.default_rng(seed),
                       spec.patch_size)
    buffers = jax.device_get(variables["buffers"])
    pm = TU.UViT3D(spec, 3, resolution, use_fourier_noise_emb=True,
                   external_cond_dim=cond_dim, external_cond_dropout=dropout)
    pm.load_state_dict(uvit3d_state_dict_from_flax(params, buffers, spec, 3), strict=True)
    jv = {"params": jax.tree_util.tree_map(jnp.asarray, params),
          "buffers": jax.tree_util.tree_map(jnp.asarray, buffers)}
    return jm, jv, pm.eval()


@pytest.mark.parametrize("cond_type,cond_dim", [("action", 5), ("label", 1)])
def test_plain_uvit_external_conditions_match(cond_type, cond_dim):
    """Actions (B, T, dim), or labels as the UCF-101 configs give the U-ViT
    them (external_cond_dim 1: class ids as values), through the SiLU MLP
    embedding, with and without a mask that drops a sample's condition."""
    spec = tiny_spec()
    jm, jv, pm = plain_uvit_pair(spec, 16, cond_dim, 0.1, seed=7)
    rng = np.random.default_rng(7)
    B, T = 2, spec.max_temporal_length
    x = rng.standard_normal((B, T, 16, 16, 3)).astype(np.float32)
    k = rng.uniform(-2, 2, (B, T)).astype(np.float32)
    if cond_type == "label":
        cond = np.repeat(rng.integers(0, 101, (B, 1, 1)), T, axis=1).astype(np.float32)
    else:
        cond = rng.standard_normal((B, T, cond_dim)).astype(np.float32)
    mask = np.array([False, True])
    outs = {}
    for m in (None, mask):
        want = jm.apply(jv, jnp.asarray(x), jnp.asarray(k), jnp.asarray(cond),
                        None if m is None else jnp.asarray(m))
        with torch.no_grad():
            got = pm(t(x), t(k), t(cond), None if m is None else t(m))
        assert rel_err(got, want) < MODEL_RTOL
        outs[m is None] = got
    with torch.no_grad():
        unconditioned = pm(t(x), t(k))
    # the mask drops sample 1's condition and keeps sample 0's
    assert torch.equal(outs[False][1], unconditioned[1])
    assert not torch.allclose(outs[False][0], unconditioned[0])


AXIAL = ("ResBlock", "ResBlock", "AxialTransformerBlock", "AxialTransformerBlock")


def test_axial_precomputed_pose_maps_match():
    """The axial U-ViT's sampling route: per-level pooled pose maps
    precomputed once, against the raw pose map through the same model and
    against the JAX model on its own precomputed conditioning, with a mask
    that drops one sample's pose."""
    spec = tiny_spec(block_types=AXIAL)
    jm, jv, pm = build_pair(spec, 16, seed=8, token_io=True)
    rng = np.random.default_rng(8)
    B, T, R = 2, spec.max_temporal_length, 16
    x = rng.standard_normal((B, T, (R // 2) ** 2, 12)).astype(np.float32)
    k = rng.uniform(-2, 2, (B, T)).astype(np.float32)
    pose = rng.standard_normal((B, T, R, R, POSE_DIM)).astype(np.float32)
    mask = np.array([True, False])
    jc = JU.precompute_pose_conditioning(jm, jv, jnp.asarray(pose))
    with torch.no_grad():
        pc = TU.precompute_pose_conditioning(pm, t(pose))
        assert set(pc["levels"]) == set(jc["levels"]) == {"2", "3"}
        assert set(pc["mods"]) == set(jc["mods"])
        for lvl, w in jc["levels"].items():
            np.testing.assert_allclose(pc["levels"][lvl].numpy(), w, rtol=1e-4, atol=1e-5)
        for m in (None, mask):
            tm = None if m is None else t(m)
            got = pm(t(x), t(k), pc, tm)
            raw = pm(t(x), t(k), t(pose), tm)
            want = jm.apply(jv, jnp.asarray(x), jnp.asarray(k), jc,
                            None if m is None else jnp.asarray(m))
            assert rel_err(got, raw) < MODEL_RTOL
            assert rel_err(got, want) < MODEL_RTOL


@pytest.mark.parametrize("block_types", [
    ("ResBlock", "ResBlock", "TransformerBlock", "TransformerBlock"),
    ("ResBlock", "ResBlock", "TransformerBlock", "AxialTransformerBlock"),
], ids=["full", "axial"])
def test_uvit_without_rope_matches(block_types):
    """A ``pos_emb_type`` other than ``rope``: no rotation on any level (the
    port keeps the learned q/k norm scales in identity tables)."""
    spec = tiny_spec(block_types=block_types, pos_emb_type="none")
    jm, jv, pm = build_pair(spec, 32, seed=9)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 8, 32, 32, 3)).astype(np.float32)
    k = rng.uniform(-2, 2, (1, 8)).astype(np.float32)
    pose = rng.standard_normal((1, 8, 32, 32, POSE_DIM)).astype(np.float32)
    want = jm.apply(jv, jnp.asarray(x), jnp.asarray(k), jnp.asarray(pose), None)
    with torch.no_grad():
        got = pm(t(x), t(k), t(pose))
    assert rel_err(got, want) < MODEL_RTOL
    # the same weights with RoPE give another function
    roped = TU.UViT3DPose(dataclasses.replace(spec, pos_emb_type="rope"), 3, 32, POSE_DIM,
                          use_fourier_noise_emb=True).eval()
    roped.load_state_dict(pm.state_dict())
    with torch.no_grad():
        assert rel_err(roped(t(x), t(k), t(pose)), want) > CONTROL_MIN


UCF = ["+name=ucf", "algorithm=dfot_video", "experiment=video_generation",
       "algorithm/backbone=u_vit3d"]


@pytest.mark.parametrize("extra,cond_dim,pos_emb", [
    (["dataset=dmlab"], 3, "rope"),
    (["dataset=cond_ucf_101", "dataset.latent.enabled=false"], 1, "rope"),
    (["dataset=dmlab", "++algorithm.backbone.pos_emb_type=none"], 3, "none"),
], ids=["actions", "labels", "no_rope"])
def test_build_algorithm_builds_the_plain_uvit_options(extra, cond_dim, pos_emb):
    algo = build_algorithm(load_config(UCF + extra), device="meta")
    model = algo.model
    assert type(model) is TU.UViT3D and model.external_cond_dim == cond_dim
    assert model.external_cond_embedding.embedding.linear_1.in_features == cond_dim
    assert model.spec.pos_emb_type == pos_emb


# ---------------------------------------------------------------------------
# A6: reconstruction guidance
# ---------------------------------------------------------------------------


def pin_noise(monkeypatch):
    monkeypatch.setattr(
        JDC, "clipped_normal",
        lambda rng, shape, clip, dtype=jnp.float32: jnp.asarray(pinned(shape), dtype))
    monkeypatch.setattr(
        TDC, "clipped_normal",
        lambda shape, clip, generator=None, device=None, dtype=torch.float32:
            torch.as_tensor(pinned(tuple(shape)), dtype=dtype, device=device))


def guided(dcfg, weight):
    return dataclasses.replace(dcfg, reconstruction_guidance=weight)


def check_guided_window(run_jax, run_port, dcfg, weight):
    want = run_jax(guided(dcfg, weight))
    got = run_port(guided(dcfg, weight))
    unguided = run_port(dcfg)
    assert got.shape == want.shape and torch.isfinite(got).all()
    errs = [rel_err(got[:, f], np.asarray(want)[:, f]) for f in range(got.shape[1])]
    assert max(errs) < WINDOW_RTOL, errs
    ctrl = rel_err(unguided, want)
    assert ctrl > CONTROL_MIN, ctrl
    return got


def test_guided_window_continuous_uvit_matches(monkeypatch):
    """The flagship's route at a small size: UViT3DPose, continuous
    diffusion, vanilla HG at 4 (NFE 2), token-layout state, pose FiLM terms
    precomputed once a window (without gradient), 2 context frames."""
    pin_noise(monkeypatch)
    spec = tiny_spec()
    R, T, p = 16, 8, 2
    jm, jv, pm = build_pair(spec, R, seed=10, token_io=True)
    dcfg = dataclasses.replace(flagship().dcfg, sampling_timesteps=3)
    rng = np.random.default_rng(10)
    ctx = rng.standard_normal((1, T, R, R, 3)).astype(np.float32)
    mask = np.zeros((1, T), np.int64)
    mask[:, :2] = 1
    poses = np.zeros((1, T, 16), np.float32)
    poses[..., :4] = [1.0, 1.0, 0.5, 0.5]
    poses[..., 4:16] = np.concatenate([np.eye(3), 0.1 * rng.standard_normal((3, 1))], 1).reshape(12)
    codec_j = (lambda x: JU.patchify_tokens(x, p), lambda x: JU.unpatchify_tokens(x, p, R, R))
    codec_t = (lambda x: TU.patchify_tokens(x, p), lambda x: TU.unpatchify_tokens(x, p, R, R))

    def run_jax(d):
        ro = JR.DFoTRollout(
            JR.RolloutConfig(max_tokens=T, x_shape=(R, R, 3), state_codec=codec_j,
                             cond_transform=lambda c, v: JU.precompute_pose_conditioning(
                                 jm, v, expand_pose_conditions_jax(c, "ray", R))),
            jax_dcfg(d), JDC.make_schedule(jax_dcfg(d)),
            lambda v, x, n, c, m: jm.apply(v, x, n, c, m))
        return ro.sample_sequence(jv, jax.random.PRNGKey(0), 1, length=T, context=jnp.asarray(ctx),
                                  context_mask=mask, conditions=jnp.asarray(poses),
                                  history_guidance=JHG.HistoryGuidance.vanilla(4.0))

    def run_port(d):
        ro = TR.DFoTRollout(
            TR.RolloutConfig(max_tokens=T, x_shape=(R, R, 3), state_codec=codec_t,
                             cond_transform=sampling_cond_transform(pm, "ray")),
            d, TDC.make_schedule(d, device="cpu"), pm)
        return ro.sample_sequence(None, 1, length=T, context=ctx, context_mask=mask,
                                  conditions=poses,
                                  history_guidance=THG.HistoryGuidance.vanilla(4.0))

    got = check_guided_window(run_jax, run_port, dcfg, 2.0)
    np.testing.assert_array_equal(got[:, :2].numpy(), ctx[:, :2])  # context kept
    assert all(p.grad is None for p in pm.parameters())  # no gradient reaches a weight


def test_guided_window_discrete_dit_matches(monkeypatch):
    """The K600 recipe's model at a small size (DiT3D, the plain versions of
    B8 and the packed attention), discrete diffusion, 2 context frames of 5,
    sampled as a full sequence: the context is noised with the other frames
    and replaced, and its reconstruction is what the guidance corrects (a
    context pinned clean at level 0 has sqrt(1 - alpha) near 0 and gives the
    guidance nothing to move)."""
    pin_noise(monkeypatch)
    r = k600_dit_xl()
    spec = dataclasses.replace(r.spec, hidden_size=64, depth=2, num_heads=2)
    x_shape = (4, 4, 4)
    pm = TD.DiT3D(spec, x_shape[-1], x_shape[:2])
    init_random_weights(pm, torch.Generator().manual_seed(11))
    pm.eval()
    jv = {"params": jax.tree_util.tree_map(jnp.asarray, import_dit3d_params(
        {k: v.numpy() for k, v in pm.state_dict().items()}))}
    jm = JD.DiT3D(spec=JD.DiTSpec(**dataclasses.asdict(spec)), x_channels=x_shape[-1],
                  resolution=x_shape[:2])
    dcfg = dataclasses.replace(r.dcfg, sampling_timesteps=3)
    B, T = 2, r.max_tokens
    ctx = np.random.default_rng(11).standard_normal((B, T, *x_shape)).astype(np.float32)
    mask = np.zeros((B, T), np.int64)
    mask[:, :2] = 1

    def run_jax(d):
        ro = JR.DFoTRollout(JR.RolloutConfig(max_tokens=T, x_shape=x_shape, is_full_sequence=True),
                            jax_dcfg(d),
                            JDC.make_schedule(jax_dcfg(d)), lambda v, x, n, c, m: jm.apply(v, x, n, c, m))
        return ro.sample_sequence(jv, jax.random.PRNGKey(0), B, length=T, context=jnp.asarray(ctx),
                                  context_mask=mask,
                                  history_guidance=JHG.HistoryGuidance.conditional())

    def run_port(d):
        ro = TR.DFoTRollout(TR.RolloutConfig(max_tokens=T, x_shape=x_shape, is_full_sequence=True),
                            d,
                            TDC.make_schedule(d, device="cpu"), pm)
        return ro.sample_sequence(None, B, length=T, context=ctx, context_mask=mask,
                                  history_guidance=THG.HistoryGuidance.conditional())

    check_guided_window(run_jax, run_port, dcfg, 2.0)
