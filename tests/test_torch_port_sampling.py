"""PyTorch port of the sampling stack against the JAX package.

Host numpy copies (schedules, scheduling matrices, HG tables, sampling
plans) must be EQUAL to the originals. Device math (diffusion steps, HG
prepare/compose, the window sampler, the rollout) is compared on the same
seeded inputs with the random draws pinned on both sides (torch and JAX
cannot share a random stream): 1e-6 absolute for single elementwise steps,
1e-4 relative (L2) for sampled windows, which chain a model through several
steps.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfot_tpu.diffusion import core as JDC
from dfot_tpu.diffusion import schedules as JS
from dfot_tpu.diffusion.continuous import continuous_model_noise_input as j_noise_input
from dfot_tpu.guidance import history_guidance as JHG
from dfot_tpu.models import uvit as JU
from dfot_tpu.sampling import rollout as JR
from dfot_tpu.sampling import sampler as JSM
from dfot_tpu.sampling import scheduling as JSC
from dfot_tpu.utils.geometry import expand_pose_conditions_jax
from dfot_tpu_torch.algorithms.dfot_video import flagship, sampling_cond_transform
from dfot_tpu_torch.diffusion import core as TDC
from dfot_tpu_torch.diffusion import schedules as TS
from dfot_tpu_torch.diffusion.continuous import continuous_model_noise_input as t_noise_input
from dfot_tpu_torch.guidance import history_guidance as THG
from dfot_tpu_torch.models import uvit as TU
from dfot_tpu_torch.sampling import rollout as TR
from dfot_tpu_torch.sampling import sampler as TSM
from dfot_tpu_torch.sampling import scheduling as TSC

from torch_port_helpers import build_pair, pinned, t, tiny_spec

WINDOW_RTOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def jax_dcfg(dcfg):
    return JDC.DiffusionConfig(**dataclasses.asdict(dcfg))


def small_dcfg(steps=3):
    return dataclasses.replace(flagship().dcfg, sampling_timesteps=steps)


def hg_pairs():
    return [
        (JHG.HistoryGuidance.vanilla(4.0), THG.HistoryGuidance.vanilla(4.0)),
        (JHG.HistoryGuidance.stabilized_vanilla(3.0, 0.02),
         THG.HistoryGuidance.stabilized_vanilla(3.0, 0.02)),
        (JHG.HistoryGuidance.conditional(), THG.HistoryGuidance.conditional()),
        (JHG.HistoryGuidance.vanilla(2.0, use_external_cond_guidance=False),
         THG.HistoryGuidance.vanilla(2.0, use_external_cond_guidance=False)),
    ]


MASKS = [
    np.array([1, 0, 0, 0, 0, 0, 0, 0]),
    np.array([1, 2, 0, 0, 0, 0, 0, 1]),
    np.array([0, 0, 0, 0, 0, 0, 0, 0]),
    np.array([1, 1, 0, 0, 0, -1, -1, -1]),
]


# ---------------------------------------------------------------------------
# host numpy copies: equal to the originals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("cosine", {}),
    ("cosine", {"shift": 0.5}),
    ("cosine_simple_diffusion", {"shifted": 0.125, "interpolated": False}),
    ("cosine_simple_diffusion", {"shifted": 0.125, "interpolated": True}),
])
def test_beta_schedules_equal(name, kw):
    np.testing.assert_array_equal(
        TS.make_beta_schedule(name, 1000, **kw), JS.make_beta_schedule(name, 1000, **kw)
    )


def test_make_schedule_equal():
    dcfg = flagship().dcfg
    js, ts = JDC.make_schedule(jax_dcfg(dcfg)), TDC.make_schedule(dcfg, device="cpu")
    for name in JDC.Schedule._fields:
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))


@pytest.mark.parametrize("name,padding", [
    # the full_sequence cases keep their earlier ids, "0" and "3"
    pytest.param(name, padding, id=str(padding) if name == "full_sequence" else f"{name}-{padding}")
    for name in ("full_sequence", "autoregressive", "interleaved", "gibbs") for padding in (0, 3, 5)
])
def test_scheduling_matrices_equal(name, padding):
    for horizon, steps in ((8, 50), (5, 10), (3, 7)):
        np.testing.assert_array_equal(
            TSC.generate_scheduling_matrix(name, horizon, 1000, steps, padding),
            JSC.generate_scheduling_matrix(name, horizon, 1000, steps, padding),
        )
    np.testing.assert_array_equal(
        TSC.generate_refine_scheduling_matrix(8, 1000, 20, 4, 2, padding),
        JSC.generate_refine_scheduling_matrix(8, 1000, 20, 4, 2, padding),
    )


def _tables_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("pair", range(4))
def test_history_guidance_plan_equal(pair):
    jh, th = hg_pairs()[pair]
    for m in MASKS:
        _tables_equal(th.plan(m), jh.plan(m))


@pytest.mark.parametrize("refine,pad", [(None, None), ({"goback_length": 2, "n_goback": 1}, None),
                                        (None, 12)])
def test_plan_sampling_equal(refine, pad):
    ctx = np.stack([MASKS[0], MASKS[1]])
    for jh, th in hg_pairs()[:2]:
        args = (ctx, "full_sequence", 1000, 10, 8)
        kw = dict(refine=refine, pad_steps_to=pad)
        _tables_equal(TSM.plan_sampling(ctx, th, *args[1:], **kw),
                      JSM.plan_sampling(ctx, jh, *args[1:], **kw))


# ---------------------------------------------------------------------------
# device math
# ---------------------------------------------------------------------------


def test_diffusion_steps_match():
    dcfg = small_dcfg()
    js, ts = JDC.make_schedule(jax_dcfg(dcfg)), TDC.make_schedule(dcfg, device="cpu")
    rng = np.random.default_rng(0)
    x, noise, out = (rng.standard_normal((2, 4, 3, 3)).astype(np.float32) for _ in range(3))
    k = np.array([[-1, 0, 500, 999], [10, 10, 998, 3]], np.int32)
    nk = np.array([[-1, -1, 300, 999], [5, 10, 500, -1]], np.int32)
    jx, jk, jnk, jn, jo = map(jnp.asarray, (x, k, nk, noise, out))
    tx, tk, tnk, tn, to = map(t, (x, k, nk, noise, out))
    kc, tkc = jnp.clip(jk, 0, None), tk.clamp(min=0)
    close = lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6, rtol=1e-6)
    close(TDC.q_sample(ts, tx, tkc, tn), JDC.q_sample(js, jx, kc, jn))
    close(TDC.q_sample_from_x_k(ts, 1000, tx, tkc, tnk.clamp(min=0), tn),
          JDC.q_sample_from_x_k(js, 1000, jx, kc, jnp.clip(jnk, 0, None), jn))
    for obj in ("pred_v", "pred_noise", "pred_x0"):
        c = dataclasses.replace(dcfg, objective=obj)
        tp = TDC.model_predictions(ts, c, tx, tkc, to)
        jp = JDC.model_predictions(js, jax_dcfg(c), jx, kc, jo)
        close(tp.pred_noise, jp.pred_noise)
        close(tp.pred_x_start, jp.pred_x_start)
        for eta in (0.0, 0.5):
            ce = dataclasses.replace(c, ddim_sampling_eta=eta)
            close(TDC.ddim_step(ts, ce, tx, tk, tnk, tp, tn),
                  JDC.ddim_step(js, jax_dcfg(ce), jx, jk, jnk, jp, jn))
        close(TDC.ddpm_step(ts, c, tx, tk, tp, tn), JDC.ddpm_step(js, jax_dcfg(c), jx, jk, jp, jn))
    close(t_noise_input(dcfg, ts, tk), j_noise_input(jax_dcfg(dcfg), js, jk))
    np.testing.assert_array_equal(TDC.ddim_idx_to_noise_level(1000, 50, np.arange(51)),
                                  JDC.ddim_idx_to_noise_level(1000, 50, np.arange(51)))


@pytest.mark.parametrize("replacement_only", [False, True])
def test_hg_prepare_and_compose_match(replacement_only):
    dcfg = small_dcfg()
    js, ts = JDC.make_schedule(jax_dcfg(dcfg)), TDC.make_schedule(dcfg, device="cpu")
    jh, th = hg_pairs()[1]
    mask = np.stack([MASKS[1], MASKS[0]])
    table_j = jh.plan_batched(mask)
    table_t = THG.HGTable(*(np.concatenate([getattr(th.plan(m), f) for m in mask])
                            if f not in ("cond_mask", "weights") else getattr(th.plan(mask[0]), f)
                            for f in THG.HGTable._fields))
    _tables_equal(table_t, table_j)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 4, 3)).astype(np.float32)
    fk = np.where(mask >= 1, -1, 700).astype(np.int32)
    tk = np.where(mask >= 1, -1, 600).astype(np.int32)

    def jq(xf, kf, rng_):
        return JDC.q_sample(js, xf, jnp.clip(kf, 0, None), jnp.asarray(pinned(xf.shape)))

    def tq(xf, kf):
        return TDC.q_sample(ts, xf, kf.clamp(min=0), t(pinned(tuple(xf.shape))))

    jout = JHG.hg_prepare(jnp.asarray(x), jnp.asarray(fk), jnp.asarray(tk), jnp.asarray(mask),
                          table_j, jq, jax.random.PRNGKey(0), 1000, replacement_only)
    dev = THG.HGTable(*(torch.as_tensor(a) for a in table_t))
    tout = THG.hg_prepare(t(x), t(fk), t(tk), t(mask), table_t, dev, tq, 1000, replacement_only)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    y = rng.standard_normal(tuple(tout[0].shape)).astype(np.float32)
    np.testing.assert_allclose(THG.hg_compose(t(y), dev, 2).numpy(),
                               np.asarray(JHG.hg_compose(jnp.asarray(y), table_j, 2)), atol=1e-6)


def _pin_noise(monkeypatch):
    monkeypatch.setattr(
        JDC, "clipped_normal",
        lambda rng, shape, clip, dtype=jnp.float32: jnp.asarray(pinned(shape), dtype),
    )
    monkeypatch.setattr(
        TDC, "clipped_normal",
        lambda shape, clip, generator=None, device=None, dtype=torch.float32:
            torch.as_tensor(pinned(tuple(shape)), dtype=dtype, device=device),
    )


def test_window_sampler_all_branches(monkeypatch):
    """Denoise, go-back re-noise and no-op steps (a refinement plan padded
    with identity rows) through an analytic model, in both packages."""
    _pin_noise(monkeypatch)
    dcfg = dataclasses.replace(small_dcfg(10), is_continuous=False)
    js, ts = JDC.make_schedule(jax_dcfg(dcfg)), TDC.make_schedule(dcfg, device="cpu")
    jh, th = hg_pairs()[1]
    ctx = np.stack([MASKS[1]])
    kw = dict(refine={"goback_length": 2, "n_goback": 1}, pad_steps_to=40)
    tplan = TSM.plan_sampling(ctx, th, "full_sequence", 1000, 10, 8, **kw)
    jplan = JSM.plan_sampling(ctx, jh, "full_sequence", 1000, 10, 8, **kw)
    assert tplan.renoise.any() and tplan.noop.any() and not (tplan.renoise | tplan.noop).all()

    def j_model(variables, x, noise_in, cond, cond_mask):
        return jnp.tanh(x) * (1 + noise_in[:, :, None, None] / 1000.0) - 0.3 * cond_mask[:, None, None, None]

    def t_model(x, noise_in, cond, cond_mask):
        return torch.tanh(x) * (1 + noise_in[:, :, None, None] / 1000.0) - 0.3 * cond_mask[:, None, None, None]

    x0 = pinned((1, 8, 4, 3))
    jfn = JSM.make_window_sampler(j_model, jax_dcfg(dcfg), js)
    want = jfn(None, jnp.asarray(x0), jnp.zeros_like(jnp.asarray(x0)),
               jax.tree_util.tree_map(jnp.asarray, jplan), None, jax.random.PRNGKey(0),
               num_hist=jplan.num_hist, num_gen=jplan.num_gen)
    got = TSM.make_window_sampler(t_model, dcfg, ts)(t(x0), tplan, None)
    assert rel_err(got, want) < 1e-5


def test_sample_sequence_matches_jax(monkeypatch):
    """3 DDIM steps of an 8-frame window: tiny UViT3DPose, continuous
    diffusion, vanilla HG at scale 4, 1 context frame, pose vectors expanded
    to ray maps and precomputed pose FiLM terms once per window, token-layout
    state: the flagship's route at a small size, with pinned noise."""
    _pin_noise(monkeypatch)
    spec = tiny_spec()
    R, T, p = 16, 8, 2
    jm, jv, pm = build_pair(spec, R, seed=3, token_io=True)
    dcfg = small_dcfg(3)
    jh, th = hg_pairs()[0]
    rng = np.random.default_rng(2)
    ctx = rng.standard_normal((1, T, R, R, 3)).astype(np.float32)
    mask = np.zeros((1, T), np.int64)
    mask[:, 0] = 1
    poses = np.zeros((1, T, 16), np.float32)
    poses[..., :4] = [1.0, 1.0, 0.5, 0.5]
    poses[..., 4:16] = np.concatenate([np.eye(3), 0.1 * rng.standard_normal((3, 1))], 1).reshape(12)

    def j_transform(c, v):
        return JU.precompute_pose_conditioning(jm, v, expand_pose_conditions_jax(c, "ray", R))

    jro = JR.DFoTRollout(
        JR.RolloutConfig(
            max_tokens=T, x_shape=(R, R, 3), cond_transform=j_transform,
            state_codec=(lambda x: JU.patchify_tokens(x, p),
                         lambda x: JU.unpatchify_tokens(x, p, R, R)),
        ),
        jax_dcfg(dcfg), JDC.make_schedule(jax_dcfg(dcfg)),
        lambda v, x, n, c, m: jm.apply(v, x, n, c, m),
    )
    want = jro.sample_sequence(jv, jax.random.PRNGKey(0), 1, length=T, context=jnp.asarray(ctx),
                               context_mask=mask, conditions=jnp.asarray(poses),
                               history_guidance=jh)
    tro = TR.DFoTRollout(
        TR.RolloutConfig(
            max_tokens=T, x_shape=(R, R, 3),
            cond_transform=sampling_cond_transform(pm, "ray"),
            state_codec=(lambda x: TU.patchify_tokens(x, p),
                         lambda x: TU.unpatchify_tokens(x, p, R, R)),
        ),
        dcfg, TDC.make_schedule(dcfg, device="cpu"), pm,
    )
    got = tro.sample_sequence(None, 1, length=T, context=ctx, context_mask=mask,
                              conditions=poses, history_guidance=th)
    assert got.shape == (1, T, R, R, 3) and torch.isfinite(got).all()
    np.testing.assert_array_equal(got[:, 0].numpy(), ctx[:, 0])  # context kept
    assert rel_err(got, want) < WINDOW_RTOL
    assert tro.stats == jro.stats == {"denoiser_evals_b1": 6, "windows": 1}


def test_unported_options_raise():
    dcfg = small_dcfg()
    ts = TDC.make_schedule(dcfg, device="cpu")
    # reconstruction guidance is ported (tests/test_torch_port_remainders.py);
    # a guided window needs the clean context
    window = TSM.make_window_sampler(None, dcfg, ts, reconstruction_guidance=1.0)
    plan = TSM.plan_sampling(np.stack([MASKS[0]]), THG.HistoryGuidance.conditional(),
                             "full_sequence", 1000, 3, 8)
    with pytest.raises(ValueError, match="clean context"):
        window(torch.zeros(1, 8, 4, 4, 3), plan, None)
    with pytest.raises(NotImplementedError):
        TR.DFoTRollout(TR.RolloutConfig(8, (4, 4, 3), mesh=object()), dcfg, ts, None)
    with pytest.raises(ValueError):
        TSC.generate_scheduling_matrix("no_such_matrix", 8, 1000, 10)


# ---------------------------------------------------------------------------
# the flagship recipe and package hygiene
# ---------------------------------------------------------------------------


def test_flagship_matches_config_composition():
    from dfot_tpu.config import load_config
    from dfot_tpu.models.uvit import UViTSpec as JSpec

    cfg = load_config([
        "+name=re10k", "dataset=realestate10k_mini", "algorithm=dfot_video_pose",
        "experiment=video_generation", "@diffusion/continuous",
        "experiment.tasks=[validation]", "load=pretrained:DFoT_RE10K.ckpt",
        "++algorithm.tasks.prediction.history_guidance.name=vanilla",
        "++algorithm.tasks.prediction.history_guidance.guidance_scale=4.0",
    ])
    fs = flagship()
    a = cfg.algorithm
    assert JSpec.from_config(a.backbone, a.max_frames) == JSpec(**dataclasses.asdict(fs.spec))
    assert JDC.DiffusionConfig.from_config(a.diffusion) == jax_dcfg(fs.dcfg)
    hg = JHG.HistoryGuidance.from_config(a.tasks.prediction.history_guidance,
                                         timesteps=a.diffusion.timesteps)
    assert dataclasses.astuple(hg) == dataclasses.astuple(fs.history_guidance)
    assert a.x_shape == [fs.x_channels, fs.resolution, fs.resolution]
    assert a.camera_pose_conditioning.type == fs.conditioning_type
    assert a.backbone.use_fourier_noise_embedding is fs.use_fourier_noise_emb
    assert {"ray_encoding": 180}[fs.conditioning_type] == fs.external_cond_dim


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dfot_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(dfot_tpu_torch.__path__, 'dfot_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "want = {'models.remat', 'training.trainer', 'training.state', 'training.optim',\n"
        "        'training.noise_levels', 'algorithms.dfot_video', 'ops.attention',\n"
        "        'config', 'utils.yaml_reader', 'utils.torch_ckpt', 'experiments.video_generation',\n"
        "        '__main__', 'metrics.registry', 'metrics.frechet', 'metrics.vbench'}\n"
        "missing = {'dfot_tpu_torch.' + w for w in want} - set(names)\n"
        "assert not missing, missing\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'yaml', 'dfot_tpu', 'triton') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)
