"""PyTorch port of the training stack against the JAX package: noise levels,
loss weights and targets, learning-rate schedules, the optimizer chain, EMA,
and the flagship's training recipe.

Torch and JAX draw different random streams, so wherever a function draws,
the test makes the JAX draws itself (the same ``jax.random.split`` chain as
the JAX function) and injects them into the port; the deterministic parts
must then be EQUAL. Tolerances: 1e-6 absolute for elementwise fp32 math
(1e-5 relative for the loss weights, whose SNRs span twelve decades, and
for the learning-rate schedules, which optax evaluates in fp32);
1e-6 relative to the largest value for five chained AdamW updates.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dfot_tpu.diffusion import continuous as JC
from dfot_tpu.diffusion import core as JDC
from dfot_tpu.training import noise_levels as JNL
from dfot_tpu.training import optim as JO
from dfot_tpu.training import state as JST
from dfot_tpu_torch.algorithms.dfot_video import build_model, flagship
from dfot_tpu_torch.diffusion import continuous as TC
from dfot_tpu_torch.diffusion import core as TDC
from dfot_tpu_torch.models import embeddings as TE
from dfot_tpu_torch.models.remat import REMAT_POLICIES, remat
from dfot_tpu_torch.training import noise_levels as TNL
from dfot_tpu_torch.training import optim as TO
from dfot_tpu_torch.training import state as TST

from torch_port_helpers import t


def jax_dcfg(dcfg):
    return JDC.DiffusionConfig(**dataclasses.asdict(dcfg))


# ---------------------------------------------------------------------------
# training noise levels
# ---------------------------------------------------------------------------

NL_MODES = {
    "independent": dict(noise_level="random_independent"),
    "uniform": dict(noise_level="random_uniform"),
    "interleaved": dict(noise_level="interleaved"),
    "uniform_future": dict(noise_level="random_independent", uniform_future=True,
                           n_context_tokens=3),
    "fixed_context": dict(noise_level="random_uniform", fixed_context=True, n_context_tokens=2,
                          fixed_context_dropout=0.5),
    "fixed_context_indices": dict(noise_level="random_uniform", fixed_context=True,
                                  fixed_context_indices=(0, 5), fixed_context_dropout=0.5),
    "variable_context": dict(noise_level="random_independent", variable_context=True,
                             variable_context_prob=0.4, variable_context_dropout=0.5),
}


def _jax_draws(rng, cfg, B, T):
    """The draws ``dfot_tpu``'s training_noise_levels makes from ``rng``."""
    r_levels, r_ctx, r_drop, r_future = jax.random.split(rng, 4)
    width = {"random_independent": T, "random_uniform": 1, "interleaved": 2}[cfg.noise_level]
    draws = {"levels": np.asarray(JNL._rand_levels(r_levels, (B, width), cfg))}
    if cfg.uniform_future:
        draws["future"] = np.asarray(JNL._rand_levels(r_future, (B, 1), cfg))
    if cfg.variable_context:
        draws["context"] = np.asarray(
            jax.random.bernoulli(r_ctx, cfg.variable_context_prob, (B, T)))
    if cfg.variable_context or cfg.fixed_context:
        p = cfg.variable_context_dropout if cfg.variable_context else cfg.fixed_context_dropout
        draws["context_drop"] = np.asarray(jax.random.bernoulli(r_drop, p, (B, 1)))
    return draws


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("mode", sorted(NL_MODES))
def test_training_noise_levels_match(mode, continuous):
    """Injected draws: levels and loss mask equal to the JAX function's,
    forced max levels on unavailable frames and context handling included."""
    B, T = 6, 8
    kw = dict(NL_MODES[mode], timesteps=1000, is_continuous=continuous)
    jcfg, tcfg = JNL.NoiseLevelConfig(**kw), TNL.NoiseLevelConfig(**kw)
    frame_mask = np.ones((B, T), bool)
    frame_mask[1, 5:] = False
    frame_mask[4, :2] = False
    for seed in range(3):
        rng = jax.random.PRNGKey(seed)
        want_k, want_m = JNL.training_noise_levels(rng, jcfg, jnp.asarray(frame_mask))
        draws = {k: t(v) for k, v in _jax_draws(rng, jcfg, B, T).items()}
        got_k, got_m = TNL.training_noise_levels(None, tcfg, t(frame_mask), draws=draws)
        assert got_k.shape == (B, T) and got_m.dtype == torch.bool
        assert got_k.dtype == (torch.float32 if continuous else torch.int64)
        np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
        # eval mode: the context is never dropped
        want_k, _ = JNL.training_noise_levels(rng, jcfg, jnp.asarray(frame_mask), train=False)
        if "context_drop" in draws:
            draws["context_drop"] = torch.zeros(B, 1, dtype=torch.bool)
        got_k, _ = TNL.training_noise_levels(None, tcfg, t(frame_mask), train=False, draws=draws)
        np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("mode", sorted(NL_MODES))
def test_training_noise_levels_own_draws(mode, continuous):
    """The port's own draws: a seeded generator repeats, levels stay in
    range, and the structure of each mode holds."""
    B, T = 64, 8
    cfg = TNL.NoiseLevelConfig(**dict(NL_MODES[mode], timesteps=1000, is_continuous=continuous))
    mask = torch.ones(B, T, dtype=torch.bool)
    mask[0, 6:] = False
    gen = lambda: torch.Generator().manual_seed(7)
    k, lm = TNL.training_noise_levels(gen(), cfg, mask)
    k2, lm2 = TNL.training_noise_levels(gen(), cfg, mask)
    assert torch.equal(k, k2) and torch.equal(lm, lm2)
    top = 1.0 if continuous else 999
    assert k.min() >= 0 and k.max() <= top
    assert (k[0, 6:] == top).all() and not lm[0, 6:].any()
    if mode == "uniform":
        assert (k[1:] == k[1:, :1]).all()
    if mode == "interleaved":
        assert (k[1:, 0::2] == k[1:, :1]).all() and (k[1:, 1::2] == k[1:, 1:2]).all()
    if mode == "uniform_future":
        assert (k[1:, 3:] == k[1:, 3:4]).all()
    if mode == "fixed_context":
        assert not lm[:, :2].any() and lm[1:, 2:].all()
        assert set(k[:, 0].tolist()) == {0, top}  # kept or dropped, with p = 0.5
    if mode == "independent":
        mean = k[1:].float().mean() / (1.0 if continuous else 1000)
        assert abs(float(mean) - 0.5) < 0.06  # 504 draws of U(0, 1): 4.5 sigma


def test_training_noise_levels_rejects_bad_input():
    mask = torch.ones(2, 4, dtype=torch.bool)
    with pytest.raises(ValueError):
        TNL.training_noise_levels(None, TNL.NoiseLevelConfig(noise_level="nope"), mask)
    with pytest.raises(ValueError):
        TNL.training_noise_levels(None, TNL.NoiseLevelConfig(), mask,
                                  draws={"levels": torch.zeros(2, 3)})


# ---------------------------------------------------------------------------
# diffusion math, training side
# ---------------------------------------------------------------------------


def _schedules(**kw):
    dcfg = dataclasses.replace(flagship().dcfg, **kw)
    return dcfg, JDC.make_schedule(jax_dcfg(dcfg)), TDC.make_schedule(dcfg, device="cpu")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0", "pred_v"])
@pytest.mark.parametrize("strategy", ["uniform", "sigmoid", "min_snr", "fused_min_snr"])
def test_loss_weights_match(strategy, objective, causal):
    dcfg, js, ts = _schedules(loss_weighting_strategy=strategy, objective=objective,
                              use_causal_mask=causal, is_continuous=False)
    k = np.random.default_rng(0).integers(0, 1000, (3, 8))
    k[0, 0], k[0, 1] = 0, 999
    want = np.asarray(JDC.compute_loss_weights(js, jax_dcfg(dcfg), jnp.asarray(k)))
    got = TDC.compute_loss_weights(ts, dcfg, t(k))
    assert got.dtype == torch.float32 and got.shape == (3, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0", "pred_v"])
def test_training_targets_and_loss_match(objective):
    dcfg, js, ts = _schedules(objective=objective, is_continuous=False,
                              loss_weighting_strategy="fused_min_snr")
    rng = np.random.default_rng(1)
    x, noise, out = (rng.standard_normal((2, 8, 4, 4, 3)).astype(np.float32) for _ in range(3))
    k = rng.integers(0, 1000, (2, 8))
    want = JDC.training_targets(js, jax_dcfg(dcfg), jnp.asarray(x), jnp.asarray(k),
                                jnp.asarray(noise))
    got = TDC.training_targets(ts, dcfg, t(x), t(k), t(noise))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    np.testing.assert_allclose(
        TDC.predict_v(ts, t(x), t(k), t(noise)).numpy(),
        np.asarray(JDC.predict_v(js, jnp.asarray(x), jnp.asarray(k), jnp.asarray(noise))),
        atol=1e-6)
    want = JDC.training_loss(js, jax_dcfg(dcfg), jnp.asarray(out), want[1], jnp.asarray(k))
    got_loss = TDC.training_loss(ts, dcfg, t(out), got[1], t(k))
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # no gradient flows into the target
    tgt = got[1].clone().requires_grad_()
    o = t(out).requires_grad_()
    TDC.training_loss(ts, dcfg, o, tgt, t(k)).sum().backward()
    assert tgt.grad is None and o.grad is not None


def test_continuous_training_fields_and_v_loss_match():
    dcfg = flagship().dcfg
    assert dcfg.is_continuous
    rng = np.random.default_rng(2)
    x, noise, v = (rng.standard_normal((2, 8, 4, 4, 3)).astype(np.float32) for _ in range(3))
    tt = rng.uniform(0, 1, (2, 8)).astype(np.float32)
    tt[0, 0], tt[0, 1] = 0.0, 1.0
    want = JC.continuous_training_fields(jax_dcfg(dcfg), jnp.asarray(x), jnp.asarray(tt),
                                         jnp.asarray(noise))
    got = TC.continuous_training_fields(dcfg, t(x), t(tt), t(noise))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    want_l = JC.continuous_v_loss(jax_dcfg(dcfg), jnp.asarray(v), *want[:1], jnp.asarray(noise),
                                  *want[1:])
    got_l = TC.continuous_v_loss(dcfg, t(v), got[0], t(noise), *got[1:])
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# learning-rate schedules, optimizer, EMA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup", [0, 1, 7])
@pytest.mark.parametrize("name", ["constant", "constant_with_warmup", "linear", "cosine"])
def test_lr_schedule_matches_optax(name, warmup):
    """Step for step from 0, the first warm-up step's zero included."""
    want = JO.make_lr_schedule(name, 3e-4, warmup, 40)
    got = TO.make_lr_schedule(name, 3e-4, warmup, 40)
    for step in range(60):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5, atol=1e-12,
                                   err_msg=f"step {step}")
    if name != "constant" and warmup:
        assert got(0) == 0.0


def test_lr_schedule_rejects_bad_input():
    with pytest.raises(ValueError):
        TO.make_lr_schedule("exponential", 1e-3)
    with pytest.raises(ValueError):
        TO.make_lr_schedule("cosine", 1e-3, 10)


def _seeded_tree(rng):
    shapes = {"w": (5, 7), "b": (7,), "scale": (3,), "k": (2, 3, 4)}
    return {name: rng.standard_normal(shape).astype(np.float32) for name, shape in shapes.items()}


@pytest.mark.parametrize("accumulate", [1, 2])
@pytest.mark.parametrize("schedule", ["constant_with_warmup", "cosine"])
def test_optimizer_matches_optax(schedule, accumulate):
    """Five AdamW updates (ten micro-steps under accumulation) on a seeded
    tree with seeded gradients, some of norm above the clip, some below:
    clipping by optax's rule, decoupled weight decay on every leaf, the
    schedule read at the update count, the mean over micro-steps."""
    rng = np.random.default_rng(3)
    params = _seeded_tree(rng)
    kw = dict(lr=1e-2, weight_decay=0.05, betas=(0.9, 0.95), grad_clip=1.0,
              lr_schedule_name=schedule, num_warmup_steps=2, num_training_steps=8,
              accumulate_steps=accumulate)
    tx = JO.make_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(t(v)) for k, v in params.items()}
    opt = TO.make_optimizer(tp.values(), **kw)
    updated = []
    for step in range(5 * accumulate):
        size = 0.02 if step % 3 == 0 else 3.0  # below and above the clip
        grads = {k: (size * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in params.items()}
        updates, opt_state = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        for k, p in tp.items():
            p.grad = t(grads[k])
        updated.append(opt.step())
        for k in params:
            want = np.asarray(jp[k])
            np.testing.assert_allclose(tp[k].detach().numpy(), want, rtol=0,
                                       atol=1e-6 * max(1.0, np.abs(want).max()),
                                       err_msg=f"{k} after micro-step {step}")
    assert updated == [(i + 1) % accumulate == 0 for i in range(5 * accumulate)]
    # the first update ran at learning rate 0: only later ones moved the tree
    assert any(not np.array_equal(np.asarray(jp[k]), params[k]) for k in params)


def test_optimizer_first_warmup_step_leaves_params():
    p = torch.nn.Parameter(torch.ones(4))
    opt = TO.make_optimizer([p], lr=1e-2, num_warmup_steps=3)
    assert opt.lr == 0.0
    p.grad = torch.ones(4)
    assert opt.step()
    assert torch.equal(p.detach(), torch.ones(4))
    assert opt.lr == pytest.approx(1e-2 / 3)


def test_global_norm_matches_optax():
    tree = _seeded_tree(np.random.default_rng(4))
    want = float(optax.global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    assert float(TO.global_norm([t(v) for v in tree.values()])) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("accumulate", [1, 3])
def test_ema_matches_jax(accumulate):
    rng = np.random.default_rng(5)
    ema, params = _seeded_tree(rng), _seeded_tree(rng)
    want = JST.ema_update({k: jnp.asarray(v) for k, v in ema.items()},
                          {k: jnp.asarray(v) for k, v in params.items()}, 0.9)
    got = TST.ema_update({k: t(v) for k, v in ema.items()}, {k: t(v) for k, v in params.items()},
                         0.9)
    for k in ema:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6)
    for step in range(1, 7):
        want = JST.gated_ema_update({k: jnp.asarray(v) for k, v in ema.items()},
                                    {k: jnp.asarray(v) for k, v in params.items()}, 0.9,
                                    jnp.asarray(step), accumulate)
        got = TST.gated_ema_update({k: t(v) for k, v in ema.items()},
                                   {k: t(v) for k, v in params.items()}, 0.9, step, accumulate)
        for k in ema:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6,
                                       err_msg=f"{k} step {step}")
        changed = any(not np.array_equal(got[k].numpy(), ema[k]) for k in ema)
        assert changed == (step % accumulate == 0)


def test_train_state_keeps_fp32_ema_of_trainable_parameters():
    model = torch.nn.Linear(3, 2)
    model.bias.requires_grad_(False)
    opt = TO.make_optimizer(model.parameters(), lr=1e-3)
    state = TST.create_train_state(model, opt)
    assert state.step == 0 and set(state.ema) == {"weight"}
    assert state.ema["weight"].dtype == torch.float32
    assert state.ema["weight"].data_ptr() != model.weight.data_ptr()
    assert state.scheduler is opt.scheduler
    state.ema["weight"].zero_()
    sd = state.ema_state_dict()
    assert not sd["weight"].any() and torch.equal(sd["bias"], model.bias)
    with pytest.raises(ValueError):
        TST.create_train_state(model, opt, use_ema=False).ema_state_dict()


# ---------------------------------------------------------------------------
# embeddings' training branches, remat policies
# ---------------------------------------------------------------------------


def test_stochastic_time_embedding_unknown_token():
    """p > 0: in training mode positions take the learned token with
    probability p (from the global generator), in eval mode where the mask
    says; p = 0, the UViT's setting, owns no token."""
    assert not hasattr(TE.StochasticTimeEmbedding(16, 8), "unknown_token")
    emb = TE.StochasticTimeEmbedding(16, 8, p=0.5)
    levels = torch.arange(4000.0).reshape(40, 100) % 1000
    plain = emb.embedding(TE.timestep_embedding(levels, 16))
    token = emb.embedding(emb.unknown_token)[0]
    emb.train()
    torch.manual_seed(0)
    out = emb(levels)
    torch.manual_seed(0)
    assert torch.equal(out, emb(levels))
    # a one-row and a batched matmul round differently: compare within 1e-5
    took = (out - token).abs().amax(-1) < 1e-5
    torch.testing.assert_close(out[~took], plain[~took], rtol=0, atol=1e-5)
    assert abs(float(took.float().mean()) - 0.5) < 0.04  # 4000 draws: 5 sigma
    emb.eval()
    mask = torch.zeros(40, 100, dtype=torch.bool)
    mask[3] = True
    out = emb(levels, mask)
    torch.testing.assert_close(out[3], token.expand(100, -1), rtol=0, atol=1e-5)
    torch.testing.assert_close(out[~mask], plain[~mask], rtol=0, atol=1e-5)
    out.sum().backward()
    assert emb.unknown_token.grad is not None and emb.unknown_token.grad.any()


@pytest.mark.parametrize("policy", [None, *REMAT_POLICIES, "everything"])
def test_remat_policies(policy):
    """Every policy recomputes what it does not keep and replays the
    block's dropout: the gradient is the block's own; an unknown name is an
    error. (What each policy keeps: tests/test_torch_port_remat.py.)"""
    if policy is None or policy in REMAT_POLICIES:
        lin = torch.nn.Sequential(torch.nn.Linear(6, 6), torch.nn.Dropout(0.5))
        x = torch.randn(4, 6, requires_grad=True)
        torch.manual_seed(1)
        remat(policy)(lin, x).sum().backward()
        got = x.grad.clone()
        x.grad = None
        torch.manual_seed(1)
        lin(x).sum().backward()
        assert torch.equal(got, x.grad)
    else:
        with pytest.raises(ValueError):
            remat(policy)


# ---------------------------------------------------------------------------
# the flagship's training recipe, and where entry points put their tensors
# ---------------------------------------------------------------------------


def test_flagship_training_values_match_config_composition():
    from dfot_tpu.config import load_config

    cfg = load_config([
        "+name=re10k", "dataset=realestate10k_mini", "algorithm=dfot_video_pose",
        "experiment=video_generation", "@diffusion/continuous", "experiment.tasks=[training]",
    ])
    fs = flagship()
    r, a, e = fs.train, cfg.algorithm, cfg.experiment
    assert (r.lr, r.weight_decay) == (a.lr, a.weight_decay)
    assert list(r.optimizer_beta) == list(a.optimizer_beta)
    assert (r.lr_scheduler, r.num_warmup_steps) == (a.lr_scheduler.name,
                                                    a.lr_scheduler.num_warmup_steps)
    assert r.num_training_steps == a.lr_scheduler.get("num_training_steps")
    assert r.grad_clip == e.training.optim.gradient_clip_val
    assert r.accumulate_steps == e.training.optim.accumulate_grad_batches
    assert r.ema_decay == e.ema.decay and e.ema.enable
    assert (r.precision, r.batch_size) == (e.training.precision, e.training.batch_size)
    assert fs.external_cond_dropout == a.backbone.external_cond_dropout
    want = JNL.NoiseLevelConfig.from_config(a, a.diffusion.timesteps, a.context_frames)
    assert dataclasses.asdict(want) == dataclasses.asdict(r.noise_levels)
    assert JDC.DiffusionConfig.from_config(a.diffusion) == jax_dcfg(fs.dcfg)
    assert fs.spec.use_checkpointing == (False, False, False, True)
    assert fs.spec.block_dropouts == tuple(a.backbone.block_dropouts)


def test_entry_points_default_to_the_card():
    """``device=None`` is the card: with no CUDA device PyTorch's own error
    comes up; the CPU is used only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("this test is about a machine without a CUDA device")
    fs = flagship()
    with pytest.raises((RuntimeError, AssertionError)):
        TDC.make_schedule(fs.dcfg)
    with pytest.raises((RuntimeError, AssertionError)):
        TDC.clipped_normal((2, 2), 20.0)
    tiny = fs._replace(spec=dataclasses.replace(
        fs.spec, channels=(32, 32, 64, 64), emb_channels=32, num_updown_blocks=(1, 1, 1),
        num_mid_blocks=1, num_heads=1), resolution=16)
    with pytest.raises((RuntimeError, AssertionError)):
        build_model(tiny)
    assert TDC.make_schedule(fs.dcfg, device="cpu").betas.device.type == "cpu"
    assert TDC.clipped_normal((2, 2), 0.5, device="cpu").abs().max() <= 0.5
    model = build_model(tiny, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {b.device.type for b in model.buffers()} == {"cpu"}
