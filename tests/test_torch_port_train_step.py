"""The port's UViT3DPose backward and its train step against the JAX package.

Same weights (``uvit3d_state_dict_from_flax``; gradients and updated trees
come back through the same map), same seeded numpy inputs, fp32 on the CPU,
where the port's attention route runs the plain versions of its kernels,
forward and backward. Torch and JAX draw different random streams, so the
train step gets its noise levels and noise injected: the test makes them
with the ``jax.random.split`` chain of ``dfot_tpu/training/trainer.py``.

Tolerances: every parameter's gradient within 1e-4 relative (L2) of
``jax.grad``'s, the model's loss within 1e-5 relative, the train step's
loss and gradient norm within 1e-4 relative (they chain the fp32 logSNR
schedule, the model and a mean over 1e4 elements); after an
AdamW step at learning rate lr, every leaf of the parameters and of the EMA
within 2e-3 relative (L2) of the JAX update's norm and each element within
5e-2 * lr (Adam's normalised update is O(1) per element whatever the
gradient's size: a leaf's gradients agree to 1e-4 of its norm, so the few
elements whose gradient is that small can move by a visible part of lr).

One leaf differs by construction: the output projection's bias. The JAX
model holds p*p copies of it (one per pixel of a patch), each with its own
gradient; the port, like the upstream checkpoint, holds one, whose gradient
is their sum. The train-step test therefore ties the copies on the JAX side
(every copy reads the first), which gives the first copy that sum.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfot_tpu.diffusion import core as JDC
from dfot_tpu.ops.qkv_prep import force_fused_interpret
from dfot_tpu.training import noise_levels as JNL
from dfot_tpu.training import optim as JO
from dfot_tpu.training import state as JST
from dfot_tpu.training import trainer as JT
from dfot_tpu_torch.algorithms.dfot_video import flagship
from dfot_tpu_torch.diffusion import core as TDC
from dfot_tpu_torch.models import uvit as TU
from dfot_tpu_torch.training import noise_levels as TNL
from dfot_tpu_torch.training import optim as TO
from dfot_tpu_torch.training import state as TST
from dfot_tpu_torch.training import trainer as TT
from dfot_tpu_torch.utils.weights import uvit3d_state_dict_from_flax

from torch_port_helpers import POSE_DIM, build_pair, t, tiny_spec, one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


GRAD_RTOL = 1e-4
STEP_RTOL, STEP_ATOL = 2e-3, 5e-2
# two channels per GroupNorm group at every level: with one (the helpers'
# 32-channel levels) a conv bias ahead of a GroupNorm has a gradient that is
# zero in exact arithmetic and rounding noise in fp32, which no relative
# bound can compare and which Adam would scale up to a full-size update
WIDE = (64, 64, 64, 64)


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _port_tree(tree, spec, cotangent=False):
    """A JAX params-shaped tree on the port's parameter names."""
    return uvit3d_state_dict_from_flax(jax.device_get(tree), None, spec, 3, POSE_DIM,
                                       cotangent=cotangent)


@pytest.mark.parametrize("route,resolution,checkpoint", [
    ("reference", 16, False),
    ("reference", 16, True),
    ("fused_interpret", 64, True),
])
def test_uvit_gradients_match_jax(route, resolution, checkpoint):
    """Loss and every parameter's gradient of the tiny UViT3DPose in training
    mode (dropouts 0), with the transformer levels checkpointed and not,
    against ``jax.grad`` on the JAX reference attention chain and on its
    fused Pallas route in interpret mode (both transformer levels have
    N >= 128 tokens at 64 px). The q/k norm scales get their gradients
    through the differentiable table fold."""
    spec = tiny_spec(channels=WIDE, use_checkpointing=(False, False, checkpoint, checkpoint))
    jm, jv, pm = build_pair(spec, resolution, seed=3)
    rng = np.random.default_rng(20)
    B, T, R = 1, 8, resolution
    x, g = (rng.standard_normal((B, T, R, R, 3)).astype(np.float32) for _ in range(2))
    k = rng.uniform(-2, 2, (B, T)).astype(np.float32)
    pose = rng.standard_normal((B, T, R, R, POSE_DIM)).astype(np.float32)

    def jloss(params):
        out = jm.apply({"params": params, "buffers": jv["buffers"]}, jnp.asarray(x),
                       jnp.asarray(k), jnp.asarray(pose), None, train=True,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.mean(out * jnp.asarray(g))

    force_fused_interpret(route == "fused_interpret")
    try:
        want_loss, want = jax.value_and_grad(jloss)(jv["params"])
    finally:
        force_fused_interpret(False)
    want = _port_tree(want, spec, cotangent=True)

    pm.train()
    loss = (pm(t(x), t(k), t(pose)) * t(g)).mean()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5, abs=1e-8)
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert set(got) == set(want)
    worst = {}
    for name, w in want.items():
        assert got[name] is not None, f"{name} got no gradient"
        assert got[name].shape == w.shape
        worst[name] = rel_err(got[name].numpy(), w.numpy())
    bad = {n: e for n, e in worst.items() if e > GRAD_RTOL}
    assert not bad, bad
    for name in ("mid_blocks.0.q_norm.weight", "mid_blocks.0.k_norm.weight",
                 "down_blocks.2.0.q_norm.weight", "up_blocks.0.1.k_norm.weight"):
        assert got[name].abs().max() > 0, f"{name}: zero gradient"


def test_inference_fold_is_cached_and_carries_no_gradient():
    """Without gradients the folded tables are cached per block; with them
    the fold is made anew and is part of the graph."""
    _, _, pm = build_pair(tiny_spec(), 16)
    blk = pm.mid_blocks[0]
    with torch.no_grad():
        a = blk._tables(torch.device("cpu"), torch.float32)
        assert blk._tables(torch.device("cpu"), torch.float32) is a
    b = blk._tables(torch.device("cpu"), torch.float32)
    assert b is not a and b[0][0].requires_grad and b[1][1].requires_grad
    for p in (blk.q_norm.weight, blk.k_norm.weight):
        p.requires_grad_(False)
    assert blk._tables(torch.device("cpu"), torch.float32) is a


def test_block_dropout_and_pose_dropout_follow_the_mode():
    """``train()`` switches on the block dropouts and the whole-sample pose
    dropout, ``eval()`` switches them off; a checkpointed level replays its
    dropout in the backward (same gradients as without checkpointing)."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((4, 8, 16, 16, 3)).astype(np.float32)
    k = rng.uniform(-2, 2, (4, 8)).astype(np.float32)
    pose = rng.standard_normal((4, 8, 16, 16, POSE_DIM)).astype(np.float32)
    grads = []
    for checkpoint in (False, True):
        spec = tiny_spec(block_dropouts=(0.0, 0.0, 0.3, 0.3),
                         use_checkpointing=(False, False, checkpoint, checkpoint))
        pm = TU.UViT3DPose(spec, 3, 16, POSE_DIM, use_fourier_noise_emb=True)
        pm.load_state_dict(build_pair(tiny_spec(), 16)[2].state_dict())
        pm.eval()
        with torch.no_grad():
            e1, e2 = pm(t(x), t(k), t(pose)), pm(t(x), t(k), t(pose))
        assert torch.equal(e1, e2)
        pm.train()
        torch.manual_seed(5)
        out = pm(t(x), t(k), t(pose))
        assert not torch.allclose(out, e1)
        out.square().mean().backward()
        grads.append({n: p.grad.clone() for n, p in pm.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-5, atol=1e-7, msg=name)

    # whole-sample pose dropout at p = 1 equals a cond mask that drops all
    pm = TU.UViT3DPose(tiny_spec(), 3, 16, POSE_DIM, use_fourier_noise_emb=True,
                       external_cond_dropout=1.0)
    pm.load_state_dict(build_pair(tiny_spec(), 16)[2].state_dict())
    with torch.no_grad():
        dropped = pm.train()(t(x), t(k), t(pose))
        masked = pm.eval()(t(x), t(k), t(pose), torch.ones(4, dtype=torch.bool))
        kept = pm(t(x), t(k), t(pose))
    assert torch.equal(dropped, masked) and not torch.allclose(dropped, kept)
    with pytest.raises(ValueError):
        pm.train()(t(x), t(k), {"mods": {}})


def _tie_output_bias(params, p):
    """Every copy of the output projection's bias reads the first."""
    b = params["project_output"]["bias"]
    tied = jnp.tile(b[: b.shape[0] // (p * p)], p * p)
    return {**params, "project_output": {**params["project_output"], "bias": tied}}


def _first_bias_copy(tree, p):
    b = np.asarray(tree["project_output"]["bias"])
    tree = jax.device_get(tree)
    return {**tree, "project_output": {**tree["project_output"],
                                       "bias": np.tile(b[: b.shape[0] // (p * p)], p * p)}}


@pytest.mark.parametrize("continuous", [True, False])
def test_two_train_steps_match_jax(continuous):
    """Two steps of ``make_train_step`` on the tiny model, continuous and
    discrete branch: loss, gradient norm, updated parameters and EMA. The
    warm-up's first step runs at learning rate 0 in both packages."""
    spec = tiny_spec(channels=WIDE, use_checkpointing=(False, False, False, True))
    R, B, T, p = 16, 2, 8, spec.patch_size
    jm, jv, pm = build_pair(spec, R, seed=4)
    dcfg = dataclasses.replace(flagship().dcfg, is_continuous=continuous,
                               loss_weighting_strategy="sigmoid" if continuous else "fused_min_snr")
    jdcfg = JDC.DiffusionConfig(**dataclasses.asdict(dcfg))
    nl_kw = dict(noise_level="random_independent", timesteps=dcfg.timesteps,
                 is_continuous=continuous, n_context_tokens=1)
    lr, decay = 1e-3, 0.9
    opt_kw = dict(lr=lr, weight_decay=0.01, betas=(0.9, 0.99), grad_clip=1.0,
                  lr_schedule_name="constant_with_warmup", num_warmup_steps=2)

    rng = np.random.default_rng(22)
    batch = {
        "xs": rng.standard_normal((B, T, R, R, 3)).astype(np.float32),
        "conditions": rng.standard_normal((B, T, R, R, POSE_DIM)).astype(np.float32),
        "masks": np.ones((B, T), bool),
    }
    batch["masks"][1, 6:] = False

    def j_apply(params, x, noise_levels, cond, cond_mask, rngs=None, train=False):
        return jm.apply({"params": _tie_output_bias(params, p), "buffers": jv["buffers"]}, x,
                        noise_levels, cond, cond_mask, train=train, rngs=rngs)

    j_step = JT.make_train_step(j_apply, jdcfg, JDC.make_schedule(jdcfg),
                                JNL.NoiseLevelConfig(**nl_kw), ema_decay=decay)
    j_state = JST.create_train_state(jv["params"], JO.make_optimizer(**opt_kw))

    t_step = TT.make_train_step(
        lambda model, x, nl, cond, mask: model(x, nl, cond, mask), dcfg,
        TDC.make_schedule(dcfg, device="cpu"), TNL.NoiseLevelConfig(**nl_kw), ema_decay=decay)
    t_state = TST.create_train_state(pm, TO.make_optimizer(pm.parameters(), **opt_kw))
    t_batch = {k: t(v) for k, v in batch.items()}
    start = {n: q.detach().clone() for n, q in pm.named_parameters()}

    for step in range(2):
        key = jax.random.PRNGKey(100 + step)
        r_k, r_noise, _ = jax.random.split(key, 3)
        r_levels = jax.random.split(r_k, 4)[0]
        levels = np.asarray(JNL._rand_levels(r_levels, (B, T), JNL.NoiseLevelConfig(**nl_kw)))
        noise = np.asarray(JDC.clipped_normal(r_noise, batch["xs"].shape, dcfg.clip_noise))
        j_state, want = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        t_state, got = t_step(t_state, t_batch, None, noise_levels=t(levels), noise=t(noise))
        assert t_state.step == step + 1 == int(j_state.step)
        assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-4)
        assert float(got["grad_norm"]) == pytest.approx(float(want["grad_norm"]), rel=1e-4)
        assert float(got["grad_norm"]) > opt_kw["grad_clip"]  # the clip is at work
        want_p = _port_tree(_first_bias_copy(j_state.params, p), spec)
        want_e = _port_tree(_first_bias_copy(j_state.ema_params, p), spec)
        moved = 0.0
        for name, q in pm.named_parameters():
            for what, got_t, want_t in (("param", q.detach(), want_p[name]),
                                        ("ema", t_state.ema[name], want_e[name])):
                diff = (got_t - want_t).abs()
                update = (want_t - start[name]).norm()
                assert float(diff.max()) <= STEP_ATOL * lr, f"{what} {name} step {step}"
                # floor: fp32 rounding of the leaf itself (the EMA's two products)
                assert float(diff.norm()) <= STEP_RTOL * float(update) + 1e-6 * float(
                    want_t.norm()), f"{what} {name} step {step}"
            moved = max(moved, float((q.detach() - start[name]).abs().max()))
        if step == 0:
            assert moved == 0.0  # learning rate 0: nothing moved, decay included
        else:
            assert moved > 0.2 * lr  # half the base rate times Adam's O(1) update
            assert not torch.equal(t_state.ema["mid_blocks.0.q_norm.weight"],
                                   start["mid_blocks.0.q_norm.weight"])
    assert t_state.optimizer.lr == pytest.approx(lr)


def test_train_step_own_draws_and_accumulation():
    """With its own generator the step repeats from a seed, dropout
    included, restores the global random state, and under accumulation
    updates parameters and EMA every second micro-step only."""
    spec = tiny_spec(block_dropouts=(0.0, 0.0, 0.2, 0.2),
                     use_checkpointing=(False, False, False, True))
    dcfg = flagship().dcfg
    nl = TNL.NoiseLevelConfig(is_continuous=True)
    rng = np.random.default_rng(23)
    batch = {
        "xs": t(rng.standard_normal((1, 8, 16, 16, 3)).astype(np.float32)),
        "conditions": t(rng.standard_normal((1, 8, 16, 16, POSE_DIM)).astype(np.float32)),
        "masks": torch.ones(1, 8, dtype=torch.bool),
    }
    step = TT.make_train_step(lambda m, x, k, c, cm: m(x, k, c, cm), dcfg,
                              TDC.make_schedule(dcfg, device="cpu"), nl, ema_decay=0.5,
                              accumulate_steps=2)
    runs = []
    for _ in range(2):
        pm = TU.UViT3DPose(spec, 3, 16, POSE_DIM, use_fourier_noise_emb=True,
                           external_cond_dropout=0.1)
        pm.load_state_dict(build_pair(tiny_spec(), 16, seed=5)[2].state_dict())
        opt = TO.make_optimizer(pm.parameters(), lr=1e-2, num_warmup_steps=0,
                                lr_schedule_name="constant", accumulate_steps=2)
        state = TST.create_train_state(pm, opt)
        start = pm.mid_blocks[0].attn_out.weight.detach().clone()
        gen = torch.Generator().manual_seed(11)
        torch.manual_seed(99)
        before = torch.get_rng_state()
        state, m1 = step(state, batch, gen)
        assert torch.equal(torch.get_rng_state(), before)
        assert pm.training
        assert torch.equal(pm.mid_blocks[0].attn_out.weight, start)
        assert torch.equal(state.ema["mid_blocks.0.attn_out.weight"], start)
        state, m2 = step(state, batch, gen)
        assert not torch.equal(pm.mid_blocks[0].attn_out.weight, start)
        assert not torch.equal(state.ema["mid_blocks.0.attn_out.weight"], start)
        assert state.step == 2 and opt.micro_step == 2
        for m in (m1, m2):
            assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
        assert float(m1["loss"]) != float(m2["loss"])
        runs.append((float(m1["loss"]), float(m2["loss"]),
                     pm.mid_blocks[0].attn_out.weight.detach().clone()))
    assert runs[0][:2] == runs[1][:2] and torch.equal(runs[0][2], runs[1][2])
