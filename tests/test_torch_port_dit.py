"""The port's DiT family and axial U-ViT blocks against the JAX package.

The port's model gets seeded random weights (no layer left at its zero
initialization), and ``dfot_tpu/utils/torch_ckpt.py:import_dit3d_params`` maps
its ``state_dict()`` onto the flax tree: the port's parameter names are the
upstream checkpoint's. Both models then see the same seeded numpy inputs, in
fp32 on the CPU, where the port runs the plain versions of its kernels.

Tolerances: model outputs 1e-4 relative (L2): flax's LayerNorm takes the
variance as E[(x - mu)^2] on the CPU route and the port, like the TPU kernel,
as E[x^2] - mu^2, and blocks chain; the same bound against the JAX model on its
Pallas kernels in interpret mode. Gradients 2e-4 relative per parameter.
The train step and the window as ``tests/test_torch_port_train_step.py`` and
``tests/test_torch_port_sampling.py`` hold the U-ViT's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfot_tpu.diffusion import core as JDC
from dfot_tpu.guidance import history_guidance as JHG
from dfot_tpu.models import dit as JD
from dfot_tpu.models import embeddings as JE
from dfot_tpu.ops.ln_modulate import force_ln_interpret
from dfot_tpu.ops.qkv_prep import force_fused_interpret
from dfot_tpu.sampling import rollout as JR
from dfot_tpu.training import noise_levels as JNL
from dfot_tpu.training import optim as JO
from dfot_tpu.training import state as JST
from dfot_tpu.training import trainer as JT
from dfot_tpu.utils.torch_ckpt import import_dit3d_params, patchify_conv_w
from dfot_tpu_torch.algorithms import dfot_video as TV
from dfot_tpu_torch.diffusion import core as TDC
from dfot_tpu_torch.models import dit as TD
from dfot_tpu_torch.models import embeddings as TE
from dfot_tpu_torch.sampling import rollout as TR
from dfot_tpu_torch.utils.weights import dit3d_state_dict_from_flax, init_random_weights

from torch_port_helpers import POSE_DIM, build_pair, pinned, t, tiny_spec, one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


OUT_RTOL = 1e-4
GRAD_RTOL = 2e-4
STEP_RTOL, STEP_ATOL = 2e-3, 5e-2


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def spec_pair(**kw):
    base = dict(hidden_size=128, depth=2, num_heads=2, patch_size=2, max_temporal_length=4)
    base.update(kw)
    return TD.DiTSpec(**base), JD.DiTSpec(**base)


def randomized(model, seed=0):
    init_random_weights(model, torch.Generator().manual_seed(seed))
    return model.eval()


def flax_variables(model):
    """The port model's weights as the JAX model's variables."""
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    buffers = {k: state.pop(k) for k in list(state) if ".timesteps." in k}
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, import_dit3d_params(state))}
    if buffers:
        variables["buffers"] = {"noise_emb": {"fourier": {
            k.rsplit(".", 1)[1]: jnp.asarray(v) for k, v in buffers.items()}}}
    return variables


def dit_pair(seed=0, x_channels=3, resolution=(8, 8), model_kw=None, **spec_kw):
    tspec, jspec = spec_pair(**spec_kw)
    model_kw = model_kw or {}
    pm = randomized(TD.DiT3D(tspec, x_channels, resolution, **model_kw), seed)
    jm = JD.DiT3D(spec=jspec, x_channels=x_channels, resolution=resolution, **model_kw)
    return jm, flax_variables(pm), pm


def inputs(seed, B, T, resolution=(8, 8), channels=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, *resolution, channels)).astype(np.float32)
    k = rng.integers(0, 1000, (B, T)).astype(np.float32)
    return rng, x, k


# ---------------------------------------------------------------------------
# host tables, embeddings, blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim,shape", [(128, (20,)), (96, (4, 6)), (96, (3, 4, 5))])
def test_sincos_tables_equal(dim, shape):
    np.testing.assert_array_equal(TE.get_nd_sincos_pos_embed(dim, shape),
                                  JE.get_nd_sincos_pos_embed(dim, shape))


def _block_variables(block, prefix, path):
    state = {prefix + k: v.detach().numpy() for k, v in block.state_dict().items()}
    tree = import_dit3d_params(state)["dit"]
    for part in path:
        tree = tree[part]
    return {"params": jax.tree_util.tree_map(jnp.asarray, tree)}


@pytest.mark.parametrize("mlp_ratio,rope,causal,n", [
    (4.0, True, False, 64), (None, True, False, 64), (4.0, False, True, 64), (2.0, False, False, 8),
])
def test_dit_block_matches(mlp_ratio, rope, causal, n):
    """One block, with and without an MLP, RoPE and the causal mask; 64 tokens
    take the packed route's plain versions, 8 tokens the small-N one's."""
    dim, heads = 128, 2
    r = TE.make_rope_3d(dim // heads, (4, 4, 4)) if rope else None
    blk = randomized(TD.DiTBlock(dim, heads, mlp_ratio, TE.RopeTables(r) if rope else None, causal))
    jr = JE.make_rope_3d(dim // heads, (4, 4, 4)) if rope else None
    jblk = JD.DiTBlock(dim=dim, num_heads=heads, mlp_ratio=mlp_ratio, rope=jr, causal=causal)
    rng = np.random.default_rng(1)
    x, c = (rng.standard_normal((2, n, dim)).astype(np.float32) for _ in range(2))
    want = jblk.apply(_block_variables(blk, "dit_base.blocks.0.", ("block_0",)),
                      jnp.asarray(x), jnp.asarray(c))
    got = blk(t(x), t(c))
    assert rel_err(got.detach(), want) < OUT_RTOL
    # conditioning that broadcasts over the tokens takes the LayerNorm chain
    want_b = jblk.apply(_block_variables(blk, "dit_base.blocks.0.", ("block_0",)),
                        jnp.asarray(x), jnp.asarray(c[:, :1]))
    assert rel_err(blk(t(x), t(c[:, :1])).detach(), want_b) < OUT_RTOL


def test_final_layer_matches():
    layer = randomized(TD.FinalLayer(128, 12))
    rng = np.random.default_rng(2)
    x, c = (rng.standard_normal((2, 16, 128)).astype(np.float32) for _ in range(2))
    variables = _block_variables(layer, "dit_base.final_layer.", ("final_layer",))
    want = JD.FinalLayer(dim=128, out_dim=12).apply(variables, jnp.asarray(x), jnp.asarray(c))
    assert rel_err(layer(t(x), t(c)).detach(), want) < OUT_RTOL


# ---------------------------------------------------------------------------
# DiT3D, every variant and position embedding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(variant="full", pos_emb_type="rope_3d"),
    dict(variant="full", pos_emb_type="rope_3d", hidden_size=144, patch_size=1),  # d = 72
    dict(variant="full", pos_emb_type="rope_3d", spatial_mlp_ratio=4.0, causal=True),
    dict(variant="factorized_encoder", pos_emb_type="rope_2d"),
    dict(variant="full", pos_emb_type="learned_1d"),
    dict(variant="full", pos_emb_type="sinusoidal_1d", spatial_mlp_ratio=2.0),
    dict(variant="full", pos_emb_type="sinusoidal_3d", hidden_size=96),
    dict(variant="full", pos_emb_type="sinusoidal_factorized"),
    dict(variant="factorized_attention", pos_emb_type="sinusoidal_factorized",
         spatial_mlp_ratio=4.0),
    dict(variant="factorized_encoder", pos_emb_type="sinusoidal_2d"),
    dict(variant="factorized_encoder", pos_emb_type="learned_1d", causal=True),
], ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_dit3d_forward_matches(kw):
    jm, jv, pm = dit_pair(seed=3, **kw)
    _, x, k = inputs(3, 2, 4)
    want = jm.apply(jv, jnp.asarray(x), jnp.asarray(k))
    got = pm(t(x), t(k))
    assert got.shape == x.shape and got.dtype == torch.float32
    assert rel_err(got.detach(), want) < OUT_RTOL


def test_dit3d_forward_matches_the_pallas_route():
    """The JAX model on its Pallas kernels in interpret mode (fused
    LayerNorm + modulate, fused qkv preparation, flash attention, collect):
    256 tokens of 128 channels tile for all of them."""
    jm, jv, pm = dit_pair(seed=4, resolution=(16, 16), variant="full", pos_emb_type="rope_3d",
                          spatial_mlp_ratio=4.0)
    _, x, k = inputs(4, 1, 4, (16, 16))
    force_ln_interpret(True)
    force_fused_interpret(True)
    try:
        want = jm.apply(jv, jnp.asarray(x), jnp.asarray(k))
    finally:
        force_ln_interpret(False)
        force_fused_interpret(False)
    assert rel_err(pm(t(x), t(k)).detach(), want) < OUT_RTOL


@pytest.mark.parametrize("cond_type,dropout", [("label", 0.1), ("label", 0.0), ("action", 0.1)])
def test_dit3d_external_conditions_match(cond_type, dropout):
    model_kw = dict(external_cond_type=cond_type, external_cond_dim=5,
                    external_cond_num_classes=7, external_cond_dropout=dropout)
    jm, jv, pm = dit_pair(seed=5, model_kw=model_kw, use_gradient_checkpointing=True)
    rng, x, k = inputs(5, 2, 4)
    if cond_type == "label":
        cond = rng.integers(0, 7, (2,))
        mask = np.array([True, False])
    else:
        cond = rng.standard_normal((2, 4, 5)).astype(np.float32)
        mask = np.array([False, True])
    for m in (None, mask):
        want = jm.apply(jv, jnp.asarray(x), jnp.asarray(k), jnp.asarray(cond),
                        None if m is None else jnp.asarray(m))
        got = pm(t(x), t(k), t(cond), None if m is None else t(m))
        assert rel_err(got.detach(), want) < OUT_RTOL
    if dropout:
        masked = pm(t(x), t(k), t(cond), t(mask))
        assert not torch.allclose(masked, pm(t(x), t(k), t(cond)))


def test_dit3d_fourier_noise_embedding_matches():
    jm, jv, pm = dit_pair(seed=6, model_kw=dict(use_fourier_noise_emb=True))
    rng, x, _ = inputs(6, 2, 4)
    logsnr = rng.uniform(-2, 2, (2, 4)).astype(np.float32)
    assert "buffers" in jv
    want = jm.apply(jv, jnp.asarray(x), jnp.asarray(logsnr))
    assert rel_err(pm(t(x), t(logsnr)).detach(), want) < OUT_RTOL


def test_dit3d_joint_image_video_split():
    """Frames beyond max_temporal_length are single images: the same blocks
    run them as length-1 sequences."""
    jm, jv, pm = dit_pair(seed=7, variant="factorized_attention",
                          pos_emb_type="sinusoidal_factorized", spatial_mlp_ratio=4.0)
    _, x, k = inputs(7, 2, 6)
    want = jm.apply(jv, jnp.asarray(x), jnp.asarray(k))
    got = pm(t(x), t(k))
    assert got.shape == x.shape
    assert rel_err(got.detach(), want) < OUT_RTOL


@pytest.mark.parametrize("conditioning", ["concat", "film"])
def test_dit3d_pose_matches(conditioning):
    tspec, jspec = spec_pair()
    pm = randomized(TD.DiT3DPose(tspec, 3, (8, 8), POSE_DIM, conditioning), seed=8)
    jm = JD.DiT3DPose(spec=jspec, x_channels=3, resolution=(8, 8),
                      conditioning_type=conditioning, external_cond_dim=POSE_DIM)
    state = {k: v.detach().numpy() for k, v in pm.state_dict().items()}
    trunk = {k[len("trunk."):]: v for k, v in state.items() if k.startswith("trunk.")}
    params = {"trunk": import_dit3d_params(trunk)}
    if conditioning == "film":
        params["pose_embed"] = {"proj": {"kernel": patchify_conv_w(state["pose_embed.proj.weight"]),
                                         "bias": state["pose_embed.proj.bias"]}}
    assert len(trunk) + 2 * (conditioning == "film") == len(state)
    jv = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    rng, x, k = inputs(8, 2, 4)
    pose = rng.standard_normal((2, 4, 8, 8, POSE_DIM)).astype(np.float32)
    mask = np.array([True, False])
    for m in (None, mask):
        want = jm.apply(jv, jnp.asarray(x), jnp.asarray(k), jnp.asarray(pose),
                        None if m is None else jnp.asarray(m))
        got = pm(t(x), t(k), t(pose), None if m is None else t(m))
        assert got.shape == x.shape
        assert rel_err(got.detach(), want) < OUT_RTOL
    # the inverse map gives the port's state dict back, bit for bit
    back = dit3d_state_dict_from_flax(jax.device_get(jv["params"]), None, tspec.patch_size)
    assert set(back) == set(state)
    for name, value in back.items():
        np.testing.assert_array_equal(value.numpy(), state[name])


def test_unported_dit_variants_raise_by_name():
    # the matrix variants are ported (tests/test_torch_port_matrix.py)
    matrix = dict(embed_col_dim=16, embed_row_dim=384, num_col_heads=1, num_row_heads=6)
    for variant in ("full_matrix_attention", "factorized_matrix_attention"):
        TD.DiT3D(TD.DiTSpec(variant=variant, pos_emb_type="sinusoidal_2d", **matrix), 3, (8, 8))
    with pytest.raises(ValueError, match="unknown DiT variant"):
        TD.DiT3D(TD.DiTSpec(variant="no_such_variant", pos_emb_type="sinusoidal_2d"), 3, (8, 8))
    # the difference-DiT's double RoPE is ported: the JAX package's doubled
    # table (tests/test_torch_port_difference.py holds the model)
    for merge in ("concat", "interleaved"):
        pm = TD.DiT3D(TD.DiTSpec(double_rope_merge=merge), 3, (8, 8))
        want = JE.make_rope_3d(64, (16, 4, 4), double_merge=merge)
        np.testing.assert_array_equal(pm.dit_base.blocks[0].attn.rope._np[0],
                                      np.asarray(want.cos, np.float32))
    with pytest.raises(ValueError, match="double-rope merge"):
        TD.DiT3D(TD.DiTSpec(double_rope_merge="stacked"), 3, (8, 8))
    with pytest.raises(ValueError):
        TD.DiT3D(TD.DiTSpec(variant="factorized_attention", pos_emb_type="rope_3d"), 3, (8, 8))
    # the selective remat policies are ported (tests/test_torch_port_remat.py)
    for policy in ("dots", "attn", "dots_attn"):
        TD.DiT3D(TD.DiTSpec(use_gradient_checkpointing=True, remat_policy=policy), 3, (8, 8))
    with pytest.raises(ValueError, match="unknown remat_policy"):
        TD.DiT3D(TD.DiTSpec(use_gradient_checkpointing=True, remat_policy="all"), 3, (8, 8))


def test_random_weights_leave_no_gate_closed():
    """The JAX package zero-initializes every modulation and the output
    projection: a model left so ignores its blocks. The seeded law does not."""
    pm = TD.DiT3D(TD.DiTSpec(hidden_size=64, depth=1, num_heads=1), 3, (8, 8))
    zeros = [n for n, p in pm.named_parameters() if not p.any()]
    assert any("modulation" in n for n in zeros) and any("final_layer.linear" in n for n in zeros)
    randomized(pm)
    assert all(p.any() for p in pm.parameters())


# ---------------------------------------------------------------------------
# the axial U-ViT block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("resolution", [64])
def test_axial_uvit_forward_matches(resolution):
    """UViT3DPose with AxialTransformerBlock on both transformer levels:
    spatial attention over each frame's tokens with the 2D table (at 64 px
    level 2 has 64 tokens a frame and takes the packed route, level 3 has 16
    and takes the small-N one), temporal attention over 8 frames with the 1D
    table (the small-N route)."""
    spec = tiny_spec(block_types=("ResBlock", "ResBlock", "AxialTransformerBlock",
                                  "AxialTransformerBlock"))
    jm, jv, pm = build_pair(spec, resolution, seed=9)
    assert any(n.endswith("another_attn.out.weight") for n, _ in pm.named_parameters())
    rng = np.random.default_rng(9)
    R, T = resolution, 8
    x = rng.standard_normal((1, T, R, R, 3)).astype(np.float32)
    k = rng.uniform(-2, 2, (1, T)).astype(np.float32)
    pose = rng.standard_normal((1, T, R, R, POSE_DIM)).astype(np.float32)
    want = jm.apply(jv, jnp.asarray(x), jnp.asarray(k), jnp.asarray(pose), None)
    got = pm(t(x), t(k), t(pose))
    assert rel_err(got.detach(), want) < 1e-4
    from dfot_tpu_torch.models.uvit import precompute_pose_conditioning

    # axial levels keep their pooled pose maps (tests/test_torch_port_remainders.py)
    assert set(precompute_pose_conditioning(pm, t(pose))["levels"]) == {"2", "3"}


# ---------------------------------------------------------------------------
# the slice as a whole: gradients, train steps, a window, the recipe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(variant="full", pos_emb_type="rope_3d", use_gradient_checkpointing=True),
    dict(variant="factorized_attention", pos_emb_type="sinusoidal_factorized",
         spatial_mlp_ratio=4.0, depth=1),
], ids=["full", "factorized_attention"])
def test_dit3d_gradients_match_jax(kw):
    jm, jv, pm = dit_pair(seed=10, **kw)
    rng, x, k = inputs(10, 2, 4)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(params):
        return jnp.mean(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(k)) * jnp.asarray(g))

    want_loss, want = jax.value_and_grad(jloss)(jv["params"])
    want = dit3d_state_dict_from_flax(jax.device_get(want), None, pm.spec.patch_size)
    pm.train()
    loss = (pm(t(x), t(k)) * t(g)).mean()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5, abs=1e-8)
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert set(got) == set(want)
    bad = {n: e for n in want if (e := rel_err(got[n].numpy(), want[n].numpy())) > GRAD_RTOL}
    assert not bad, bad


def tiny_recipe():
    r = TV.k600_dit_xl()
    spec = dataclasses.replace(r.spec, hidden_size=128, depth=2, num_heads=2)
    return r._replace(spec=spec, resolution=(4, 4), x_channels=4)


def jax_dcfg(dcfg):
    return JDC.DiffusionConfig(**dataclasses.asdict(dcfg))


def test_two_train_steps_match_jax():
    """Two steps of the recipe's train step (checkpointed blocks, fused
    min-SNR weighting, AdamW, clipping, EMA) on a tiny DiT: loss, gradient
    norm, updated parameters and EMA, with the level and noise draws of the
    JAX step injected."""
    r = tiny_recipe()
    pm = randomized(TV.build_model(r, device="cpu"), seed=11)
    jv = flax_variables(pm)
    jm = JD.DiT3D(spec=JD.DiTSpec(**dataclasses.asdict(r.spec)), x_channels=r.x_channels,
                  resolution=r.resolution)
    B, T = 2, r.max_tokens
    lr, decay = 1e-3, 0.9
    r = r._replace(train=r.train._replace(lr=lr, num_warmup_steps=2, ema_decay=decay,
                                          precision="fp32"))
    nl = dataclasses.asdict(r.train.noise_levels)
    rng = np.random.default_rng(11)
    batch = {"xs": rng.standard_normal((B, T, 4, 4, r.x_channels)).astype(np.float32),
             "masks": np.ones((B, T), bool)}
    batch["masks"][1, 3:] = False

    def j_apply(params, x, noise_levels, cond, cond_mask, rngs=None, train=False):
        return jm.apply({"params": params}, x, noise_levels, train=train, rngs=rngs)

    jdcfg = jax_dcfg(r.dcfg)
    j_step = JT.make_train_step(j_apply, jdcfg, JDC.make_schedule(jdcfg),
                                JNL.NoiseLevelConfig(**nl), ema_decay=decay)
    j_state = JST.create_train_state(jv["params"], JO.make_optimizer(
        lr=lr, weight_decay=r.train.weight_decay, betas=r.train.optimizer_beta,
        grad_clip=r.train.grad_clip, lr_schedule_name=r.train.lr_scheduler, num_warmup_steps=2))
    t_state = TV.make_train_state(r, pm, device="cpu")
    t_step = TV.make_train_step(r, device="cpu")
    t_batch = {k: t(v) for k, v in batch.items()}
    start = {n: q.detach().clone() for n, q in pm.named_parameters()}

    for step in range(2):
        key = jax.random.PRNGKey(200 + step)
        r_k, r_noise, _ = jax.random.split(key, 3)
        levels = np.asarray(JNL._rand_levels(jax.random.split(r_k, 4)[0], (B, T),
                                             JNL.NoiseLevelConfig(**nl)))
        noise = np.asarray(JDC.clipped_normal(r_noise, batch["xs"].shape, r.dcfg.clip_noise))
        j_state, want = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        t_state, got = t_step(t_state, t_batch, None, noise_levels=t(levels), noise=t(noise))
        assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-4)
        assert float(got["grad_norm"]) == pytest.approx(float(want["grad_norm"]), rel=2e-4)
        want_p = dit3d_state_dict_from_flax(jax.device_get(j_state.params), None, 1)
        want_e = dit3d_state_dict_from_flax(jax.device_get(j_state.ema_params), None, 1)
        for name, q in pm.named_parameters():
            for what, got_t, want_t in (("param", q.detach(), want_p[name]),
                                        ("ema", t_state.ema[name], want_e[name])):
                diff = (got_t - want_t).abs()
                update = (want_t - start[name]).norm()
                assert float(diff.max()) <= STEP_ATOL * lr, f"{what} {name} step {step}"
                assert float(diff.norm()) <= STEP_RTOL * float(update) + 1e-6 * float(
                    want_t.norm()), f"{what} {name} step {step}"
    assert t_state.step == 2 and t_state.optimizer.lr == pytest.approx(lr)
    assert max(float((q.detach() - start[n]).abs().max()) for n, q in pm.named_parameters()) > 0


def test_dit_window_matches_jax(monkeypatch):
    """One 5-frame window of the K600 recipe at a tiny size: 2 context
    frames, conditional sampling, 3 DDIM steps, pinned noise."""
    shape_noise = lambda shape, dtype: pinned(tuple(shape))
    monkeypatch.setattr(JDC, "clipped_normal",
                        lambda rng, shape, clip, dtype=jnp.float32: jnp.asarray(
                            shape_noise(shape, dtype), dtype))
    monkeypatch.setattr(TDC, "clipped_normal",
                        lambda shape, clip, generator=None, device=None, dtype=torch.float32:
                        torch.as_tensor(shape_noise(shape, dtype), dtype=dtype, device=device))
    r = tiny_recipe()
    dcfg = dataclasses.replace(r.dcfg, sampling_timesteps=3)
    pm = randomized(TV.build_model(r, device="cpu"), seed=12)
    jv = flax_variables(pm)
    jm = JD.DiT3D(spec=JD.DiTSpec(**dataclasses.asdict(r.spec)), x_channels=r.x_channels,
                  resolution=r.resolution)
    B, T = 2, r.max_tokens
    x_shape = (*r.resolution, r.x_channels)
    ctx = np.random.default_rng(12).standard_normal((B, T, *x_shape)).astype(np.float32)
    mask = np.zeros((B, T), np.int64)
    mask[:, : r.n_context_tokens] = 1
    jro = JR.DFoTRollout(JR.RolloutConfig(max_tokens=T, x_shape=x_shape), jax_dcfg(dcfg),
                         JDC.make_schedule(jax_dcfg(dcfg)),
                         lambda v, x, n, c, m: jm.apply(v, x, n, c, m))
    want = jro.sample_sequence(jv, jax.random.PRNGKey(0), B, length=T, context=jnp.asarray(ctx),
                               context_mask=mask,
                               history_guidance=JHG.HistoryGuidance.conditional())
    tro = TR.DFoTRollout(TR.RolloutConfig(max_tokens=T, x_shape=x_shape), dcfg,
                         TDC.make_schedule(dcfg, device="cpu"), pm)
    got = tro.sample_sequence(None, B, length=T, context=ctx, context_mask=mask,
                              history_guidance=r.history_guidance)
    assert got.shape == (B, T, *x_shape) and torch.isfinite(got).all()
    np.testing.assert_array_equal(got[:, :2].numpy(), ctx[:, :2])  # context kept
    assert rel_err(got, want) < 1e-4
    assert tro.stats == jro.stats == {"denoiser_evals_b1": 3 * B, "windows": 1}


def test_k600_recipe_matches_config_composition():
    from dfot_tpu.algorithms.dfot_video import build_algorithm
    from dfot_tpu.config import load_config

    cfg = load_config(["+name=k600", "dataset=kinetics_600", "algorithm=dfot_video",
                       "experiment=video_generation", "@DiT/XL"])
    algo = build_algorithm(cfg)
    r = TV.k600_dit_xl()
    a, e = cfg.algorithm, cfg.experiment
    want, got = dataclasses.asdict(algo.model.spec), dataclasses.asdict(r.spec)
    assert {k: want[k] for k in got} == got
    # the two specs have the same fields: the recipe leaves the matrix
    # variants' at their defaults
    assert want.keys() == got.keys()
    assert algo.dcfg == jax_dcfg(r.dcfg)
    assert algo.x_shape == (*r.resolution, r.x_channels)
    assert (algo.max_tokens, algo.n_context_tokens) == (r.max_tokens, r.n_context_tokens)
    assert dataclasses.asdict(algo.nl_cfg) == dataclasses.asdict(r.train.noise_levels)
    hg = JHG.HistoryGuidance.from_config(a.tasks.prediction.history_guidance,
                                         timesteps=a.diffusion.timesteps)
    assert dataclasses.astuple(hg) == dataclasses.astuple(r.history_guidance)
    assert (a.get("external_cond_type"), a.get("external_cond_dim") or 0) == (
        r.external_cond_type, r.external_cond_dim)
    assert a.backbone.get("use_fourier_noise_embedding", False) is r.use_fourier_noise_emb
    tr = r.train
    assert (tr.lr, tr.weight_decay, list(tr.optimizer_beta)) == (
        a.lr, a.weight_decay, list(a.optimizer_beta))
    assert (tr.lr_scheduler, tr.num_warmup_steps) == (a.lr_scheduler.name,
                                                      a.lr_scheduler.num_warmup_steps)
    assert tr.num_training_steps == a.lr_scheduler.get("num_training_steps")
    assert tr.grad_clip == e.training.optim.gradient_clip_val
    assert tr.accumulate_steps == e.training.optim.accumulate_grad_batches
    assert tr.ema_decay == e.ema.decay and e.ema.enable
    assert (tr.precision, tr.batch_size) == (e.training.precision, e.training.batch_size)
    # the full-width model: 28 blocks without an MLP, heads of 72
    assert r.spec.hidden_size // r.spec.num_heads == 72 and r.spec.spatial_mlp_ratio is None
