"""UNet3D, FAR-DiT and DiT1D (``dfot_tpu_torch/models/{unet3d,far,dit1d}.py``)
against the JAX package's (``dfot_tpu/models/{unet3d,far,dit1d}.py``).

- The weights: seeded random flax trees (``test_torch_port_vae.randomize``)
  carried to the port by ``utils/weights.py:{unet3d,far,dit1d}_state_dict_from_flax``
  and loaded strictly; the JAX importers (``import_unet3d_params``,
  ``import_far_params``, ``import_dit1d_params``) map ``port.state_dict()``
  back to the same tree bit for bit.
- Forward and every gradient leaf in fp32 on the CPU, each within
  ``RTOL`` = 1e-5 relative (L2) of the JAX model and ``jax.grad``: UNet3D
  causal and not, per-frame GroupNorm on and off, linear attention on and
  off, with and without action conditions and the Fourier noise embedding
  (three models); FAR-DiT with a
  non-zero ALiBi slope and labels; DiT1D in both merge modes with the sincos
  table or RoPE, with and without q/k LayerNorm. The port's spatial attention
  runs the plain versions of B1, B4 and B5 here (heads of 8 padded to 64).
- The remat policies of FAR-DiT and DiT1D keep what JAX keeps: the same
  residuals by element count, the same loss and gradients as ``none``.
- ``@UNet3D/L`` raises the same ValueError on both sides: 12 GroupNorm
  groups do not divide its 64 channels (ROADMAP.md C10).

Which cases reach upstream (ROADMAP.md C3): the JAX UNet3D is held to the
upstream torch module in ``tests/test_reference_parity.py:
test_unet3d_forward_parity``, whose causal case passes and whose non-causal
case fails (ROADMAP.md C3). The non-causal cases here are held to the JAX
package alone; the causal ones reach upstream through it.
"""

import collections
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfot_tpu.models import dit1d as JD1
from dfot_tpu.models import far as JF
from dfot_tpu.models import unet3d as JU
from dfot_tpu.utils.torch_ckpt import import_dit1d_params, import_far_params, import_unet3d_params
from dfot_tpu_torch.models import dit1d as TD1
from dfot_tpu_torch.models import far as TF
from dfot_tpu_torch.models import remat as TR
from dfot_tpu_torch.models import unet3d as TU
from dfot_tpu_torch.utils.weights import (
    dit1d_state_dict_from_flax,
    far_state_dict_from_flax,
    unet3d_state_dict_from_flax,
)

from test_torch_port_vae import randomize

RTOL = 1e-5
B, T = 2, 4

UNET = dict(network_size=16, num_res_blocks=2, resnet_block_groups=4, dim_mults=(1, 2),
            attn_resolutions=(8, 16), attn_dim_head=8, attn_heads=2, use_linear_attn=True,
            max_temporal_length=T)
# each model compiles its own jax.grad (about 7 s on the CPU): the options
# are spread over three models, each on in one and off in another
UNET_CASES = {
    "causal_linear_actions": ({}, {"external_cond_type": "action", "external_cond_dim": 3}),
    "non_causal_frame_local_fourier": ({"frame_local_norm": True},
                                       {"use_causal_mask": False, "use_fourier_noise_emb": True}),
    "non_causal_softmax_only": ({"use_linear_attn": False}, {"use_causal_mask": False}),
}
FAR = dict(hidden_size=64, depth=2, num_heads=2, patch_size=2, axes_dims_rope=(8, 12, 12),
           slope_scale=0.3, max_temporal_length=T)
DIT1D_CASES = {
    "share_norm_sincos": dict(merge_mode="share_norm"),
    "share_norm_rope_qk_norm": dict(merge_mode="share_norm", use_rotary_emb=True, qk_norm=True),
    "reproduce_sincos_qk_norm": dict(merge_mode="reproduce", qk_norm=True),
    "reproduce_rope": dict(merge_mode="reproduce", use_rotary_emb=True),
}


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


class Pair:
    """A JAX model on a seeded random tree, the port's on the same weights,
    inputs, and ``model_kw``'s conditions."""

    def __init__(self, jm, variables, pm, args, to_state):
        self.jm, self.variables, self.pm, self.args = jm, variables, pm, args
        self.to_state = to_state  # a flax params tree -> the port's names

    def jax_loss(self, g, with_output=True):
        def loss(params):
            out = self.jm.apply({**self.variables, "params": params},
                                *(None if a is None else jnp.asarray(a) for a in self.args))
            value = jnp.mean(out * jnp.asarray(g))
            return (value, out) if with_output else value
        return loss

    def port_loss(self, g):
        self.pm.zero_grad(set_to_none=True)
        loss = (self.pm(*(None if a is None else t(a) for a in self.args)) * t(g)).mean()
        loss.backward()
        return float(loss.detach()), {n: p.grad.clone() for n, p in self.pm.named_parameters()
                             if p.grad is not None}


def seeded_tree(init, seed):
    """``randomize`` over the shapes of ``init()``'s variables, traced, not
    run (eager flax init of a UNet3D takes tens of seconds on the CPU)."""
    shapes = jax.eval_shape(init)
    return {k: randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), v),
                         seed + i)
            for i, (k, v) in enumerate(sorted(shapes.items()))}


def _inputs(seed, shape, cond=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T) + shape).astype(np.float32)
    k = rng.uniform(0, 999, (B, T)).astype(np.float32)
    return rng, x, k, cond


def unet3d_pair(spec_kw=None, model_kw=None, seed=0, res=16):
    spec_kw, model_kw = {**UNET, **(spec_kw or {})}, dict(model_kw or {})
    model_kw.setdefault("use_causal_mask", True)
    rng, x, k, _ = _inputs(seed, (res, res, 3))
    cond = (rng.standard_normal((B, T, model_kw["external_cond_dim"])).astype(np.float32)
            if model_kw.get("external_cond_dim") else None)
    jm = JU.UNet3D(spec=JU.UNet3DSpec(**spec_kw), x_channels=3, resolution=res, **model_kw)
    v = seeded_tree(lambda: jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(k),
                                    None if cond is None else jnp.asarray(cond)), seed + 1)
    params, buffers = v["params"], v.get("buffers")
    pm = TU.UNet3D(TU.UNet3DSpec(**spec_kw), 3, res, **model_kw).eval()
    n = len(spec_kw["dim_mults"])
    to_state = functools.partial(unet3d_state_dict_from_flax, buffers=None, num_levels=n,
                                 num_res_blocks=spec_kw["num_res_blocks"])
    pm.load_state_dict(unet3d_state_dict_from_flax(params, buffers, n, spec_kw["num_res_blocks"]),
                       strict=True)
    variables = {"params": params, **({"buffers": buffers} if buffers else {})}
    return Pair(jm, variables, pm, (x, k, cond), to_state)


def far_pair(seed=0, res=8, **spec_kw):
    spec_kw = {**FAR, **spec_kw}
    rng, x, k, _ = _inputs(seed, (res, res, 3))
    labels = rng.integers(0, 5, (B,))
    kw = dict(external_cond_type="label", external_cond_num_classes=5, external_cond_dropout=0.1)
    jm = JF.FARDiT(spec=JF.FARSpec(**spec_kw), x_channels=3, resolution=(res, res), **kw)
    params = seeded_tree(lambda: jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(k),
                                         jnp.asarray(labels)), seed + 1)["params"]
    pm = TF.FARDiT(TF.FARSpec(**spec_kw), 3, (res, res), **kw).eval()
    pm.load_state_dict(far_state_dict_from_flax(params), strict=True)
    return Pair(jm, {"params": params}, pm, (x, k, labels), far_state_dict_from_flax)


def dit1d_pair(seed=0, n=8, channels=4, **spec_kw):
    spec_kw = {"hidden_size": 64, "depth": 2, "num_heads": 2, "max_temporal_length": T,
               **spec_kw}
    _, x, k, _ = _inputs(seed, (1, n, channels))
    jm = JD1.DiT1D(spec=JD1.DiT1DSpec(**spec_kw), x_channels=channels, n_tokens=n)
    params = seeded_tree(lambda: jm.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                                         jnp.asarray(k)), seed + 1)["params"]
    pm = TD1.DiT1D(TD1.DiT1DSpec(**spec_kw), channels, n).eval()
    pm.load_state_dict(dit1d_state_dict_from_flax(params), strict=True)
    return Pair(jm, {"params": params}, pm, (x, k), dit1d_state_dict_from_flax)


def check_pair(pair: Pair, seed: int):
    """Forward, loss and every gradient leaf against JAX within RTOL (the
    JAX side's forward and ``jax.grad`` in one jitted call: eager, its
    backward compiles op by op, five times slower for a UNet3D)."""
    out = pair.pm(*(None if a is None else t(a) for a in pair.args))
    shape = out.shape
    g = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    loss_of = pair.jax_loss(g)
    (value, want), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        pair.variables["params"])
    assert out.shape == want.shape and out.dtype == torch.float32
    assert rel_err(out.detach(), want) < RTOL
    loss, got = pair.port_loss(g)
    # the loss, a mean of terms of both signs, against the mean of their sizes
    assert abs(loss - float(value)) <= RTOL * float(np.mean(np.abs(np.asarray(want) * g)))
    want_grads = pair.to_state(jax.device_get(grads))
    assert set(got) == set(want_grads)
    # a bias of the keys shifts every score of a row alike where no RoPE
    # follows it: its gradient is zero but for rounding, held against the
    # whole gradient's norm
    scale = np.linalg.norm(np.concatenate([np.ravel(v) for v in want_grads.values()]))

    def err(n):
        if n.endswith("k_norm.bias") and not getattr(pair.pm.spec, "use_rotary_emb", True):
            return float(np.linalg.norm(got[n].numpy() - want_grads[n].numpy()) / scale)
        return rel_err(got[n], want_grads[n])

    off = {n: e for n in got if (e := err(n)) > RTOL}
    assert not off, off


def _round_trip(params, state, importer):
    back = flax.traverse_util.flatten_dict(importer({k: v.numpy() for k, v in state.items()}))
    want = flax.traverse_util.flatten_dict(jax.device_get(params))
    assert set(back) == set(want)
    for key in want:
        np.testing.assert_array_equal(back[key], np.asarray(want[key]), err_msg=str(key))


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(UNET_CASES))
def test_unet3d_matches_jax(case):
    spec_kw, model_kw = UNET_CASES[case]
    pair = unet3d_pair(spec_kw, model_kw, seed=3)
    check_pair(pair, 4)
    state = {k: v for k, v in pair.pm.state_dict().items() if "timesteps" not in k}
    _round_trip(pair.variables["params"], state,
                lambda s: import_unet3d_params(s, 2, len(UNET["dim_mults"])))


def test_unet3d_layout_and_controls():
    """Upstream's indices (levels without attention keep theirs), and two
    controls that miss: attention scaled for heads padded to 64 (1/8 in
    place of 1/sqrt(8)) and a GroupNorm over each frame alone."""
    pair = unet3d_pair({"attn_resolutions": (16,)}, {"use_causal_mask": False}, seed=5)
    names = set(pair.pm.state_dict())
    assert "down_blocks.1.0.2.wrapper.module.attn.to_qkv.weight" not in names
    assert "up_blocks.0.4.conv.weight" in names and "down_blocks.0.1.conv.weight" in names
    assert not any(n.startswith(("up_blocks.1.4", "down_blocks.1.1")) for n in names)
    want = pair.jm.apply(pair.variables, *(jnp.asarray(a) for a in pair.args[:2]))
    x, k = t(pair.args[0]), t(pair.args[1])
    from dfot_tpu_torch.ops import attention as TA

    real = TA.attention_reference

    def wide_scale(q, kk, v, causal=False, sm_scale=None, return_lse=False):
        return real(q, kk, v, causal, 1.0 / q.shape[-1] ** 0.5, return_lse)

    TA.attention_reference = wide_scale
    try:
        assert rel_err(pair.pm(x, k).detach(), want) > 100 * RTOL
    finally:
        TA.attention_reference = real
    for m in pair.pm.modules():
        if isinstance(m, TU.VideoGroupNorm):
            m.frame_local = True
    assert rel_err(pair.pm(x, k).detach(), want) > 100 * RTOL


def test_far_matches_jax():
    pair = far_pair(seed=6)
    check_pair(pair, 7)
    _round_trip(pair.variables["params"], pair.pm.state_dict(), import_far_params)
    with pytest.raises(ValueError, match="axes_dims_rope"):
        TF.FARDiT(TF.FARSpec(**{**FAR, "axes_dims_rope": (8, 8, 8)}), 3, (8, 8))
    # control: no frame-causal bias
    pm, (x, k, labels) = pair.pm, pair.args
    want = pair.jm.apply(pair.variables, jnp.asarray(x), jnp.asarray(k), jnp.asarray(labels))
    pm.causal_bias = lambda T_, P, device: torch.zeros(())
    assert rel_err(pm(t(x), t(k), t(labels)).detach(), want) > 100 * RTOL


@pytest.mark.parametrize("case", sorted(DIT1D_CASES))
def test_dit1d_matches_jax(case):
    pair = dit1d_pair(seed=8, **DIT1D_CASES[case])
    check_pair(pair, 9)
    _round_trip(pair.variables["params"], pair.pm.state_dict(), import_dit1d_params)


def test_dit1d_raises_like_jax():
    with pytest.raises(NotImplementedError, match="learn_sigma"):
        TD1.DiT1D(TD1.DiT1DSpec(learn_sigma=True), 4, 8)
    with pytest.raises(NotImplementedError, match="merge_mode"):
        TD1.DiT1D(TD1.DiT1DSpec(hidden_size=64, depth=1, num_heads=2, merge_mode="other"), 4, 8)


# ---------------------------------------------------------------------------
# remat policies on the einsum-attention models
# ---------------------------------------------------------------------------


def _with_policy(pair: Pair, policy):
    import dataclasses

    spec = dataclasses.replace(pair.pm.spec, use_gradient_checkpointing=True,
                               remat_policy=policy)
    pair.pm.spec = spec
    pair.jm = pair.jm.clone(spec=dataclasses.replace(
        pair.jm.spec, use_gradient_checkpointing=True, remat_policy=policy))
    return pair


@pytest.mark.parametrize("model", ["far", "dit1d"])
@pytest.mark.parametrize("policy", ["dots", "attn", "dots_attn"])
def test_remat_policies_keep_what_jax_keeps(model, policy, monkeypatch):
    """The outputs a policy keeps in one forward against the dense outputs
    and ``attn_out`` tensors the JAX jaxpr keeps beyond ``none``, by element
    count; the loss and every gradient leaf equal to ``none``'s within RTOL."""
    from test_torch_port_remat import _jax_saved, _out_numel

    make = (lambda: far_pair(seed=10)) if model == "far" else (
        lambda: dit1d_pair(seed=10, use_rotary_emb=True))
    pairs = {p: _with_policy(make(), p) for p in (None, policy)}
    g = np.random.default_rng(11).standard_normal(
        pairs[None].args[0].shape).astype(np.float32)
    want = (_jax_saved(pairs[policy].jax_loss(g, False), pairs[policy].variables["params"])
            - _jax_saved(pairs[None].jax_loss(g, False), pairs[None].variables["params"]))
    saved = collections.Counter()
    real_fn = TR.remat_policy

    def wrapped(name):
        fn = real_fn(name)

        def policy_fn(ctx, op, *args, **kwargs):
            decision = fn(ctx, op, *args, **kwargs)
            if not ctx.is_recompute and decision == TR.CheckpointPolicy.MUST_SAVE:
                saved[_out_numel(op, args)] += 1
            return decision

        return policy_fn

    none_loss, none_grads = pairs[None].port_loss(g)
    monkeypatch.setattr(TR, "remat_policy", wrapped)
    loss, grads = pairs[policy].port_loss(g)
    assert want and saved == want, (saved, want)
    assert loss == pytest.approx(none_loss, rel=RTOL)
    assert max(rel_err(grads[n], none_grads[n]) for n in none_grads) < RTOL


# ---------------------------------------------------------------------------
# @UNet3D/L (ROADMAP.md C10)
# ---------------------------------------------------------------------------


def test_unet3d_l_preset_raises_on_both_sides():
    """``configurations/shortcut/UNet3D/L.yaml`` sets 12 GroupNorm groups
    on 64 channels: the JAX model raises when it is traced, the port's when
    it is built, both a ValueError naming the two numbers."""
    from dfot_tpu.algorithms import build_algorithm as jax_build
    from dfot_tpu.config import load_config as jax_load_config
    from dfot_tpu_torch.algorithms.dfot_video import build_algorithm
    from dfot_tpu_torch.config import load_config

    argv = ["+name=ucf", "dataset=ucf_101", "algorithm=dfot_video", "experiment=video_generation",
            "@UNet3D/L", "++dataset.latent.enabled=false"]
    cfg, jcfg = load_config(argv), jax_load_config(argv)
    assert cfg.algorithm.backbone.resnet_block_groups == 12
    assert cfg.algorithm.backbone.network_size == 64
    with pytest.raises(ValueError, match=r"groups \(12\) does not divide the number of channels "
                                         r"\(64\)"):
        jax.eval_shape(jax_build(jcfg, compute_dtype=jnp.float32).init_params,
                       jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match=r"groups \(12\) does not divide the number of channels "
                                         r"\(64\)"):
        build_algorithm(cfg, torch.float32, device="meta")


# ---------------------------------------------------------------------------
# python -m dfot_tpu_torch on the new backbones
# ---------------------------------------------------------------------------

CLI_CASES = {
    "u_net3d": ["algorithm/backbone=u_net3d", "++algorithm.backbone.network_size=16",
                "++algorithm.backbone.dim_mults=[1,2]", "++algorithm.backbone.attn_heads=2",
                "++algorithm.backbone.attn_dim_head=8", "++algorithm.backbone.attn_resolutions=[16]"],
    "far_dit": ["algorithm/backbone=far_dit", "++algorithm.backbone.hidden_size=64",
                "++algorithm.backbone.depth=1", "++algorithm.backbone.num_heads=2",
                "++algorithm.backbone.axes_dims_rope=[8,12,12]",
                "dataset.external_cond_type=null", "dataset.external_cond_dim=0"],
    "difference_concat": ["algorithm=difference_dfot_video", "dataset.context_length=0",
                          "++algorithm.backbone.hidden_size=64", "++algorithm.backbone.depth=1",
                          "++algorithm.backbone.num_heads=2"],
    "difference_factorized_matrix": [
        "algorithm=difference_dfot_video",
        "algorithm/backbone=difference_dit3d_factorized_matrix",
        "++algorithm.backbone.hidden_size=32", "++algorithm.backbone.embed_row_dim=32",
        "++algorithm.backbone.num_heads=2", "++algorithm.backbone.num_row_heads=2",
        "++algorithm.backbone.depth=1"],
}


@pytest.fixture(scope="module")
def dmlab_dir(tmp_path_factory):
    from test_torch_port_latent_cli import make_dmlab

    root = str(tmp_path_factory.mktemp("backbones") / "dmlab")
    make_dmlab(root)
    return root


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_trains_and_validates(tmp_path, dmlab_dir, case):
    """``run(argv)`` with ``experiment.tasks=[training,validation]`` at 32 px
    on a seeded DMLab-layout directory: two steps, finite losses, a
    checkpoint, finite validation metrics (the difference DFoT's
    ``prediction_diff`` task among them). DiT1D takes (C, 1, N) tokens, which
    no pixel dataset makes; its train step and window run in
    ``test_dit1d_algorithm_step_and_window``."""
    from dfot_tpu_torch.__main__ import run
    from test_torch_port_train_cli import _lines

    argv = ["+name=bb", "dataset=dmlab", "algorithm=dfot_video", "experiment=video_generation",
            f"dataset.save_dir={dmlab_dir}", "++dataset.latent.enabled=false",
            "dataset.resolution=32", "dataset.max_frames=4", "dataset.context_length=1",
            "algorithm.diffusion.sampling_timesteps=2", "experiment.tasks=[training,validation]",
            "experiment.training.batch_size=2", "experiment.training.max_steps=2",
            "experiment.training.data.num_workers=0", "++algorithm.logging.loss_freq=1",
            "experiment.validation.batch_size=1", "experiment.validation.limit_batch=1",
            "experiment.validation.data.num_workers=0", "++algorithm.logging.max_num_videos=0",
            # the composed list's frozen networks and its 2048-wide matrix
            # square root would add about 15 s a case; the composed list runs
            # in test_torch_port_cli.py
            "++algorithm.logging.metrics=[mse,psnr]", "wandb.mode=disabled",
            f"output_dir={tmp_path}"] + CLI_CASES[case]
    exp = run(argv, device="cpu")
    lines = _lines(tmp_path)
    losses = [x["loss"] for x in lines if "loss" in x]
    assert len(losses) == 2 and np.isfinite(losses).all()
    if case.startswith("difference"):
        assert all(np.isfinite([x["diff_loss"], x["xs_loss"]]).all() for x in lines if "loss" in x)
    metrics = {k: v for x in lines for k, v in x.items() if "/" in k}
    assert metrics and np.isfinite(list(metrics.values())).all()
    assert any("prediction_diff" in k for k in metrics) == case.startswith("difference")
    assert exp.state.step == 2


def test_dit1d_algorithm_step_and_window():
    """DiT1D through ``build_algorithm`` on taichi's (4, 1, 32) tokens at a
    reduced width: one train step and one sampling window, finite. The
    composed taichi recipe gives the algorithm (32, 32, 4) latents (its
    ``latent.shape`` is read by neither package: ROADMAP.md C11), so the
    tokens' shape is set as the observation shape."""
    from dfot_tpu_torch.algorithms.dfot_video import build_algorithm
    from dfot_tpu_torch.config import load_config

    argv = ["+name=taichi", "dataset=taichi", "algorithm=dfot_video",
            "experiment=video_generation", "algorithm/backbone=dit1d",
            "++dataset.latent.enabled=false", "dataset.observation_shape=[4,1,32]",
            "dataset.max_frames=4",
            "++algorithm.backbone.hidden_size=64", "++algorithm.backbone.depth=1",
            "++algorithm.backbone.num_heads=2", "algorithm.diffusion.sampling_timesteps=2"]
    algo = build_algorithm(load_config(argv), torch.float32, device="cpu")
    assert algo.x_shape == (1, 32, 4) and type(algo.model).__name__ == "DiT1D"
    xs = torch.randn(2, algo.max_tokens, 1, 32, 4, generator=torch.Generator().manual_seed(0))
    state = algo.make_train_state()
    _, metrics = algo.make_train_step()(state, {"xs": xs, "masks": torch.ones(2, algo.max_tokens,
                                                                            dtype=torch.bool)},
                                        torch.Generator().manual_seed(1))
    assert np.isfinite(float(metrics["loss"]))
    out = algo.sample_videos(torch.Generator().manual_seed(2), xs, n_context_tokens=1)
    assert out["prediction"].shape == xs.shape and torch.isfinite(out["prediction"]).all()


@pytest.mark.parametrize("case", ["u_net3d", "far_dit", "dit1d"])
def test_upstream_checkpoints_load_strictly(tmp_path, case):
    """An upstream ``.ckpt`` of each new backbone loads through the CLI's
    surgery strictly: the port's names, with the entries upstream holds and
    the port makes itself (UNet3D's temporal RoPE buffer, DiT1D's sincos
    table, FAR-DiT's unused noise-level embedding) dropped, as the JAX
    importers drop them; any other unknown key raises."""
    import types

    from dfot_tpu_torch.algorithms.dfot_video import build_algorithm
    from dfot_tpu_torch.config import load_config
    from dfot_tpu_torch.experiments import video_generation as TVG
    from dfot_tpu_torch.utils.weights import init_random_weights

    argv = {
        "u_net3d": CLI_CASES["u_net3d"],
        "far_dit": CLI_CASES["far_dit"][:-2],
        "dit1d": ["algorithm/backbone=dit1d", "++algorithm.backbone.hidden_size=64",
                  "++algorithm.backbone.depth=1", "++algorithm.backbone.num_heads=2"],
    }[case]
    cfg = load_config(["+name=ucf", "dataset=ucf_101", "algorithm=dfot_video",
                       "experiment=video_generation", "++dataset.latent.enabled=false",
                       "dataset.resolution=16", "dataset.max_frames=4"] + argv)
    source, target = (build_algorithm(cfg, torch.float32, device="cpu") for _ in range(2))
    init_random_weights(source.model, torch.Generator().manual_seed(40))
    extra = {"u_net3d": "rotary_time_pos_embedding.freqs", "dit1d": "pos_embed",
             "far_dit": "noise_level_pos_embedding.embedding.linear_1.weight"}[case]
    state = {"diffusion_model.model." + k: v for k, v in source.model.state_dict().items()}
    state["diffusion_model.model." + extra] = torch.ones(3)
    path = tmp_path / "model.ckpt"
    torch.save({"state_dict": state}, path)
    exp = types.SimpleNamespace(cfg=cfg, algo=target)
    TVG.VideoGenerationExperiment._import_torch_checkpoint(exp, str(path))
    for k, v in source.model.state_dict().items():
        assert torch.equal(target.model.state_dict()[k], v), k
    state["diffusion_model.model.unknown.weight"] = torch.ones(3)
    torch.save({"state_dict": state}, path)
    with pytest.raises(RuntimeError, match="unknown.weight"):
        TVG.VideoGenerationExperiment._import_torch_checkpoint(exp, str(path))
