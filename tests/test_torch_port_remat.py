"""Selective rematerialization (``dfot_tpu_torch/models/remat.py``) against the
JAX package's ``jax.checkpoint`` policies (``dfot_tpu/models/remat.py``).

- A tiny UViT3DPose (both transformer levels checkpointed, 512 and 128
  tokens at 64 px) and a tiny DiT3D (every block checkpointed, 256 tokens of
  128 channels) under ``none``, ``dots``, ``attn`` and ``dots_attn``: the loss
  and every gradient leaf against ``jax.grad`` of the JAX model on its Pallas
  kernels in interpret mode, and against the port's own ``none``.
- What each policy runs again: per kernel, the port's calls in one forward
  and backward (its plain versions, counted where each kernel's wrapper
  calls them on the CPU) against the ``pallas_call`` equations of the JAX
  jaxpr of ``jax.grad`` (sub-jaxprs included), mapped to the kernels by
  their source line. A control policy that also keeps the flash op's
  outputs misses.
- ``torch.library.opcheck`` on each of the four custom ops.

fp32 on the CPU. Tolerances: the loss 1e-5 relative; every gradient leaf
1e-5 relative (L2), against ``jax.grad`` and against the port's ``none``.
"""

import collections
import dataclasses
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

from dfot_tpu.ops.ln_modulate import force_ln_interpret
from dfot_tpu.ops.qkv_prep import force_fused_interpret
from dfot_tpu_torch.models import remat as TR
from dfot_tpu_torch.ops import attention as TA
from dfot_tpu_torch.ops import ln_modulate as TL
from dfot_tpu_torch.ops import qkv_prep as TQ
from dfot_tpu_torch.utils.weights import uvit3d_state_dict_from_flax

from test_torch_port_dit import dit_pair, inputs as dit_inputs
from torch_port_helpers import POSE_DIM, build_pair, one_thread, t, tiny_spec

POLICIES = ("none", "dots", "attn", "dots_attn")
LOSS_RTOL = 1e-5
SELF_RTOL = 1e-5
JAX_RTOL = 1e-5

# the JAX package's Pallas kernels by source line -> the port's kernel names
JAX_KERNELS = {
    "qkv_prep.py:115": "qkv_prep", "attention.py:114": "flash_fwd",
    "attention.py:183": "flash_fwd", "qkv_prep.py:528": "attn_out_collect",
    "attention.py:378": "flash_bwd_dq", "attention.py:423": "flash_bwd_dq",
    "attention.py:500": "flash_bwd_dkv", "qkv_prep.py:147": "qkv_prep_bwd",
    "qkv_prep.py:534": "attn_out_scatter", "ln_modulate.py:64": "ln_modulate",
    "ln_modulate.py:72": "ln_modulate_bwd",
}
# the port's plain version of each kernel, where its wrapper calls it on the CPU
PLAIN = {
    "qkv_prep": (TQ, "_prep_plain"), "flash_fwd": (TA, "attention_reference"),
    "attn_out_collect": (TQ, "reference_attn_out_collect"),
    "flash_bwd_dq": (TA, "_dq_plain"), "flash_bwd_dkv": (TA, "_dkv_plain"),
    "qkv_prep_bwd": (TQ, "_prep_bwd_plain"), "attn_out_scatter": (TQ, "reference_attn_out_scatter"),
    "ln_modulate": (TL, "reference_ln_modulate"),
    "ln_modulate_bwd": (TL, "reference_ln_modulate_bwd"),
}


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def jax_kernel_counts(closed_jaxpr) -> dict:
    counts = collections.Counter()

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                src = eqn.params["jaxpr"].debug_info.func_src_info
                counts[JAX_KERNELS[os.path.basename(src.rsplit(" ", 1)[-1])]] += 1
            for p in eqn.params.values():
                for sub in p if isinstance(p, (list, tuple)) else (p,):
                    if isinstance(sub, jcore.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jcore.Jaxpr):
                        walk(sub)

    walk(closed_jaxpr.jaxpr)
    return dict(counts)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture
def port_counts(monkeypatch):
    """Counts the calls of each kernel's plain version."""
    counts = collections.Counter()
    for name, (module, attr) in PLAIN.items():
        def counted(*args, _fn=getattr(module, attr), _name=name, **kwargs):
            counts[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(module, attr, counted)
    return counts


@pytest.fixture
def pallas_interpret():
    force_fused_interpret(True)
    force_ln_interpret(True)
    yield
    force_fused_interpret(False)
    force_ln_interpret(False)


# ---------------------------------------------------------------------------
# the two models
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _uvit():
    # two channels a GroupNorm group (64-channel levels), as in
    # tests/test_torch_port_base.py: with one, a conv bias before a norm has
    # a gradient of zero and rounding alone
    spec = tiny_spec(channels=(64, 64, 64, 64), use_checkpointing=(False, False, True, True))
    jm, jv, pm = build_pair(spec, 64, seed=11)
    rng = np.random.default_rng(12)
    x, g = (rng.standard_normal((1, 8, 64, 64, 3)).astype(np.float32) for _ in range(2))
    k = rng.uniform(-2, 2, (1, 8)).astype(np.float32)
    pose = rng.standard_normal((1, 8, 64, 64, POSE_DIM)).astype(np.float32)
    return spec, jm, jv, pm, (x, k, pose), g


def _uvit_jax(policy):
    spec, jm, jv, _, (x, k, pose), g = _uvit()
    jm = jm.clone(spec=dataclasses.replace(jm.spec, remat_policy=policy))

    def loss(params):
        out = jm.apply({"params": params, "buffers": jv["buffers"]}, jnp.asarray(x),
                       jnp.asarray(k), jnp.asarray(pose), None, train=True,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.mean(out * jnp.asarray(g))

    return loss, jv["params"]


def _uvit_port(policy):
    spec, _, _, pm, (x, k, pose), g = _uvit()
    pm.spec = dataclasses.replace(pm.spec, remat_policy=policy)
    pm.train()
    pm.zero_grad(set_to_none=True)
    loss = (pm(t(x), t(k), t(pose)) * t(g)).mean()
    loss.backward()
    return float(loss), {n: p.grad.clone() for n, p in pm.named_parameters()}


def _uvit_jax_grads(loss, params):
    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    spec = _uvit()[0]
    return float(value), uvit3d_state_dict_from_flax(jax.device_get(grads), None, spec, 3,
                                                     POSE_DIM, cotangent=True)


@functools.lru_cache(maxsize=1)
def _dit():
    jm, jv, pm = dit_pair(seed=13, resolution=(16, 16), variant="full", pos_emb_type="rope_3d",
                          spatial_mlp_ratio=4.0, use_gradient_checkpointing=True)
    rng, x, k = dit_inputs(14, 1, 4, (16, 16))
    g = rng.standard_normal(x.shape).astype(np.float32)
    return jm, jv, pm, (x, k), g


def _dit_jax(policy):
    jm, jv, _, (x, k), g = _dit()
    jm = jm.clone(spec=dataclasses.replace(jm.spec, remat_policy=policy))

    def loss(params):
        return jnp.mean(jm.apply({**jv, "params": params}, jnp.asarray(x), jnp.asarray(k))
                        * jnp.asarray(g))

    return loss, jv["params"]


def _dit_port(policy):
    _, _, pm, (x, k), g = _dit()
    pm.dit_base.spec = dataclasses.replace(pm.dit_base.spec, remat_policy=policy)
    pm.train()
    pm.zero_grad(set_to_none=True)
    loss = (pm(t(x), t(k)) * t(g)).mean()
    loss.backward()
    return float(loss), {n: p.grad.clone() for n, p in pm.named_parameters()}


def _dit_jax_grads(loss, params):
    from dfot_tpu_torch.utils.weights import dit3d_state_dict_from_flax

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), dit3d_state_dict_from_flax(jax.device_get(grads), None, 2)


MODELS = {"uvit": (_uvit_jax, _uvit_port, _uvit_jax_grads),
          "dit": (_dit_jax, _dit_port, _dit_jax_grads)}


# what the cases share, computed once a module (each under ``pallas_interpret``)
@functools.lru_cache(maxsize=None)
def port_none(model):
    """The port's loss and gradients under ``none``."""
    return MODELS[model][1]("none")


@functools.lru_cache(maxsize=None)
def jax_kernel_counts_of(model, policy):
    """Kernel counts of the JAX jaxpr of ``jax.grad`` under ``policy``."""
    loss, params = MODELS[model][0](policy)
    return jax_kernel_counts(jax.make_jaxpr(jax.grad(loss))(params))


@functools.lru_cache(maxsize=None)
def jax_saved_of(model, policy):
    return _jax_saved(*MODELS[model][0](policy))


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("policy", POLICIES)
def test_gradients_match_jax_and_none(model, policy, pallas_interpret):
    jax_fn, port_fn, jax_grads = MODELS[model]
    want_loss, want = jax_grads(*jax_fn(None if policy == "none" else policy))
    none_loss, none = port_none(model)
    loss, got = port_fn(policy)
    assert loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert loss == pytest.approx(none_loss, rel=LOSS_RTOL)
    assert set(got) == set(want) == set(none)
    off_jax = {n: e for n in got if (e := rel_err(got[n], want[n])) > JAX_RTOL}
    off_none = {n: e for n in got if (e := rel_err(got[n], none[n])) > SELF_RTOL}
    assert not off_jax, off_jax
    assert not off_none, off_none


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("policy", POLICIES)
def test_recomputed_kernels_match_the_jax_jaxpr(model, policy, pallas_interpret, port_counts):
    want = jax_kernel_counts_of(model, None if policy == "none" else policy)
    MODELS[model][1](policy)
    assert dict(port_counts) == want


def _jax_saved(loss, params):
    """Element counts of what the JAX jaxpr keeps: dense outputs (flax's
    ``Dense``) and tensors named ``attn_out``."""
    import contextlib
    import io

    from jax.ad_checkpoint import print_saved_residuals

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        print_saved_residuals(loss, params)
    out = collections.Counter()
    for line in buf.getvalue().splitlines():
        if "linear.py" in line and "Dense" in line or "attn_out" in line:
            dims = line.split("[", 1)[1].split("]", 1)[0]
            out[int(np.prod([int(d) for d in dims.split(",")]))] += 1
    return out


def _out_numel(op, args) -> int:
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default):
        a, b = args[-2:]
        return a.shape[0] * b.shape[1]
    if op == torch.ops.dfot.attn_out_collect.default:
        o, head_dim = args[:2]
        return o.shape[0] * o.shape[1] * o.shape[2] * head_dim
    if op == aten.bmm.default:  # an einsum attention's a @ v
        a, b = args[:2]
        return a.shape[0] * a.shape[1] * b.shape[2]
    return args[0].numel()  # small-N attention: o is q's shape


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("policy", ["dots", "attn", "dots_attn"])
def test_saved_outputs_match_the_jax_residuals(model, policy, pallas_interpret, monkeypatch):
    """What each policy keeps: the outputs the port's policy saves in one
    forward against the dense outputs and ``attn_out`` tensors the JAX jaxpr
    keeps beyond what ``none`` keeps, by element count (the port's linears
    flatten (B, N, C) to 2-D): the same outputs, no more. JAX keeps only the
    residuals its backward reads; the U-ViT's ``attn_out`` and ``mlp_out``
    outputs, added to the residual stream and read by no VJP, run under
    ``remat.not_a_residual`` in the port, which keeps them neither (the
    DiT's pass through a gate, whose VJP reads them, and both keep them)."""
    port_fn = MODELS[model][1]
    want = jax_saved_of(model, policy) - jax_saved_of(model, None)
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

    monkeypatch.setattr(TR, "remat_policy", wrapped)
    port_fn(policy)
    assert not want - saved, (saved, want)
    assert saved - want == collections.Counter(), (saved, want)


def test_jax_runs_the_flash_forward_again_under_attn(pallas_interpret):
    """ROADMAP.md C6: under ``attn`` the JAX jaxpr keeps the collect's output
    but still runs the prep and flash kernels again for their residuals; only
    the collect is not run again."""
    counts = {p: jax_kernel_counts_of("uvit", p) for p in (None, "attn")}
    blocks = counts[None]["attn_out_collect"] // 2
    assert blocks == 3
    assert counts["attn"]["qkv_prep"] == counts[None]["qkv_prep"] == 2 * blocks
    assert counts["attn"]["flash_fwd"] == counts[None]["flash_fwd"] == 2 * blocks
    assert counts["attn"]["attn_out_collect"] == blocks


def test_control_policy_that_keeps_the_flash_op_misses(pallas_interpret, port_counts, monkeypatch):
    """A policy that also keeps ``dfot::flash_attention``'s outputs skips the
    flash kernel's second run: a saving the JAX package does not have."""
    want = jax_kernel_counts_of("uvit", "attn")
    monkeypatch.setattr(TR, "_attn_out_ops", lambda: frozenset(
        {torch.ops.dfot.attn_out_collect.default, torch.ops.dfot.flash_attention.default}))
    _uvit_port("attn")
    assert port_counts["flash_fwd"] == want["flash_fwd"] - 3
    assert dict(port_counts) != want


def test_policy_names():
    assert TR.remat_policy(None) is None and TR.remat_policy("none") is None
    for name in ("dots", "attn", "dots_attn"):
        assert callable(TR.remat_policy(name))
    assert TR.saved_ops("dots_attn") == TR.saved_ops("dots") | TR.saved_ops("attn")
    with pytest.raises(ValueError):
        TR.remat("everything")
    from dfot_tpu_torch.models.uvit import UViT3DPose

    with pytest.raises(ValueError):
        UViT3DPose(tiny_spec(use_checkpointing=(False, False, True, True), remat_policy="bogus"),
                   3, 16, POSE_DIM)


def _opcheck_cases():
    rng = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=rng)  # noqa: E731
    B, N, H, D, DP = 2, 64, 2, 32, 64
    qkv = r(B, N, 3 * H * D).requires_grad_()
    tabs = [r(N, D) for _ in range(4)]
    tabs[1].requires_grad_()
    q, k, v = (r(B, H, N, DP).requires_grad_() for _ in range(3))
    qs, ks, vs = (r(B, H, 8, DP).requires_grad_() for _ in range(3))
    return {
        "qkv_prep": (torch.ops.dfot.qkv_prep.default, (qkv, *tabs, H, D, DP, True, 1e-6, False)),
        "flash_attention": (torch.ops.dfot.flash_attention.default,
                            (q, k, v, True, 1 / math.sqrt(D), D, False)),
        "attn_out_collect": (torch.ops.dfot.attn_out_collect.default, (q, D, False)),
        "small_n_attention": (torch.ops.dfot.small_n_attention.default, (qs, ks, vs, False)),
    }


@pytest.mark.parametrize("name", ["qkv_prep", "flash_attention", "attn_out_collect",
                                  "small_n_attention"])
def test_opcheck(name):
    op, args = _opcheck_cases()[name]
    result = torch.library.opcheck(op, args)
    assert all(v == "SUCCESS" for v in result.values()), result


def _cli_run(out, name):
    from dfot_tpu_torch.__main__ import run

    from test_torch_port_train_cli import TRAIN, _step_metrics

    argv = TRAIN + ["++algorithm.backbone.use_checkpointing=[false,true]",
                    "experiment.training.max_steps=2"]
    exp = run(argv + [f"++algorithm.backbone.remat_policy={name}", f"output_dir={out}"],
              device="cpu")
    assert exp.algo.model.spec.remat_policy == name
    return _step_metrics(out)


@pytest.fixture(scope="module")
def cli_none(tmp_path_factory):
    """The CLI's step metrics under ``none``, one run for every policy's case."""
    return _cli_run(tmp_path_factory.mktemp("remat_cli") / "none", "none")


@pytest.mark.parametrize("policy", ["dots", "dots_attn"])
def test_cli_trains_under_a_policy(tmp_path, policy, cli_none):
    """``python -m dfot_tpu_torch`` takes the policy from the backbone config
    (its level 1 checkpointed): the same draws, the same losses as ``none``
    within 1e-5 relative."""
    runs = {"none": cli_none, policy: _cli_run(tmp_path / policy, policy)}
    assert sorted(runs["none"]) == sorted(runs[policy]) == [1, 2]
    for step, (loss, grad_norm) in runs["none"].items():
        assert runs[policy][step][0] == pytest.approx(loss, rel=LOSS_RTOL)
        assert runs[policy][step][1] == pytest.approx(grad_norm, rel=LOSS_RTOL)
