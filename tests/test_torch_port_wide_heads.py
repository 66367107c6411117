"""Heads wider than 256 lanes in the port, on the CPU, against the JAX package.

The JAX package gives every head dim that is a multiple of 64 after padding
to its Pallas kernels (``_blocks_ok``, ``_padded_flash``); the port takes
them on the wide family of B1, B4 and B5 (``csrc/flash_wide.cu``) and on B2
and B6 past their old 256 cap. On the CPU every wrapper runs its kernel's
plain version, held here against the JAX package's Pallas kernels in
interpret mode on the same seeded fp32 inputs:

- attention at (1, 2, 256, d) for d = 384 and 512 and heads of 288 padded
  to 320, causal and not: O and the LSE within 2e-5 (sums over 256 keys in
  another order), dq, dk, dv against ``jax.vjp`` within 1e-5 relative L2;
- ``qkv_prep`` and its VJP at 2 heads of 288 (padded to 320) and of 512,
  with the norm on and off: 1e-5 absolute (elementwise), the gradients
  within 1e-5 relative L2;
- a tiny DiT3D (hidden 576, 2 heads of 288, depth 2) forward and every
  gradient leaf against the JAX model on its fused Pallas route, through
  ``import_dit3d_params``: 1e-4 and 2e-4 relative (the DiT tests' bounds);
  its weights and a tiny UViT3DPose's with a head of 512 at level 3
  carried between the packages bit for bit, the U-ViT's forward within
  1e-4 relative of the JAX model's, reference and fused routes;
- short rows above 256 lanes (B10's wide entry on the card): a tiny axial
  U-ViT with one head of 320 at level 3 and a tiny factorized DiT with one
  head of 384, weights both ways, forward and every gradient leaf within
  1e-4 relative (``tests/test_torch_port_base.py``'s bounds);
- the wide plans at every multiple of 64 from 320 to 1280 (and B6's up to
  1152), the two consumers of a wide B1, B4 or B5 block owning every output
  lane and every score step once, the grid rule of B4's and B5's slice
  widths, and the dispatcher computing every shape on the CPU, the short-row
  ones too.

The CUDA kernels themselves are tested on the card by
``tests/test_torch_port_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfot_tpu.models import dit as JD
from dfot_tpu.ops import attention as JA
from dfot_tpu.ops import qkv_prep as JQ
from dfot_tpu.utils.torch_ckpt import import_dit3d_params, import_uvit3d_params
from dfot_tpu_torch.models import dit as TD
from dfot_tpu_torch.ops import attention as TA
from dfot_tpu_torch.ops import qkv_prep as TQ
from dfot_tpu_torch.utils.weights import (
    dit3d_state_dict_from_flax,
    init_random_weights,
    uvit3d_state_dict_from_flax,
)
from torch_port_helpers import POSE_DIM, build_pair, one_thread, tiny_spec

OUT_ATOL = 2e-5     # attention O and LSE
GRAD_RTOL = 1e-5    # attention and qkv_prep gradients, relative L2
PREP_ATOL = 1e-5    # qkv_prep, elementwise
MODEL_RTOL, MODEL_GRAD_RTOL = 1e-4, 2e-4
UVIT_RTOL = 1e-4    # tests/test_torch_port_base.py's: outputs and every gradient leaf
WIDE = tuple(range(320, 1281, 64))
WIDE_PLAN_ROWS = (64, 192, 1280, 2048, 8192)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [384, 512, 288])
def test_wide_attention_matches_jax(d, causal):
    """O, the LSE and dq, dk, dv of the port's plain attention at heads of
    384 and 512 (``flash_attention``) and of 288 (``attention``'s
    ``"padded_flash"``, 288 of 320 lanes) against the JAX package's Pallas
    flash attention in interpret mode (``_flash_forward`` for the LSE,
    ``jax.vjp`` of ``flash_attention`` / ``_padded_flash`` for the
    gradients)."""
    rng = np.random.default_rng(40 + d)
    B, H, N = 1, 2, 256
    q, k, v, do = (rng.standard_normal((B, H, N, d)).astype(np.float32) for _ in range(4))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    dp = TA.padded_head_dim(d)
    assert dp == d + (-d % 64) and TA.attention_route(N, d, causal) == (
        "flash" if d == dp else "padded_flash")
    if d == dp:
        jfn = lambda a, b, c: JA.flash_attention(a, b, c, causal, 128, 128, True)  # noqa: E731
        want_o, want_lse = JA._flash_forward(jq, jk, jv, causal, 128, 128, True, return_lse=True)
        got_o, got_lse = TA.flash_attention(_t(q), _t(k), _t(v), causal, return_lse=True)
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=OUT_ATOL)
    else:
        jfn = lambda a, b, c: JA._padded_flash(a, b, c, causal, True)  # noqa: E731
        got_o = TA.attention(_t(q), _t(k), _t(v), causal)
        want_o = jfn(jq, jk, jv)
    assert got_o.shape == (B, H, N, d)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=OUT_ATOL)

    _, vjp = jax.vjp(jfn, jq, jk, jv)
    want = vjp(jnp.asarray(do))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    out = TA.attention(*leaves, causal)
    got = torch.autograd.grad(out, leaves, _t(do))
    for name, g, w in zip("qkv", got, want):
        assert rel_err(g.numpy(), w) < GRAD_RTOL, name


@pytest.mark.parametrize("shape", [(1, 2, 512, 320), (2, 2, 16, 320)])
def test_cpu_attention_computes_every_shape(shape):
    """The repair: on the CPU ``attention`` computes what the JAX package
    computes, long rows at a head dim of 320 (``"flash"``, the wide family's
    plain version) and short rows above 256 (``"small_n"``: the plain
    version of B10, whose wide entry takes them on the card), as the JAX
    package's ``attention`` (XLA on the CPU) within 2e-5."""
    rng = np.random.default_rng(50)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    want = JA.attention(*(jnp.asarray(a) for a in (q, k, v)))
    got = TA.attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_ATOL)
    route = TA.attention_route(shape[2], shape[3])
    assert route == ("flash" if shape[2] > 32 else "small_n")


# ---------------------------------------------------------------------------
# qkv_prep (B2) and its VJP (B6)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("d", [288, 512])
def test_wide_qkv_prep_and_vjp_match_jax(d, norm):
    """B2's plain version at 2 heads of 288 (padded to 320, the padding both
    packages now share) and of 512, with the per-head norm over the whole
    row and learned scales, against ``JQ.qkv_prep(interpret=True)``; its
    VJP (B6's plain version: dqkv and, through the folded tables, the
    scales' gradients) against ``jax.vjp``."""
    rng = np.random.default_rng(60 + d)
    B, N, H = 1, 128, 2
    dp = TA.padded_head_dim(d)
    qkv = rng.standard_normal((B, N, 3 * H * d)).astype(np.float32)
    ang = rng.standard_normal((N, d // 2))
    cos, sin = (np.repeat(f(ang), 2, axis=1).astype(np.float32) for f in (np.cos, np.sin))
    ss = JQ.signed_sin(sin)
    qs, ks = (1 + 0.1 * rng.standard_normal(d).astype(np.float32) for _ in range(2))
    gs = [rng.standard_normal((B, H, N, dp)).astype(np.float32) for _ in range(3)]
    for g in gs:
        g[..., d:] = 0

    def jfn(x, a, b):
        return JQ.qkv_prep(x, H, d, jnp.asarray(cos), jnp.asarray(ss), q_scale=a, k_scale=b,
                           norm=norm, d_out=dp, interpret=True)

    want, vjp = jax.vjp(jfn, jnp.asarray(qkv), jnp.asarray(qs), jnp.asarray(ks))
    want_g = vjp(tuple(jnp.asarray(g) for g in gs))
    leaves = [_t(a).requires_grad_() for a in (qkv, qs, ks)]
    got = TQ.qkv_prep(leaves[0], H, d, _t(cos), _t(ss), q_scale=leaves[1], k_scale=leaves[2],
                      norm=norm, d_out=dp)
    for g, w in zip(got, want):
        assert g.shape == (B, H, N, dp) and not g[..., d:].any()
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=PREP_ATOL)
    got_g = torch.autograd.grad(got, leaves, [_t(g) for g in gs])
    for name, g, w in zip(("qkv", "q_scale", "k_scale"), got_g, want_g):
        assert rel_err(g.numpy(), w) < GRAD_RTOL, name


# ---------------------------------------------------------------------------
# a DiT3D with heads of 288
# ---------------------------------------------------------------------------


def test_tiny_dit3d_with_heads_of_288_matches_jax():
    """DiT3D at hidden 576 with 2 heads of 288 and depth 2 (256 tokens: 4
    frames of 8 x 8 patches), seeded random weights carried to the JAX
    model by ``import_dit3d_params(port.state_dict())``: the port takes the
    packed route (``attention_route`` answers ``"padded_flash"``, B2 pads to
    320) and the JAX model its fused Pallas route in interpret mode
    (``force_fused_interpret``); the forward and every gradient leaf."""
    kw = dict(hidden_size=576, depth=2, num_heads=2, patch_size=2, max_temporal_length=4,
              variant="full", pos_emb_type="rope_3d")
    pm = TD.DiT3D(TD.DiTSpec(**kw), 3, (16, 16))
    init_random_weights(pm, torch.Generator().manual_seed(70))
    jm = JD.DiT3D(spec=JD.DiTSpec(**kw), x_channels=3, resolution=(16, 16))
    state = {n: p.detach().numpy() for n, p in pm.state_dict().items()}
    flax = import_dit3d_params(state)
    back = dit3d_state_dict_from_flax(flax, None, pm.spec.patch_size)
    assert set(back) == set(state)
    for n, v in back.items():
        np.testing.assert_array_equal(v.numpy(), state[n], err_msg=n)
    params = jax.tree_util.tree_map(jnp.asarray, flax)
    assert TA.attention_route(256, 288) == "padded_flash"
    rng = np.random.default_rng(71)
    x = rng.standard_normal((1, 4, 16, 16, 3)).astype(np.float32)
    k = rng.integers(0, 1000, (1, 4)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(k))
        return jnp.mean(out * jnp.asarray(g)), out

    JQ.force_fused_interpret(True)
    try:
        assert JQ.fused_qkv_eligible(256, 288, 2)
        (want_loss, want_out), want = jax.value_and_grad(jloss, has_aux=True)(params)
    finally:
        JQ.force_fused_interpret(False)
    want = dit3d_state_dict_from_flax(jax.device_get(want), None, pm.spec.patch_size)
    pm.train()
    out = pm(_t(x), _t(k))
    assert rel_err(out.detach().numpy(), want_out) < MODEL_RTOL
    loss = (out * _t(g)).mean()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5, abs=1e-8)
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert set(got) == set(want)
    bad = {n: e for n in want if (e := rel_err(got[n].numpy(), want[n].numpy())) > MODEL_GRAD_RTOL}
    assert not bad, bad


def test_tiny_uvit_with_a_head_of_512_matches_jax():
    """UViT3DPose whose level 3 has one head of 512 lanes (64 px: 128 tokens,
    the wide family's route): the JAX parameters carried into the port by
    ``uvit3d_state_dict_from_flax`` and back by ``import_uvit3d_params`` bit
    for bit, and the forward against the JAX model on its reference
    attention and on its fused Pallas route (interpret mode)."""
    spec = tiny_spec(channels=(64, 64, 64, 512), num_heads=1)
    jm, jv, pm = build_pair(spec, 64, seed=72)
    assert dict(pm.named_parameters())["mid_blocks.0.q_norm.weight"].shape == (512,)
    assert TA.attention_route(4 * 4 * 8, 512) == "flash"
    params = jax.device_get(jv["params"])
    back = import_uvit3d_params(
        {n: v.numpy() for n, v in uvit3d_state_dict_from_flax(params, None, spec, 3,
                                                              POSE_DIM).items()},
        spec.num_updown_blocks, len(spec.channels), spec.patch_size)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, a in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(np.asarray(flat[path]), np.asarray(a), err_msg=str(path))
    rng = np.random.default_rng(73)
    x = rng.standard_normal((1, 8, 64, 64, 3)).astype(np.float32)
    k = rng.uniform(-2, 2, (1, 8)).astype(np.float32)
    pose = rng.standard_normal((1, 8, 64, 64, POSE_DIM)).astype(np.float32)
    with torch.no_grad():
        got = pm(_t(x), _t(k), _t(pose))
    for fused in (False, True):
        JQ.force_fused_interpret(fused)
        try:
            want = jax.jit(jm.apply)(jv, jnp.asarray(x), jnp.asarray(k), jnp.asarray(pose), None)
        finally:
            JQ.force_fused_interpret(False)
        assert rel_err(got.numpy(), want) < MODEL_RTOL, fused


# ---------------------------------------------------------------------------
# short rows above 256 lanes: B10's wide entry on two models
# ---------------------------------------------------------------------------


def _model_errors(apply, params, to_state, pm, run, g):
    """The port's output (``run()``, training mode, dropouts 0), its loss
    (the output times ``g``, meaned) and every gradient leaf against
    ``jax.value_and_grad`` of the same loss of ``apply(params)``, the leaves
    mapped by ``to_state``: the loss within 1e-5; returns the output's and
    each leaf's relative L2 error."""
    def jloss(p):
        out = apply(p)
        return jnp.mean(out * jnp.asarray(g)), out

    (want_loss, want_out), want = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    want = to_state(jax.device_get(want))
    pm.train()
    out = run()
    loss = (out * _t(g)).mean()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5, abs=1e-8)
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert set(got) == set(want) and all(v is not None for v in got.values())
    return rel_err(out.detach().numpy(), want_out), {
        n: rel_err(got[n].numpy(), want[n].numpy()) for n in want}


def test_tiny_axial_uvit_with_a_head_of_320_matches_jax():
    """The axial U-ViT whose level 3 has one head of 320 (32 px: 4 tokens a
    frame, 8 frames), so that its spatial rows (4, 320) and its temporal
    rows (8, 320) both take the small-N route, B10's wide entry on the card:
    the weights across and back bit for bit, the forward and every gradient
    leaf against the JAX model (its plain attention on the CPU), at
    ``tests/test_torch_port_base.py``'s tolerances (1e-4 relative)."""
    spec = tiny_spec(channels=(64, 64, 64, 320), num_heads=1, block_types=(
        "ResBlock", "ResBlock", "AxialTransformerBlock", "AxialTransformerBlock"))
    jm, jv, pm = build_pair(spec, 32, seed=74)
    assert TA.attention_route(4, 320) == TA.attention_route(8, 320) == "small_n"
    params = jax.device_get(jv["params"])
    back = import_uvit3d_params(
        {n: v.numpy() for n, v in uvit3d_state_dict_from_flax(params, None, spec, 3,
                                                              POSE_DIM).items()},
        spec.num_updown_blocks, len(spec.channels), spec.patch_size)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, a in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(np.asarray(flat[path]), np.asarray(a), err_msg=str(path))
    rng = np.random.default_rng(75)
    x, g = (rng.standard_normal((1, 8, 32, 32, 3)).astype(np.float32) for _ in range(2))
    k = rng.uniform(-2, 2, (1, 8)).astype(np.float32)
    pose = rng.standard_normal((1, 8, 32, 32, POSE_DIM)).astype(np.float32)
    out_err, errs = _model_errors(
        lambda p: jm.apply({"params": p, "buffers": jv["buffers"]}, jnp.asarray(x),
                           jnp.asarray(k), jnp.asarray(pose), None, train=True,
                           rngs={"dropout": jax.random.PRNGKey(0)}),
        jv["params"],
        lambda tree: uvit3d_state_dict_from_flax(tree, None, spec, 3, POSE_DIM, cotangent=True),
        pm, lambda: pm(_t(x), _t(k), _t(pose)), g)
    assert out_err < UVIT_RTOL
    assert len([n for n in errs if "another_attn.q_norm" in n]) == 3
    bad = {n: e for n, e in errs.items() if e > UVIT_RTOL}
    assert not bad, bad


def test_tiny_factorized_dit_with_one_head_of_384_matches_jax():
    """The factorized-attention DiT at its config's hidden 384 with one head
    (depth 2, 8 frames of 4 x 4 patches): spatial rows (16, 384) and
    temporal rows (8, 384), both B10's wide entry on the card; the weights
    across by ``import_dit3d_params`` and back by
    ``dit3d_state_dict_from_flax`` bit for bit, the forward and every
    gradient leaf against the JAX model (1e-4 relative)."""
    kw = dict(hidden_size=384, depth=2, num_heads=1, patch_size=2, max_temporal_length=8,
              variant="factorized_attention", pos_emb_type="sinusoidal_factorized",
              spatial_mlp_ratio=4.0)
    pm = TD.DiT3D(TD.DiTSpec(**kw), 3, (8, 8))
    init_random_weights(pm, torch.Generator().manual_seed(76))
    jm = JD.DiT3D(spec=JD.DiTSpec(**kw), x_channels=3, resolution=(8, 8))
    state = {n: p.detach().numpy() for n, p in pm.state_dict().items()}
    flax = import_dit3d_params(state)
    back = dit3d_state_dict_from_flax(flax, None, pm.spec.patch_size)
    assert set(back) == set(state)
    for n, v in back.items():
        np.testing.assert_array_equal(v.numpy(), state[n], err_msg=n)
    params = jax.tree_util.tree_map(jnp.asarray, flax)
    assert TA.attention_route(16, 384) == TA.attention_route(8, 384) == "small_n"
    rng = np.random.default_rng(77)
    x, g = (rng.standard_normal((1, 8, 8, 8, 3)).astype(np.float32) for _ in range(2))
    k = rng.integers(0, 1000, (1, 8)).astype(np.float32)
    out_err, errs = _model_errors(
        lambda p: jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(k)), params,
        lambda tree: dit3d_state_dict_from_flax(tree, None, pm.spec.patch_size),
        pm, lambda: pm(_t(x), _t(k)), g)
    assert out_err < UVIT_RTOL
    bad = {n: e for n, e in errs.items() if e > UVIT_RTOL}
    assert not bad, bad


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv", "ring_fwd", "ring_dq", "ring_dkv"])
def test_wide_plans_fit_at_every_width(kernel):
    """At every multiple of 64 from 320 to 1280, at the true head dim and at
    48 lanes less (a head padded to the width), N from 64 to 8192, 2 and 128
    heads: shared memory within one H100 block's 227 KB, the exchange of
    score tiles included; at least two stages; the grid within CUDA's
    limits; the ring entries on their kernel's plan. Slices of 512 lanes
    covering the computed lanes' atoms (B5: a dK and a dV block a slice), of
    256 for B4 and B5 where those fit one wave and add blocks; the block's
    own rows (B1: Q; B4: Q and dO; B5: K and V) resident where they fit
    beside two one-atom stages; stages of as many atoms as let two fit; output
    stages of as many atoms as a stage's bytes take, at most a slice's."""
    base = TA.RING_PLAN_OF.get(kernel, kernel)
    sides = 1 if base == "fwd" else 2
    atom = TA.FLASH_WIDE_ATOM_BYTES
    for d in WIDE:
        for head_dim in (d, d - 48):
            for n in WIDE_PLAN_ROWS:
                for bh in (2, 8 * 16):
                    plan = TA.flash_plan(kernel, bh, n, d, head_dim)
                    assert plan == TA.flash_plan(base, bh, n, d, head_dim)
                    lanes = -(-head_dim // 16) * 16
                    assert plan["lanes"] == lanes and plan["k_steps"] == lanes // 16
                    assert plan["smem_bytes"] <= TA.SMEM_PER_BLOCK
                    atoms = plan["atoms"]
                    assert atoms == -(-lanes // 64) <= d // 64
                    assert 2 <= plan["stages"] <= TA.FLASH_WIDE_MAX_STAGES
                    x, y, z = plan["grid"]
                    per = plan["slice_atoms"]
                    assert (x, y) == (n // 64, bh) and y <= 65535
                    assert per * (plan["slices"] - 1) < atoms <= per * plan["slices"]
                    assert z == plan["slices"] * (2 if base == "dkv" else 1) <= 65535
                    small = -(-n // 64) * bh * -(-atoms // 4) * (2 if base == "dkv" else 1)
                    assert per == (4 if base != "fwd" and atoms > 4 and small <= TA.SM_COUNT
                                   else 8)
                    barriers = 8 * (1 + 2 * plan["stages"])
                    used = plan["resident_bytes"] + plan["stages"] * plan["stage_bytes"]
                    assert plan["smem_bytes"] == 1024 + used + TA.FLASH_WIDE_EXCHANGE_BYTES + (
                        barriers)
                    room = (TA.SMEM_PER_BLOCK - 1024 - TA.FLASH_WIDE_EXCHANGE_BYTES
                            - 8 * (1 + 2 * TA.FLASH_WIDE_MAX_STAGES))
                    assert plan["resident"] == (sides * (atoms + 2) * atom <= room)
                    unit = sides * atom * (1 if plan["resident"] else 2)
                    sa = plan["stage_atoms"]
                    assert 1 <= sa <= min(TA.FLASH_WIDE_STAGE_ATOMS, atoms)
                    assert plan["stage_bytes"] == sa * unit
                    # the most atoms a stage that leave room for two stages
                    assert plan["resident_bytes"] + 2 * sa * unit <= room
                    assert sa == min(TA.FLASH_WIDE_STAGE_ATOMS, atoms) or (
                        plan["resident_bytes"] + 2 * (sa + 1) * unit > room)
                    assert plan["out_atoms"] == min(per, plan["stage_bytes"] // atom) >= sa


def _wide_walk(plan, kinds=1):
    """The wide family's consumer loops, as ``csrc/flash_wide.cu`` runs them
    (``score_tile``, ``output_product``) for every slice block of a row
    block: for each slice and consumer, the (product, atom) score steps it
    contracts from the score stages of a tile and the head's output atoms it
    accumulates from the output stages. ``kinds``: the block's score
    products (B1's S and a dV block's: one, split by atoms; B4's and a dK
    block's S and dP: two, consumer w contracting product w)."""
    A, SA, OA, per = plan["atoms"], plan["stage_atoms"], plan["out_atoms"], plan["slice_atoms"]
    walked = []
    for z, (a0, t0) in enumerate(plan["splits"]):
        sa = min(per, A - per * z)
        for w in (0, 1):
            prod = w if kinds == 2 else 0
            k_lo, k_hi = (0, A) if kinds == 2 else (t0, A) if w else (0, t0)
            v_lo, v_hi = (a0, sa) if w else (0, a0)
            scores, atoms = [], []
            for lo in range(0, A, SA):
                hi = min(lo + SA, A)
                scores += [(prod, a) for a in range(max(lo, k_lo), min(hi, k_hi))]
            for lo in range(0, sa, OA):
                hi = min(lo + OA, sa)
                atoms += [per * z + v_lo + at for at in range(4)
                          if v_lo + at < v_hi and lo <= v_lo + at < hi]
            walked.append((z, w, scores, atoms))
    return walked


def _owns_every_atom_and_step_once(plan, kinds, where):
    """Every output atom accumulated by exactly one consumer of one slice
    block, at most 4 a consumer (128 registers a thread); in every slice
    block each (product, atom) score step contracted by exactly one
    consumer; the two consumers' counts of atom products (4 k16 steps of n64
    each, in any product) within one of each other."""
    walked = _wide_walk(plan, kinds)
    owned = sorted(a for _, _, _, atoms in walked for a in atoms)
    assert owned == list(range(plan["atoms"])), where
    steps = sorted((k, a) for k in range(kinds) for a in range(plan["atoms"]))
    for z in range(plan["slices"]):
        mine = [(scores, atoms) for zz, _, scores, atoms in walked if zz == z]
        assert sorted(mine[0][0] + mine[1][0]) == steps, (where, z)
        assert all(len(atoms) <= 4 for _, atoms in mine), (where, z)
        work = [len(scores) + len(atoms) for scores, atoms in mine]
        assert abs(work[0] - work[1]) <= 1, (where, z, work)


def test_wide_fwd_plan_owns_every_lane_and_score_step_once():
    """The wide B1 at every multiple of 64 from 320 to 1280 (true head dims d
    and d - 48), N from 64 to 8192: every output atom of a query-row block is
    accumulated by exactly one consumer of one slice block, no consumer
    holds more than 4 (128 registers a thread); in every slice block each
    64-lane atom of the scores is contracted by exactly one of the two
    consumers (their partials are then summed on both); the split gives the
    two consumers counts of atoms (4 k16 steps of n64 products each, in
    either product) within one of each other."""
    for d in WIDE:
        for head_dim in (d, d - 48):
            for n in WIDE_PLAN_ROWS:
                plan = TA.flash_plan("fwd", 4, n, d, head_dim)
                _owns_every_atom_and_step_once(plan, 1, (d, head_dim, n))


@pytest.mark.parametrize("d", range(320, 1153, 64))
@pytest.mark.parametrize("kernel", ["dq", "dkv", "ring_dq", "ring_dkv"])
def test_wide_bwd_plan_owns_every_lane_and_score_step_once(kernel, d):
    """The wide B4 and B5 (and their ring entries) at heads of d and d - 48
    true lanes, N from 64 to 8192 and 2 or 128 heads, and at the paths' two
    sites (W: 2 heads of 512 over 2048 rows at B = 1 and 2; X: 32 heads of
    288 padded to 320 over 1280 rows): every lane of dq, dk and dv is owned
    by exactly one consumer of one block, every score step (S and dP over
    every atom; a dV block's S alone) contracted exactly once a block, the
    consumers' work within one atom of each other; the slice width the grid
    rule gives: 256 lanes where that grid fits one wave and has more blocks,
    so that B4 at W and B = 1 runs 128 blocks, not 64."""
    base = TA.RING_PLAN_OF.get(kernel, kernel)
    shapes = [(bh, n, d, hd) for hd in (d, d - 48) for n in WIDE_PLAN_ROWS for bh in (2, 128)]
    if d == 320:
        shapes.append((32, 1280, 320, 288))   # X
    if d == 512:
        shapes += [(2, 2048, 512, 512), (4, 2048, 512, 512)]  # W at B = 1 and 2
    for bh, n, dp, hd in shapes:
        plan = TA.flash_plan(kernel, bh, n, dp, hd)
        where = (kernel, bh, n, dp, hd)
        # B4's blocks and B5's dK blocks: S and dP; B5's dV blocks: S
        for kinds in ((2,) if base == "dq" else (2, 1)):
            _owns_every_atom_and_step_once(plan, kinds, where)
        blocks = plan["grid"][0] * plan["grid"][1] * plan["grid"][2]
        per_slice = plan["grid"][0] * plan["grid"][1] * (2 if base == "dkv" else 1)
        # the grid of the other slice width
        other = per_slice * -(-plan["atoms"] // (8 if plan["slice_atoms"] == 4 else 4))
        if plan["slice_atoms"] == 4:
            # every 256-lane block runs at once, and there are more of them
            assert other < blocks <= TA.SM_COUNT, where
        else:
            assert plan["atoms"] <= 4 or other > TA.SM_COUNT, where
    if d == 512:
        w1 = TA.flash_plan(kernel, 2, 2048, 512)
        want = (2, 128) if base == "dq" else (1, 128)
        assert (w1["slices"], w1["grid"][0] * w1["grid"][1] * w1["grid"][2]) == want


def test_wide_plans_at_the_paths_sites():
    """The two paths' wide sites. W, the base U-ViT's level 3 at 2 heads of
    512: the wide B1 in one 512-lane slice with Q resident, each consumer
    owning 256 lanes of O and 4 of the 8 score atoms, key tiles of K and of V
    a 64 KB stage each; B4 and B5 with the block's own rows resident beside
    two stages of 2 atoms of each score operand (32 KB), an output stage
    taking 4 atoms; at the train step's B = 1 B4 in two 256-lane slices (128
    blocks), B5 in one slice (128 blocks); at B = 2 B4 in one. X, K600
    @DiT/XL at 4 heads (288 of 320 lanes): the wide B1 in one slice, consumer
    0 owning 192 lanes of O and 2 score atoms, consumer 1 128 lanes and 3 (5
    atoms of products each); B4 and B5 in one slice, stages of 3 atoms, the
    5 output atoms in one stage; B5 640 dK and 640 dV blocks."""
    w = TA.flash_plan("fwd", 2 * 2, 2048, 512)
    assert (w["slices"], w["resident"], w["stage_atoms"], w["stages"], w["splits"]) == (
        1, True, 8, 2, ((4, 4),))
    assert w["smem_bytes"] == 1024 + 64 * 1024 + 32 * 1024 + 2 * 64 * 1024 + 8 * 5
    assert w["grid"] == (32, 4, 1)
    dq = TA.flash_plan("dq", 2 * 2, 2048, 512)
    assert (dq["slices"], dq["atoms"], dq["resident"], dq["stages"]) == (1, 8, True, 2)
    assert (dq["stage_atoms"], dq["out_atoms"], dq["grid"]) == (2, 4, (32, 4, 1))
    assert dq["smem_bytes"] == 1024 + 128 * 1024 + 32 * 1024 + 2 * 32 * 1024 + 8 * 5
    assert TA.flash_plan("dq", 2, 2048, 512)["grid"] == (32, 2, 2)
    assert TA.flash_plan("dkv", 2, 2048, 512)["grid"] == (32, 2, 2)
    x = TA.flash_plan("fwd", 8 * 4, 1280, 320, 288)
    assert (x["slices"], x["atoms"], x["k_steps"], x["resident"], x["splits"]) == (
        1, 5, 18, True, ((3, 2),))
    assert (x["stage_atoms"], x["stages"], x["grid"]) == (5, 3, (20, 32, 1))
    xb = TA.flash_plan("dkv", 8 * 4, 1280, 320, 288)
    assert (xb["slices"], xb["stage_atoms"], xb["out_atoms"], xb["stages"]) == (1, 3, 6, 2)
    assert xb["grid"] == (20, 32, 2)


@pytest.mark.parametrize("chunk", [8, 2])
def test_wide_prep_bwd_plans(chunk):
    """B6's plan for every even head dim from 258 to 1152 (a multiple of 8
    where 16-byte chunks are asked for): a warp a row, the chunks a lane
    holds cover the row, the groups' fp32 table partials fit the rings'
    shared memory, which fits a block; the narrow plans as they were."""
    for d in range(258 if chunk == 2 else 264, 1153, chunk):
        plan = TQ.prep_bwd_plan(8, 1280, 4, d, TA.padded_head_dim(d), chunk)
        assert plan["lanes"] == 32 and plan["chunks"] * 32 * chunk >= d
        assert plan["partials_bytes"] <= plan["smem_bytes"] <= TA.SMEM_PER_BLOCK
        assert plan["stages"] == TQ.PREP_BWD_WIDE_STAGES
    narrow = TQ.prep_bwd_plan(8, 1280, 16, 72, 128, chunk)
    assert (narrow["stages"], narrow["smem_bytes"]) == (6, 6 * TQ.PREP_BWD_STAGE_BYTES)
    with pytest.raises(ValueError):
        TQ.prep_bwd_plan(1, 128, 1, TQ.PREP_MAX_HEAD_DIM + chunk, 2048, chunk)
