"""The DiT family's kernels in the port (dfot_tpu_torch.ops) against the JAX package.

On the CPU every wrapper runs its kernel's plain PyTorch version; here each
is held against the JAX package's Pallas kernel in interpret mode on the same
seeded numpy inputs:

- ``ln_modulate`` (kernels B8, B9), forward and ``jax.vjp``: 1e-5 absolute in
  fp32 (both sides take var = E[x^2] - mu^2 in fp32; the sums run in another
  order), and in bf16 one rounding step of the largest value;
- ``small_n_attention`` (kernel B10) against ``_small_n_impl(interpret=True)``
  and its gradient against ``small_n_attention``'s VJP: 2e-5 / 2e-4 absolute;
- the head-dim-72 packed route (B2 with ``d_out`` 128, B1 at the true scale,
  B3 back to 72; B7, B4, B5, B6 on the way back) against the JAX fused route
  under ``force_fused_interpret(True)``: 2e-5 / 1e-4 absolute;
- the dispatcher's rule, as a table: every shape the JAX package gives a
  Pallas kernel has a kernel route (short rows above 256 lanes: B10's wide
  entry), and B10's plans fit at every N and head dim.

The CUDA kernels themselves are tested on the card by
``tests/test_torch_port_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfot_tpu.models.embeddings import make_rope_3d
from dfot_tpu.ops import attention as JA
from dfot_tpu.ops import ln_modulate as JL
from dfot_tpu.ops import qkv_prep as JQ
from dfot_tpu_torch import ops as TOPS
from dfot_tpu_torch.ops import attention as TA
from dfot_tpu_torch.ops import ln_modulate as TL
from dfot_tpu_torch.ops import qkv_prep as TQ
from torch_port_helpers import one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def _t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


@pytest.fixture
def ln_interpret():
    JL.force_ln_interpret(True)
    yield
    JL.force_ln_interpret(False)


def _ln_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    shift, scale, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    return x, shift, 0.3 * scale, g


@pytest.mark.parametrize("shape", [(2, 256, 128), (1, 128, 384), (1, 256, 1152)])
def test_ln_modulate_matches_pallas_kernel(ln_interpret, shape):
    x, shift, scale, g = _ln_inputs(0, shape)
    want, vjp = jax.vjp(JL.ln_modulate, *(jnp.asarray(a) for a in (x, shift, scale)))
    tx, tsh, tsc = (_t(a).requires_grad_() for a in (x, shift, scale))
    got = TL.ln_modulate(tx, tsh, tsc)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    grads = torch.autograd.grad(got, (tx, tsh, tsc), _t(g))
    for a, b in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    # the backward wrapper alone, and the plain route's flag
    dx, dscale = TL.ln_modulate_bwd(_t(x), _t(scale), _t(g))
    np.testing.assert_array_equal(dx.numpy(), grads[0].numpy())
    np.testing.assert_array_equal(dscale.numpy(), grads[2].numpy())
    plain = TL.ln_modulate(_t(x), _t(shift), _t(scale), plain=True)
    np.testing.assert_array_equal(plain.numpy(), got.detach().numpy())


def test_ln_modulate_bf16_keeps_the_kernels_rounding_points(ln_interpret):
    """bf16 in, bf16 out, op by op as the Pallas kernel rounds: the two may
    differ by one rounding step where a sum lands on a tie."""
    x, shift, scale, g = _ln_inputs(1, (1, 128, 128))
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    want, vjp = jax.vjp(JL.ln_modulate, bf(x), bf(shift), bf(scale))
    args = [_t(a, torch.bfloat16).requires_grad_() for a in (x, shift, scale)]
    got = TL.ln_modulate(*args)
    assert got.dtype == torch.bfloat16
    step = 2.0 ** -7  # one bf16 step relative to the value
    w = np.asarray(want.astype(jnp.float32))
    assert np.abs(got.detach().float().numpy() - w).max() <= step * np.abs(w).max()
    grads = torch.autograd.grad(got, args, _t(g, torch.bfloat16))
    for a, b in zip(grads, vjp(bf(g))):
        b = np.asarray(b.astype(jnp.float32))
        assert a.dtype == torch.bfloat16
        assert np.abs(a.float().numpy() - b).max() <= step * np.abs(b).max()


def test_ln_modulate_backward_formulas_are_the_forwards_derivative():
    """The explicit backward (plain version of B9) against autograd of the
    plain forward, in fp64."""
    rng = np.random.default_rng(2)
    x, shift, scale = (torch.from_numpy(rng.standard_normal((2, 5, 16))).requires_grad_()
                       for _ in range(3))
    g = torch.from_numpy(rng.standard_normal((2, 5, 16)))
    want = torch.autograd.grad(TL.reference_ln_modulate(x, shift, scale), (x, shift, scale), g)
    got = torch.autograd.grad(TL.ln_modulate(x, shift, scale), (x, shift, scale), g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)


def test_ln_modulate_takes_token_wise_conditioning_only():
    x = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="token-wise"):
        TL.ln_modulate(x, torch.zeros(2, 1, 16), torch.zeros(2, 1, 16))
    with pytest.raises(ValueError, match="no ln_modulate path"):
        TL.ln_modulate(x.to("meta"), x.to("meta"), x.to("meta"))


@pytest.mark.parametrize("n,d", [(8, 64), (16, 64), (5, 64), (32, 128), (8, 256), (32, 256),
                                 (8, 320), (16, 384), (5, 512), (32, 1152)])
def test_small_n_attention_matches_pallas_kernel(n, d):
    rng = np.random.default_rng(3)
    q, k, v, g = (rng.standard_normal((4, 3, n, d)).astype(np.float32) for _ in range(4))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = JA._small_n_impl(jq, jk, jv, interpret=True)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    before = TOPS.launch_counts()
    got = TA.small_n_attention(tq, tk, tv)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5)
    # the gradient: the JAX package's VJP is autodiff of its plain attention
    want_g = JA._small_n_bwd((jq, jk, jv), jnp.asarray(g))
    for a, b in zip(torch.autograd.grad(got, (tq, tk, tv), _t(g)), want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)
    # the dispatcher sends this shape here, and on the CPU nothing is launched
    np.testing.assert_array_equal(TA.attention(_t(q), _t(k), _t(v)).numpy(), got.detach().numpy())
    assert TOPS.launch_counts() == before


def test_small_n_attention_rejects_long_rows():
    x = torch.zeros(1, 1, 33, 64)
    with pytest.raises(ValueError, match="N <= 32"):
        TA.small_n_attention(x, x, x)


# (N, d, causal) -> route; beside each what the JAX dispatcher does on a TPU
ROUTES = [
    ((8, 64, False), "small_n"),        # axial temporal attention: _small_n_kernel
    ((16, 64, False), "small_n"),       # factorized DiT, temporal and spatial
    ((32, 128, False), "small_n"),
    ((32, 64, True), "plain"),          # short causal rows: XLA attention
    ((16, 72, False), "plain"),         # short rows, ragged head dim: XLA attention
    ((8192, 64, False), "flash"),       # the flagship's level 2
    ((2048, 128, True), "flash"),
    ((256, 64, False), "flash"),        # XLA on a TPU (< 512 tokens); the port's kernel takes it
    ((1280, 72, False), "padded_flash"),  # K600 @DiT/XL: _padded_flash
    ((1280, 96, True), "padded_flash"),
    ((100, 64, False), "plain"),        # ragged N: XLA attention
    ((1000, 72, False), "plain"),
    ((1024, 320, False), "flash"),      # Pallas flash at d = 320; the wide family
    ((16, 320, False), "small_n"),      # _small_n_kernel at d = 320: B10's wide entry
    ((300, 192, False), "plain"),
    ((2048, 256, False), "flash"),      # the base U-ViT's level 3: 1024 channels, 4 heads
    ((2048, 256, True), "flash"),
    ((2048, 160, False), "padded_flash"),  # 160 -> 256 (the JAX package pads to 192)
    ((1024, 192, False), "padded_flash"),  # Pallas flash at d = 192; 192 -> 256 here
    ((8, 256, False), "small_n"),       # the base axial U-ViT's temporal attention
    ((16, 192, False), "small_n"),      # _small_n_kernel at d = 192
    ((2048, 320, True), "flash"),
    ((8, 160, False), "plain"),
]


@pytest.mark.parametrize("shape,route", ROUTES)
def test_attention_route(shape, route):
    assert TA.attention_route(*shape) == route


@pytest.mark.parametrize("n,d,causal", [(128, 72, False), (64, 40, True), (50, 72, False),
                                        (24, 64, True)])
def test_attention_dispatcher_matches_plain_jax_attention(n, d, causal):
    """Every route that computes gives the JAX package's plain attention
    (2e-5: sums over the keys in another order)."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 2, n, d)).astype(np.float32) for _ in range(3))
    want = JA._xla_attention(*(jnp.asarray(a) for a in (q, k, v)), causal)
    got = TA.attention(_t(q), _t(k), _t(v), causal)
    assert got.shape == (2, 2, n, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_attention_dispatcher_refuses_what_no_kernel_takes():
    """Only a CUDA tensor of a shape no kernel takes is refused
    (``tests/test_torch_port_gpu.py``); on the CPU every shape computes, as
    the JAX package's plain attention (2e-5), long and short rows at 320
    lanes too."""
    rng = np.random.default_rng(6)
    for shape in ((1, 1, 1024, 320), (1, 1, 16, 320)):
        q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
        want = JA._xla_attention(*(jnp.asarray(a) for a in (q, k, v)), False)
        np.testing.assert_allclose(TA.attention(_t(q), _t(k), _t(v)).numpy(), np.asarray(want),
                                   atol=2e-5)


def test_packed_route_head_dim_72_matches_fused_jax():
    """K600 @DiT/XL's heads: 72 lanes padded to 128 inside the preparation,
    the true 1/sqrt(72) scale, 3D RoPE, no norm; forward and gradient."""
    rng = np.random.default_rng(5)
    B, H, d, N = 1, 2, 72, 256
    rope = make_rope_3d(d, (4, 8, 8))
    qkv = rng.standard_normal((B, N, 3 * H * d)).astype(np.float32)
    g = rng.standard_normal((B, N, H * d)).astype(np.float32)
    JQ.force_fused_interpret(True)
    try:
        assert JQ.fused_qkv_eligible(N, d, H)
        want, vjp = jax.vjp(
            lambda a: JQ.attention_from_packed_qkv(a, H, d, rope), jnp.asarray(qkv))
        (want_g,) = vjp(jnp.asarray(g))
    finally:
        JQ.force_fused_interpret(False)
    cos, sin = torch.as_tensor(rope.cos), torch.as_tensor(TQ.signed_sin(rope.sin))
    tables = TQ.fold_qk_tables(cos, sin, dtype=torch.float32)
    tq = _t(qkv).requires_grad_()
    got = TQ.attention_from_packed_qkv(tq, H, d, tables)
    assert got.shape == (B, N, H * d)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5)
    (got_g,) = torch.autograd.grad(got, tq, _t(g))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-4)
    # the pad lanes: zero on the way in, their cotangents dropped on the way back
    q, k, v = TQ._prep(_t(qkv), tables, H, d, 128, False, 1e-6)
    assert q.shape == (B, H, N, 128) and not q[..., d:].any() and not v[..., d:].any()
    dq = torch.from_numpy(rng.standard_normal((B, H, N, 128)).astype(np.float32))
    junk = dq.clone()
    junk[..., d:] = 1e6
    a = TQ.qkv_prep_bwd(_t(qkv), tables, dq, dq, dq, H, d)
    b = TQ.qkv_prep_bwd(_t(qkv), tables, junk, junk, junk, H, d)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_new_wrappers_are_counted():
    assert {"ln_modulate", "ln_modulate_bwd", "small_n_attn", "ring_fwd", "ring_dq",
            "ring_dkv"} <= set(TOPS.KERNEL_WRAPPERS)
    # B1-B10, the ring hop's three entries (B1's forward, B4's and B5's
    # backward), the wide family's six (B1, B4, B5 and their ring entries)
    # and B10's wide entry
    assert len(TOPS.KERNEL_WRAPPERS) == 20
    assert TOPS.KERNEL_WRAPPERS["small_n_attn_wide"] is TA.small_n_attention_wide
    TOPS.reset_launch_counts()
    assert set(TOPS.launch_counts().values()) == {0}


def test_no_kernel_shape_up_to_head_dim_256_is_unported():
    """Every (N, d) the JAX dispatcher gives a Pallas kernel (``_blocks_ok``
    on the padded head dim, or its small-N gate) has a kernel route in the
    port, at every head dim up to 1152: long rows past 256 on the wide
    family, short rows past 256 on B10's wide entry."""
    for d in range(8, 1153, 8):
        dp = d + (-d % 64)
        for n in (8, 16, 32, 512, 1024, 1280, 2048, 8192):
            for causal in (False, True):
                small = not causal and n <= 32 and d % 64 == 0
                pallas = small or (JA._blocks_ok(n, dp) and n % 64 == 0)
                if not pallas:
                    continue
                route = TA.attention_route(n, d, causal)
                assert route == "small_n" if small else route in ("flash", "padded_flash"), (
                    n, d, causal, route)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_small_n_plans_fit_at_every_n_and_head_dim(dtype):
    """B10's plan at every N in 1..32 and every head dim in 64..2048 (step
    64): within one H100 block's shared memory with at least two stages and
    at least one block an SM; above 256 lanes (the wide entry) a stage holds
    a whole item where two stages of one fit a block, else a 64-lane chunk
    of two operands, whose bytes do not grow with d."""
    es = 2 if dtype == torch.bfloat16 else 4
    for n in range(1, 33):
        chunk_stage = None
        for d in range(64, 2049, 64):
            plan = TA.small_n_plan(1000, n, d, dtype)
            assert plan["wide"] == (d > TA.SMALL_N_WHOLE_D)
            assert 2 <= plan["stages"] <= TA.SMALL_N_MAX_STAGES, (n, d)
            assert plan["smem_bytes"] <= TA.SMEM_PER_BLOCK, (n, d)
            assert plan["blocks_per_sm"] * (plan["smem_bytes"] + TA.SMEM_BLOCK_RESERVE) <= (
                TA.SMEM_PER_SM), (n, d)
            assert plan["smem_bytes"] >= plan["stages"] * plan["stage_bytes"]
            if plan["wide"] and plan["whole"]:
                items = plan["items_per_stage"]
                assert plan["stage_bytes"] == items * 3 * n * (d * es + 16), (n, d)
            elif plan["wide"]:
                chunk_stage = chunk_stage or plan["stage_bytes"]
                assert plan["stage_bytes"] == chunk_stage, (n, d)
    with pytest.raises(ValueError):
        TA.small_n_plan(1000, 8, 352, dtype)  # above 256 only multiples of 64
