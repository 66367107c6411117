"""The port's backward kernels' plain versions against the JAX package.

On the CPU every wrapper runs its kernel's plain PyTorch version: explicit
backward formulas, not autograd of the forward. Here each is held against
the VJP of the JAX package's Pallas kernel in interpret mode (and its plain
JAX mirror) on the same seeded fp32 inputs, and ``torch.autograd.gradcheck``
holds each hand-written backward against its own forward in fp64,
independently of JAX. Tolerances, relative to the reference's largest
magnitude: 2e-5 for the attention gradients (sums over N = 256 keys in
another order) and for the qkv_prep gradients and table cotangents (sums
over batch and heads in another order); exact for the scatter (a copy).

The CUDA kernels themselves are tested on the card by
``tests/test_torch_port_gpu.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfot_tpu.ops import attention as JA
from dfot_tpu.ops import qkv_prep as JQ
from dfot_tpu_torch.ops import attention as TA
from dfot_tpu_torch.ops import qkv_prep as TQ
from torch_port_helpers import one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


RTOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()))


def _tables(rng, n, d):
    ang = rng.standard_normal((n, d // 2))
    cos, sin = np.repeat(np.cos(ang), 2, axis=1), np.repeat(np.sin(ang), 2, axis=1)
    return cos.astype(np.float32), JQ.signed_sin(sin).astype(np.float32)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("stream", [False, True])
def test_flash_backward_matches_jax(monkeypatch, d, causal, stream):
    """B4 (``_flash_bwd_dq_kernel``), its K/V-streaming twin B4'
    (``_flash_bwd_dq_stream_kernel``, forced by a zero VMEM budget) and B5
    (``_flash_bwd_dkv_kernel``): the port's one dq and one dk/dv function are
    held against both dq variants."""
    if stream:
        monkeypatch.setattr(JA, "_DQ_STREAM_BYTES", 0)
    rng = np.random.default_rng(10)
    B, H, N = 1, 2, 256
    q, k, v, do = (rng.standard_normal((B, H, N, d)).astype(np.float32) for _ in range(4))
    scale = 0.7 / math.sqrt(d)
    _, vjp = jax.vjp(
        lambda q, k, v: JA.flash_attention(q, k, v, causal, 128, 128, True, scale),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    want = vjp(jnp.asarray(do))

    # through autograd: the Function saves q, k, v, O, LSE and calls B4, B5
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    TA.flash_attention(tq, tk, tv, causal, scale).backward(_t(do))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got.numpy(), w)

    # and the plain backward on the saved forward results, directly
    o, lse = TA.attention_reference(_t(q), _t(k), _t(v), causal, scale, return_lse=True)
    for got, w in zip(TA.attention_backward_reference(_t(q), _t(k), _t(v), o, lse, _t(do),
                                                      causal, scale), want):
        _close(got.numpy(), w)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_padded_head_dim_matches_jax(causal):
    """K600 @DiT/XL's heads: d = 72 zero-padded to 128 with the true scale
    and ``head_dim=72`` passed to B4 and B5 (the kernels then compute 80
    lanes and write the rest as zeros), against the JAX package's
    ``_flash_backward`` (Pallas, interpret mode) on the unpadded heads."""
    rng = np.random.default_rng(15)
    B, H, N, d, dp = 1, 2, 256, 72, 128
    q, k, v, do = (rng.standard_normal((B, H, N, d)).astype(np.float32) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    _, vjp = jax.vjp(
        lambda q, k, v: JA.flash_attention(q, k, v, causal, 128, 128, True, scale),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    want = vjp(jnp.asarray(do))

    tq, tk, tv, tdo = (torch.nn.functional.pad(_t(a), (0, dp - d)) for a in (q, k, v, do))
    o, lse = TA.attention_reference(tq, tk, tv, causal, scale, return_lse=True)
    delta = TA._delta(o, tdo)
    dq = TA.flash_bwd_dq(tq, tk, tv, tdo, lse, delta, causal, scale, head_dim=d)
    dk, dv = TA.flash_bwd_dkv(tq, tk, tv, tdo, lse, delta, causal, scale, head_dim=d)
    for got, w in zip((dq, dk, dv), want):
        assert got.shape == (B, H, N, dp) and not got[..., d:].any()
        _close(got[..., :d].numpy(), w)

    # and through autograd, with the head dim carried to both backward kernels
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    TA.flash_attention(tq, tk, tv, causal, scale, head_dim=d).backward(tdo)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert not got[..., d:].any()
        _close(got[..., :d].numpy(), w)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_head_dim_160_matches_jax(causal):
    """Heads of 160 zero-padded to 256 with the true scale and
    ``head_dim=160`` passed to B4 and B5 (the kernels then compute 192
    lanes and write the rest as zeros), and the dispatcher's
    ``"padded_flash"`` route through autograd, against the JAX package's
    Pallas backward (interpret mode) on the unpadded heads."""
    rng = np.random.default_rng(16)
    B, H, N, d, dp = 1, 2, 256, 160, 256
    q, k, v, do = (rng.standard_normal((B, H, N, d)).astype(np.float32) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    _, vjp = jax.vjp(
        lambda q, k, v: JA._padded_flash(q, k, v, causal, True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    want = vjp(jnp.asarray(do))

    tq, tk, tv, tdo = (torch.nn.functional.pad(_t(a), (0, dp - d)) for a in (q, k, v, do))
    o, lse = TA.attention_reference(tq, tk, tv, causal, scale, return_lse=True)
    delta = TA._delta(o, tdo)
    dq = TA.flash_bwd_dq(tq, tk, tv, tdo, lse, delta, causal, scale, head_dim=d)
    dk, dv = TA.flash_bwd_dkv(tq, tk, tv, tdo, lse, delta, causal, scale, head_dim=d)
    for got, w in zip((dq, dk, dv), want):
        assert got.shape == (B, H, N, dp) and not got[..., d:].any()
        _close(got[..., :d].numpy(), w)

    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    TA.attention(tq, tk, tv, causal).backward(_t(do))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got.numpy(), w)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_matches_xla_autodiff(causal):
    rng = np.random.default_rng(11)
    q, k, v, do = (rng.standard_normal((2, 3, 64, 32)).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(lambda q, k, v: JA._xla_attention(q, k, v, causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    TA.attention(tq, tk, tv, causal).backward(_t(do))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got.numpy(), w)


@pytest.mark.parametrize("d,d_out", [(64, 64), (128, 128), (32, 64), (72, 128), (160, 256),
                                     (256, 256)])
@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("strided", [False, True])
def test_qkv_prep_backward_matches_jax(d, d_out, norm, strided):
    """B6 (``_bwd_kernel`` in interpret mode, and its mirror ``_bwd_jax``):
    packed dqkv, the four fp32 table cotangents, and, through the
    differentiable fold, the gradients of the learned q/k norm scales.
    ``strided``: qkv is a slice of a wider fused projection. The widths
    include those at which the kernel is held on the card: K600 @DiT/XL's
    72 -> 128, a head of 160 padded to 256, and the base widths' 256."""
    rng = np.random.default_rng(12)
    B, N, H = 2, 128, 2
    W = 3 * H * d
    fused = rng.standard_normal((B, N, 7 * H * d)).astype(np.float32)
    qkv = np.ascontiguousarray(fused[..., :W])
    cos, ss = _tables(rng, N, d)
    scales = [1 + 0.3 * rng.standard_normal(d).astype(np.float32) for _ in range(2)]
    grads = [rng.standard_normal((B, H, N, d_out)).astype(np.float32) for _ in range(3)]

    def jfn(x, qs, ks):
        return JQ.qkv_prep(x, H, d, jnp.asarray(cos), jnp.asarray(ss), q_scale=qs, k_scale=ks,
                           norm=norm, d_out=d_out, interpret=True)

    _, vjp = jax.vjp(jfn, jnp.asarray(qkv), *(jnp.asarray(s) for s in scales))
    want_dqkv, want_dqs, want_dks = vjp(tuple(jnp.asarray(g) for g in grads))

    tf = _t(fused).requires_grad_()
    tx = tf[..., :W] if strided else _t(qkv).requires_grad_()
    ts = [_t(s).requires_grad_() for s in scales]
    out = TQ.qkv_prep(tx, H, d, _t(cos), _t(ss), q_scale=ts[0], k_scale=ts[1], norm=norm,
                      d_out=d_out)
    torch.autograd.backward(out, [_t(g) for g in grads])
    if strided:
        _close(tf.grad[..., :W].numpy(), want_dqkv)
        assert not tf.grad[..., W:].any()
    else:
        _close(tx.grad.numpy(), want_dqkv)
    _close(ts[0].grad.numpy(), want_dqs)
    _close(ts[1].grad.numpy(), want_dks)

    # the table cotangents themselves, against the mirror and the kernel
    jtabs = [jnp.asarray(a) for a in (cos * scales[0], ss * JQ.swap_pairs(jnp.asarray(scales[0])),
                                      cos * scales[1], ss * JQ.swap_pairs(jnp.asarray(scales[1])))]
    bn = JQ._pick_bn(N, JQ._prep_bytes_per_token(W, H, d, d_out))
    spec = JQ._Spec(H, d, d_out, norm, 1e-6, True, bn, True, False, bn)
    res = (jnp.asarray(qkv), *jtabs)
    jg = tuple(jnp.asarray(g) for g in grads)
    ttabs = ((_t(jtabs[0]), _t(jtabs[1])), (_t(jtabs[2]), _t(jtabs[3])))
    got = TQ.qkv_prep_bwd(_t(fused)[..., :W] if strided else _t(qkv), ttabs,
                          *(_t(g) for g in grads), H, d, norm)
    assert all(g.dtype == torch.float32 for g in got[1:])
    for want in (JQ._bwd_jax(spec, res, jg), JQ._qkv_prep_bwd(spec, res, jg)):
        for g, w in zip(got, want):
            _close(g.numpy(), w)


@pytest.mark.parametrize("d,dp", [(64, 64), (32, 64), (128, 128)])
def test_attn_out_collect_backward_matches_jax(d, dp):
    """B7 (``_scatter_kernel`` through ``_collect_bwd`` in interpret mode)."""
    rng = np.random.default_rng(13)
    o = rng.standard_normal((2, 3, 128, dp)).astype(np.float32)
    g = rng.standard_normal((2, 128, 3 * d)).astype(np.float32)
    _, vjp = jax.vjp(lambda o: JQ.attn_out_collect(o, d, interpret=True), jnp.asarray(o))
    (want,) = vjp(jnp.asarray(g))
    to = _t(o).requires_grad_()
    TQ.attn_out_collect(to, d).backward(_t(g))
    np.testing.assert_array_equal(to.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(TQ.attn_out_scatter(_t(g), 3, d, dp).numpy(), np.asarray(want))
    assert not to.grad[..., d:].any()


def test_packed_route_backward_matches_jax():
    """qkv_prep -> flash -> collect as one differentiable route, the JAX
    Pallas chain in interpret mode against the port's: dqkv and the norm
    scales' gradients (N = 128, d = 64, so the JAX route appends and drops
    its ones lane on v)."""
    from dfot_tpu.models.embeddings import make_rope_3d
    from dfot_tpu_torch.models.embeddings import make_rope_3d as t_rope

    rng = np.random.default_rng(14)
    B, N, H, d = 1, 128, 2, 64
    qkv = rng.standard_normal((B, N, 3 * H * d)).astype(np.float32)
    g = rng.standard_normal((B, N, H * d)).astype(np.float32)
    scales = [1 + 0.3 * rng.standard_normal(d).astype(np.float32) for _ in range(2)]
    rope = make_rope_3d(d, (2, 8, 8))
    JQ.force_fused_interpret(True)
    try:
        _, vjp = jax.vjp(
            lambda x, qs, ks: JQ.attention_from_packed_qkv(x, H, d, rope, q_scale=qs, k_scale=ks,
                                                           norm=True),
            jnp.asarray(qkv), *(jnp.asarray(s) for s in scales))
        want = vjp(jnp.asarray(g))
    finally:
        JQ.force_fused_interpret(False)
    tr = t_rope(d, (2, 8, 8))
    tx = _t(qkv).requires_grad_()
    ts = [_t(s).requires_grad_() for s in scales]
    tabs = TQ.fold_qk_tables(_t(tr.cos), _t(TQ.signed_sin(tr.sin)), *ts, dtype=torch.float32)
    TQ.attention_from_packed_qkv(tx, H, d, tabs, norm=True).backward(_t(g))
    for got, w in zip((tx.grad, ts[0].grad, ts[1].grad), want):
        _close(got.numpy(), w, rtol=5e-5)  # three chained kernels


GRADCHECK_CASES = {
    "attention": lambda: _gradcheck_attention(False),
    "attention_causal": lambda: _gradcheck_attention(True),
    "qkv_prep_norm": lambda: _gradcheck_prep(True, 4),
    "qkv_prep_norm_padded": lambda: _gradcheck_prep(True, 8),
    "qkv_prep_plain_rope": lambda: _gradcheck_prep(False, 4),
    "attn_out_collect": lambda: torch.autograd.gradcheck(
        lambda o: TQ.attn_out_collect(o, 4),
        (torch.randn(2, 2, 4, 8, dtype=torch.float64, requires_grad=True),)),
}


def _gradcheck_attention(causal):
    q, k, v = (torch.randn(1, 2, 8, 4, dtype=torch.float64, requires_grad=True) for _ in range(3))
    return torch.autograd.gradcheck(lambda q, k, v: TA.flash_attention(q, k, v, causal), (q, k, v))


def _gradcheck_prep(norm, d_out):
    B, N, H, D = 2, 4, 2, 4
    f64 = torch.float64
    wide = torch.randn(B, N, 7 * H * D, dtype=f64, requires_grad=True)
    cos, sin = torch.randn(N, D, dtype=f64), torch.randn(N, D, dtype=f64)
    qs, ks = ((torch.rand(D, dtype=f64) + 0.5).requires_grad_() for _ in range(2))
    return torch.autograd.gradcheck(
        lambda w, a, b: TQ.qkv_prep(w[..., : 3 * H * D], H, D, cos, sin, q_scale=a, k_scale=b,
                                    norm=norm, d_out=d_out),
        (wide, qs, ks))


@pytest.mark.parametrize("case", sorted(GRADCHECK_CASES))
def test_backward_formulas_gradcheck(case):
    """fp64 finite differences against the hand-written backward of each
    autograd Function, on its plain route."""
    torch.manual_seed(0)
    assert GRADCHECK_CASES[case]()
