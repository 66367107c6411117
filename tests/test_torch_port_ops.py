"""The port's attention kernels (dfot_tpu_torch.ops) against the JAX package.

On the CPU every wrapper runs its kernel's plain PyTorch version; here each
is held against the JAX package's Pallas kernel in interpret mode (and its
plain JAX mirror) on the same seeded fp32 inputs. Tolerances: 1e-5 absolute
for qkv_prep (elementwise), 2e-5 for attention outputs and LSE (sums over
N = 256 keys in another order), exact for the collect (a copy).

The CUDA kernels themselves are tested on the card by
``tests/test_torch_port_gpu.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfot_tpu.models.embeddings import make_rope_3d
from dfot_tpu.ops import attention as JA
from dfot_tpu.ops import qkv_prep as JQ
from dfot_tpu_torch.ops import attention as TA
from dfot_tpu_torch.ops import qkv_prep as TQ
from dfot_tpu_torch import ops as TOPS
from torch_port_helpers import one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _tables(rng, n, d):
    ang = rng.standard_normal((n, d // 2))
    return np.repeat(np.cos(ang), 2, axis=1), np.repeat(np.sin(ang), 2, axis=1)


def test_signed_sin_and_swap_pairs():
    x = np.random.default_rng(0).standard_normal((3, 4, 8)).astype(np.float32)
    np.testing.assert_array_equal(TQ.signed_sin(x), JQ.signed_sin(x))
    for axis in (-1, 1):
        np.testing.assert_array_equal(
            TQ.swap_pairs(_t(x), axis).numpy(), JQ.swap_pairs(jnp.asarray(x), axis)
        )


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("norm,scaled", [(False, False), (True, False), (True, True)])
def test_qkv_prep_matches_jax(d, norm, scaled):
    rng = np.random.default_rng(1)
    B, N, H = 2, 128, 2
    qkv = rng.standard_normal((B, N, 3 * H * d)).astype(np.float32)
    cos, sin = _tables(rng, N, d)
    ss = JQ.signed_sin(sin)
    scales = [rng.standard_normal(d).astype(np.float32) if scaled else None for _ in range(2)]
    jkw = dict(q_scale=None if scales[0] is None else jnp.asarray(scales[0]),
               k_scale=None if scales[1] is None else jnp.asarray(scales[1]), norm=norm, d_out=d)
    # the JAX route appends the flash normalizer's ones lane to v for d = 64
    aug = d % 128 == 64
    jargs = (jnp.asarray(qkv), H, d, jnp.asarray(cos, jnp.float32), jnp.asarray(ss, jnp.float32))
    kern = JQ.qkv_prep(*jargs, aug_v=aug, interpret=True, **jkw)
    mirror = JQ.reference_qkv_prep(*jargs, aug_v=aug, **jkw)
    got = TQ.qkv_prep(
        _t(qkv), H, d, _t(cos).float(), _t(ss).float(), norm=norm,
        q_scale=None if scales[0] is None else _t(scales[0]),
        k_scale=None if scales[1] is None else _t(scales[1]),
    )
    for g, k_, m in zip(got, kern, mirror):
        assert g.shape == (B, H, N, d)
        np.testing.assert_allclose(g.numpy(), np.asarray(k_)[..., :d], atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(m)[..., :d], atol=1e-5)


def test_qkv_prep_pads_and_reads_strided_rows():
    """d_out zero-pads each head; the packed rows may be a slice of the
    wider fused projection (the model's layout)."""
    rng = np.random.default_rng(2)
    B, N, H, d = 1, 128, 2, 32
    fused = rng.standard_normal((B, N, 7 * H * d)).astype(np.float32)
    qkv = fused[..., : 3 * H * d]
    cos, sin = _tables(rng, N, d)
    ss = JQ.signed_sin(sin)
    want = JQ.qkv_prep(jnp.asarray(qkv), H, d, jnp.asarray(cos, jnp.float32),
                       jnp.asarray(ss, jnp.float32), norm=True, d_out=64, interpret=True)
    got = TQ.qkv_prep(_t(fused)[..., : 3 * H * d], H, d, _t(cos).float(), _t(ss).float(),
                      norm=True, d_out=64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
        assert not g[..., d:].any()


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("variant", ["row", "pvt"])
def test_flash_forward_matches_jax(d, causal, variant):
    """B1 (``_flash_kernel``) and its transposed TPU orientation B1'
    (``_flash_kernel_pvt``) compute the same function: the port's one flash
    forward is held against both."""
    rng = np.random.default_rng(3)
    B, H, N = 1, 2, 256
    q, k, v = (rng.standard_normal((B, H, N, d)).astype(np.float32) for _ in range(3))
    scale = 0.7 / math.sqrt(d)
    want_o, want_lse = JA._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 128, 128, True,
        return_lse=True, variant=variant, sm_scale=scale,
    )
    got_o, got_lse = TA.flash_attention(_t(q), _t(k), _t(v), causal, scale, return_lse=True)
    assert got_lse.shape == (B, H, N, 1)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward_head_dim_160_matches_jax(causal):
    """Heads of 160: the JAX package pads them to 192 for its Pallas kernel
    (``_padded_flash``, interpret mode), the port to 256 (``"padded_flash"``);
    the zero lanes are inert, so both give the function of the true heads at
    the true 1/sqrt(160) scale. Also ``flash_attention`` on heads padded by
    the caller with ``head_dim=160``: pad lanes come back zero."""
    rng = np.random.default_rng(13)
    B, H, N, d, dp = 1, 2, 256, 160, 256
    q, k, v = (rng.standard_normal((B, H, N, d)).astype(np.float32) for _ in range(3))
    assert TA.attention_route(N, d, causal) == "padded_flash" and TA.padded_head_dim(d) == dp
    want = JA._padded_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, True)
    got = TA.attention(_t(q), _t(k), _t(v), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    tq, tk, tv = (torch.nn.functional.pad(_t(a), (0, dp - d)) for a in (q, k, v))
    got, lse = TA.flash_attention(tq, tk, tv, causal, 1.0 / math.sqrt(d), return_lse=True,
                                  head_dim=d)
    assert got.shape == (B, H, N, dp) and not got[..., d:].any()
    np.testing.assert_allclose(got[..., :d].numpy(), np.asarray(want), atol=2e-5)


def test_attention_dispatcher_matches_xla():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 3, 64, 32)).astype(np.float32) for _ in range(3))
    want = JA._xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False)
    np.testing.assert_allclose(TA.attention(_t(q), _t(k), _t(v)).numpy(), want, atol=2e-5)


@pytest.mark.parametrize("d,dp", [(64, 64), (32, 64), (128, 128)])
def test_attn_out_collect_matches_jax(d, dp):
    o = np.random.default_rng(5).standard_normal((2, 3, 128, dp)).astype(np.float32)
    want = JQ.attn_out_collect(jnp.asarray(o), d, interpret=True)
    np.testing.assert_array_equal(TQ.attn_out_collect(_t(o), d).numpy(), np.asarray(want))


def test_attention_from_packed_qkv_matches_fused_jax():
    """The whole B2 -> B1 -> B3 route against the JAX fused route (Pallas
    kernels in interpret mode), with 3D RoPE, QK norm and learned scales."""
    rng = np.random.default_rng(6)
    B, H, d, N = 1, 2, 64, 128
    rope = make_rope_3d(d, (8, 4, 4))
    qkv = rng.standard_normal((B, N, 3 * H * d)).astype(np.float32)
    qs, ks = (1 + 0.1 * rng.standard_normal(d).astype(np.float32) for _ in range(2))
    JQ.force_fused_interpret(True)
    try:
        want = JQ.attention_from_packed_qkv(
            jnp.asarray(qkv), H, d, rope, norm=True,
            q_scale=jnp.asarray(qs), k_scale=jnp.asarray(ks),
        )
    finally:
        JQ.force_fused_interpret(False)
    cos = torch.as_tensor(rope.cos)
    sin = torch.as_tensor(TQ.signed_sin(rope.sin))
    tables = TQ.fold_qk_tables(cos, sin, _t(qs), _t(ks), torch.float32)
    got = TQ.attention_from_packed_qkv(_t(qkv), H, d, tables, norm=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    plain = TQ.attention_from_packed_qkv(_t(qkv), H, d, tables, norm=True, plain=True)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


@pytest.mark.parametrize("rows,width", [(127, 32), (128, 16)])
def test_qkv_prep_rejects_tables_of_another_shape(rows, width):
    """Tables must be (N, head_dim): too few rows or another width raise on
    every route (the kernel would read past them)."""
    rng = np.random.default_rng(7)
    qkv = _t(rng.standard_normal((1, 128, 3 * 2 * 32)).astype(np.float32))
    cos, sin = (_t(t).float() for t in _tables(rng, rows, width))
    with pytest.raises(ValueError, match="RoPE tables"):
        TQ.qkv_prep(qkv, 2, 32, cos, sin, norm=True)
    with pytest.raises(ValueError, match="RoPE tables"):
        TQ.reference_qkv_prep(qkv, 2, 32, cos, sin, norm=True)
    with pytest.raises(ValueError, match="RoPE tables"):
        TQ.attention_from_packed_qkv(qkv, 2, 32, TQ.fold_qk_tables(cos, sin, dtype=torch.float32))


def test_wrappers_reject_devices_without_a_path():
    """The attention wrappers dispatch through custom ops whose only
    implementations are the plain version (CPU) and the kernel (CUDA), with
    no implementation for every device to fall back on; a meta tensor takes
    the ops' shape-only kernel and launches nothing."""
    for op in ("flash_attention", "small_n_attention", "qkv_prep", "attn_out_collect"):
        has = {key: torch._C._dispatch_has_kernel_for_dispatch_key(f"dfot::{op}", key)
               for key in ("CPU", "CUDA", "Meta", "XPU", "MPS", "CompositeExplicitAutograd",
                           "CompositeImplicitAutograd")}
        assert has == {"CPU": True, "CUDA": True, "Meta": True, "XPU": False, "MPS": False,
                       "CompositeExplicitAutograd": False,
                       "CompositeImplicitAutograd": False}, (op, has)
    TOPS.reset_launch_counts()
    x = torch.empty((1, 1, 64, 64), device="meta")
    assert TA.flash_attention(x, x, x).device.type == "meta"
    assert TQ.attn_out_collect(x, 64).shape == (1, 64, 64)
    assert not any(TOPS.launch_counts().values())


def test_cpu_wrappers_launch_no_kernel():
    TOPS.reset_launch_counts()
    x = torch.randn(1, 1, 64, 64)
    TA.flash_attention(x, x, x)
    TQ.attn_out_collect(x, 64)
    counts = TOPS.launch_counts()
    assert set(counts) >= {"flash_fwd", "qkv_prep", "attn_out_collect"}
    assert not any(counts.values())
