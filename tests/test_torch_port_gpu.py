"""The port's CUDA kernels against their plain versions, on the card.

Every test is marked ``gpu`` and skips where no CUDA device exists (the
kernels have no CPU mode). This file imports no JAX, so it also runs on the
machine with the card, which has none:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py -q

Tolerances as in ``chip_smoke.py``: B1's O within 1e-2 * max(1, |ref|max)
and LSE within 1e-3; B2 within 2e-2 * max(1, |ref|max) (the plain version
rounds to bf16 three times, the kernel once); B3 and B7 exact; B4 and B5
(dq, dk, dv) within 2e-2 * max(1, |ref|max) (the kernels round p and ds to
bf16 before the second products, the plain versions keep fp32 throughout);
B6's dqkv within 2e-2 * max(1, |ref|max) and its fp32 table cotangents
within 1e-3 * max(1, |ref|max) (sums of bf16 products in another order).
B8 and B9 within 2e-2 * max(1, |ref|max) in bf16 (the row sums run in another
order, so a normalized value can round to the neighbouring bf16) and 2e-5 in
fp32; B10 within 2e-2 * max(1, |ref|max) in bf16 (weights rounded to bf16 on
both sides, products summed in another order) and 2e-5 in fp32; the
head-dim-72 route as the head-dim-64 one. B1's O and B5's dk, dv also within
1e-2 relative L2 (``chip_smoke.ATTN_REL_L2_TOL``: P, dS and the outputs are
rounded to bf16 once each), with the lanes past the true head dim exact
zeros.
"""

import math
import zlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dfot_tpu_torch import ops
from dfot_tpu_torch.models.embeddings import make_rope_3d
from dfot_tpu_torch.ops import attention as A
from dfot_tpu_torch.ops import ln_modulate as L
from dfot_tpu_torch.ops import qkv_prep as Q


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want, rel):
    return (got.float() - want.float()).abs().max() <= rel * max(1.0, want.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("d,n", [(64, 1024), (128, 512)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward(cuda, d, n, causal):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 3, n, d, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    ops.reset_launch_counts()
    o, lse = A.flash_attention(q, k, v, causal, return_lse=True)
    assert ops.launch_counts()["flash_fwd"] == 1
    o_ref, lse_ref = A.attention_reference(q, k, v, causal, return_lse=True)
    assert _close(o, o_ref, 1e-2)
    assert (lse - lse_ref).abs().max() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_qkv_prep_and_collect(cuda, d):
    g = torch.Generator(device=cuda).manual_seed(1)
    B, N, H = 2, 256, 3
    fused = torch.randn(B, N, 7 * H * d, generator=g, device=cuda).to(torch.bfloat16)
    qkv = fused[..., : 3 * H * d]  # strided rows, as the model passes them
    rope = make_rope_3d(d, (4, 8, 8))
    cos = torch.as_tensor(rope.cos, device=cuda)
    sin = torch.as_tensor(Q.signed_sin(rope.sin), device=cuda)
    kw = dict(norm=True, q_scale=torch.rand(d, generator=g, device=cuda) + 0.5)
    ops.reset_launch_counts()
    got = Q.qkv_prep(qkv, H, d, cos, sin, **kw)
    want = Q.reference_qkv_prep(qkv, H, d, cos, sin, **kw)
    for a, b in zip(got, want):
        assert _close(a, b, 2e-2)
    o = got[0]
    assert torch.equal(Q.attn_out_collect(o, d), Q.reference_attn_out_collect(o, d))
    counts = ops.launch_counts()
    assert (counts["flash_fwd"], counts["qkv_prep"], counts["attn_out_collect"]) == (0, 1, 1)


@pytest.mark.gpu
def test_kernels_reject_what_they_do_not_take(cuda):
    x = torch.randn(1, 2, 128, 64, device=cuda)
    with pytest.raises(TypeError):
        A.flash_attention(x, x, x)  # fp32
    y = x.to(torch.bfloat16)
    with pytest.raises(ValueError):
        A.flash_attention(y[..., :96, :], y[..., :96, :], y[..., :96, :])  # N % 64
    with pytest.raises(TypeError):
        Q.qkv_prep(torch.randn(1, 64, 3 * 2 * 64, device=cuda), 2, 64,
                   torch.ones(64, 64, device=cuda), torch.zeros(64, 64, device=cuda))


@pytest.mark.gpu
def test_qkv_prep_rejects_bad_tables_and_misaligned_data(cuda):
    """The kernel reads the tables at every token and loads pairs of bf16:
    short tables, tables of another width and data off a 4-byte boundary
    raise instead of reading out of bounds."""
    g = torch.Generator(device=cuda).manual_seed(2)
    H, d, N = 2, 64, 128
    flat = torch.randn(N * 3 * H * d + 1, generator=g, device=cuda).to(torch.bfloat16)
    qkv = flat[: N * 3 * H * d].view(1, N, 3 * H * d)
    rope = make_rope_3d(d, (2, 8, 8))
    cos = torch.as_tensor(rope.cos, device=cuda)
    sin = torch.as_tensor(Q.signed_sin(rope.sin), device=cuda)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="RoPE tables"):
        Q.qkv_prep(qkv, H, d, cos[: N - 1], sin[: N - 1])
    with pytest.raises(ValueError, match="RoPE tables"):
        Q.qkv_prep(qkv, H, d, cos[:, : d // 2], sin[:, : d // 2])
    with pytest.raises(ValueError, match="aligned"):
        Q.qkv_prep(flat[1:].view(1, N, 3 * H * d), H, d, cos, sin)
    assert ops.launch_counts()["qkv_prep"] == 0
    Q.qkv_prep(qkv, H, d, cos, sin)
    assert ops.launch_counts()["qkv_prep"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("d,n", [(64, 1024), (128, 512)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward(cuda, d, n, causal):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(2, 3, n, d, generator=g, device=cuda).to(torch.bfloat16)
                   for _ in range(4))
    q.requires_grad_(), k.requires_grad_(), v.requires_grad_()
    ops.reset_launch_counts()
    A.flash_attention(q, k, v, causal).backward(do)
    counts = ops.launch_counts()
    assert (counts["flash_fwd"], counts["flash_bwd_dq"], counts["flash_bwd_dkv"]) == (1, 1, 1)
    o, lse = A.attention_reference(q, k, v, causal, return_lse=True)
    want = A.attention_backward_reference(q, k, v, o, lse, do, causal)
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        assert _close(got, ref, 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("d,d_out", [(64, 64), (128, 128), (64, 128)])
@pytest.mark.parametrize("norm", [True, False])
def test_qkv_prep_backward(cuda, d, d_out, norm):
    g = torch.Generator(device=cuda).manual_seed(4)
    B, N, H = 2, 256, 3
    fused = torch.randn(B, N, 7 * H * d, generator=g, device=cuda).to(torch.bfloat16)
    qkv = fused[..., : 3 * H * d]  # strided rows, as the model passes them
    rope = make_rope_3d(d, (4, 8, 8))
    cos = torch.as_tensor(rope.cos, device=cuda)
    sin = torch.as_tensor(Q.signed_sin(rope.sin), device=cuda)
    scales = [torch.rand(d, generator=g, device=cuda) + 0.5 for _ in range(2)]
    tabs = Q.fold_qk_tables(cos, sin, *scales, dtype=torch.bfloat16)
    grads = [torch.randn(B, H, N, d_out, generator=g, device=cuda).to(torch.bfloat16)
             for _ in range(3)]
    ops.reset_launch_counts()
    got = Q.qkv_prep_bwd(qkv, tabs, *grads, H, d, norm)
    assert ops.launch_counts()["qkv_prep_bwd"] == 1
    want = Q.qkv_prep_bwd(qkv, tabs, *grads, H, d, norm, plain=True)
    assert got[0].dtype == torch.bfloat16 and _close(got[0], want[0], 2e-2)
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32 and _close(a, b, 1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,H,d,d_out,width,norm", [
    (3, 1000, 9, 64, 64, 7 * 9 * 64, True),     # no multiple of a tile, odd H, 7C rows
    (8, 320, 16, 72, 128, 3 * 16 * 72, False),  # K600 @DiT/XL's heads, 72 -> 128
    (2, 256, 3, 64, 128, 3 * 3 * 64 + 2, True),  # rows off 16 bytes: 4-byte chunks
    (1, 2048, 4, 160, 256, 7 * 4 * 160, True),  # a head of 160 padded to 256
])
def test_qkv_prep_backward_tails_and_repeats(cuda, B, N, H, d, d_out, width, norm):
    """B6 at a token count that is no multiple of its tile, an odd head count
    and strided rows, at XL's head dim and on the 4-byte path: within
    ``chip_smoke.py``'s bounds (dqkv 2e-2, each table cotangent 5e-3 of its
    reference's magnitude: where the kernel's and the plain version's rms
    sums differ in the last bit, a u can round to the neighbouring bf16 and
    move a table sum by 2^-8 of one product; and 1e-2 relative L2 on each),
    and two calls on the same operands give the same bits (the table
    cotangents are summed over (batch, head) in a fixed order, without
    atomics)."""
    g = torch.Generator(device=cuda).manual_seed(13)
    fused = torch.randn(B, N, width, generator=g, device=cuda).to(torch.bfloat16)
    qkv = fused[..., : 3 * H * d]
    rope = make_rope_3d(d, (1, 1, N))
    cos = torch.as_tensor(rope.cos, device=cuda)
    sin = torch.as_tensor(Q.signed_sin(rope.sin), device=cuda)
    scales = [torch.rand(d, generator=g, device=cuda) + 0.5 for _ in range(2)]
    tabs = Q.fold_qk_tables(cos, sin, *scales, dtype=torch.bfloat16)
    grads = [torch.randn(B, H, N, d_out, generator=g, device=cuda).to(torch.bfloat16)
             for _ in range(3)]
    ops.reset_launch_counts()
    got = Q.qkv_prep_bwd(qkv, tabs, *grads, H, d, norm)
    again = Q.qkv_prep_bwd(qkv, tabs, *grads, H, d, norm)
    assert ops.launch_counts()["qkv_prep_bwd"] == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = Q.qkv_prep_bwd(qkv, tabs, *grads, H, d, norm, plain=True)
    assert _close(got[0], want[0], 2e-2) and _rel_l2(got[0], want[0]) <= 1e-2
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32 and _close(a, b, 5e-3) and _rel_l2(a, b) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,H,d,d_in", [(2, 256, 3, 64, 64), (2, 256, 3, 64, 128),
                                          (8, 1280, 16, 72, 128), (2, 2048, 4, 256, 256),
                                          (3, 1000, 3, 64, 64), (3, 1000, 4, 160, 256),
                                          (1, 37, 5, 2048, 2048)])
def test_attn_out_scatter(cuda, B, N, H, d, d_in):
    """B7 is an exact copy at the path head dims, padded or not (K600
    @DiT/XL's 72 -> 128 at its shape, heads of 256), at a token count that is
    no multiple of any tile with B = 3, and where one token row is more than
    a block's slots; one launch a call, the same bits twice. A scatter that
    takes the heads in the wrong order is not."""
    g = torch.randn(B, N, H * d, device=cuda).to(torch.bfloat16)
    ops.reset_launch_counts()
    got = Q.attn_out_scatter(g, H, d, d_in)
    assert ops.launch_counts()["attn_out_scatter"] == 1
    want = Q.reference_attn_out_scatter(g, H, d, d_in)
    assert torch.equal(got, want)
    assert torch.equal(Q.attn_out_scatter(g, H, d, d_in), got)
    reversed_heads = g.reshape(B, N, H, d).flip(2).reshape(B, N, H * d)
    assert not torch.equal(Q.reference_attn_out_scatter(reversed_heads, H, d, d_in), want)


@pytest.mark.gpu
def test_packed_route_gradients(cuda):
    """attention_from_packed_qkv on the kernel route against the plain
    route: output, dqkv and the norm-scale gradients through the fold."""
    g = torch.Generator(device=cuda).manual_seed(5)
    B, N, H, d = 1, 512, 2, 64
    rope = make_rope_3d(d, (8, 8, 8))
    cos = torch.as_tensor(rope.cos, device=cuda)
    sin = torch.as_tensor(Q.signed_sin(rope.sin), device=cuda)
    qkv0 = torch.randn(B, N, 3 * H * d, generator=g, device=cuda).to(torch.bfloat16)
    do = torch.randn(B, N, H * d, generator=g, device=cuda).to(torch.bfloat16)
    results = []
    for plain in (False, True):
        qkv = qkv0.clone().requires_grad_()
        scales = [torch.full((d,), 2.0, device=cuda, requires_grad=True) for _ in range(2)]
        tabs = Q.fold_qk_tables(cos, sin, *scales, dtype=torch.float32)
        out = Q.attention_from_packed_qkv(qkv, H, d, tabs, norm=True, plain=plain)
        out.backward(do)
        results.append((out, qkv.grad, scales[0].grad, scales[1].grad))
    for got, want in zip(*results):
        assert _close(got, want, 2e-2)
    counts = ops.launch_counts()
    route = ("qkv_prep", "flash_fwd", "attn_out_collect", "attn_out_scatter", "flash_bwd_dq",
             "flash_bwd_dkv", "qkv_prep_bwd")
    assert all(counts[name] >= 1 for name in route), counts


@pytest.mark.gpu
def test_backward_kernels_reject_what_they_do_not_take(cuda):
    x = torch.randn(1, 2, 128, 64, device=cuda)
    stat = torch.zeros(1, 2, 128, 1, device=cuda)
    with pytest.raises(TypeError):
        A.flash_bwd_dq(x, x, x, x, stat, stat)  # fp32
    y = x.to(torch.bfloat16)
    with pytest.raises(ValueError):
        A.flash_bwd_dkv(y, y, y, y, stat[:, :, :64], stat)  # short lse
    with pytest.raises(ValueError):
        A.flash_bwd_dq(y[..., :96, :], y[..., :96, :], y[..., :96, :], y[..., :96, :],
                       stat[:, :, :96], stat[:, :, :96])  # N % 64
    with pytest.raises(TypeError):
        Q.attn_out_scatter(torch.randn(1, 64, 128, device=cuda), 2, 64, 64)  # fp32
    with pytest.raises(ValueError):
        Q.attn_out_scatter(y.reshape(1, 256, 64), 3, 64, 64)  # width != H * D


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 2e-2), (torch.float32, 2e-5)])
@pytest.mark.parametrize("shape", [(2, 1280, 1152), (16, 16, 384), (3, 7, 768), (2, 5, 1150),
                                   (1, 3, 4096), (3, 7, 384), (1, 5, 896), (2, 3, 1024),
                                   (3, 7, 1152), (1, 5, 2048)])
def test_ln_modulate_forward_and_backward(cuda, dtype, rel, shape):
    """B8 and B9 at the XL, DiT/B and factorized widths, at every other
    width-exact width with a token count that is no multiple of a block's
    tokens (21, 5, 6), a width that is no multiple of the 16-byte vector and
    one wider than the registers hold (both take the pair kernels), through
    the autograd Function; B9 twice on the same operands gives the same
    bits."""
    g = torch.Generator(device=cuda).manual_seed(10)
    x = (2 * torch.randn(shape, generator=g, device=cuda) + 0.5).to(dtype).requires_grad_()
    shift = torch.randn(shape, generator=g, device=cuda).to(dtype).requires_grad_()
    scale = (0.3 * torch.randn(shape, generator=g, device=cuda)).to(dtype).requires_grad_()
    cot = torch.randn(shape, generator=g, device=cuda).to(dtype)
    ops.reset_launch_counts()
    y = L.ln_modulate(x, shift, scale)
    grads = torch.autograd.grad(y, (x, shift, scale), cot)
    counts = ops.launch_counts()
    assert (counts["ln_modulate"], counts["ln_modulate_bwd"]) == (1, 1)
    y_ref = L.ln_modulate(x, shift, scale, plain=True)
    grads_ref = torch.autograd.grad(y_ref, (x, shift, scale), cot)
    assert ops.launch_counts() == counts  # the plain route launches nothing
    assert y.dtype == dtype and _close(y, y_ref, rel)
    for a, b in zip(grads, grads_ref):
        assert a.dtype == dtype and _close(a, b, rel)
    assert torch.equal(grads[1], cot)  # the cotangent of shift is g itself
    again = L.ln_modulate_bwd(x.detach(), scale.detach(), cot)
    assert torch.equal(again[0], grads[0]) and torch.equal(again[1], grads[2])


@pytest.mark.gpu
def test_ln_modulate_rejects_what_it_does_not_take(cuda):
    x = torch.randn(2, 8, 16, device=cuda)
    odd = torch.randn(2, 8, 15, device=cuda)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="C even"):
        L.ln_modulate(odd, odd, odd)
    with pytest.raises(ValueError, match="C even"):
        L.ln_modulate_bwd(odd, odd, odd)
    with pytest.raises(TypeError):
        L.ln_modulate(x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="share"):
        L.ln_modulate(x, x.to(torch.bfloat16), x)
    with pytest.raises(ValueError, match="token-wise"):
        L.ln_modulate(x, x[:, :1], x[:, :1])
    flat = torch.randn(2 * 8 * 16 + 1, device=cuda).to(torch.bfloat16)
    off = flat[1:].view(2, 8, 16)  # two bytes off a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        L.ln_modulate(off, off, off)
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 2e-2), (torch.float32, 2e-5)])
@pytest.mark.parametrize("z,n,d", [(18432, 8, 64), (4608, 8, 128), (768, 16, 64), (70000, 5, 64),
                                   (333, 32, 64), (100, 32, 128), (7, 1, 64), (2048, 8, 256),
                                   (100, 32, 256), (64, 16, 192)])
def test_small_n_attention(cuda, z, n, d, dtype, rel):
    """B10 at the axial (N = 8, d = 64, 128 and 256) and factorized-DiT
    (N = 16) shapes, at row lengths that are no multiple of a tensor-core
    tile, at the longest row (in fp32 its item passes 48 KB of shared memory;
    at d = 256 it passes the budget in bf16 too and takes a block of its
    own), and with more items than a grid's second dimension holds."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = ((1.5 * torch.randn(2, z // 2 or 1, n, d, generator=g, device=cuda)).to(
        dtype).requires_grad_() for _ in range(3))
    cot = torch.randn(q.shape, generator=g, device=cuda).to(dtype)
    ops.reset_launch_counts()
    o = A.attention(q, k, v)  # the dispatcher sends short rows to B10
    assert ops.launch_counts()["small_n_attn"] == 1 and ops.launch_counts()["flash_fwd"] == 0
    o_ref = A.small_n_attention_reference(q, k, v)
    assert o.dtype == dtype and _close(o, o_ref, rel)
    assert _close(o, A.attention_reference(q, k, v), rel)
    grads = torch.autograd.grad(o, (q, k, v), cot)
    want = torch.autograd.grad(A.attention(q, k, v, plain=True), (q, k, v), cot)
    for a, b in zip(grads, want):
        assert _close(a, b, rel)
    assert ops.launch_counts()["small_n_attn"] == 1


@pytest.mark.gpu
def test_small_n_attention_rejects_what_it_does_not_take(cuda):
    y = torch.randn(1, 2, 64, 64, device=cuda).to(torch.bfloat16)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="N <= 32"):
        A.small_n_attention(y, y, y)  # N > 32
    with pytest.raises(ValueError, match="d in"):
        A.small_n_attention(y[..., :8, :32], y[..., :8, :32], y[..., :8, :32])  # d = 32
    wide = torch.zeros(1, 2, 8, 320, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="d in"):
        A.small_n_attention(wide, wide, wide)  # d = 320
    with pytest.raises(TypeError):
        A.small_n_attention(y[..., :8, :].half(), y[..., :8, :].half(), y[..., :8, :].half())
    with pytest.raises(TypeError):
        A.small_n_attention(y[..., :8, :].float(), y[..., :8, :], y[..., :8, :])  # mixed
    assert ops.launch_counts()["small_n_attn"] == 0
    # a causal short row is no shape of B10: the dispatcher computes it plainly
    short = y[..., :8, :].contiguous()
    out = A.attention(short, short, short, causal=True)
    assert ops.launch_counts()["small_n_attn"] == 0
    assert _close(out, A.attention_reference(short, short, short, True), 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 8])
def test_packed_route_head_dim_72(cuda, batch):
    """K600 @DiT/XL's attention, (B, 16, 1280, 72 -> 128): B2 pads, B1 runs at
    the true 1/sqrt(72) scale, B3 cuts back; B7, B4, B5, B6 on the way back."""
    g = torch.Generator(device=cuda).manual_seed(12)
    H, d, N = 16, 72, 1280
    qkv = torch.randn(batch, N, 3 * H * d, generator=g, device=cuda).to(
        torch.bfloat16).requires_grad_()
    cot = torch.randn(batch, N, H * d, generator=g, device=cuda).to(torch.bfloat16)
    rope = make_rope_3d(d, (5, 16, 16))
    tables = Q.fold_qk_tables(torch.as_tensor(rope.cos, device=cuda),
                              torch.as_tensor(Q.signed_sin(rope.sin), device=cuda),
                              dtype=torch.bfloat16)
    ops.reset_launch_counts()
    out = Q.attention_from_packed_qkv(qkv, H, d, tables)
    (grad,) = torch.autograd.grad(out, qkv, cot)
    assert set(ops.launch_counts().values()) - {0} == {1}
    assert {k for k, n in ops.launch_counts().items() if n} == {
        "qkv_prep", "flash_fwd", "attn_out_collect", "attn_out_scatter", "flash_bwd_dq",
        "flash_bwd_dkv", "qkv_prep_bwd"}
    ref = Q.attention_from_packed_qkv(qkv, H, d, tables, plain=True)
    (grad_ref,) = torch.autograd.grad(ref, qkv, cot)
    assert out.shape == (batch, N, H * d)
    assert _close(out, ref, 1e-2) and _close(grad, grad_ref, 2e-2)
    q, k, v = Q._prep_cuda(qkv.detach(), tables, H, d, 128, False, 1e-6)
    assert q.shape == (batch, H, N, 128)
    assert not q[..., d:].any() and not k[..., d:].any() and not v[..., d:].any()


def _rel_l2(got, want):
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def _padded_heads(g, bh, n, d, dp, cuda, scale=1.0):
    """(1, bh, n, d) seeded bf16 heads zero-padded to dp lanes."""
    x = scale * torch.randn(1, bh, n, d, generator=g, device=cuda)
    return F.pad(x.to(torch.bfloat16), (0, dp - d))


def _check_wgmma_pair(cuda, bh, n, d, dp, causal, seed):
    """B1 and B5 on padded heads with the true head dim passed, against the
    plain versions: O and the LSE, then dk and dv on the plain forward's O and
    LSE; pad lanes zeros; one launch each."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    scale = 1.0 / math.sqrt(d)
    q, k = (_padded_heads(g, bh, n, d, dp, cuda, 1.7) for _ in range(2))
    v, do = (_padded_heads(g, bh, n, d, dp, cuda) for _ in range(2))
    ops.reset_launch_counts()
    o, lse = A.flash_attention(q, k, v, causal, scale, return_lse=True, head_dim=d)
    o_ref, lse_ref = A.attention_reference(q, k, v, causal, scale, return_lse=True)
    assert _close(o, o_ref, 1e-2) and _rel_l2(o, o_ref) <= 1e-2
    assert (lse - lse_ref).abs().max() <= 1e-3
    assert not o[..., d:].any()
    delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
    dk, dv = A.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal, scale, head_dim=d)
    dk_ref, dv_ref = A._dkv_plain(q, k, v, do, lse_ref, delta, causal, scale)
    for got, want in ((dk, dk_ref), (dv, dv_ref)):
        assert _close(got, want, 2e-2) and _rel_l2(got, want) <= 1e-2
        assert not got[..., d:].any()
    counts = ops.launch_counts()
    assert (counts["flash_fwd"], counts["flash_bwd_dkv"]) == (1, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("d,dp", [(64, 64), (128, 128), (72, 128), (256, 256), (160, 256)])
@pytest.mark.parametrize("bh", [1, 128])
@pytest.mark.parametrize("n", [64, 192, 1280])
def test_wgmma_flash_kernels(cuda, n, bh, d, dp):
    """B1 and B5 where N is half a 128-row block, one and a half (the
    block's second half lies past N), and ten; with one head and with 128 (a
    tile past a head's last row must read zeros, not the next head's rows);
    heads of 72 padded to 128 contract over 80 lanes, heads of 160 padded to
    256 over 192, and both come back with zero pad lanes; at d = 256 B1
    streams 64-key tiles and a B5 block owns 64 keys."""
    _check_wgmma_pair(cuda, bh, n, d, dp, False, seed=20)


@pytest.mark.gpu
@pytest.mark.parametrize("d,dp", [(64, 64), (128, 128), (72, 128), (256, 256), (160, 256)])
def test_wgmma_flash_kernels_causal(cuda, d, dp):
    """Causal at N = 320: 128-row blocks and 128-key tiles meet the diagonal
    mid-tile, and the last block is half past N."""
    _check_wgmma_pair(cuda, 2, 320, d, dp, True, seed=21)


@pytest.mark.gpu
def test_wgmma_flash_kernels_reject_what_they_do_not_take(cuda):
    y = torch.zeros(1, 2, 128, 128, device=cuda, dtype=torch.bfloat16)
    stat = torch.zeros(1, 2, 128, 1, device=cuda)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="head_dim"):
        A.flash_attention(y, y, y, head_dim=130)
    with pytest.raises(ValueError):
        A.flash_bwd_dkv(y, y, y, y, stat, stat, head_dim=0)
    off = torch.zeros(2 * 128 + 1, device=cuda)[1:].view(1, 2, 128, 1)  # 4 bytes off
    with pytest.raises(ValueError, match="aligned"):
        A.flash_bwd_dkv(y, y, y, y, off, stat)
    assert ops.launch_counts()["flash_fwd"] == ops.launch_counts()["flash_bwd_dkv"] == 0


def _check_dq(cuda, bh, n, d, dp, causal, seed):
    """B4 on padded heads with the true head dim passed, against its plain
    version on the plain forward's LSE and delta: within 2e-2 * max(1,
    |ref|max) and 1e-2 relative L2, pad lanes zeros, one launch."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    scale = 1.0 / math.sqrt(d)
    q, k = (_padded_heads(g, bh, n, d, dp, cuda, 1.7) for _ in range(2))
    v, do = (_padded_heads(g, bh, n, d, dp, cuda) for _ in range(2))
    o, lse = A.attention_reference(q, k, v, causal, scale, return_lse=True)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    ops.reset_launch_counts()
    dq = A.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale, head_dim=d)
    assert ops.launch_counts()["flash_bwd_dq"] == 1
    ref = A._dq_plain(q, k, v, do, lse, delta, causal, scale)
    assert _close(dq, ref, 2e-2) and _rel_l2(dq, ref) <= 1e-2
    assert not dq[..., d:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d,dp", [(64, 64), (128, 128), (72, 128), (256, 256), (160, 256)])
@pytest.mark.parametrize("bh", [1, 128])
@pytest.mark.parametrize("n", [64, 192, 1280])
def test_wgmma_dq_kernel(cuda, n, bh, d, dp, causal):
    """B4 where N is half a 128-row block, one and a half (the block's
    second consumer lies past N) and ten, with one head and 128 (a tile past
    a head's last row must read zeros), causal and not; heads of 72 padded
    to 128 contract over 80 lanes and come back with zero pad lanes."""
    _check_dq(cuda, bh, n, d, dp, causal, seed=22)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1280, 100])
@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("d,dp", [(64, 64), (72, 128), (128, 128), (64, 128), (72, 72),
                                  (70, 70), (256, 256)])
def test_qkv_prep_token_tiles(cuda, d, dp, norm, n):
    """B2 on strided rows (a slice of a fused projection seven heads' widths
    wide, as the flagship passes it) at the model head dims, padded and not,
    with a ragged last token tile (N = 100); a head dim of 70 takes the
    kernel's 4-byte chunks. Each of q, k, v within 2e-2 * max(1, |ref|max)
    and 1e-2 relative L2, pad lanes zeros, one launch."""
    g = torch.Generator(device=cuda).manual_seed(23)
    B, H = 2, 3
    fused = torch.randn(B, n, 7 * H * d, generator=g, device=cuda).to(torch.bfloat16)
    qkv = fused[..., : 3 * H * d]
    cos = torch.randn(n, d, generator=g, device=cuda).cos()
    sin = torch.randn(n, d, generator=g, device=cuda).sin()
    scales = [(1 + 0.1 * torch.randn(d, generator=g, device=cuda)) for _ in range(2)]
    tabs = Q.fold_qk_tables(cos, sin, *scales, dtype=torch.bfloat16)
    ops.reset_launch_counts()
    got = Q._prep(qkv, tabs, H, d, dp, norm, 1e-6)
    assert ops.launch_counts()["qkv_prep"] == 1
    want = Q._prep_plain(qkv, tabs, H, d, dp, norm, 1e-6)
    for a, b in zip(got, want):
        assert a.shape == (B, H, n, dp)
        assert _close(a, b, 2e-2) and _rel_l2(a, b) <= 1e-2
        assert not a[..., d:].any()
    assert torch.equal(got[2], want[2])  # v is a copy


@pytest.mark.gpu
def test_dq_and_prep_entries_refuse_what_they_do_not_take(cuda):
    """B4's C entry refuses a tile plan other than the compiled one and a
    lane count it has no instantiation for; its wrapper raises for a head
    dim outside {64, 128, 256} and a head_dim above d. B2's entry refuses an odd
    head dim, one above 256 and a padded width below it; its wrapper raises
    for rows off a 4-byte boundary."""
    from dfot_tpu_torch.ops import _cuda

    lib = _cuda.library()
    y = torch.zeros(1, 2, 128, 128, device=cuda, dtype=torch.bfloat16)
    stat = torch.zeros(1, 2, 128, 1, device=cuda)
    plan = A.flash_plan("dq", 2, 128, 128, 72)
    stream = _cuda.stream_handle(y.device)
    ptrs = [t.data_ptr() for t in (y, y, y, y, stat, stat, y)]
    for lanes, stages, smem in ((plan["lanes"], plan["stages"] + 1, plan["smem_bytes"]),
                                (plan["lanes"], plan["stages"], plan["smem_bytes"] + 8),
                                (96, plan["stages"], plan["smem_bytes"])):
        assert lib.dfot_flash_bwd_dq(*ptrs, 2, 128, 128, lanes, stages, smem, 0.1, 0,
                                     stream) == 1  # cudaErrorInvalidValue
    ops.reset_launch_counts()
    with pytest.raises(ValueError):
        z = torch.zeros(1, 2, 128, 96, device=cuda, dtype=torch.bfloat16)
        A.flash_bwd_dq(z, z, z, z, stat, stat)
    with pytest.raises(ValueError):
        A.flash_bwd_dq(y, y, y, y, stat, stat, head_dim=129)
    assert ops.launch_counts()["flash_bwd_dq"] == 0

    x = torch.zeros(1, 64, 3 * 2 * 64, device=cuda, dtype=torch.bfloat16)
    tab = torch.zeros(64, 64, device=cuda, dtype=torch.bfloat16)
    out = torch.zeros(1, 2, 64, 64, device=cuda, dtype=torch.bfloat16)
    for d, dp in ((63, 64), (258, 258), (64, 62)):
        assert lib.dfot_qkv_prep(x.data_ptr(), x.stride(0), x.stride(1), *(tab.data_ptr(),) * 4,
                                 *(out.data_ptr(),) * 3, 1, 64, 2, d, dp, 0, 1e-6,
                                 stream) == 1
    flat = torch.zeros(64 * 3 * 2 * 64 + 1, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        Q.qkv_prep(flat[1:].view(1, 64, 3 * 2 * 64), 2, 64, tab.float(), tab.float())
    assert ops.launch_counts()["qkv_prep"] == 0


@pytest.mark.gpu
def test_attention_at_head_dim_256_launches_the_kernels(cuda):
    """The base-width U-ViT's level-3 attention, (1, 4, 2048, 256): the
    dispatcher's flash route launches B1, and B4 and B5 under grad, by the
    wrappers' counts; a head of 160 takes the padded route (B1 on heads
    padded to 256); d = 320 is the one width no kernel takes."""
    g = torch.Generator(device=cuda).manual_seed(30)
    q, k, v = ((1.7 * torch.randn(1, 4, 2048, 256, generator=g, device=cuda)).to(
        torch.bfloat16).requires_grad_() for _ in range(3))
    do = torch.randn(q.shape, generator=g, device=cuda).to(torch.bfloat16)
    assert A.attention_route(2048, 256) == "flash"
    ops.reset_launch_counts()
    out = A.attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    counts = ops.launch_counts()
    assert (counts["flash_fwd"], counts["flash_bwd_dq"], counts["flash_bwd_dkv"]) == (1, 1, 1)
    want = A.attention(q, k, v, plain=True)
    want_g = torch.autograd.grad(want, (q, k, v), do)
    assert _close(out, want, 1e-2) and _rel_l2(out, want) <= 1e-2
    for a, b in zip(grads, want_g):
        assert _close(a, b, 2e-2) and _rel_l2(a, b) <= 1e-2
    ops.reset_launch_counts()
    x = q.detach()[..., :160].contiguous()
    assert A.attention_route(2048, 160) == "padded_flash"
    assert _close(A.attention(x, x, x), A.attention_reference(x, x, x), 1e-2)
    assert ops.launch_counts()["flash_fwd"] == 1
    wide = torch.zeros(1, 1, 1024, 320, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="no kernel"):
        A.attention(wide, wide, wide)


@pytest.mark.gpu
def test_packed_route_head_dim_256(cuda):
    """attention_from_packed_qkv at the base-width level 3 (4 heads of 256,
    2048 tokens, norm and 3D RoPE): B2 -> B1 -> B3 and back B7 -> B4, B5 -> B6
    against the plain route: output, dqkv and the norm-scale gradients."""
    g = torch.Generator(device=cuda).manual_seed(31)
    B, N, H, d = 1, 2048, 4, 256
    rope = make_rope_3d(d, (8, 16, 16))
    cos = torch.as_tensor(rope.cos, device=cuda)
    sin = torch.as_tensor(Q.signed_sin(rope.sin), device=cuda)
    qkv0 = torch.randn(B, N, 3 * H * d, generator=g, device=cuda).to(torch.bfloat16)
    do = torch.randn(B, N, H * d, generator=g, device=cuda).to(torch.bfloat16)
    results = []
    ops.reset_launch_counts()
    for plain in (False, True):
        qkv = qkv0.clone().requires_grad_()
        scales = [torch.full((d,), 2.0, device=cuda, requires_grad=True) for _ in range(2)]
        tabs = Q.fold_qk_tables(cos, sin, *scales, dtype=torch.float32)
        out = Q.attention_from_packed_qkv(qkv, H, d, tabs, norm=True, plain=plain)
        out.backward(do)
        results.append((out, qkv.grad, scales[0].grad, scales[1].grad))
    for got, want in zip(*results):
        assert _close(got, want, 2e-2)
    counts = ops.launch_counts()
    route = ("qkv_prep", "flash_fwd", "attn_out_collect", "attn_out_scatter", "flash_bwd_dq",
             "flash_bwd_dkv", "qkv_prep_bwd")
    assert all(counts[name] == 1 for name in route), counts


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rel,l2", [(torch.bfloat16, 2e-2, 2e-3), (torch.float32, 2e-5, 1e-5)])
@pytest.mark.parametrize("shape", [(8, 1280, 1152), (8, 1024, 768), (128, 16, 384), (3, 7, 1152),
                                   (1, 5, 384), (3, 7, 896), (2, 3, 1024), (1, 5, 2048),
                                   (2, 5, 1154), (1, 3, 2304)])
def test_ln_modulate_forward_plans(cuda, dtype, rel, l2, shape):
    """B8 against its plain version at the XL, DiT/B and factorized-DiT
    shapes (bf16: width-exact kernel), at token counts that are no multiple
    of a block's tokens (21 and 5), at the other exact widths, at a width
    that is no multiple of the 16-byte vector (1154) and one wider than the
    registers hold (2304), and in fp32 (generic kernels): one launch a call,
    within ``chip_smoke.py``'s bounds (2e-2 of the magnitude and 2e-3
    relative L2 in bf16)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x = (2 * torch.randn(shape, generator=g, device=cuda) + 0.5).to(dtype)
    shift = torch.randn(shape, generator=g, device=cuda).to(dtype)
    scale = (0.3 * torch.randn(shape, generator=g, device=cuda)).to(dtype)
    ops.reset_launch_counts()
    y = L.ln_modulate(x, shift, scale)
    assert ops.launch_counts()["ln_modulate"] == 1
    want = L.reference_ln_modulate(x, shift, scale)
    assert y.dtype == dtype and _close(y, want, rel) and _rel_l2(y, want) <= l2


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("d,dp", [(64, 64), (72, 128), (128, 128), (160, 256), (256, 256)])
@pytest.mark.parametrize("n", [2048, 1000])
def test_attn_out_collect_plans(cuda, B, d, dp, n):
    """B3 is an exact copy at every path head dim, padded or not, at both
    batches and at a token count that is no multiple of any tile; one launch
    a call. A collect that takes the heads in the wrong order is not."""
    g = torch.Generator(device=cuda).manual_seed(12)
    H = 3
    o = torch.randn(B, H, n, dp, generator=g, device=cuda).to(torch.bfloat16)
    ops.reset_launch_counts()
    got = Q.attn_out_collect(o, d)
    assert ops.launch_counts()["attn_out_collect"] == 1
    want = Q.reference_attn_out_collect(o, d)
    assert torch.equal(got, want)
    assert not torch.equal(got, Q.reference_attn_out_collect(o.flip(1), d))


@pytest.mark.gpu
def test_attn_out_collect_rows_wider_than_a_block(cuda):
    """B3 where one token row (5 heads of 2048 lanes) is more than a block's
    loads move at once: a block walks its row in several rounds."""
    o = torch.randn(1, 5, 37, 2048, device=cuda).to(torch.bfloat16)
    assert torch.equal(Q.attn_out_collect(o, 2048), Q.reference_attn_out_collect(o, 2048))


@pytest.mark.gpu
def test_ln_modulate_and_collect_entries_refuse_other_plans(cuda):
    """The C entries of B8 and B3 refuse any plan but their own."""
    from dfot_tpu_torch.ops import _cuda

    lib = _cuda.library()
    stream = _cuda.stream_handle(cuda)
    x = torch.zeros(3, 7, 1152, device=cuda, dtype=torch.bfloat16)
    plan = L.ln_modulate_plan(21, 1152, torch.bfloat16)
    ptrs = [x.data_ptr()] * 4
    for lanes, per_block, grid in ((32, plan["block_tokens"], plan["grid"]),
                                   (plan["lanes"], 4, plan["grid"]),
                                   (plan["lanes"], plan["block_tokens"], plan["grid"] + 1)):
        assert lib.dfot_ln_modulate_fwd(*ptrs, 21, 1152, 1e-6, 0, lanes, per_block, grid,
                                        stream) == 1  # cudaErrorInvalidValue
    o = torch.zeros(1, 2, 1000, 128, device=cuda, dtype=torch.bfloat16)
    out = torch.zeros(1, 1000, 2 * 72, device=cuda, dtype=torch.bfloat16)
    plan = Q.collect_plan(1, 2, 1000, 72, 128)
    for tile, gx in ((plan["tile"] + 1, plan["grid"][0]), (plan["tile"], plan["grid"][0] + 1)):
        assert lib.dfot_attn_out_collect(o.data_ptr(), out.data_ptr(), 1, 2, 1000, 72, 128, tile,
                                         gx, stream) == 1


@pytest.mark.gpu
def test_ln_modulate_bwd_and_scatter_entries_refuse_other_plans(cuda):
    """The C entries of B9 and B7 refuse any plan but their own."""
    from dfot_tpu_torch.ops import _cuda

    lib = _cuda.library()
    stream = _cuda.stream_handle(cuda)
    x = torch.zeros(3, 7, 1152, device=cuda, dtype=torch.bfloat16)
    ptrs = [x.data_ptr()] * 5
    for dtype, is_fp32 in ((torch.bfloat16, 0), (torch.float32, 1)):
        plan = L.ln_modulate_bwd_plan(21, 1152, dtype)
        for lanes, per_block, grid in (
                (plan["lanes"] // 2, plan["block_tokens"], plan["grid"]),
                (plan["lanes"], plan["block_tokens"] * 2, plan["grid"]),
                (plan["lanes"], plan["block_tokens"], plan["grid"] + 1)):
            assert lib.dfot_ln_modulate_bwd(*ptrs, 21, 1152, 1e-6, is_fp32, lanes, per_block,
                                            grid, stream) == 1  # cudaErrorInvalidValue
    g = torch.zeros(1, 1000, 2 * 72, device=cuda, dtype=torch.bfloat16)
    do = torch.zeros(1, 2, 1000, 128, device=cuda, dtype=torch.bfloat16)
    plan = Q.scatter_plan(1, 2, 1000, 72, 128)
    for tile, gx in ((plan["tile"] + 1, plan["grid"][0]), (plan["tile"], plan["grid"][0] + 1),
                     (plan["tile"] // 2, -(-1000 // (plan["tile"] // 2)))):
        assert lib.dfot_attn_out_scatter(g.data_ptr(), do.data_ptr(), 1, 2, 1000, 72, 128, tile,
                                         gx, stream) == 1
    torch.cuda.synchronize()
    assert not do.any()  # nothing was launched


@pytest.mark.gpu
def test_small_rollout_kernel_route(cuda):
    """``predict_videos`` of a narrow flagship U-ViT (heads of 64 and 128,
    64 px, bf16, 2 DDIM steps) over 24 frames from one: 6 keyframes in 2
    sliding windows, then interpolation. The kernel route within 2e-2
    relative L2 of the plain route (``chip_smoke.WINDOW_REL_TOL``), with the
    same weights and random stream; the context frame comes back exactly."""
    import dataclasses

    from dfot_tpu_torch.algorithms.dfot_video import (build_model, flagship,
                                                      sampling_cond_transform)
    from dfot_tpu_torch.diffusion.core import make_schedule
    from dfot_tpu_torch.guidance.history_guidance import HistoryGuidance
    from dfot_tpu_torch.models.uvit import patchify_tokens, unpatchify_tokens
    from dfot_tpu_torch.sampling import DFoTRollout, RolloutConfig
    from dfot_tpu_torch.utils.weights import init_random_weights

    fs = flagship()
    fs = fs._replace(resolution=64, spec=dataclasses.replace(
        fs.spec, channels=(32, 32, 64, 128), emb_channels=64, num_updown_blocks=(1, 1, 1),
        num_mid_blocks=1, num_heads=1))
    dcfg = dataclasses.replace(fs.dcfg, sampling_timesteps=2)
    model = build_model(fs, token_io=True, device=cuda)
    init_random_weights(model, torch.Generator().manual_seed(2))
    model = model.to(torch.bfloat16).eval()
    R, p, n = fs.resolution, fs.spec.patch_size, 24
    ro = DFoTRollout(RolloutConfig(
        max_tokens=8, x_shape=(R, R, 3), external_cond_type="action", keyframe_density=0.25,
        sliding_context_len=4, cond_transform=sampling_cond_transform(model, "ray_encoding"),
        state_codec=(lambda x: patchify_tokens(x, p), lambda x: unpatchify_tokens(x, p, R, R)),
    ), dcfg, make_schedule(dcfg, cuda), model)
    g = torch.Generator(device=cuda).manual_seed(5)
    xs = torch.zeros(1, n, R, R, 3, device=cuda)
    xs[:, 0] = torch.rand(R, R, 3, generator=g, device=cuda) * 2 - 1
    poses = torch.zeros(1, n, 16, device=cuda)
    poses[..., :4] = torch.tensor([1.0, 1.0, 0.5, 0.5], device=cuda)
    poses[..., 4] = poses[..., 9] = poses[..., 14] = 1.0
    poses[..., 7] = torch.linspace(0, 1, n, device=cuda)  # a camera moving along x

    def run():
        return ro.predict_videos(torch.Generator(device=cuda).manual_seed(6), xs, 1,
                                 conditions=poses,
                                 prediction_hg=HistoryGuidance.stabilized_vanilla(4.0, 0.02),
                                 interpolation_hg=HistoryGuidance.vanilla(1.5))

    ops.reset_launch_counts()
    got = run()
    counts = ops.launch_counts()
    assert counts["flash_fwd"] > 0 and counts["flash_fwd"] == counts["attn_out_collect"]
    model.use_plain_attention(True)
    want = run()
    model.use_plain_attention(False)
    assert got.shape == (1, n, R, R, 3) and got.dtype == torch.float32
    assert torch.isfinite(got).all() and torch.equal(got[:, 0], xs[:, 0])
    assert _rel_l2(got, want) <= 2e-2


# the README's RE10K validation at a small size (a U-ViT of two narrow levels
# with heads of 64, 16 px, 3 DDIM steps), as tests/test_torch_port_cli.py runs it
SMALL_CLI = [
    "+name=tiny", "dataset=realestate10k_mini", "algorithm=dfot_video_pose",
    "experiment=video_generation", "@diffusion/continuous", "experiment.tasks=[validation]",
    "++algorithm.tasks.prediction.history_guidance.name=vanilla",
    "++algorithm.tasks.prediction.history_guidance.guidance_scale=4.0",
    "dataset.resolution=16", "++algorithm.backbone.channels=[32,64]",
    "++algorithm.backbone.block_types=[ResBlock,TransformerBlock]",
    "++algorithm.backbone.block_dropouts=[0.0,0.0]", "++algorithm.backbone.num_updown_blocks=[1]",
    "++algorithm.backbone.num_mid_blocks=1", "++algorithm.backbone.num_heads=1",
    "++algorithm.backbone.emb_channels=32", "++algorithm.backbone.use_checkpointing=[false,false]",
    "algorithm.diffusion.sampling_timesteps=3", "experiment.validation.batch_size=2",
    "experiment.validation.limit_batch=1", "++algorithm.logging.metrics=[mse,ssim,psnr]",
    "++algorithm.logging.max_num_videos=0",
]


def _pinned_noise(shape, clip, generator=None, device=None, dtype=torch.float32):
    """The same N(0, 1) draws for a shape on any device (the card's and the
    CPU's generators give different streams)."""
    seed = zlib.crc32(repr(tuple(int(s) for s in shape)).encode())
    x = np.random.default_rng(seed).standard_normal(tuple(shape)).astype(np.float32)
    return torch.as_tensor(x, dtype=dtype, device=device).clamp_(-clip, clip)


@pytest.mark.gpu
def test_cli_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """``python -m dfot_tpu_torch`` (``run(argv)``, the card by default)
    against the same run with ``device="cpu"`` (the plain routes): the same
    checkpoint, bf16 compute on both, noise pinned. Generated frames within
    the route tolerance of chip_smoke.py (2e-2 relative L2), context frames
    exact, B1-B3 launched once per transformer block and forward."""
    from dfot_tpu_torch.__main__ import run
    from dfot_tpu_torch.algorithms.dfot_video import build_algorithm
    from dfot_tpu_torch.config import load_config
    from dfot_tpu_torch.diffusion import core as DC
    from dfot_tpu_torch.utils.weights import init_random_weights

    algo = build_algorithm(load_config(SMALL_CLI), torch.float32, device="cpu")
    init_random_weights(algo.model, torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "fixture.ckpt")
    torch.save({"state_dict": {"diffusion_model.model." + k: v
                               for k, v in algo.model.state_dict().items()}}, ckpt)
    monkeypatch.setattr(DC, "clipped_normal", _pinned_noise)
    argv = SMALL_CLI + [f"load={ckpt}"]
    ops.reset_launch_counts()
    card = run(argv + [f"output_dir={tmp_path / 'card'}"])
    launches = ops.launch_counts()
    host = run(argv + [f"output_dir={tmp_path / 'cpu'}"], device="cpu")
    assert card.algo.device.type == "cuda"
    got, want = card.last_videos["prediction"].cpu(), host.last_videos["prediction"]
    assert torch.equal(got[:, :4], want[:, :4])
    err = (got[:, 4:] - want[:, 4:]).norm() / want[:, 4:].norm()
    assert err <= 2e-2, float(err)
    forwards = 3  # steps; one transformer block
    for name in ("flash_fwd", "qkv_prep", "attn_out_collect"):
        assert launches[name] == forwards, (name, launches)
    assert all(math.isfinite(v) for v in card.last_metrics.values()) and card.last_metrics


def _rel_l2_of(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.gpu
def test_factorized_matrix_dit_routes(cuda):
    """A narrow FacMatDiT (the UCF-101 latent shape, 16 patches a frame,
    spatial heads of 128): its spatial blocks on B8 and B10 (B9 back)
    against the plain route, forward and a spatial block's gradient; the
    matrix blocks launch nothing; a LayerNorm + modulate without its
    normalisation falls outside the bound."""
    from dfot_tpu_torch.models import dit
    from dfot_tpu_torch.utils.weights import init_random_weights

    spec = dit.DiTSpec(hidden_size=256, depth=2, num_heads=2, spatial_mlp_ratio=4.0,
                       variant="factorized_matrix_attention", pos_emb_type="rope_2d",
                       max_temporal_length=16, use_gradient_checkpointing=True,
                       embed_col_dim=16, embed_row_dim=256, num_col_heads=1, num_row_heads=4,
                       matrix_use_bias=True, use_temporal_rope=True)
    with torch.device(cuda):
        model = dit.DiT3D(spec, 32, (8, 8))
    init_random_weights(model, torch.Generator().manual_seed(0))
    model.eval()
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(4, 16, 8, 8, 32, generator=g, device=cuda)
    k = torch.randint(0, 1000, (4, 16), generator=g, device=cuda).float()
    cot = torch.randn(x.shape, generator=g, device=cuda)
    probe = model.dit_base.blocks[0].attn.qkv.weight

    def run(plain=False):
        model.use_plain_kernels(plain)
        model.zero_grad(set_to_none=True)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            out = model(x, k).float()
        (out * cot).mean().backward()
        model.use_plain_kernels(False)
        return out.detach(), probe.grad.clone()

    ops.reset_launch_counts()
    out_k, grad_k = run()
    launches = ops.launch_counts()
    out_p, grad_p = run(plain=True)
    assert _rel_l2_of(out_k, out_p) <= 2e-2
    assert _rel_l2_of(grad_k, grad_p) <= 5e-2
    # each spatial block: B8 twice (with its MLP), B10 once; the final layer
    # B8 once; the checkpointed spatial blocks run again in the backward
    assert launches == {**{n: 0 for n in launches}, "ln_modulate": 5 + 4,
                        "ln_modulate_bwd": 5, "small_n_attn": 2 + 2}, launches
    real = dit.ln_modulate
    dit.ln_modulate = lambda x, shift, scale, eps=None, plain=False: x * (1 + scale) + shift
    try:
        out_c, _ = run()
    finally:
        dit.ln_modulate = real
    assert _rel_l2_of(out_c, out_p) > 2e-2


@pytest.mark.gpu
def test_reconstruction_guided_window_routes(cuda):
    """A narrow flagship (heads of 64 and 128, 64 px) samples a 3-step
    window with reconstruction guidance: each step a forward and a backward
    through B2 -> B1 -> B3 and B7 -> B4, B5 -> B6, against the plain route
    within 2e-2 relative L2; the window without the guidance gradient falls
    outside."""
    import dataclasses

    from dfot_tpu_torch.algorithms.dfot_video import (
        build_model, flagship, sampling_cond_transform,
    )
    from dfot_tpu_torch.diffusion.core import make_schedule
    from dfot_tpu_torch.models.uvit import TransformerBlock, patchify_tokens, unpatchify_tokens
    from dfot_tpu_torch.sampling import DFoTRollout, RolloutConfig
    from dfot_tpu_torch.utils.weights import init_random_weights

    fs = flagship()
    spec = dataclasses.replace(fs.spec, channels=(32, 32, 64, 128), emb_channels=64,
                               num_updown_blocks=(1, 1, 1), num_mid_blocks=1, num_heads=1)
    fs = fs._replace(spec=spec, resolution=64)
    model = build_model(fs, device=cuda)
    init_random_weights(model, torch.Generator().manual_seed(2))
    model = model.to(torch.bfloat16).eval()
    R, T, p = 64, spec.max_temporal_length, spec.patch_size
    pose = torch.zeros(1, T, 16, device=cuda)
    pose[..., :4] = torch.tensor([1.0, 1.0, 0.5, 0.5], device=cuda)
    pose[..., 4] = pose[..., 9] = pose[..., 14] = 1.0
    g = torch.Generator(device=cuda).manual_seed(3)
    ctx = torch.zeros(1, T, R, R, 3, device=cuda)
    ctx[:, 0] = torch.rand(R, R, 3, generator=g, device=cuda) * 2 - 1
    mask = np.zeros((1, T), np.int64)
    mask[:, 0] = 1

    def window(weight):
        dcfg = dataclasses.replace(fs.dcfg, sampling_timesteps=3, reconstruction_guidance=weight)
        ro = DFoTRollout(RolloutConfig(
            max_tokens=T, x_shape=(R, R, 3),
            cond_transform=sampling_cond_transform(model, fs.conditioning_type),
            state_codec=(lambda x: patchify_tokens(x, p), lambda x: unpatchify_tokens(x, p, R, R)),
        ), dcfg, make_schedule(dcfg, cuda), model)
        return ro.sample_sequence(torch.Generator(device=cuda).manual_seed(4), 1, length=T,
                                  context=ctx, context_mask=mask, conditions=pose,
                                  history_guidance=fs.history_guidance)

    ops.reset_launch_counts()
    got = window(10.0)
    launches = ops.launch_counts()
    model.use_plain_attention(True)
    try:
        want = window(10.0)
    finally:
        model.use_plain_attention(False)
    assert torch.isfinite(got).all() and torch.equal(got[:, 0], ctx[:, 0])
    assert _rel_l2_of(got, want) <= 2e-2
    assert _rel_l2_of(window(0.0), want) > 2e-2
    # a step is one batched call (vanilla HG's two evaluations) forward and
    # back, the checkpointed levels' blocks run again in the backward
    levels = [i for name, i in model.block_names()
              if isinstance(model.block(name), TransformerBlock)]
    again = sum(spec.use_checkpointing[i] for i in levels)
    for name in ("flash_fwd", "qkv_prep", "attn_out_collect"):
        assert launches[name] == 3 * (len(levels) + again), (name, launches)
    for name in ("flash_bwd_dq", "flash_bwd_dkv", "qkv_prep_bwd", "attn_out_scatter"):
        assert launches[name] == 3 * len(levels), (name, launches)


# the DMLab DC-AE recipe's DiT3D: 16 latent frames of (8 / 2)^2 patches, 6
# heads of 64, batch 32; its LayerNorm + modulate at C = 384 over 32 x 256 tokens
DMLAB_B, DMLAB_N, DMLAB_H, DMLAB_D = 32, 256, 6, 64


@pytest.mark.gpu
def test_dmlab_site_forward_kernels(cuda):
    """B2 -> B1 -> B3 at the DMLab site on seeded operands, each kernel once,
    against its plain version (tolerances of the module docstring)."""
    g = torch.Generator(device=cuda).manual_seed(14)
    B, N, H, d = DMLAB_B, DMLAB_N, DMLAB_H, DMLAB_D
    qkv = torch.randn(B, N, 3 * H * d, generator=g, device=cuda).to(torch.bfloat16)
    rope = make_rope_3d(d, (16, 4, 4))
    cos = torch.as_tensor(rope.cos, device=cuda)
    sin = torch.as_tensor(Q.signed_sin(rope.sin), device=cuda)
    ops.reset_launch_counts()
    q, k, v = Q.qkv_prep(qkv, H, d, cos, sin)
    o, lse = A.flash_attention(q, k, v, return_lse=True, head_dim=d)
    out = Q.attn_out_collect(o, d)
    counts = ops.launch_counts()
    assert counts["qkv_prep"] == counts["flash_fwd"] == counts["attn_out_collect"] == 1
    for got, want in zip((q, k, v), Q.reference_qkv_prep(qkv, H, d, cos, sin)):
        assert _close(got, want, 2e-2)
    o_ref, lse_ref = A.attention_reference(q, k, v, return_lse=True)
    assert _close(o, o_ref, 1e-2) and (lse - lse_ref).abs().max() <= 1e-3
    assert torch.equal(out, Q.reference_attn_out_collect(o, d))
    assert out.shape == (B, N, H * d)


@pytest.mark.gpu
def test_dmlab_site_ln_modulate(cuda):
    """B8 (and B9 back) at C = 384 over the DMLab batch's 32 x 256 tokens."""
    g = torch.Generator(device=cuda).manual_seed(15)
    shape = (DMLAB_B, DMLAB_N, DMLAB_H * DMLAB_D)
    x = (2 * torch.randn(shape, generator=g, device=cuda) + 0.5).to(torch.bfloat16)
    shift, scale, gy = (torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
                        for _ in range(3))
    ops.reset_launch_counts()
    y = L.ln_modulate(x, shift, scale)
    dx, dscale = L.ln_modulate_bwd(x, scale, gy)
    assert ops.launch_counts()["ln_modulate"] == ops.launch_counts()["ln_modulate_bwd"] == 1
    assert _close(y, L.reference_ln_modulate(x, shift, scale), 2e-2)
    dx_ref, dscale_ref = L.reference_ln_modulate_bwd(x, scale, gy)
    assert _close(dx, dx_ref, 2e-2) and _close(dscale, dscale_ref, 2e-2)


# ---------------------------------------------------------------------------
# the attention routes as torch.library custom ops
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["flash_attention", "small_n_attention", "qkv_prep",
                                "attn_out_collect"])
def test_custom_ops_launch_their_kernels(cuda, op):
    """Each ``dfot::`` op on a CUDA tensor launches its kernel once, forward
    and backward, against its plain version (``plain=True``) on the same
    inputs, at the tolerances above."""
    g = torch.Generator(device=cuda).manual_seed(3)

    def r(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=cuda).to(dtype).requires_grad_()

    if op == "flash_attention":
        args = [r(2, 3, 256, 128) for _ in range(3)] + [False, 1 / math.sqrt(128), 128]
        kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        run = lambda plain: torch.ops.dfot.flash_attention(*args, plain)[0]  # noqa: E731
    elif op == "small_n_attention":
        args = [r(64, 4, 8, 64) for _ in range(3)]
        kernels = ("small_n_attn",)
        run = lambda plain: torch.ops.dfot.small_n_attention(*args, plain)  # noqa: E731
    elif op == "qkv_prep":
        N, H, d = 256, 2, 64
        tabs = [r(N, d, dtype=torch.float32) for _ in range(4)]
        args = [r(2, N, 3 * H * d)] + tabs + [H, d, 128, True, 1e-6]
        kernels = ("qkv_prep", "qkv_prep_bwd")
        run = lambda plain: torch.cat(torch.ops.dfot.qkv_prep(*args, plain), -1)  # noqa: E731
    else:
        args = [r(2, 3, 256, 128), 72]
        kernels = ("attn_out_collect", "attn_out_scatter")
        run = lambda plain: torch.ops.dfot.attn_out_collect(*args, plain)  # noqa: E731
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    grads = {}
    for plain in (True, False):
        ops.reset_launch_counts()
        out = run(plain)
        (out.float() * out.float().detach()).sum().backward()
        counts = ops.launch_counts()
        assert all(counts[k] == (0 if plain else 1) for k in kernels), (plain, counts)
        grads[plain] = [out.detach()] + [t.grad.clone() for t in tensors]
        for t in tensors:
            t.grad = None
    for got, want in zip(grads[False], grads[True]):
        assert _close(got, want, 2e-2)
