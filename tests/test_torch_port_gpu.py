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
"""

import pytest
import torch

from dfot_tpu_torch import ops
from dfot_tpu_torch.models.embeddings import make_rope_3d
from dfot_tpu_torch.ops import attention as A
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
@pytest.mark.parametrize("d,d_in", [(64, 64), (64, 128)])
def test_attn_out_scatter(cuda, d, d_in):
    g = torch.randn(2, 256, 3 * d, device=cuda).to(torch.bfloat16)
    ops.reset_launch_counts()
    got = Q.attn_out_scatter(g, 3, d, d_in)
    assert ops.launch_counts()["attn_out_scatter"] == 1
    assert torch.equal(got, Q.reference_attn_out_scatter(g, 3, d, d_in))


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
    assert all(n >= 1 for n in counts.values()), counts


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
