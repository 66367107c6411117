"""The tile plan of the wgmma flash-attention kernels B1, B4 and B5, and the
work count their bounds are taken from, on the CPU.

``ops/attention.py:flash_plan`` is what the wrappers pass to the C entries
(which refuse any other plan), so it is checked here where no card is
needed: shared memory within one H100 block's 227 KB and k-steps at the true
head dim at every shape the paths give the kernels. ``chip_smoke.py`` counts
attention's operations at the true head dim, not at the padded width.
"""

import math
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from dfot_tpu_torch.ops import attention as A  # noqa: E402

# (what, batch * heads, tokens, padded head dim, true head dim) of every
# flash-attention call on the paths: the flagship's levels 2 and 3 in the
# window (B * NFE = 2) and the train step (B = 1), its axial blocks' spatial
# attention (a frame's tokens, B * T items), K600 @DiT/XL at batch 8, the
# base-width UViT3DPose's levels 2 and 3 (4 heads of 128 and 256) and its
# axial level 3, and a head of 160 padded to 256
MAIN_SHAPES = (
    ("flagship level 2, window", 2 * 9, 8192, 64, 64),
    ("flagship level 3, window", 2 * 9, 2048, 128, 128),
    ("flagship level 2, train", 9, 8192, 64, 64),
    ("flagship level 3, train", 9, 2048, 128, 128),
    ("axial level 2", 2 * 8 * 9, 1024, 64, 64),
    ("axial level 3", 2 * 8 * 9, 256, 128, 128),
    ("K600 @DiT/XL", 8 * 16, 1280, 128, 72),
    ("base level 2, window", 2 * 4, 8192, 128, 128),
    ("base level 3, window", 2 * 4, 2048, 256, 256),
    ("base level 3, train", 4, 2048, 256, 256),
    ("base axial level 3", 2 * 8 * 4, 256, 256, 256),
    ("head dim 160", 4, 2048, 256, 160),
)


@pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
@pytest.mark.parametrize("what,bh,n,d,head_dim", MAIN_SHAPES)
def test_plan_fits_and_contracts_over_the_true_head_dim(kernel, what, bh, n, d, head_dim):
    plan = A.flash_plan(kernel, bh, n, d, head_dim)
    assert plan["smem_bytes"] <= A.SMEM_PER_BLOCK == 227 * 1024
    # the lanes: the true head dim rounded up to 16 where a kernel for that
    # width is compiled (80 of 128), else to the next compiled width (192 or
    # 256 of 256)
    assert plan["lanes"] == min(w for w in A.FLASH_LANES[d] if w >= head_dim) <= d
    assert plan["k_steps"] == plan["lanes"] // 16 >= math.ceil(head_dim / 16)
    assert 2 <= plan["stages"] <= A.FLASH_MAX_STAGES
    block = {"fwd": 128, "dq": 128, "dkv": A.FLASH_DKV_KEYS[d]}[kernel]
    assert plan["block_rows"] == block and plan["grid"] == (math.ceil(n / block), bh)
    rows = {"fwd": A.FLASH_FWD_KEYS[d], "dkv": 64, "dq": A.FLASH_DQ_KEYS[d]}[kernel]
    assert plan["tile_rows"] == rows
    # the tiles a block holds, at 2 bytes a lane, and 1 KB of alignment slack:
    # B1 Q and K/V stages, B5 K, V and Q/dO/LSE/delta stages, B4 Q, dO and
    # K/V stages
    tiles = {
        "fwd": 128 * d * 2 + plan["stages"] * 2 * rows * d * 2,
        "dkv": 2 * block * d * 2 + plan["stages"] * (2 * 64 * d * 2 + 2 * 64 * 4),
        "dq": 2 * 128 * d * 2 + plan["stages"] * 2 * rows * d * 2,
    }[kernel]
    assert plan["smem_bytes"] == 1024 + tiles + 8 * (1 + 2 * plan["stages"])


# a ring hop's shapes: a LocalRing of R = 2 and 4 at the flagship's two
# attention sites (B * NFE = 2), R B H heads of N / R rows
RING_SHAPES = tuple(
    (f"flagship level {lvl}, ring of {R}", R * 2 * 9, n // R, d, d)
    for lvl, n, d in ((2, 8192, 64), (3, 2048, 128)) for R in (2, 4))


@pytest.mark.parametrize("ring_kernel,kernel", sorted(A.RING_PLAN_OF.items()))
@pytest.mark.parametrize("what,bh,n,d,head_dim", MAIN_SHAPES + RING_SHAPES)
def test_ring_entries_take_their_kernels_plan(ring_kernel, kernel, what, bh, n, d, head_dim):
    """The ring hops' C entries (dfot_ring_fwd, dfot_ring_bwd_dq,
    dfot_ring_bwd_dkv) instantiate B1, B4 and B5 with another epilogue and
    head index and refuse any plan but theirs: the same tiles, stages and
    shared memory at every shape, the ring's own included."""
    plan = A.flash_plan(ring_kernel, bh, n, d, head_dim)
    assert plan == A.flash_plan(kernel, bh, n, d, head_dim)
    assert plan["smem_bytes"] <= A.SMEM_PER_BLOCK


# the plans the C entries are compiled for (flash_fwd.cu, flash_bwd.cu): the
# d <= 128 ones as before the kernels took d = 256, and the d = 256 ones
COMPILED_PLANS = [
    ("fwd", 64, 128, 4), ("fwd", 128, 128, 3), ("fwd", 256, 64, 2),
    ("dq", 64, 128, 4), ("dq", 128, 64, 4), ("dq", 256, 32, 3),
    ("dkv", 64, 64, 4), ("dkv", 128, 64, 4), ("dkv", 256, 64, 2),
]


@pytest.mark.parametrize("kernel,d,tile_rows,stages", COMPILED_PLANS)
def test_plan_is_the_compiled_one(kernel, d, tile_rows, stages):
    plan = A.flash_plan(kernel, 8, 2048, d)
    assert (plan["tile_rows"], plan["stages"]) == (tile_rows, stages)
    # B5 at d = 256: 64 keys a block (two consumers sharing them), so the
    # base-width train step's 4 heads of 2048 tokens give 128 blocks
    assert plan["block_rows"] == (64 if (kernel, d) == ("dkv", 256) else 128)


@pytest.mark.parametrize("d,head_dim,lanes", [(64, 64, 64), (64, 40, 64), (128, 72, 80),
                                              (128, 80, 80), (128, 96, 128), (128, 128, 128),
                                              (256, 129, 192), (256, 160, 192), (256, 192, 192),
                                              (256, 200, 256), (256, 256, 256),
                                              (320, 320, 320), (320, 288, 288), (384, 300, 304),
                                              (512, 512, 512), (1152, 1152, 1152)])
def test_plan_rounds_the_head_dim_up_to_a_compiled_width(d, head_dim, lanes):
    """Only the true head dim rounded up to 16 is computed where a kernel
    for that width is compiled (80 at d = 128); other widths take the next
    compiled one (192 or 256 at d = 256), whose extra lanes are zero and
    inert. The wide family above 256 computes the true head dim rounded up
    to 16 at every width (288 of 320)."""
    assert A.flash_plan("fwd", 1, 192, d, head_dim)["lanes"] == lanes
    assert A.flash_plan("dkv", 1, 192, d, head_dim)["lanes"] == lanes
    assert A.flash_plan("dq", 1, 192, d, head_dim)["lanes"] == lanes


@pytest.mark.parametrize("kernel,d,head_dim", [("fwd", 96, 96), ("fwd", 128, 0),
                                               ("ring_fwd", 96, 96), ("ring_dkv", 320, 352),
                                               ("ring", 64, 64),
                                               ("dkv", 64, 72), ("bwd", 64, 64),
                                               ("dq", 96, 96), ("dq", 64, 72), ("dq", 128, 0),
                                               ("dq", 192, 192), ("fwd", 352, 352),
                                               ("dkv", 256, 257), ("ring_dkv", 320, 321)])
def test_plan_refuses_what_no_kernel_takes(kernel, d, head_dim):
    with pytest.raises(ValueError):
        A.flash_plan(kernel, 1, 128, d, head_dim)


def test_flash_attention_checks_the_true_head_dim():
    q = torch.zeros(1, 1, 64, 128)
    with pytest.raises(ValueError, match="head_dim"):
        A.flash_attention(q, q, q, head_dim=129)
    assert torch.equal(A.flash_attention(q, q, q, head_dim=72), q)


def test_attention_ops_at_the_true_head_dim():
    """The XL site's bound counts 72 lanes, not the 128 its heads are padded
    to: 4 B H N^2 72 = 60.4 GFLOP for the forward."""
    B, H, N = chip_smoke.XL_BATCH, chip_smoke.XL_SITE[1], chip_smoke.XL_SITE[0]
    assert chip_smoke.XL_SITE[2:] == (72, 128)
    assert chip_smoke.attention_ops(B, H, N, 72) == 4 * B * H * N**2 * 72 == 60_397_977_600
    # causal: the pairs at or below the diagonal
    assert chip_smoke.attention_ops(1, 1, 4, 8, causal=True) == 4 * 10 * 8
