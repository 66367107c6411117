"""The plans of kernels B10 (small-N attention) and B6 (qkv_prep backward),
on the CPU.

``ops/attention.py:small_n_plan`` and ``ops/qkv_prep.py:prep_bwd_plan`` are
what the wrappers pass to the C entries, which compute the plan again and
refuse any other; so the plans are checked here, where no card is needed:
every item (B10) or token, stream and (batch, head) item (B6) is covered
exactly once, the shared memory fits one H100 block (and the blocks an SM is
planned to hold fit the SM), and the grid gives every SM a block at the
shapes the paths give the kernels. The constants the C sources compute the
plans from are read from the sources and held against the Python ones.
"""

import math
import re
from pathlib import Path

import pytest
import torch

from dfot_tpu_torch.ops import attention as A
from dfot_tpu_torch.ops import qkv_prep as Q

CSRC = Path(A.__file__).resolve().parent.parent / "csrc"

# (what, items Z = B * H, N, d) of every B10 call on the paths: the axial
# U-ViT's temporal attention at levels 2 and 3 (window batch 2) and at the
# base widths' level 3, the factorized DiT's temporal and spatial attention,
# five latent frames, and the longest rows at every head dim
SMALL_N_SHAPES = (
    ("axial level 2", 2 * 1024 * 9, 8, 64),
    ("axial level 3", 2 * 256 * 9, 8, 128),
    ("base axial level 3", 2 * 256 * 4, 8, 256),
    ("factorized temporal", 8 * 16 * 6, 16, 64),
    ("factorized spatial", 8 * 16 * 6, 16, 64),
    ("five frames", 8 * 256 * 6, 5, 64),
    ("rows 32, d 64", 768, 32, 64),
    ("rows 32, d 128", 768, 32, 128),
    ("rows 32, d 256", 768, 32, 256),
)

# (what, B, N, H, d, dp) of every B6 call on the paths: the flagship's levels
# 2 and 3 in the train step, K600 @DiT/XL at batch 8 (72 -> 128), the base
# widths' levels 2 and 3, a head of 160 padded to 256, a tail shape
PREP_SHAPES = (
    ("flagship level 2", 1, 8192, 9, 64, 64),
    ("flagship level 3", 1, 2048, 9, 128, 128),
    ("K600 @DiT/XL", 8, 1280, 16, 72, 128),
    ("base level 2", 1, 8192, 4, 128, 128),
    ("base level 3", 1, 2048, 4, 256, 256),
    ("base level 3, B = 2", 2, 2048, 4, 256, 256),
    ("head dim 160", 1, 2048, 4, 160, 256),
    ("tail", 3, 1000, 9, 64, 64),
)


def _constants(source: str) -> dict:
    text = (CSRC / source).read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("what,items,n,d", SMALL_N_SHAPES)
def test_small_n_plan_covers_every_item_once_and_fits(what, items, n, d, dtype):
    plan = A.small_n_plan(items, n, d, dtype)
    ipb, grid = plan["items_per_stage"], plan["grid"]
    # the persistent grid: block b walks the groups b, b + grid, ...
    groups = math.ceil(items / ipb)
    walked = sorted(g for b in range(grid) for g in range(b, groups, grid))
    assert walked == list(range(groups))
    covered = [i for g in walked for i in range(g * ipb, min((g + 1) * ipb, items))]
    assert covered == list(range(items))
    if dtype == torch.bfloat16:
        # a warp an item's 16 query rows: the item's warps hold its n rows
        assert plan["warps"] == ipb * plan["units"] <= A.SMALL_N_MAX_WARPS
        assert 16 * (plan["units"] - 1) < n <= 16 * plan["units"]
    else:
        assert plan["warps"] == A.SMALL_N_WARPS_FP32
    # q, k, v rows of 16-byte padded width in each stage; fp32 adds the scores
    es = 2 if dtype == torch.bfloat16 else 4
    stage = ipb * 3 * n * (d * es + A.SMALL_N_ROW_PAD)
    scores = 0 if dtype == torch.bfloat16 else math.ceil(ipb * n * (n + 1) * 4 / 16) * 16
    assert plan["smem_bytes"] == scores + plan["stages"] * stage
    assert 2 <= plan["stages"] <= A.SMALL_N_MAX_STAGES
    assert plan["smem_bytes"] <= A.SMEM_PER_BLOCK == 227 * 1024
    per_sm = plan["blocks_per_sm"]
    assert per_sm * (plan["smem_bytes"] + A.SMEM_BLOCK_RESERVE) <= A.SMEM_PER_SM
    # every SM gets a block where there are groups enough
    assert grid == min(groups, per_sm * A.SM_COUNT) and grid >= min(groups, A.SM_COUNT)


def test_small_n_plan_at_the_path_shapes():
    """The bf16 plans the paths run: four items a stage (two for rows of 32)
    and 4 blocks an SM for the axial shapes; an item of 32 x 256 shares its
    block with a second one."""
    plan = A.small_n_plan(2 * 1024 * 9, 8, 64, torch.bfloat16)
    assert (plan["warps"], plan["items_per_stage"], plan["stages"], plan["blocks_per_sm"]) == (
        4, 4, 4, 4)
    assert plan["grid"] == 4 * A.SM_COUNT
    plan = A.small_n_plan(768, 32, 256, torch.bfloat16)
    assert (plan["units"], plan["warps"], plan["items_per_stage"]) == (2, 4, 2)


@pytest.mark.parametrize("items,n,d,dtype", [(0, 8, 64, torch.bfloat16), (8, 0, 64, torch.bfloat16),
                                             (8, 33, 64, torch.bfloat16), (8, 8, 72, torch.float32),
                                             (8, 8, 320, torch.bfloat16), (8, 8, 0, torch.float32)])
def test_small_n_plan_refuses_what_the_kernel_refuses(items, n, d, dtype):
    with pytest.raises(ValueError):
        A.small_n_plan(items, n, d, dtype)


def test_small_n_plan_refuses_other_types():
    with pytest.raises(TypeError):
        A.small_n_plan(8, 8, 64, torch.float16)


@pytest.mark.parametrize("chunk", [8, 2])
@pytest.mark.parametrize("what,B,N,H,d,dp", PREP_SHAPES)
def test_prep_bwd_plan_covers_every_token_stream_and_item_once(what, B, N, H, d, dp, chunk):
    plan = Q.prep_bwd_plan(B, N, H, d, dp, chunk)
    tile, lanes, groups = plan["tile"], plan["lanes"], plan["groups"]
    # tiles of tokens: every token once
    assert plan["tiles"] == math.ceil(N / tile)
    tokens = [t for i in range(plan["tiles"]) for t in range(i * tile, min((i + 1) * tile, N))]
    assert tokens == list(range(N))
    # a block for each (tile, stream) of q and k; the v copy is split between
    # the two by the parity of the item
    assert plan["grid"] == 2 * plan["tiles"]
    items = range(B * H)
    even, odd = [i for i in items if i % 2 == 0], [i for i in items if i % 2 == 1]
    assert sorted(even + odd) == list(items)
    # the block's threads: groups x tile rows x lanes, and a row's chunks in its lanes
    assert groups * tile * lanes == Q.PREP_BWD_THREADS
    per_lane = 1 if chunk == 8 else 4
    assert lanes * chunk * per_lane >= d and lanes & (lanes - 1) == 0 and lanes <= 32
    # the (batch, head) items: item i to group i % groups in round i // groups
    assignment = sorted((r * groups + g) for g in range(groups) for r in range(plan["rounds"])
                        if r * groups + g < B * H)
    assert assignment == list(items)
    # the lanes' rings, 48 KB, hold the groups' partials at the end
    assert plan["stages"] == Q.PREP_BWD_STAGES
    assert plan["smem_bytes"] == Q.PREP_BWD_STAGES * Q.PREP_BWD_STAGE_BYTES == 48 * 1024
    assert 2 * groups * tile * d * 4 <= plan["smem_bytes"]
    assert Q.PREP_BWD_BLOCKS_PER_SM * (plan["smem_bytes"] + 1024) <= 228 * 1024


@pytest.mark.parametrize("what,B,N,H,d,dp", PREP_SHAPES[:-1])
def test_prep_bwd_plan_fills_the_card_at_the_path_shapes(what, B, N, H, d, dp):
    plan = Q.prep_bwd_plan(B, N, H, d, dp)
    assert plan["grid"] >= Q.PREP_BWD_BLOCKS_PER_SM * Q.SM_COUNT
    # the largest tile that does, in a block of 256 threads
    if plan["tile"] < 32 and 2 * plan["tile"] * plan["lanes"] <= Q.PREP_BWD_THREADS:
        assert 2 * math.ceil(N / (2 * plan["tile"])) < Q.PREP_BWD_BLOCKS_PER_SM * Q.SM_COUNT


def test_prep_bwd_plan_at_the_xl_and_flagship_shapes():
    """K600 @DiT/XL: tiles of 4 tokens, 16 lanes a row of 72 lanes (9 chunks),
    4 groups of 32 items; the flagship's level 2: tiles of 32 tokens."""
    xl = Q.prep_bwd_plan(8, 1280, 16, 72, 128)
    assert (xl["tile"], xl["lanes"], xl["groups"], xl["rounds"], xl["grid"]) == (4, 16, 4, 32, 640)
    f2 = Q.prep_bwd_plan(1, 8192, 9, 64, 64)
    assert (f2["tile"], f2["lanes"], f2["groups"], f2["grid"]) == (32, 8, 1, 512)


@pytest.mark.parametrize("B,N,H,d,dp,chunk", [(1, 64, 1, 64, 64, 4), (1, 64, 1, 63, 64, 2),
                                              (1, 64, 1, 258, 258, 2), (1, 64, 1, 64, 32, 8),
                                              (1, 64, 1, 36, 36, 8), (0, 64, 1, 64, 64, 8),
                                              (1, 0, 1, 64, 64, 8), (1, 64, 1, 64, 68, 8)])
def test_prep_bwd_plan_refuses_what_the_kernel_refuses(B, N, H, d, dp, chunk):
    with pytest.raises(ValueError):
        Q.prep_bwd_plan(B, N, H, d, dp, chunk)


def test_the_c_sources_plan_with_the_same_constants():
    """The constants each C entry computes its plan from are the Python
    plans' own."""
    b10 = _constants("small_n_attn.cu")
    assert (b10["kMaxN"], b10["kMaxWarps"], b10["kWarpsFp32"], b10["kMaxItemsFp32"],
            b10["kMaxStages"], b10["kRowPad"], b10["kSmCount"], b10["kSmemPerSm"],
            b10["kSmemPerBlock"], b10["kBlockReserve"]) == (
        A.SMALL_N_MAX, A.SMALL_N_MAX_WARPS, A.SMALL_N_WARPS_FP32, A.SMALL_N_MAX_ITEMS_FP32,
        A.SMALL_N_MAX_STAGES, A.SMALL_N_ROW_PAD, A.SM_COUNT, A.SMEM_PER_SM,
        A.SMEM_PER_BLOCK, A.SMEM_BLOCK_RESERVE)
    b6 = _constants("qkv_prep_bwd.cu")
    assert (b6["kThreads"], b6["kStages"], b6["kSmCount"], b6["kBlocksPerSm"]) == (
        Q.PREP_BWD_THREADS, Q.PREP_BWD_STAGES, Q.SM_COUNT, Q.PREP_BWD_BLOCKS_PER_SM)
