"""The plans of kernels B10 (small-N attention), B6 (qkv_prep backward), B8
and B9 (ln_modulate forward and backward), B3 (attn_out_collect) and B7
(attn_out_scatter), on the CPU.

``ops/attention.py:small_n_plan``, ``ops/qkv_prep.py:prep_bwd_plan``,
``ops/ln_modulate.py:ln_modulate_plan`` and ``ln_modulate_bwd_plan``, and
``ops/qkv_prep.py:collect_plan`` and ``scatter_plan`` are what the wrappers
pass to the C entries, which compute the plan again and refuse any other; so
the plans are checked here, where no card is needed: every item (B10), token,
stream and (batch, head) item (B6), token (B8, B9), (batch, head, token
tile) item (B3) or (batch, token, head, lane) (B7) is covered exactly once,
the shared memory fits one H100 block (and the blocks an SM is planned to
hold fit the SM), and the grid gives every SM a block at the shapes the paths
give the kernels. The constants the C sources compute the plans from are
read from the sources and held against the Python ones.
"""

import math
import re
from pathlib import Path

import pytest
import torch

from dfot_tpu_torch.ops import attention as A
from dfot_tpu_torch.ops import ln_modulate as L
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


# (what, tokens, C) of every B8 call on the paths: K600 @DiT/XL at batch 8,
# DiT/B's widths, the factorized DiT's spatial view (B * T, P, C)
LN_SHAPES = (
    ("K600 @DiT/XL", 8 * 1280, 1152),
    ("DiT/B", 8 * 1024, 768),
    ("factorized DiT", 128 * 16, 384),
)

# (what, B, H, N, d, dp) of every B3 call on the paths and its tails: the
# flagship's levels 2 and 3 at the window's batch and the train step's, K600
# @DiT/XL (72 -> 128), the base widths' level 3 at B = 1 and 2, a head of 160
# padded to 256, and N = 1000 (no multiple of any tile)
COLLECT_SHAPES = (
    ("flagship level 2", 2, 9, 8192, 64, 64),
    ("flagship level 3", 2, 9, 2048, 128, 128),
    ("flagship level 2, B = 1", 1, 9, 8192, 64, 64),
    ("K600 @DiT/XL", 8, 16, 1280, 72, 128),
    ("base level 3", 2, 4, 2048, 256, 256),
    ("base level 3, B = 1", 1, 4, 2048, 256, 256),
    ("head dim 160", 1, 4, 2048, 160, 256),
    ("tail, d 72", 1, 3, 1000, 72, 128),
    ("tail, d 160", 2, 4, 1000, 160, 256),
    ("tail, d 256", 1, 2, 1000, 256, 256),
    ("token rows wider than a block's loads", 1, 5, 37, 2048, 2048),
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
    # the wide entry's two path sites, whole items a stage and the head dealt
    # one 64-lane chunk a warp: the base axial U-ViT's level 3 at 2 heads of
    # 512 (8 warps an item, 4 blocks an SM, a block for every item up to
    # 528) and the factorized DiT at one head of 384 (6 warps, a block for
    # each of the 128 items)
    plan = A.small_n_plan(2 * 256 * 2, 8, 512, torch.bfloat16)
    assert plan["wide"] and plan["whole"]
    assert (plan["parts"], plan["warps"], plan["items_per_stage"], plan["stages"],
            plan["stage_bytes"], plan["blocks_per_sm"], plan["grid"]) == (
        8, 8, 1, 2, 3 * 8 * (512 * 2 + 16), 4, 4 * A.SM_COUNT)
    plan = A.small_n_plan(8 * 16, 16, 384, torch.bfloat16)
    assert plan["wide"] and plan["whole"]
    assert (plan["parts"], plan["warps"], plan["items_per_stage"], plan["stages"],
            plan["blocks_per_sm"], plan["grid"]) == (6, 6, 1, 2, 2, 128)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("items", [1, 7, 128, 1000, 70000])
def test_small_n_wide_plans_cover_every_item_and_fill_the_card(items, dtype):
    """B10's wide entry at every N from 1 to 32 and every head dim from 320 to
    2048: the grid walks every item once (a group of ``items_per_stage`` a
    stage) and covers a wave of SMs where the items allow; the shared memory
    fits a block and the blocks an SM; whole items where two stages of one
    fit a block, else the chunked ring; in bf16 whole items each 16-row unit
    deals its 64-lane chunks over ``parts`` warps, each chunk to one warp,
    at most 8 warps a block, the warps' partial scores beside the ring."""
    es = 2 if dtype == torch.bfloat16 else 4
    for n in range(1, 33):
        for d in range(320, 2049, 64):
            plan = A.small_n_plan(items, n, d, dtype)
            ipb, grid = plan["items_per_stage"], plan["grid"]
            groups = math.ceil(items / ipb)
            walked = sorted(g for b in range(grid) for g in range(b, groups, grid))
            assert walked == list(range(groups))
            assert grid >= min(items, A.SM_COUNT)
            assert plan["smem_bytes"] <= A.SMEM_PER_BLOCK
            assert plan["blocks_per_sm"] * (plan["smem_bytes"] + A.SMEM_BLOCK_RESERVE) <= (
                A.SMEM_PER_SM)
            assert 2 <= plan["stages"] <= A.SMALL_N_MAX_STAGES
            whole = 3 * n * (d * es + A.SMALL_N_ROW_PAD)
            chunk = 2 * n * (64 * es + A.SMALL_N_ROW_PAD)
            scores = 0 if dtype == torch.bfloat16 else math.ceil(ipb * n * (n + 1) * 4 / 16) * 16
            if plan["whole"] and dtype == torch.bfloat16:
                units, parts, chunks = plan["units"], plan["parts"], d // 64
                assert ipb == 1 and 16 * (units - 1) < n <= 16 * units
                assert plan["warps"] == units * parts <= A.SMALL_N_WIDE_WARPS
                dealt = sorted(c for part in range(parts) for c in range(part, chunks, parts))
                assert dealt == list(range(chunks))
                # the fewest chunks a warp that the warps allow
                per = math.ceil(chunks / parts)
                assert per == math.ceil(chunks / (A.SMALL_N_WIDE_WARPS // units))
                tiles = 1 if n <= 8 else 2 if n <= 16 else 4
                scores = plan["warps"] * tiles * 4 * 32 * 4
            assert plan["stage_bytes"] == ipb * (whole if plan["whole"] else chunk)
            assert plan["smem_bytes"] == scores + plan["stages"] * plan["stage_bytes"]
            # whole items exactly where two stages of one (and the scores) fit
            if dtype == torch.bfloat16:
                units = 1 if n <= 16 else 2
                most = A.SMALL_N_WIDE_WARPS // units
                per = math.ceil((d // 64) / most)
                warps = units * math.ceil((d // 64) / per)
                fits = warps * (1 if n <= 8 else 2 if n <= 16 else 4) * 512 + 2 * whole <= (
                    A.SMEM_PER_BLOCK)
            else:
                fits = math.ceil(n * (n + 1) * 4 / 16) * 16 + 2 * whole <= A.SMEM_PER_BLOCK
            assert plan["whole"] == fits, (n, d)


@pytest.mark.parametrize("items,n,d,dtype", [(0, 8, 64, torch.bfloat16), (8, 0, 64, torch.bfloat16),
                                             (8, 33, 64, torch.bfloat16), (8, 8, 72, torch.float32),
                                             (8, 8, 352, torch.bfloat16), (8, 8, 0, torch.float32)])
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
                                              (1, 64, 1, 1282, 1282, 2), (1, 64, 1, 64, 32, 8),
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
            b10["kSmemPerBlock"], b10["kBlockReserve"], b10["kChunk"], b10["kWideWarps"]) == (
        A.SMALL_N_MAX, A.SMALL_N_MAX_WARPS, A.SMALL_N_WARPS_FP32, A.SMALL_N_MAX_ITEMS_FP32,
        A.SMALL_N_MAX_STAGES, A.SMALL_N_ROW_PAD, A.SM_COUNT, A.SMEM_PER_SM,
        A.SMEM_PER_BLOCK, A.SMEM_BLOCK_RESERVE, A.SMALL_N_CHUNK, A.SMALL_N_WIDE_WARPS)
    b6 = _constants("qkv_prep_bwd.cu")
    assert (b6["kThreads"], b6["kStages"], b6["kSmCount"], b6["kBlocksPerSm"]) == (
        Q.PREP_BWD_THREADS, Q.PREP_BWD_STAGES, Q.SM_COUNT, Q.PREP_BWD_BLOCKS_PER_SM)
    # the widest heads B2 and B6 take, B6's wide plan, and the wide flash
    # family's plan (csrc/flash_wide.cu:make_plan against flash_plan)
    assert (b6["kWideStages"], b6["kWideBlocksPerSm"], b6["kMaxHeadDim"]) == (
        Q.PREP_BWD_WIDE_STAGES, Q.PREP_BWD_WIDE_BLOCKS_PER_SM, Q.PREP_MAX_HEAD_DIM)
    assert _constants("qkv_prep.cu")["kMaxHeadDim"] == Q.PREP_MAX_HEAD_DIM
    wide = _constants("flash_wide.cu")
    assert (wide["kRows"], wide["kMaxStages"], wide["kSmemPerBlock"], wide["kBarrier"],
            wide["kSmCount"]) == (A.FLASH_WIDE_ROWS, A.FLASH_WIDE_MAX_STAGES, A.SMEM_PER_BLOCK,
                                  8, A.SM_COUNT)
    # the slices (512 lanes; B4's and B5's 256 where those fill the card),
    # stages of up to 8 atoms, the two consumers' score tiles
    assert (wide["kSliceAtoms"] * 64, wide["kSmallSliceAtoms"] * 64, wide["kStageAtoms"],
            wide["kExchangeBytes"]) == (A.FLASH_WIDE_SLICE, A.FLASH_WIDE_SMALL_SLICE,
                                        A.FLASH_WIDE_STAGE_ATOMS, A.FLASH_WIDE_EXCHANGE_BYTES)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tokens,C", [(10240, 1152), (8192, 768), (2048, 384), (1001, 1152),
                                      (7, 896), (5, 2048), (3, 1154), (3, 2304), (1, 2)])
def test_ln_modulate_plan_covers_every_token_once(tokens, C, dtype):
    plan = L.ln_modulate_plan(tokens, C, dtype)
    lanes, per_block = plan["lanes"], plan["block_tokens"]
    # block b owns the tokens b * per_block + (thread / lanes): every token
    # once, the last block's surplus groups store nothing
    assert per_block * lanes == plan["threads"] == L.LN_THREADS
    owned = [b * per_block + t // lanes for b in range(plan["grid"])
             for t in range(0, plan["threads"], lanes)]
    assert [t for t in owned if t < tokens] == list(range(tokens))
    assert plan["grid"] == math.ceil(tokens / per_block)
    if plan["kernel"] == "exact":
        # width-exact: every lane holds the same whole number of the row's vectors
        assert dtype == torch.bfloat16 and C in L.LN_EXACT_WIDTHS
        assert lanes * plan["vectors"] * 8 == C and lanes & (lanes - 1) == 0
        assert lanes <= L.LN_MAX_LANES and (lanes == L.LN_MAX_LANES or (C // 8) % (2 * lanes))
    else:
        # a warp a token: the row in registers where it is a whole number of
        # 16-byte vectors up to 2048 wide, else in pairs
        vec = 8 if dtype == torch.bfloat16 else 4
        assert lanes == 32 and plan["vectors"] is None
        regs = C % vec == 0 and C <= L.LN_MAX_REG_WIDTH
        assert plan["kernel"] == ("registers" if regs else "pairs")


@pytest.mark.parametrize("what,tokens,C", LN_SHAPES)
def test_ln_modulate_plan_fills_the_card_at_the_path_shapes(what, tokens, C):
    plan = L.ln_modulate_plan(tokens, C, torch.bfloat16)
    assert plan["kernel"] == "exact" and plan["grid"] >= A.SM_COUNT


def test_ln_modulate_plan_at_the_path_widths():
    """K600 @DiT/XL: 16 lanes of 9 vectors a token (1152 = 16 x 9 x 8), 8
    tokens a block; DiT/B: 32 lanes of 3; the factorized DiT: 16 lanes of 3."""
    got = {C: L.ln_modulate_plan(tokens, C, torch.bfloat16) for _, tokens, C in LN_SHAPES}
    assert {C: (p["lanes"], p["vectors"], p["block_tokens"], p["grid"]) for C, p in got.items()} == {
        1152: (16, 9, 8, 1280), 768: (32, 3, 4, 2048), 384: (16, 3, 8, 256)}
    assert L.ln_modulate_plan(10240, 1152, torch.float32)["kernel"] == "registers"


@pytest.mark.parametrize("tokens,C,dtype,error", [
    (0, 768, torch.bfloat16, ValueError), (8, 0, torch.bfloat16, ValueError),
    (8, 767, torch.bfloat16, ValueError), (8, 768, torch.float16, TypeError),
    (4 * 2 ** 31, 768, torch.bfloat16, ValueError)])
def test_ln_modulate_plan_refuses_what_the_kernel_refuses(tokens, C, dtype, error):
    with pytest.raises(error):
        L.ln_modulate_plan(tokens, C, dtype)


@pytest.mark.parametrize("what,B,H,N,d,dp", COLLECT_SHAPES)
def test_collect_plan_covers_every_item_once(what, B, H, N, d, dp):
    plan = Q.collect_plan(B, H, N, d, dp)
    tile, (gx, gy) = plan["tile"], plan["grid"]
    assert gy == B and gx == math.ceil(N / tile) and 1 <= tile <= N
    # block (x, b) copies all heads of tokens x * tile .. of batch entry b
    items = sorted((b, h, t) for b in range(gy) for x in range(gx) for h in range(H)
                   for t in range(x * tile, min((x + 1) * tile, N)))
    assert items == [(b, h, t) for b in range(B) for h in range(H) for t in range(N)]
    # a thread walks the block's output run (token, head, vector) in steps of
    # the block's threads, carrying the three indices forward: the walk
    # lands where a division would
    d8, threads = d // 8, plan["threads"]
    row = H * d8

    def split(i):
        return i // row, i % row // d8, i % row % d8

    step = split(threads)
    for i in (0, 1, threads - 1):
        t, h, p = split(i)
        for k in range(2 * Q.COLLECT_VEC_PER_THREAD + 1):
            assert (t, h, p) == split(i + k * threads)
            t, h, p = t + step[0], h + step[1], p + step[2]
            if p >= d8:
                h, p = h + 1, p - d8
            if h >= H:
                t, h = t + 1, h - H
    # a block's loads cover its tile, unless the tile was halved to fill the card
    full = min(N, max(1, threads * Q.COLLECT_VEC_PER_THREAD // row))
    assert tile * row <= threads * Q.COLLECT_VEC_PER_THREAD or tile == 1
    if tile < full:
        assert math.ceil(N / (2 * tile)) * B < Q.COLLECT_MIN_BLOCKS_PER_SM * Q.SM_COUNT


@pytest.mark.parametrize("what,B,H,N,d,dp", COLLECT_SHAPES[:7])
def test_collect_plan_fills_the_card_at_the_path_shapes(what, B, H, N, d, dp):
    gx, gy = Q.collect_plan(B, H, N, d, dp)["grid"]
    assert gx * gy >= Q.COLLECT_MIN_BLOCKS_PER_SM * Q.SM_COUNT


def test_collect_plan_at_the_flagship_and_xl_shapes():
    """The flagship's level 2: tiles of 14 token rows of 9 heads x 8 vectors
    (1008 of the 1024 a block's loads take); K600 @DiT/XL: 7 rows of 16 x 9;
    the base widths' level 3 at B = 1: 8 rows of 4 x 32 halved to 4, so that
    the 512 blocks give every SM two."""
    assert Q.collect_plan(2, 9, 8192, 64, 64) == {"tile": 14, "grid": (586, 2), "threads": 256}
    assert Q.collect_plan(8, 16, 1280, 72, 128)["tile"] == 7
    assert Q.collect_plan(1, 4, 2048, 256, 256)["grid"] == (512, 1)


@pytest.mark.parametrize("B,H,N,d,dp", [(1, 1, 64, 60, 64), (1, 1, 64, 64, 60), (1, 1, 64, 128, 64),
                                        (1, 1, 64, 0, 64), (0, 1, 64, 64, 64), (1, 0, 64, 64, 64),
                                        (1, 1, 0, 64, 64), (65536, 1, 64, 64, 64)])
def test_collect_plan_refuses_what_the_kernel_refuses(B, H, N, d, dp):
    with pytest.raises(ValueError):
        Q.collect_plan(B, H, N, d, dp)


def test_the_b8_and_b3_sources_plan_with_the_same_constants():
    """B8's block, lane bound, register width and width-exact instantiations,
    and B3's block, loads a thread and fill rule, are the Python plans' own."""
    b8 = _constants("ln_modulate.cu")
    assert (b8["kThreads"], b8["kMaxLanes"], b8["kMaxRegWidth"], b8["kWarpsPerBlock"] * 32) == (
        L.LN_THREADS, L.LN_MAX_LANES, L.LN_MAX_REG_WIDTH, L.LN_THREADS)
    text = (CSRC / "ln_modulate.cu").read_text()
    # the widths the entry plans as exact, then the instantiations it launches
    widths = tuple(int(w) for w in re.findall(r"case (\d+):", text))
    assert widths == 2 * L.LN_EXACT_WIDTHS
    assert re.findall(r"return launch_exact<(\d+)>", text) == [str(w) for w in L.LN_EXACT_WIDTHS]
    b3 = _constants("attn_out_collect.cu")
    assert (b3["kThreads"], b3["kVecPerThread"], b3["kSmCount"], b3["kMinBlocksPerSm"]) == (
        Q.COLLECT_THREADS, Q.COLLECT_VEC_PER_THREAD, Q.SM_COUNT, Q.COLLECT_MIN_BLOCKS_PER_SM)


# (what, B, N, H, d, dp) of every B7 call on the paths and its tails: the
# flagship's levels 2 and 3 in the train step, K600 @DiT/XL (72 -> 128), the
# base widths' levels 2 and 3, a head of 160 padded to 256, and N = 1000 (no
# multiple of any tile) at B = 3
SCATTER_SHAPES = (
    ("flagship level 2", 1, 8192, 9, 64, 64),
    ("flagship level 3", 1, 2048, 9, 128, 128),
    ("K600 @DiT/XL", 8, 1280, 16, 72, 128),
    ("base level 2", 1, 8192, 4, 128, 128),
    ("base level 3", 1, 2048, 4, 256, 256),
    ("head dim 160", 1, 2048, 4, 160, 256),
    ("tail, d 64", 3, 1000, 3, 64, 64),
    ("tail, d 72", 3, 1000, 3, 72, 128),
    ("tail, d 256", 3, 1000, 2, 256, 256),
    ("token rows wider than a block's slots", 1, 37, 5, 2048, 2048),
)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tokens,C", [(10240, 1152), (8192, 768), (2048, 384), (1001, 1152),
                                      (21, 384), (7, 896), (6, 1024), (5, 2048), (3, 1154),
                                      (3, 2304)])
def test_ln_modulate_bwd_plan_covers_every_token_once(tokens, C, dtype):
    plan = L.ln_modulate_bwd_plan(tokens, C, dtype)
    lanes, per_block = plan["lanes"], plan["block_tokens"]
    # block b's lane group k owns token b * per_block + k: every token once;
    # the groups of the last block past the last token store nothing
    assert per_block * lanes == plan["threads"] == L.LN_THREADS
    owned = [b * per_block + k for b in range(plan["grid"]) for k in range(per_block)]
    assert [t for t in owned if t < tokens] == list(range(tokens))
    assert len(owned) - tokens < per_block
    if dtype == torch.bfloat16 and C in L.LN_EXACT_WIDTHS:
        # each lane holds the same whole number of 16-byte vectors of x,
        # scale and g, its group's lanes a power of two inside one warp
        assert plan["kernel"] == "exact" and lanes * plan["vectors"] * 8 == C
        assert lanes & (lanes - 1) == 0 and 32 % lanes == 0
        vectors = sorted(v for lane in range(lanes) for v in range(lane, C // 8, lanes))
        assert vectors == list(range(C // 8))
    else:
        assert lanes == 32 and plan["kernel"] in ("registers", "pairs")
    assert plan == L.ln_modulate_plan(tokens, C, dtype)


@pytest.mark.parametrize("what,tokens,C", LN_SHAPES)
def test_ln_modulate_bwd_plan_fills_the_card_at_the_path_shapes(what, tokens, C):
    plan = L.ln_modulate_bwd_plan(tokens, C, torch.bfloat16)
    assert plan["kernel"] == "exact" and plan["grid"] >= A.SM_COUNT


@pytest.mark.parametrize("tokens,C,dtype,error", [
    (0, 1152, torch.bfloat16, ValueError), (8, 0, torch.bfloat16, ValueError),
    (8, 1151, torch.bfloat16, ValueError), (8, 1152, torch.float16, TypeError),
    (4 * 2 ** 31, 1152, torch.bfloat16, ValueError)])
def test_ln_modulate_bwd_plan_refuses_what_the_kernel_refuses(tokens, C, dtype, error):
    with pytest.raises(error):
        L.ln_modulate_bwd_plan(tokens, C, dtype)


@pytest.mark.parametrize("what,B,N,H,d,dp", SCATTER_SHAPES)
def test_scatter_plan_covers_every_token_head_and_lane_once(what, B, N, H, d, dp):
    plan = Q.scatter_plan(B, H, N, d, dp)
    tile, (gx, gy), threads = plan["tile"], plan["grid"], plan["threads"]
    assert gy == B and gx == math.ceil(N / tile) and 1 <= tile <= N
    d8, dp8 = d // 8, dp // 8
    row = H * dp8  # output slots of a token

    def split(i):
        return i // row, i % row // dp8, i % row % dp8

    # block (x, b) walks its slots (token, head, vector) in steps of its
    # threads, carrying the indices forward as the kernel does: every output
    # vector of (b, h, t) is written once and every input vector read once
    step = split(threads)

    def walk(x, b):
        t0, written, read = x * tile, [], []
        total = min(tile, N - t0) * row
        for first in range(min(threads, total)):
            t, h, p = split(first)
            for i in range(first, total, threads):
                assert (t, h, p) == split(i)
                written.append(((b * H + h) * N + t0 + t) * dp8 + p)
                if p < d8:
                    read.append(((b * N + t0 + t) * H + h) * d8 + p)
                t, h, p = t + step[0], h + step[1], p + step[2]
                if p >= dp8:
                    h, p = h + 1, p - dp8
                if h >= H:
                    t, h = t + 1, h - H
        return written, read

    small = B * N * row <= 60000
    # every block of a small shape; the first and the last block of a large one
    blocks = [(x, b) for b in range(gy) for x in range(gx)] if small else [(0, 0), (gx - 1, B - 1)]
    walks = [walk(x, b) for x, b in blocks]
    written = sorted(v for w, _ in walks for v in w)
    read = sorted(v for _, r in walks for v in r)
    if small:
        assert written == list(range(B * H * N * dp8))
        assert read == list(range(B * N * H * d8))
    else:
        last = N - (gx - 1) * tile
        assert len(set(written)) == len(written) == (tile + last) * row
        assert len(set(read)) == len(read) == (tile + last) * H * d8
    # a block's slots fit its threads' loads, unless the tile was halved to fill the card
    full = min(N, max(1, threads * Q.COLLECT_VEC_PER_THREAD // row))
    assert tile * row <= threads * Q.COLLECT_VEC_PER_THREAD or tile == 1
    if tile < full:
        assert math.ceil(N / (2 * tile)) * B < Q.COLLECT_MIN_BLOCKS_PER_SM * Q.SM_COUNT


@pytest.mark.parametrize("what,B,N,H,d,dp", SCATTER_SHAPES[:6])
def test_scatter_plan_fills_the_card_at_the_path_shapes(what, B, N, H, d, dp):
    gx, gy = Q.scatter_plan(B, H, N, d, dp)["grid"]
    assert gx * gy >= Q.COLLECT_MIN_BLOCKS_PER_SM * Q.SM_COUNT


def test_scatter_plan_at_the_flagship_and_xl_shapes():
    """The flagship's level 2: tiles of 14 token rows of 9 heads x 8 slots;
    K600 @DiT/XL: 4 rows of 16 heads x 16 slots (9 loaded, 7 of zeros);
    the base widths' level 3 at B = 1: 8 rows of 4 x 32 halved to 4."""
    assert Q.scatter_plan(1, 9, 8192, 64, 64) == {"tile": 14, "grid": (586, 1), "threads": 256}
    assert Q.scatter_plan(8, 16, 1280, 72, 128) == {"tile": 4, "grid": (320, 8), "threads": 256}
    assert Q.scatter_plan(1, 4, 2048, 256, 256)["grid"] == (512, 1)


@pytest.mark.parametrize("B,H,N,d,dp", [(1, 1, 64, 60, 64), (1, 1, 64, 64, 60), (1, 1, 64, 128, 64),
                                        (1, 1, 64, 0, 64), (0, 1, 64, 64, 64), (1, 0, 64, 64, 64),
                                        (1, 1, 0, 64, 64), (65536, 1, 64, 64, 64)])
def test_scatter_plan_refuses_what_the_kernel_refuses(B, H, N, d, dp):
    with pytest.raises(ValueError):
        Q.scatter_plan(B, H, N, d, dp)


def test_the_b9_and_b7_sources_plan_with_the_same_constants():
    """B9's exact kernel is instantiated at every width B8's is, through the
    one launch switch, and refuses a plan by the same rule; B7's block, slots
    a thread and fill rule are the Python plan's own (B3's)."""
    text = (CSRC / "ln_modulate.cu").read_text()
    assert "ln_modulate_bwd_exact_kernel<C, L>" in text
    assert len(re.findall(r"not_my_plan\(tokens, c, is_fp32, lanes, block_tokens, grid\)",
                          text)) == 2
    assert re.findall(r"return launch_exact<(\d+)>\(backward", text) == [
        str(w) for w in L.LN_EXACT_WIDTHS]
    b7 = _constants("attn_out_scatter.cu")
    assert (b7["kThreads"], b7["kVecPerThread"], b7["kSmCount"], b7["kMinBlocksPerSm"]) == (
        Q.COLLECT_THREADS, Q.COLLECT_VEC_PER_THREAD, Q.SM_COUNT, Q.COLLECT_MIN_BLOCKS_PER_SM)
